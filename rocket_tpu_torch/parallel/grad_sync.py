"""Bucketed asynchronous gradient reduction over the data axis
(counterpart of ``rocket_tpu/parallel/grad_sync.py``), the one reduction
every multi-rank train step goes through.

The reference runs the backward inside a manual data region, where the
gradients are still per-device partials, and reduces them itself; here
each rank's backward gives its local gradients and :class:`GradSync`
reduces them over the process group as the backward retires them:

* **sharded params** (an ``fsdp_rules`` layout): the rank holds a shard
  of the leaf, gathered whole at step entry (:func:`gather_buckets`: one
  flat all-gather per :func:`bucket_plan` bucket of the leaves, the rule
  the reductions use); its
  gradient reduce-scatters (mean over ranks) straight back onto the
  shard, so the update runs on the shard. As in the reference, the
  reduce-scatter is an all-to-all at the wire dtype plus a local sum at
  full precision;
* **replicated params**: gradients are flattened into size-bounded
  buckets in reverse parameter order (:func:`bucket_plan`, the order the
  backward retires them), and each bucket's all-reduce is issued
  ``async_op=True`` from the hook of its last leaf. An all-reduce computes
  the same function as the reference's reduce-scatter + all-gather pair;
* **tensor parallelism** (a ``model`` axis): a leaf sharded over the model
  axis is held as this rank's shard and reduces over the data group only,
  like a replicated one. A replicated leaf whose gradient is a partial sum
  over the sequence shards (``partial``: the norms under sequence
  parallelism, which GSPMD sums for the reference) reduces over the plane
  of the data and model axes instead: the sum over the model group and the
  mean over the data group in one all-reduce of its own buckets;
* **ring attention** (a ``seq`` axis): every leaf is replicated and every
  rank's gradient covers its own tokens, so every leaf is partial, and the
  loss too (``loss_partial``: each rank's share of the global mean);
* **pipeline** (a ``pipe`` axis): a stage's own layers reduce over the
  data group only; the leaves every stage holds but only some use (the
  embeddings, ``ln_f``, the head) are partial, and so is the loss, which
  only the last stage computes (with each stage's share of the MoE aux
  loss);
* **expert parallelism** (an ``expert`` axis): a leaf sharded over the
  expert axis is held as this rank's experts and reduces over the data
  group only. Every other leaf is computed alike on every rank of an
  expert row (the MoE all-reduces the cotangents that leave its local
  experts, ``collectives.ep_enter``), and so is the loss: they reduce
  over the data group only too;
* **two split axes at once**: a leaf's gradient may be partial over one
  of them and the same on every rank of the other (a norm under tensor
  parallelism beside an expert axis, every leaf under ring attention beside
  a model axis run replicated). ``partial`` names, per leaf, the plane it
  is summed over (``groups`` maps each name to the process group of the
  data axis and those axes: ``Runtime.plane_group``, the default group
  where that plane is every rank), so no gradient is summed twice over
  one group;
* **gathered leaves** (a model-axis shard the step gathers whole, for the
  replicated program of a model or layer that has no tensor-parallel
  path): :meth:`GradSync.begin`'s ``maps`` turn the whole gradient, the
  same on every rank of the model group, into this rank's shard before it
  is reduced;
* **wire precision**: payloads cross at ``wire_dtype`` (bf16 by default)
  while params stay f32 masters, and every bucket gets the **f32
  bucket-sum correction**: each bucket's true f32 sum rides one stacked
  scalar all-reduce per step and group, and the wire-rounded bucket is
  shifted so its sum is that true sum. Under ``wire_dtype=None`` nothing
  narrows and the result is a plain f32 mean all-reduce.

Collectives are issued in one order on every rank, whatever order the
backward retires the leaves in: a finished bucket waits for the ones
before it in the plan. The step waits on every handle before it reads a
gradient. The loss rides the stacked scalar all-reduce, so the step sees
the global-batch mean, as the reference's ``pmean``.

On ``meta`` tensors every collective here takes the meta route of
``collectives.collective``: it records a ``CommFact`` and needs no process
group, so one rank's reduction traces on the CPU for the schedule audit.
``plane_sizes`` gives the ranks of each partial plane (the data group's
size is ``world``).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional, Sequence

import torch

__all__ = ["bucket_plan", "Layout", "shard_layout", "shard_dims", "gather_full",
           "gather_buckets", "gathered", "GradSync", "NOT_PORTED"]

#: What a spec naming an unported axis points to.
NOT_PORTED = "ROADMAP Queue A 6"

#: The ROADMAP Queue A 6 item of each unported mesh axis (every axis of
#: the reference's mesh is ported).
AXIS_ITEMS: dict = {}


def _itemsize(dtype) -> int:
    return int(dtype.itemsize)  # torch, numpy and JAX dtypes alike


def _numel(shape) -> int:
    n = 1
    for dim in shape or ():
        n *= int(dim)
    return n


def bucket_plan(leaves: Sequence, bucket_bytes: int) -> list:
    """Group ``(index, leaf)`` pairs (a leaf: anything with ``shape`` and
    ``dtype``) into buckets of at most ``bucket_bytes`` (one oversized leaf
    still gets its own), in the order given. Leaves of different dtypes
    never share a bucket. Returns a list of index lists."""
    buckets: list = []
    current: list = []
    current_bytes = 0
    current_dtype = None
    for idx, leaf in leaves:
        nbytes = _numel(tuple(leaf.shape) or (1,)) * _itemsize(leaf.dtype)
        dtype = leaf.dtype
        if current and (current_bytes + nbytes > bucket_bytes or dtype != current_dtype):
            buckets.append(current)
            current, current_bytes = [], 0
        current.append(idx)
        current_bytes += nbytes
        current_dtype = dtype
    if current:
        buckets.append(current)
    return buckets


def _stages(named_leaves, specs, mesh: dict) -> dict:
    """``{layer: stage}`` of the :class:`~rocket_tpu_torch.parallel.sharding.
    LayerStage` specs: L layers split evenly over the P stages of their
    axis, layer ``i`` on stage ``i // (L / P)``."""
    layers = sorted({spec.layer for spec in specs if hasattr(spec, "layer")})
    if not layers:
        return {}
    axis = next(spec.axis for spec in specs if hasattr(spec, "layer"))
    if axis not in mesh:
        raise NotImplementedError(f"param_sharding: layers placed over {axis!r}, which the "
                                  f"mesh {dict(mesh)} lacks (pipeline parallelism needs "
                                  "mesh_shape={'data': d, 'pipe': p})")
    n_stages = int(mesh[axis])
    if len(layers) % n_stages:
        raise ValueError(f"pipeline: {len(layers)} layers must divide over {n_stages} pipeline "
                         "stages.")
    per = len(layers) // n_stages
    return {layer: k // per for k, layer in enumerate(layers)}


class Layout(NamedTuple):
    """Where :func:`shard_layout` puts a leaf: ``dim`` cut over the mesh
    ``axis`` (both None: the leaf's dims are whole), and a layer's leaf on
    pipeline ``stage`` of ``pipe_axis`` (both None: on every stage)."""

    dim: Optional[int] = None
    axis: Optional[str] = None
    stage: Optional[int] = None
    pipe_axis: Optional[str] = None


def shard_layout(named_leaves, spec_fn, mesh: dict, data_axes=("data",),
                 model_axis: str = "model") -> list:
    """Per ``(path tuple, leaf)`` its :class:`Layout`: the dim the rule set
    ``spec_fn`` shards the leaf on and the mesh axis (a data axis,
    ``model_axis`` or the expert axis), and for a layer's leaf its
    pipeline stage (``sharding.layer_stage``; under
    ``sharding.pipeline_over`` its own dim may be sharded too: the stage,
    and the model dim within it); or None (replicated: no rule, no spec, an
    axis of size 1, or a dim that does not divide over it, as the reference
    falls back). A spec naming another axis, an axis the mesh lacks, or two
    axes on one leaf's dims raises."""
    from rocket_tpu_torch.parallel.sharding import layer_stage

    named_leaves = list(named_leaves)
    specs = [spec_fn(tuple(path), leaf) if spec_fn is not None else None
             for path, leaf in named_leaves]
    staged = [layer_stage(spec_fn, tuple(path)) for path, _ in named_leaves]
    stage_of = _stages(named_leaves, [s for s in staged if s is not None], mesh)
    out = []
    for (path, leaf), spec, stage in zip(named_leaves, specs, staged):
        found = []
        for d, entry in enumerate(spec or ()):
            if entry is None:
                continue
            for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
                name = "/".join(path)
                if axis not in data_axes and axis not in (model_axis, "pipe", "expert"):
                    raise NotImplementedError(
                        f"param_sharding: {name} is sharded over {axis!r}: "
                        f"{AXIS_ITEMS.get(axis, 'that axis')} is not ported yet ({NOT_PORTED})")
                if axis not in mesh:
                    raise NotImplementedError(
                        f"param_sharding: {name} is sharded over {axis!r}, which the mesh "
                        f"{dict(mesh)} lacks ({NOT_PORTED}: tensor parallelism needs "
                        "mesh_shape={'data': d, 'model': m}, expert parallelism "
                        "{'data': d, 'expert': e})")
                found.append((d, axis))
        if len(found) > 1:
            raise NotImplementedError(f"param_sharding: {'/'.join(path)} names {len(found)} "
                                      "mesh axes on its dims; the port shards a leaf's dims "
                                      "over one axis (and a layer's leaf over its stage)")
        layout = Layout(*found[0]) if found else None
        if layout is not None:
            n = int(mesh[layout.axis])
            if n <= 1 or leaf.shape[layout.dim] % n:
                layout = None
        if stage is not None and int(mesh[stage.axis]) > 1:
            layout = (layout or Layout())._replace(stage=stage_of[stage.layer],
                                                  pipe_axis=stage.axis)
        out.append(layout)
    return out


def shard_dims(named_leaves, spec_fn, world: int, data_axes=("data",)) -> list:
    """:func:`shard_layout`'s dims over a data-only mesh of ``world`` ranks."""
    return [None if lay is None else lay.dim
            for lay in shard_layout(named_leaves, spec_fn, {data_axes[0]: world}, data_axes)]


def _front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return (t.movedim(dim, 0) if dim else t).contiguous()


def gather_full(shard: torch.Tensor, dim: int, world: int, group=None, async_op: bool = False):
    """The whole leaf from each rank's ``shard`` (split on ``dim``), as
    ``(tensor, work)``; with ``async_op`` the tensor is valid once
    ``work.wait()`` returns."""
    import torch.distributed as dist

    from rocket_tpu_torch.parallel.collectives import collective

    src = _front(shard, dim)
    out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    work = collective("all_gather", lambda: dist.all_gather_into_tensor(
        out, src, group=group, async_op=async_op), (src,), (out,),
        (world - 1) * src.numel() * src.element_size(), world, "data", overlapped=async_op)
    return (out.movedim(0, dim) if dim else out), work


class _Whole(NamedTuple):
    """A leaf's gathered size, as :func:`bucket_plan` reads it."""

    shape: tuple
    dtype: torch.dtype


def gather_buckets(shards: Sequence, world: int, group=None, bucket_bytes: int = 4 << 20):
    """Start the step-entry gathers of ``shards``, ``(index, shard, dim)``
    triples over ``world`` ranks: the leaves are bucketed by
    :func:`bucket_plan` over their whole sizes, in the order given (at most
    ``bucket_bytes`` a bucket, one dtype a bucket, an oversized leaf alone),
    and each bucket is one flat ``all_gather_into_tensor``, started
    ``async_op`` before any wait. Returns the pending buckets for
    :func:`gathered`. A bucket moves the bytes its leaves' own gathers
    would: (world - 1) shards of each."""
    import torch.distributed as dist

    from rocket_tpu_torch.parallel.collectives import collective

    fronts = {i: (_front(t, d), d) for i, t, d in shards}
    plan = bucket_plan([(i, _Whole((world * f.shape[0],) + tuple(f.shape[1:]), f.dtype))
                        for i, (f, _) in fronts.items()], bucket_bytes)
    pending = []
    for bucket in plan:
        parts = [fronts[i][0].reshape(-1) for i in bucket]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        out = torch.empty(world * flat.numel(), dtype=flat.dtype, device=flat.device)
        work = collective("all_gather", lambda out=out, flat=flat: dist.all_gather_into_tensor(
            out, flat, group=group, async_op=True), (flat,), (out,),
            (world - 1) * flat.numel() * flat.element_size(), world, "data", overlapped=True)
        pending.append((bucket, out, work))
    return pending, fronts, world


def gathered(started):
    """``(index, whole leaf)`` of every leaf :func:`gather_buckets` started,
    each bucket waited on in turn and split back into its leaves (bitwise
    what the leaf's own gather gives)."""
    pending, fronts, world = started
    for bucket, out, work in pending:
        work.wait()
        out = out.view(world, -1)
        offset = 0
        for i in bucket:
            front, dim = fronts[i]
            n = front.numel()
            whole = out[:, offset:offset + n].reshape((-1,) + tuple(front.shape[1:]))
            offset += n
            yield i, (whole.movedim(0, dim) if dim else whole)


def _scatter(grad: torch.Tensor, dim: int, world: int, wire, group):
    """Start the mean reduce-scatter of ``grad`` onto its ``dim`` shards,
    as the reference's ``_a2a_reduce_shard``: an all-to-all at the wire
    dtype (a reduce-scatter's bytes) whose ``world`` received pieces
    :func:`_unfront` sums at full precision. Returns ``(received, work)``."""
    import torch.distributed as dist

    from rocket_tpu_torch.parallel.collectives import collective

    src = _front(grad, dim) / world
    if wire is not None and _itemsize(wire) < _itemsize(src.dtype):
        src = src.to(wire)
    out = torch.empty_like(src)
    return out, collective("all_to_all", lambda: dist.all_to_all_single(
        out, src, group=group, async_op=True), (src,), (out,),
        (world - 1) / world * src.numel() * src.element_size(), world, "data", overlapped=True)


def _unfront(received: torch.Tensor, dim: int, dtype, world: int) -> torch.Tensor:
    """This rank's shard from the ``world`` pieces an all-to-all received,
    summed in ``dtype`` in rank order."""
    pieces = received.to(dtype).reshape((world, received.shape[0] // world)
                                        + tuple(received.shape[1:]))
    out = pieces[0]
    for piece in pieces[1:]:
        out = out + piece
    return out.movedim(0, dim).contiguous() if dim else out


class GradSync:
    """The bucketed reduction of one param list: ``shapes`` and ``dtypes``
    of the leaves as the backward sees them (whole, or this rank's model
    shard), ``dims`` their data-axis shard dims (:func:`shard_layout`),
    ``world`` the data ranks (the mean's divisor) over ``group``,
    ``partial`` per leaf None or the key in ``groups`` of the plane a
    replicated leaf is summed over instead (the data axis and the split
    axes its gradient is partial over), and ``loss_partial`` the loss's
    (each rank's loss its share of its data row's mean: a sequence
    slice's, or the last stage's).
    Per step, :meth:`begin` hooks the leaves the backward differentiates,
    and :meth:`finish` takes the backward's
    gradients and the local loss and returns the reduced gradients (shard
    shaped where sharded) and the global mean loss. One data rank reduces
    nothing but the partial leaves.

    ``stats`` after a step: ``buckets`` and ``wire_bytes`` (the payload
    bytes a rank sends into its collectives per step) and ``wait_s`` (host
    seconds spent waiting on the handles)."""

    def __init__(self, shapes: Sequence, dtypes: Sequence, dims: Sequence, world: int,
                 group=None, bucket_bytes: int = 4 << 20, wire_dtype="bfloat16",
                 partial: Optional[Sequence] = None, loss_partial=None,
                 groups: Optional[dict] = None, plane_sizes: Optional[dict] = None) -> None:
        self.world = int(world)
        self.group = group
        self.dims = list(dims)
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.partial = list(partial) if partial is not None else [None] * len(self.dims)
        self.loss_partial = loss_partial
        self.groups = dict(groups or {})
        self.plane_sizes = dict(plane_sizes or {})
        if self.world < 2 and not any(p is not None for p in self.partial):
            raise ValueError("GradSync: nothing to reduce on one data rank without partial "
                             "leaves")
        self.wire = None if wire_dtype is None else (
            wire_dtype if isinstance(wire_dtype, torch.dtype) else getattr(torch, str(wire_dtype)))

        def plan(indices):
            return bucket_plan([(i, torch.empty(self.shapes[i], dtype=self.dtypes[i],
                                                device="meta")) for i in reversed(indices)],
                               bucket_bytes)

        repl = [i for i, d in enumerate(self.dims) if d is None]
        data = plan([i for i in repl if self.partial[i] is None]) if self.world > 1 else []
        kinds = [(list(b), "data") for b in data]
        self.buckets = list(data)
        planes = sorted({self.partial[i] for i in repl if self.partial[i] is not None},
                        key=lambda p: str(sorted(p)))
        for plane in planes:
            part = plan([i for i in repl if self.partial[i] == plane])
            self.buckets += part
            kinds += [(list(b), ("partial", plane)) for b in part]
        kinds += [([i], "scatter") for i, d in enumerate(self.dims) if d is not None]
        # Issue order: reverse param order of each unit's first (last
        # declared) leaf, the same on every rank.
        kinds.sort(key=lambda u: -u[0][0])
        self.units = [u for u, _ in kinds]
        self.kinds = [k for _, k in kinds]
        self._unit_of = {i: k for k, unit in enumerate(self.units) for i in unit}
        self.stats = {"buckets": len(self.buckets), "wire_bytes": 0, "wait_s": 0.0}
        self._maps: list = [None] * len(self.shapes)
        self._reset()

    def _group_of(self, kind):
        return self.group if kind == "data" else self.groups[kind[1]]

    def _all_reduce(self, payload: torch.Tensor, kind, overlapped: bool):
        """Start the sum of ``payload`` over ``kind``'s group (its work)."""
        import torch.distributed as dist

        from rocket_tpu_torch.parallel.collectives import collective

        n = self.world if kind == "data" else self.plane_sizes.get(kind[1], self.world)
        axis = "data" if kind == "data" else "+".join(sorted(("data",) + tuple(kind[1])))
        return collective("all_reduce", lambda: dist.all_reduce(
            payload, group=self._group_of(kind), async_op=True), (payload,), (payload,),
            2 * (n - 1) / n * payload.numel() * payload.element_size(), n, axis,
            overlapped=overlapped)

    def _reset(self) -> None:
        self._grads: list = [None] * len(self.shapes)
        self._left = [len(u) for u in self.units]
        self._next = 0
        self._pending: list = [None] * len(self.units)
        self._hooks: list = []

    def _narrows(self, dtype) -> bool:
        return self.wire is not None and _itemsize(self.wire) < _itemsize(dtype)

    def begin(self, leaves: Sequence[torch.Tensor], hook: bool = True,
              maps: Optional[Sequence] = None) -> None:
        """Hook each leaf that needs a gradient: the hook records the
        gradient and issues every unit that is complete and whose
        predecessors were issued. ``hook=False``: the step's gradients all
        arrive at :meth:`finish`. ``maps``: per leaf None or a function
        applied to its gradient first (a gathered leaf's whole gradient ->
        this rank's shard)."""
        self._reset()
        self._maps = list(maps) if maps is not None else [None] * len(self.shapes)
        self.stats["wire_bytes"] = 0
        if not hook:
            return
        for i, t in enumerate(leaves):
            if t.requires_grad:
                self._hooks.append(t.register_hook(partial(self._on_grad, i)))

    def _on_grad(self, i: int, grad: torch.Tensor) -> None:
        if self._grads[i] is None:
            self._grads[i] = grad if self._maps[i] is None else self._maps[i](grad)
            if i in self._unit_of:
                self._left[self._unit_of[i]] -= 1
                self._issue_ready()

    def _issue_ready(self) -> None:
        while self._next < len(self.units) and self._left[self._next] == 0:
            self._issue(self._next)
            self._next += 1

    def _issue(self, k: int) -> None:
        unit = self.units[k]
        first = unit[0]
        if self.kinds[k] == "scatter":
            out, work = _scatter(self._grads[first], self.dims[first], self.world, self.wire,
                                 self.group)
            self.stats["wire_bytes"] += out.numel() * out.element_size()
            self._pending[k] = (out, work, None)
            return
        flat = torch.cat([self._grads[i].reshape(-1) for i in unit]) / self.world
        true_sum = None
        if self._narrows(flat.dtype):
            true_sum = flat.sum(dtype=torch.float32)
            payload = flat.to(self.wire)
        else:
            payload = flat
        self.stats["wire_bytes"] += payload.numel() * payload.element_size()
        work = self._all_reduce(payload, self.kinds[k], overlapped=True)
        self._pending[k] = (payload, work, true_sum)

    def finish(self, grads: Sequence[Optional[torch.Tensor]], loss: torch.Tensor):
        """The backward's gradients (None where a leaf got none) and the
        local loss -> ``(reduced grads, global mean loss)``, after every
        handle was waited on."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        for i, g in enumerate(grads):
            if self._grads[i] is None:  # unused leaf, or hooked on no leaf
                if g is not None and self._maps[i] is not None:
                    g = self._maps[i](g)
                self._grads[i] = (g if g is not None else torch.zeros(
                    self.shapes[i], dtype=self.dtypes[i], device=loss.device))
                if i in self._unit_of:
                    self._left[self._unit_of[i]] -= 1
        self._issue_ready()
        # The f32 bucket sums and the loss, one stacked all-reduce per group.
        scalars: dict = {"data": []}
        for kind in self.kinds:
            if kind != "scatter":
                scalars.setdefault(kind, [])
        for kind, (_, _, true_sum) in zip(self.kinds, self._pending):
            if true_sum is not None:
                scalars[kind].append(true_sum)
        loss_kind = "data" if self.loss_partial is None else ("partial", self.loss_partial)
        scalars.setdefault(loss_kind, []).append(loss.float() / self.world)
        works = []
        stacked = {}
        for kind, values in scalars.items():
            if values and (kind != "data" or self.world > 1):
                stacked[kind] = torch.stack(values)
                works.append(self._all_reduce(stacked[kind], kind, overlapped=False))
        t0 = time.perf_counter()
        for _, work, _ in self._pending:
            work.wait()
        for work in works:
            work.wait()
        self.stats["wait_s"] = time.perf_counter() - t0
        out: list = [g if i not in self._unit_of else None for i, g in enumerate(self._grads)]
        seen = {kind: 0 for kind in stacked}
        for unit, kind, (payload, _, true_sum) in zip(self.units, self.kinds, self._pending):
            first = unit[0]
            if kind == "scatter":
                out[first] = _unfront(payload, self.dims[first], self.dtypes[first], self.world)
                continue
            full = payload.to(self.dtypes[first])
            if true_sum is not None:
                # The f32 bucket-sum correction: shift the wire-rounded
                # bucket so that its sum is the true f32 sum.
                delta = (stacked[kind][seen[kind]] - full.sum(dtype=torch.float32)) / full.numel()
                full = full + delta.to(full.dtype)
                seen[kind] += 1
            offset = 0
            for i in unit:
                size = _numel(self.shapes[i])
                out[i] = full[offset:offset + size].reshape(self.shapes[i])
                offset += size
        self._reset()
        if loss_kind in stacked:
            return out, stacked[loss_kind][-1]
        return out, loss
