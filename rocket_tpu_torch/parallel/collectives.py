"""Overlapped collective matmuls for tensor parallelism (counterpart of
``rocket_tpu/parallel/collectives.py``).

The Megatron layout with sequence parallelism over the model group of the
Runtime's mesh: between blocks each rank holds its sequence shard of the
residual stream ``(B, T/n, D)``; a column-parallel projection (QKV, the
MLP's input) all-gathers that shard into its matmul against the rank's
column shard of the weight, and a row-parallel projection (attention out,
the MLP's output) reduce-scatters its partial product back onto the
sequence shards. Every piece is a ``torch.autograd.Function`` whose
backward is the reference's transposed collective:

* **bulk**: one ``all_gather_into_tensor``; a reduce-scatter as one
  ``all_to_all_single`` of the ``n`` chunks and a local sum in rank order
  (the reference's gradient form, and gloo's reduce-scatter would round a
  narrow dtype twice);
* **ring**: ``n - 1`` ``batch_isend_irecv`` hops, each overlapping the
  product of the chunk before it (``ops/ring.py`` holds the index math);
  ``"auto"`` rings a collective whose per-hop chunk holds at least
  ``min_ring_bytes`` (1 MiB).
* **wire**: values that flow into gradients cross in
  ``ROCKET_TPU_OVERLAP_WIRE`` (bf16 by default; ``fp32``/``off`` keep
  them whole); forward activations always cross at their own dtype. A
  narrowed payload crosses as its bytes (a uint8 view), so no backend
  reassociates it.

``ROCKET_TPU_OVERLAP=0`` restores the plain program in the reference,
where GSPMD then places the collectives. The port has no GSPMD: its
params stay in the TP layout, so ``0`` runs the same layout with one bulk
collective each and no wire narrowing, which is the function GSPMD's
program computes. ``ROCKET_TPU_OVERLAP=ring`` or ``=bulk`` forces the
mode (the port's own values; unset or ``1`` is ``"auto"``).

Gloo's point-to-point ops take host tensors only. Over gloo a ring hop
of a CUDA chunk stages it through host memory explicitly (logged once,
and ``STATS["staged"]`` says so); it never turns into a bulk collective.
:class:`Hop` is that staged transfer, which ring attention and the
pipeline also send their blocks and activations through.

The context (:func:`tp_overlap`) is installed by ``core/module.py`` when
the Module's ``param_sharding`` rule carries the ``tp_axis`` marker
(``gpt2_tp_rules``), around the forward and the backward (a remat
recompute issues the forward's collectives again, in the same order on
every rank). It is process-wide, not per thread: a CUDA backward runs on
autograd's device thread. ``pvary_compat`` is JAX typing and has no
counterpart here.

Expert parallelism (an ``expert`` axis, ``nn/moe.py``): the Module
installs :func:`expert_parallel` around the forward and the backward when
the rule that laid the model out carries the ``expert_axis`` marker
(``sharding.moe_rules``). Every rank of an expert row routes the same
tokens and computes its own experts' share of the output; two autograd
Functions cross the group: :func:`ep_enter` (the identity, whose backward
all-reduces the cotangent the local experts send back to a replicated
tensor) and :func:`ep_combine` (an all-reduce of the local experts'
partial output, whose backward is the identity). Both cross at the
tensor's own dtype, as one all-reduce each over the expert group (CUDA
tensors too over gloo, which stages a collective's payload itself).

Over several data ranks the MoE's load-balancing loss is the global
batch's, as the reference's GSPMD program computes it: under
:func:`data_mean` (the Module's context for an MoE model that is not
pipelined) :func:`batch_mean` averages each layer's routed fractions and
mean gates over the data group (one all-reduce a layer).

The MoE under a seq axis gathers the sequence with :func:`seq_gather_sum`
(an all-gather whose backward reduce-scatters the partial cotangents:
under ring attention every gradient is a partial that ``GradSync`` sums).

Where a layer's width does not divide the model group it runs the
replicated program (the reference's plain GSPMD program for it): its
model-sharded leaves gathered whole (:func:`gather_whole`), the sequence
gathered and this rank's rows of the output kept (``seq_all_gather`` /
``seq_shard``); :func:`note_replicated` counts each such forward.

``STATS`` counts, per process, the seconds spent waiting on the model
group's collectives (and the expert group's), the bytes a rank sends into
them, each collective's calls by mode and the forwards that ran the
replicated program (``replicated_layers``); :func:`reset_stats` zeroes it.

On ``meta`` tensors every collective takes a meta route, as the kernel
wrappers do (``ops/_launch.py``): :func:`collective` records a
``CommFact`` (kind, the bytes counted into ``STATS["wire_bytes"]``, the
group's size, the axis) where the card would issue it, needs no process
group, and the caller's outputs stay empty meta tensors of the right
shapes. So one rank's step of a multi-rank world traces on the CPU and the
schedule audit prices its communication; every byte counted on the card is
a byte priced there. A real tensor never takes the route.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from rocket_tpu_torch.ops import ring as ring_lib
from rocket_tpu_torch.ops._launch import CommFact, record

__all__ = [
    "OverlapSpec", "overlap_enabled", "overlap_mode", "grad_wire_dtype", "tp_overlap",
    "current_tp", "all_gather_matmul", "matmul_reduce_scatter", "qkv_fused_views",
    "embed_lookup_sharded", "vocab_lookup", "seq_all_gather", "seq_shard", "gather_replicated",
    "STATS", "reset_stats", "Hop", "ExpertSpec", "expert_parallel", "current_ep", "ep_enter",
    "ep_combine", "seq_gather_sum", "DataSpec", "data_mean", "current_data", "batch_mean",
    "gather_whole", "note_gather", "note_replicated", "collective",
]

logger = logging.getLogger(__name__)

#: Per-process collective counters (module docstring).
STATS: dict = {"wait_s": 0.0, "wire_bytes": 0, "calls": {}, "staged": False,
               "replicated_layers": 0}


def reset_stats() -> None:
    STATS.update(wait_s=0.0, wire_bytes=0, calls={}, replicated_layers=0)


def note_gather(shards, n: int) -> None:
    """Count the gathers of the model shards ``shards`` over a group of
    ``n`` ranks that start a replicated step (the Module's), as one call of
    ``replicated_gather`` and the bytes a rank sends into them."""
    _note("replicated_gather", False)
    for t in shards:
        _sent(t, n - 1)


def note_replicated(what: str) -> None:
    """Count one forward of a layer (or a whole model: ``what``) that runs
    the replicated program over the model group instead of its
    tensor-parallel path, in ``STATS["replicated_layers"]`` (per process;
    a remat recompute counts again)."""
    STATS["replicated_layers"] += 1
    calls = STATS.setdefault("replicated", {})
    calls[what] = calls.get(what, 0) + 1


def overlap_enabled() -> bool:
    """False under ``ROCKET_TPU_OVERLAP=0`` (the plain program: bulk
    collectives, no wire narrowing)."""
    return os.environ.get("ROCKET_TPU_OVERLAP", "1") != "0"


def overlap_mode() -> str:
    """The ring mode ``ROCKET_TPU_OVERLAP`` asks for: ``"ring"``,
    ``"bulk"`` (also under ``0``) or ``"auto"``."""
    value = os.environ.get("ROCKET_TPU_OVERLAP", "1").strip().lower()
    return {"ring": "ring", "bulk": "bulk", "0": "bulk"}.get(value, "auto")


def grad_wire_dtype() -> Optional[torch.dtype]:
    """The wire dtype of gradient-carrying collectives, from
    ``ROCKET_TPU_OVERLAP_WIRE`` (default bf16; ``fp32``/``off`` disable the
    narrowing)."""
    name = os.environ.get("ROCKET_TPU_OVERLAP_WIRE", "bfloat16").lower()
    if name in ("fp32", "f32", "float32", "off", "none", ""):
        return None
    return getattr(torch, name)


@dataclass(frozen=True)
class OverlapSpec:
    """One active TP configuration: ``group`` the model group's process
    group, ``ranks`` its global ranks in model-coordinate order, ``index``
    this rank's model coordinate; ``wire`` the gradient wire dtype's name
    (None: no narrowing), ``mode`` / ``min_ring_bytes`` ring or bulk per
    collective (``ops.ring.use_ring``), ``vocab_sharded_embed`` the rule's
    ``tp_vocab_sharded`` marker."""

    group: Any
    ranks: Tuple[int, ...]
    index: int
    axis: str = "model"
    wire: Optional[str] = "bfloat16"
    mode: str = "auto"
    min_ring_bytes: int = 1 << 20
    vocab_sharded_embed: bool = False

    @property
    def tp_size(self) -> int:
        return len(self.ranks)

    def wire_dtype(self) -> Optional[torch.dtype]:
        return None if self.wire is None else getattr(torch, self.wire)


#: The active spec, process-wide (module docstring).
_ACTIVE: list = [None]


@contextlib.contextmanager
def tp_overlap(runtime, axis: str = "model", wire: Optional[str] = "__env__",
               mode: Optional[str] = None, min_ring_bytes: int = 1 << 20,
               vocab_sharded_embed: bool = False):
    """Activate the TP context over ``runtime``'s ``axis`` group for the
    block (None when the mesh has no such axis larger than 1). ``mode``
    None reads ``ROCKET_TPU_OVERLAP`` (:func:`overlap_mode`); under
    ``ROCKET_TPU_OVERLAP=0`` the wire is never narrowed. The reference's
    ``data_axes`` has no use here: each rank's batch is its stripe, and
    ``GradSync`` reduces the weights' gradients over the data group."""
    size = int(runtime.mesh.get(axis, 1))
    if size <= 1:
        yield None
        return
    if wire == "__env__":
        wd = grad_wire_dtype()
        wire = None if wd is None else str(wd).replace("torch.", "")
    if not overlap_enabled():
        wire = None
    spec = OverlapSpec(group=runtime.axis_group(axis), ranks=tuple(runtime.axis_ranks(axis)),
                       index=runtime.axis_index(axis), axis=axis, wire=wire,
                       mode=mode or overlap_mode(), min_ring_bytes=min_ring_bytes,
                       vocab_sharded_embed=vocab_sharded_embed)
    previous, _ACTIVE[0] = _ACTIVE[0], spec
    try:
        yield spec
    finally:
        _ACTIVE[0] = previous


def current_tp() -> Optional[OverlapSpec]:
    """The active :class:`OverlapSpec`, or None."""
    return _ACTIVE[0]


# -- the wire and the transport ----------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist


def _note(name: str, ring: bool) -> None:
    calls = STATS["calls"].setdefault(name, {"ring": 0, "bulk": 0})
    calls["ring" if ring else "bulk"] += 1


class _MetaWork:
    """The handle of a collective recorded on meta tensors."""

    def wait(self) -> None:
        return None


def collective(kind: str, issue, inputs, outputs, nbytes: float, group: int, axis: str = "",
               overlapped: bool = False):
    """Issue one collective: ``issue()`` (which returns its work) on real
    tensors; on meta ``inputs`` record its ``CommFact`` instead — ``kind``,
    ``nbytes`` (what the rank sends, ring model), ``group`` ranks over
    ``axis``, ``overlapped`` when its wait comes later than the next op —
    with the tensors it reads and writes, and return a handle with nothing
    to wait for."""
    if any(t.device.type == "meta" for t in inputs):
        record([CommFact(kind, int(nbytes), int(group), axis, overlapped)], tuple(inputs),
               tuple(outputs))
        return _MetaWork()
    return issue()


def _wait(work) -> None:
    t0 = time.perf_counter()
    work.wait()
    STATS["wait_s"] += time.perf_counter() - t0


def _sent(t: torch.Tensor, copies: float = 1) -> float:
    """Count ``copies`` of ``t``'s bytes as sent; returns them."""
    nbytes = t.numel() * t.element_size() * copies
    STATS["wire_bytes"] += nbytes
    return nbytes


def _narrow(spec: OverlapSpec, t: torch.Tensor) -> torch.Tensor:
    """A gradient payload in the wire dtype (never widened)."""
    wd = spec.wire_dtype()
    if wd is None or wd.itemsize >= t.element_size():
        return t
    return t.to(wd)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float payload as its bytes (a relayout moves bits; gloo
    takes no 16-bit integer type): the last dim doubles."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t


def _unbits(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype == torch.uint8 and dtype != torch.uint8 else t


def _use_ring(spec: OverlapSpec, shard_bytes: int) -> bool:
    return ring_lib.use_ring(shard_bytes, spec.mode, spec.min_ring_bytes)


def _all_gather(spec: OverlapSpec, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shards of ``t`` laid end to end on ``dim``, in
    model-coordinate order (one bulk all-gather)."""
    dim = dim % t.dim()
    src = _bits(t.movedim(dim, 0))
    out = torch.empty((spec.tp_size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    nbytes = _sent(src, spec.tp_size - 1)
    _wait(collective("all_gather", lambda: _dist().all_gather_into_tensor(
        out, src, group=spec.group, async_op=True), (src,), (out,), nbytes, spec.tp_size,
        spec.axis))
    return _unbits(out, t.dtype).movedim(0, dim)


def _own(spec: OverlapSpec, t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` on ``dim`` (no communication)."""
    return t.chunk(spec.tp_size, dim)[spec.index].contiguous()


class Hop:
    """Point-to-point transfers started together: each ``(tensor, rank)``
    of ``sends`` goes to that global rank, and each ``(like, rank)`` of
    ``recvs`` receives a tensor of ``like``'s shape, dtype and device from
    it (a third item, a tag, matches a send to its receive whatever the
    order); :meth:`wait` returns the received tensors in order. Gloo's
    point-to-point ops take host tensors only (a CUDA pointer reaches its
    socket write and breaks the pair), so over gloo a CUDA tensor crosses
    through host memory, explicitly. ``stats`` (default :data:`STATS`)
    counts the bytes sent and the seconds waited; ``what`` names the path
    in the one warning that staging logs."""

    def __init__(self, group, sends=(), recvs=(), stats: Optional[dict] = None,
                 what: str = "tensor parallelism") -> None:
        self.stats = STATS if stats is None else stats
        if any(t.device.type == "meta" for t, *_ in sends) or any(
                like.device.type == "meta" for like, *_ in recvs):
            self._meta(sends, recvs, what)
            return
        dist = _dist()
        staged = dist.get_backend(group) == "gloo"
        ops = []
        for t, rank, *tag in sends:
            payload = _bits(t)
            if payload.is_cuda and staged:
                self._note_staged(what)
                # The staging copy is the transfer itself (module docstring).
                payload = payload.cpu()  # rocketlint: disable=RKT103
            self.stats["wire_bytes"] += payload.numel() * payload.element_size()
            ops.append(dist.P2POp(dist.isend, payload, rank, group=group, tag=tag[0] if tag else 0))
        self.bufs = []
        for like, rank, *tag in recvs:
            buf = _bits(torch.empty_like(like))
            if buf.is_cuda and staged:
                buf = torch.empty_like(buf, device="cpu")
            self.bufs.append((buf, like.dtype, like.device))
            ops.append(dist.P2POp(dist.irecv, buf, rank, group=group, tag=tag[0] if tag else 0))
        self.works = dist.batch_isend_irecv(ops) if ops else []

    def _meta(self, sends, recvs, what: str) -> None:
        """The meta route: one ``send_recv`` CommFact for the hop's sends
        (their bytes counted as on the card), empty receive buffers."""
        payloads = [_bits(t) for t, *_ in sends]
        nbytes = sum(p.numel() * p.element_size() for p in payloads)
        self.stats["wire_bytes"] += nbytes
        self.bufs = [(_bits(torch.empty_like(like)), like.dtype, like.device)
                     for like, *_ in recvs]
        collective("send_recv", None, payloads or [b for b, _, _ in self.bufs],
                   [b for b, _, _ in self.bufs], nbytes, 2, what, overlapped=True)
        self.works = []

    def _note_staged(self, what: str) -> None:
        if not self.stats.get("staged"):
            self.stats["staged"] = True
            logger.warning("%s: gloo takes no point-to-point CUDA tensors; its hops are staged "
                           "through host memory", what)

    def wait(self) -> list:
        t0 = time.perf_counter()
        for work in self.works:
            work.wait()
        self.stats["wait_s"] += time.perf_counter() - t0
        out = []
        for buf, dtype, device in self.bufs:
            t = _unbits(buf, dtype)
            out.append(t.to(device) if t.device != device else t)
        return out


class _Hop(Hop):
    """One ring hop of the model group started: send ``t`` to the next
    rank and receive the previous rank's chunk of the same shape;
    :meth:`wait` returns it."""

    def __init__(self, spec: OverlapSpec, t: torch.Tensor) -> None:
        n, d = spec.tp_size, spec.index
        super().__init__(spec.group, [(t, spec.ranks[(d + 1) % n])],
                         [(t, spec.ranks[(d - 1) % n])])

    def wait(self) -> torch.Tensor:
        return super().wait()[0]


def _ring_gather(spec: OverlapSpec, chunk: torch.Tensor, on_chunk) -> list:
    """Drive the all-gather ring: ``on_chunk(j, chunk)`` for every global
    chunk ``j`` as it arrives (each product overlaps the next hop);
    returns the chunks in global order."""
    n, d = spec.tp_size, spec.index
    arrival = []
    for s in range(n):
        hop = _Hop(spec, chunk) if s < n - 1 else None
        arrival.append(chunk)
        on_chunk((d - s) % n, chunk)
        if hop is not None:
            chunk = hop.wait()
    return [arrival[i] for i in ring_lib.gather_order(d, n)]


def _ring_reduce_scatter(spec: OverlapSpec, chunk_of, acc_dtype, wire: bool) -> torch.Tensor:
    """The ring reduce-scatter: ``chunk_of(j)`` is this rank's partial for
    global chunk ``j``, computed while the accumulator is on the wire; the
    accumulator crosses in the wire dtype when ``wire`` and adds in
    ``acc_dtype``. Returns this rank's summed chunk."""
    n, d = spec.tp_size, spec.index
    acc = chunk_of(ring_lib.rs_seed_index(d, n)).to(acc_dtype)
    for s in range(1, n):
        hop = _Hop(spec, _narrow(spec, acc) if wire else acc)
        mine = chunk_of(ring_lib.rs_chunk_index(d, s, n)).to(acc_dtype)
        acc = hop.wait().to(acc_dtype) + mine
    return acc


def _bulk_reduce_scatter(spec: OverlapSpec, t: torch.Tensor, wire: bool) -> torch.Tensor:
    """``(B, T, ...)`` partials -> this rank's ``(B, T/n, ...)`` sum: the
    ``n`` chunks cross as one all-to-all (in the wire dtype when ``wire``)
    and are summed locally in ``t``'s dtype, in rank order."""
    n = spec.tp_size
    chunks = torch.stack(t.chunk(n, 1))                      # (n, B, T/n, ...)
    payload = _bits(_narrow(spec, chunks) if wire else chunks)
    out = torch.empty_like(payload)
    nbytes = _sent(payload, (n - 1) / n)
    _wait(collective("all_to_all", lambda: _dist().all_to_all_single(
        out, payload, group=spec.group, async_op=True), (payload,), (out,), nbytes, n, spec.axis))
    pieces = _unbits(out, (_narrow(spec, chunks) if wire else chunks).dtype).to(t.dtype)
    acc = pieces[0]
    for piece in pieces[1:]:
        acc = acc + piece
    return acc


def _reduce_scatter(spec, name, chunk_of, full, dtype, wire, chunk_bytes):
    """Ring (``chunk_of``) or bulk (``full()``) reduce-scatter by size."""
    ring = _use_ring(spec, chunk_bytes)
    _note(name, ring)
    if ring:
        return _ring_reduce_scatter(spec, chunk_of, dtype, wire)
    return _bulk_reduce_scatter(spec, full(), wire)


def _gather_with(spec, name, t, wire, on_chunk=None):
    """All-gather ``t`` on dim 1 (in the wire dtype when ``wire``), ring or
    bulk by the chunk's size -> ``(gathered in t's dtype, ring)``. On the
    ring ``on_chunk(j, chunk)`` sees each global chunk as it arrives, so
    its product overlaps the next hop."""
    payload = _narrow(spec, t) if wire else t
    ring = _use_ring(spec, payload.numel() * payload.element_size())
    _note(name, ring)
    if ring:
        def widen(j, c):
            if on_chunk is not None:
                on_chunk(j, c.to(t.dtype))

        return torch.cat(_ring_gather(spec, payload, widen), 1).to(t.dtype), True
    return _all_gather(spec, payload, 1).to(t.dtype), False


# -- all_gather_matmul -----------------------------------------------------------------


class _AllGatherMatmul(torch.autograd.Function):
    """``tuple(gather_seq(x) @ w for w in ws)`` with one shared gather; the
    backward reduce-scatters ``Σ dy_i @ w_iᵀ`` onto the sequence shards at
    the wire dtype, and each ``dw_i`` is local (complete for this rank's
    columns of its data stripe)."""

    @staticmethod
    def forward(ctx, spec, x, *ws):
        parts = [[None] * spec.tp_size for _ in ws]

        def on_chunk(j, chunk):
            for i, w in enumerate(ws):
                parts[i][j] = chunk @ w

        xg, ring = _gather_with(spec, "all_gather_matmul", x, False, on_chunk)
        ctx.spec = spec
        ctx.save_for_backward(xg, *ws)
        if ring:
            return tuple(torch.cat(p, 1) for p in parts)
        return tuple(xg @ w for w in ws)

    @staticmethod
    def backward(ctx, *dys):
        spec = ctx.spec
        xg, *ws = ctx.saved_tensors
        dys = [torch.zeros(xg.shape[:2] + (w.shape[1],), dtype=xg.dtype, device=xg.device)
               if dy is None else dy for dy, w in zip(dys, ws)]
        n, t = spec.tp_size, xg.shape[1]
        tc = t // n

        def chunk_of(j):
            sl = slice(j * tc, (j + 1) * tc)
            out = None
            for dy, w in zip(dys, ws):
                term = dy[:, sl] @ w.t()
                out = term if out is None else out + term
            return out

        dx = _reduce_scatter(spec, "all_gather_matmul.bwd", chunk_of,
                             lambda: torch.cat([chunk_of(j) for j in range(n)], 1), xg.dtype,
                             True, xg.shape[0] * tc * xg.shape[2] * xg.element_size())
        k = xg.shape[-1]
        dws = [xg.reshape(-1, k).t() @ dy.reshape(-1, dy.shape[-1]) for dy in dys]
        return (None, dx, *dws)


def all_gather_matmul(spec: OverlapSpec, x: torch.Tensor, ws: Sequence[torch.Tensor]):
    """``x`` ``(B, T/n, K)`` this rank's sequence shard, each ``w`` ``(K,
    F/n)`` its column shard -> ``tuple`` of ``(B, T, F/n)``: one gather
    (ring above the threshold, else bulk) feeding every product."""
    return _AllGatherMatmul.apply(spec, x, *ws)


# -- matmul_reduce_scatter ---------------------------------------------------------------


class _MatmulReduceScatter(torch.autograd.Function):
    """``reduce_scatter_seq(x @ w) (+ bias)``: the forward sums at the
    activation dtype; the backward gathers ``dy`` at the wire dtype and
    computes ``dx``, ``dw`` and the bias gradient from the one gathered
    copy (the bias gradient is then complete on every rank)."""

    @staticmethod
    def forward(ctx, spec, x, w, bias):
        n, t = spec.tp_size, x.shape[1]
        tc = t // n

        def chunk_of(j):
            return x[:, j * tc:(j + 1) * tc] @ w

        out = _reduce_scatter(spec, "matmul_reduce_scatter", chunk_of, lambda: x @ w, x.dtype,
                              False, x.shape[0] * tc * w.shape[1] * x.element_size())
        if bias is not None:
            out = out + bias
        ctx.spec, ctx.bias_dtype = spec, None if bias is None else bias.dtype
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, dy):
        spec = ctx.spec
        x, w = ctx.saved_tensors
        parts = [None] * spec.tp_size

        def on_chunk(j, chunk):
            parts[j] = chunk @ w.t()

        dy_full, ring = _gather_with(spec, "matmul_reduce_scatter.bwd", dy.contiguous(), True,
                                     on_chunk)
        dx = torch.cat(parts, 1) if ring else dy_full @ w.t()
        dw = x.reshape(-1, x.shape[-1]).t() @ dy_full.reshape(-1, dy_full.shape[-1])
        db = None
        if ctx.bias_dtype is not None:
            db = dy_full.sum((0, 1)).to(ctx.bias_dtype)
        return None, dx, dw, db


def matmul_reduce_scatter(spec: OverlapSpec, x: torch.Tensor, w: torch.Tensor, bias=None):
    """``x`` ``(B, T, K/n)`` this rank's column shard, ``w`` ``(K/n, D)``
    its row shard -> ``(B, T/n, D)`` summed over the group (ring or bulk),
    plus the replicated ``bias`` once, after the sum."""
    return _MatmulReduceScatter.apply(spec, x, w, bias)


# -- fused-QKV weight views ---------------------------------------------------------------


class _QKVViews(torch.autograd.Function):
    """The contiguous column shard of a fused ``[q | k | v]`` weight (bias
    riding as a last row) -> this rank's head-aligned q, k, v columns: one
    all-gather forward; the backward places the three gradients in the
    full width and returns each rank its contiguous columns by one
    all-to-all (each column has one contributor: placement, not
    arithmetic)."""

    @staticmethod
    def forward(ctx, spec, fused, hw, kvw):
        n, d = spec.tp_size, spec.index
        full = _all_gather(spec, fused, 1)
        _note("qkv_fused_views", False)
        hq, hkv = hw // n, kvw // n
        ctx.spec, ctx.hw, ctx.kvw, ctx.rows = spec, hw, kvw, fused.shape[0]
        return (full[:, d * hq:(d + 1) * hq].contiguous(),
                full[:, hw + d * hkv:hw + (d + 1) * hkv].contiguous(),
                full[:, hw + kvw + d * hkv:hw + kvw + (d + 1) * hkv].contiguous())

    @staticmethod
    def backward(ctx, dq, dk, dv):
        spec, hw, kvw = ctx.spec, ctx.hw, ctx.kvw
        n, d = spec.tp_size, spec.index
        hq, hkv = hw // n, kvw // n
        like = next(g for g in (dq, dk, dv) if g is not None)
        full = torch.zeros((ctx.rows, hw + 2 * kvw), dtype=like.dtype, device=like.device)
        for g, lo, width in ((dq, d * hq, hq), (dk, hw + d * hkv, hkv),
                             (dv, hw + kvw + d * hkv, hkv)):
            if g is not None:
                full[:, lo:lo + width] = g
        chunks = torch.stack(full.chunk(n, 1))                  # (n, rows, W/n)
        payload = _bits(chunks)
        out = torch.empty_like(payload)
        nbytes = _sent(chunks, (n - 1) / n)
        _wait(collective("all_to_all", lambda: _dist().all_to_all_single(
            out, payload, group=spec.group, async_op=True), (payload,), (out,), nbytes, n,
            spec.axis))
        pieces = _unbits(out, chunks.dtype)
        acc = pieces[0]
        for piece in pieces[1:]:
            acc = acc + piece
        return None, acc, None, None


def qkv_fused_views(spec: OverlapSpec, w: torch.Tensor, b, hw: int, kvw: int):
    """Head-aligned views of a fused ``[q | k | v]`` projection: ``w``
    ``(D, (hw + 2 kvw)/n)`` and ``b`` (or None) this rank's contiguous
    column shards -> ``(wq, wk, wv, bq, bk, bv)``, this rank's ``hw/n``
    query and ``kvw/n`` key and value columns (biases None without ``b``)."""
    fused = w if b is None else torch.cat([w, b[None, :]], 0)
    wq, wk, wv = _QKVViews.apply(spec, fused, hw, kvw)
    if b is None:
        return wq, wk, wv, None, None, None
    return wq[:-1], wk[:-1], wv[:-1], wq[-1], wk[-1], wv[-1]


# -- embeddings ------------------------------------------------------------------------------


def _vocab_rows(spec: OverlapSpec, table: torch.Tensor, tokens: torch.Tensor):
    """This rank's rows of its vocab shard for ``tokens`` (zero where the
    token lies in another shard), and the local ids and their mask."""
    vl = table.shape[0]
    ids = tokens.long() - spec.index * vl
    valid = (ids >= 0) & (ids < vl)
    rows = table[ids.clamp(0, vl - 1)]
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device)), ids, valid


def _scatter_rows(table_like: torch.Tensor, ids, valid, dy: torch.Tensor) -> torch.Tensor:
    """The vocab shard's gradient: ``dy``'s rows added at their local ids.
    A token repeats, so its rows meet: on the card they are summed by an
    accumulating ``index_put_``, which sorts the ids and adds each row's
    terms in that order (a CUDA ``index_add_`` adds them in whatever order
    its threads arrive); the CPU's ``index_add_`` walks them in order."""
    vl, width = table_like.shape
    upd = torch.where(valid[..., None], dy.to(table_like.dtype),
                      torch.zeros((), dtype=table_like.dtype, device=dy.device))
    out = torch.zeros((vl, width), dtype=table_like.dtype, device=dy.device)
    rows = ids.clamp(0, vl - 1).reshape(-1)
    if dy.device.type == "cpu":
        return out.index_add_(0, rows, upd.reshape(-1, width))
    return out.index_put_((rows,), upd.reshape(-1, width), accumulate=True)


class _EmbedSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, table, tokens, compute_dtype):
        rows, ids, valid = _vocab_rows(spec, table, tokens)
        if compute_dtype is not None:
            rows = rows.to(compute_dtype)
        _note("embed_lookup_sharded", False)
        out = _bulk_reduce_scatter(spec, rows, False)
        ctx.spec = spec
        ctx.save_for_backward(table, ids, valid)
        return out

    @staticmethod
    def backward(ctx, dy):
        table, ids, valid = ctx.saved_tensors
        dfull, _ = _gather_with(ctx.spec, "embed_lookup_sharded.bwd", dy.contiguous(), True)
        return None, _scatter_rows(table, ids, valid, dfull), None, None


def embed_lookup_sharded(spec: OverlapSpec, table: torch.Tensor, tokens: torch.Tensor,
                         compute_dtype=None) -> torch.Tensor:
    """Vocab-parallel lookup onto the sequence shards: ``table`` ``(V/n,
    D)`` this rank's vocab shard, ``tokens`` ``(B, T)`` the whole sequence
    -> ``(B, T/n, D)``. Each rank's masked rows reduce-scatter (one
    contributor per row: exact) in ``compute_dtype`` when given; the
    backward gathers ``dy`` at the wire dtype and scatters its rows."""
    return _EmbedSharded.apply(spec, table, tokens, compute_dtype)


class _VocabLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, table, tokens):
        rows, ids, valid = _vocab_rows(spec, table, tokens)
        rows = rows.contiguous()
        _note("vocab_lookup", False)
        _sent(rows)
        n = spec.tp_size
        _wait(collective("all_reduce", lambda: _dist().all_reduce(
            rows, group=spec.group, async_op=True), (rows,), (rows,),
            2 * (n - 1) / n * rows.numel() * rows.element_size(), n, spec.axis))
        ctx.save_for_backward(table, ids, valid)
        return rows

    @staticmethod
    def backward(ctx, dy):
        table, ids, valid = ctx.saved_tensors
        return None, _scatter_rows(table, ids, valid, dy), None


def vocab_lookup(spec: OverlapSpec, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """A vocab-sharded table's lookup, whole on every rank (``(B, T, D)``):
    the masked rows summed over the group (exact). For a replicated
    computation downstream (GPT-2's learned positions before
    :func:`seq_shard`): the backward scatters the rank's rows of the
    complete ``dy``, with no collective."""
    return _VocabLookup.apply(spec, table, tokens)


# -- relayouts ---------------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, t, dim, name):
        ctx.spec, ctx.dim = spec, dim
        _note(name, False)
        return _all_gather(spec, t, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return None, _own(ctx.spec, dy, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, t, dim):
        ctx.spec, ctx.dim, ctx.dtype = spec, dim, t.dtype
        return _own(spec, t, dim)

    @staticmethod
    def backward(ctx, dy):
        spec = ctx.spec
        _note("seq_shard.bwd", False)
        full = _all_gather(spec, _narrow(spec, dy), ctx.dim).to(ctx.dtype)
        return None, full, None


def seq_all_gather(spec: OverlapSpec, x: torch.Tensor) -> torch.Tensor:
    """``(B, T/n, ...)`` sequence shards -> ``(B, T, ...)`` on every rank
    (a relayout: the backward keeps this rank's rows of the complete
    gradient, with no collective)."""
    return _Gather.apply(spec, x, 1, "seq_all_gather")


def seq_shard(spec: OverlapSpec, x: torch.Tensor) -> torch.Tensor:
    """``(B, T, ...)``, the same on every rank -> this rank's ``(B, T/n,
    ...)`` rows (no communication); the backward gathers the gradient at
    the wire dtype."""
    return _Slice.apply(spec, x, 1)


def gather_replicated(spec: OverlapSpec, t: torch.Tensor, dim: int) -> torch.Tensor:
    """A shard on ``dim`` -> the whole tensor on every rank, for a
    computation repeated on every rank of the group (a vocab-sharded head
    under the fused loss, the vocab-sharded logits for the loss): the
    backward keeps this rank's part of the complete gradient."""
    return _Gather.apply(spec, t, dim, "gather_replicated")


def gather_whole(spec: OverlapSpec, t: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """``t`` whole on every rank of the group: :func:`gather_replicated` on
    ``dim`` where it is this rank's shard (its ``dim`` is not ``whole``
    long), else ``t`` itself (a width that does not divide the group is
    held whole)."""
    if t.shape[dim] == whole:
        return t
    return gather_replicated(spec, t, dim)


def seq_gather_sum(seq, x: torch.Tensor) -> torch.Tensor:
    """``(B, T/n, ...)`` blocks of the sequence group ``seq`` (a
    ``ring_attention.SeqSpec``) -> ``(B, T, ...)`` on every rank, for a
    computation over the whole sequence whose gradients stay partial (each
    rank back-propagates only its own rows' output): the backward
    reduce-scatters the partial cotangents onto the blocks, at their own
    dtype."""
    spec = OverlapSpec(group=seq.group, ranks=tuple(seq.ranks), index=seq.index, axis="seq",
                       wire=None)
    return _GatherSum.apply(spec, x)


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, t):
        ctx.spec = spec
        _note("seq_gather_sum", False)
        return _all_gather(spec, t, 1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        _note("seq_gather_sum.bwd", False)
        return None, _bulk_reduce_scatter(ctx.spec, dy.contiguous(), wire=False)


# -- expert parallelism ---------------------------------------------------------------------


@dataclass(frozen=True)
class ExpertSpec:
    """One rank's expert row: ``group`` its process group, ``ranks`` its
    global ranks in expert-coordinate order, ``index`` this rank's
    coordinate (it holds experts ``[index·E/n, (index+1)·E/n)`` of every MoE
    layer)."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


#: The active expert spec, process-wide (as the TP context).
_EP: list = [None]


@contextlib.contextmanager
def expert_parallel(runtime, axis: str = "expert"):
    """Activate expert parallelism over ``runtime``'s ``axis`` group for the
    block (None when the mesh has no such axis larger than 1)."""
    if runtime.axis_size(axis) <= 1:
        yield None
        return
    spec = ExpertSpec(group=runtime.axis_group(axis), ranks=tuple(runtime.axis_ranks(axis)),
                      index=runtime.axis_index(axis))
    previous, _EP[0] = _EP[0], spec
    try:
        yield spec
    finally:
        _EP[0] = previous


def current_ep() -> Optional[ExpertSpec]:
    """The active :class:`ExpertSpec`, or None."""
    return _EP[0]


def _group_sum(spec, t: torch.Tensor, name: str) -> torch.Tensor:
    """The sum of ``t`` over ``spec.group`` (a fresh tensor; the ring's
    ``2(n-1)/n`` payloads a rank sends counted as its wire bytes)."""
    _note(name, False)
    out = t.contiguous().clone()
    n = spec.size
    nbytes = _sent(out, 2 * (n - 1) / n)
    _wait(collective("all_reduce", lambda: _dist().all_reduce(
        out, group=spec.group, async_op=True), (out,), (out,), nbytes, n, name))
    return out


class _EpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, t):
        ctx.spec = spec
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dy):
        return None, _group_sum(ctx.spec, dy, "ep_enter.bwd")


class _SumForward(torch.autograd.Function):
    """``scale`` times the sum over ``spec.group`` forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, spec, t, name, scale):
        out = _group_sum(spec, t, name)
        return out if scale == 1 else out * scale

    @staticmethod
    def backward(ctx, dy):
        return None, dy, None, None


def ep_enter(spec: ExpertSpec, t: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank of the expert row) as it enters this
    rank's experts: the identity, whose backward sums the experts' partial
    cotangents over the group, so every rank's gradient is complete."""
    return _EpEnter.apply(spec, t)


def ep_combine(spec: ExpertSpec, t: torch.Tensor) -> torch.Tensor:
    """This rank's experts' partial output -> the sum over the expert
    group (every expert's share), the same on every rank; the backward
    hands each rank the complete cotangent as it is."""
    return _SumForward.apply(spec, t, "ep_combine", 1)


# -- the global batch's statistics ---------------------------------------------------------


@dataclass(frozen=True)
class DataSpec:
    """The data group of one rank (``group`` None: the default group) and
    its ``size``."""

    group: Any
    size: int


#: The active data spec, process-wide.
_DATA: list = [None]


@contextlib.contextmanager
def data_mean(runtime):
    """Activate :func:`batch_mean` over ``runtime``'s data group for the
    block (None on one data rank)."""
    if runtime.data_axis_size <= 1:
        yield None
        return
    previous, _DATA[0] = _DATA[0], DataSpec(group=runtime.axis_group("data"),
                                            size=runtime.data_axis_size)
    try:
        yield _DATA[0]
    finally:
        _DATA[0] = previous


def current_data() -> Optional[DataSpec]:
    """The active :class:`DataSpec`, or None."""
    return _DATA[0]


def batch_mean(spec: DataSpec, t: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of ``t`` (a statistic of this rank's
    stripe -> the global batch's, for equal stripes), the same on every
    rank. The backward hands the cotangent back as it is: every rank's loss
    holds the same global term, and ``GradSync``'s mean over the data ranks
    then gives its gradient."""
    return _SumForward.apply(spec, t, "batch_mean", 1.0 / spec.size)
