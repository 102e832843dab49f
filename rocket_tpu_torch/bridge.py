"""Parameter bridge: a JAX param tree (as numpy) -> the port's params, and
a JAX model's ``variables`` (params and state) -> the port's.

The port's param dicts use the JAX package's names, so the copy is
rename-free: the transformer's, the ResNets', ViT's bare ``cls`` and
``pos`` arrays beside its ``blocks``, and the ``Sequential`` trunks of
LeNet and the MLP under ``"0"``, ``"1"``, ... (their activations, pools
and ``Flatten`` as empty dicts, which the port's trunks also draw). A
scanned JAX tree (``blocks_stacked``, every leaf with a
leading layer dim) is unstacked into the per-layer ``blocks`` subtree the
port uses. Dtypes are kept, bfloat16 included (numpy holds it as the
``ml_dtypes`` type, which torch cannot read directly, so its bits are
reinterpreted). The model state (the ResNets' BatchNorm running
statistics) carries over beside the params, as laid out, with conv
kernels kept HWIO. This module takes numpy only and never imports JAX.

A train state crosses the packages through :func:`train_state_to_jax`
and :func:`train_state_from_jax`, which map the port's layout (torch's
per-param optimizer state under ``optimizer/<key>/<path>``, the step a
host int, the key a counter-hash int) to the reference's (optax's
``opt_state`` under its chain indices and field names, ``step`` an int32
scalar, ``base_key`` uint32[2] key data) and back. They move leaves and
do not compute on them: numpy arrays, torch tensors and a sharded
layout's ``checkpoint_io.ShardedLeaf`` shards (params and optimizer state
alike; a param without state gets zero shards) pass through.
:class:`OptChain` says where optax keeps each piece of one optimizer's
state; :func:`opt_chain` names it for a ``torch.optim`` optimizer.

Across ranks (data or tensor parallel): :func:`local_params` cuts a whole
param tree into the slices one rank holds under a ``param_sharding`` rule
on the Runtime's mesh, and :func:`gather_params` gathers a prepared
model's slices back whole on every rank, for comparison. A TP run's train
state crosses as any other: its shards are ``ShardedLeaf`` chunks. Under
``pipeline_rules`` a stage holds only its own layers' ``blocks/<i>``
(a JAX ``blocks_stacked`` tree is unstacked first, so each stage gets the
right layers), and a pipe run's train state names the other stages'
layers as ``checkpoint_io.OwnedLeaf`` placeholders, each saved by its
stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rocket_tpu_torch.nn import keys

__all__ = ["params_from_jax", "tensor_from_numpy", "variables_from_jax", "OptChain", "opt_chain",
           "train_state_to_jax", "train_state_from_jax", "local_params", "gather_params"]


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """One numpy array (bfloat16 included) -> a torch tensor of the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Convert a JAX param tree of numpy arrays (e.g. ``jax.tree.map(
    np.asarray, variables["params"])`` of a ``TransformerLM``, ``ViT``,
    ``LeNet`` or ``MLP``) to port params on ``device``."""
    tree = dict(tree)
    stacked = tree.pop("blocks_stacked", None)
    if stacked is not None:
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        tree["blocks"] = {str(i): _unstack(stacked, i) for i in range(np.shape(leaf)[0])}
    return _convert(tree, device)


def variables_from_jax(variables: dict, device="cpu") -> dict:
    """Convert a JAX model's ``{"params": ..., "state": ...}`` of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, model.init(key))``) to
    ``{"params", "state"}`` of port tensors on ``device``; a missing state
    is empty."""
    return {"params": params_from_jax(variables["params"], device),
            "state": _convert(variables.get("state", {}), device)}


# -- train state -----------------------------------------------------------------

#: Per optimizer kind (``rocket_tpu.optim``'s factories): the chain's
#: moment fields at their index, as (index, optax field, torch key), the
#: indices that keep a ``count``, and the index of ``scale_by_schedule``.
_CHAINS = {
    # adamw: (scale_by_adam, add_decayed_weights, scale_by_learning_rate)
    "adamw": ((("0", "mu", "exp_avg"), ("0", "nu", "exp_avg_sq")), ("0",), "2"),
    # adam: (scale_by_adam, scale_by_learning_rate)
    "adam": ((("0", "mu", "exp_avg"), ("0", "nu", "exp_avg_sq")), ("0",), "1"),
    # lion: (scale_by_lion, add_decayed_weights, scale_by_learning_rate)
    "lion": ((("0", "mu", "exp_avg"),), ("0",), "2"),
    # sgd(momentum=b): (trace, scale_by_learning_rate)
    "momentum": ((("0", "trace", "momentum_buffer"),), (), "1"),
    # sgd(): (identity, scale_by_learning_rate)
    "sgd": ((), (), "1"),
    # add_decayed_weights, then sgd(): (decay, (identity, scale_by_learning_rate))
    "sgd_decay": ((), (), "1/1"),
}


@dataclasses.dataclass(frozen=True)
class OptChain:
    """Where optax keeps one optimizer's state, as the reference's
    ``Optimizer`` capsule builds it: ``kind`` a key of the factories
    (``adamw``, ``adam``, ``lion``, ``momentum``, ``sgd``, ``sgd_decay``
    for ``sgd(weight_decay>0)``); ``schedule`` when a Scheduler capsule
    gives the lr (``scale_by_schedule`` keeps a count); ``clip`` when the
    capsule's ``clip_norm`` chains ``clip_by_global_norm`` in front,
    which moves the rest under index 1."""

    kind: str
    schedule: bool = False
    clip: bool = False

    def __post_init__(self):
        if self.kind not in _CHAINS:
            raise ValueError(f"OptChain: unknown kind {self.kind!r} (one of {sorted(_CHAINS)})")

    def _path(self, rel: str) -> tuple:
        return (("1",) if self.clip else ()) + tuple(rel.split("/"))

    @property
    def moments(self) -> list:
        """(opt_state path of the moment tree, torch key) per moment."""
        return [(self._path(index) + (field,), key) for index, field, key in _CHAINS[self.kind][0]]

    @property
    def counts(self) -> list:
        """The opt_state paths of every ``count`` leaf (each the number of
        applied updates)."""
        moments, counted, sched = _CHAINS[self.kind]
        rel = list(counted) + ([sched] if self.schedule else [])
        return [self._path(index) + ("count",) for index in rel]


def opt_chain(optimizer, schedule: bool = False, clip: bool = False):
    """The :class:`OptChain` of a ``torch.optim`` optimizer built by the
    port's factories, or None for one the reference has no chain for."""
    from rocket_tpu_torch.optim import Lion

    if isinstance(optimizer, torch.optim.AdamW):
        kind = "adamw"
    elif isinstance(optimizer, torch.optim.Adam):
        kind = "adam"
    elif isinstance(optimizer, Lion):
        kind = "lion"
    elif isinstance(optimizer, torch.optim.SGD):
        decay = any(g.get("weight_decay") for g in optimizer.param_groups)
        if optimizer.defaults.get("momentum"):
            if decay:
                return None  # the factories make no decayed momentum SGD
            kind = "momentum"
        else:
            kind = "sgd_decay" if decay else "sgd"
    else:
        return None
    return OptChain(kind, schedule=schedule, clip=clip)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _get(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise KeyError(f"train state has no leaf {'/'.join(path)!r}")
        tree = tree[key]
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _zeros_like(leaf):
    if hasattr(leaf, "zeros_like"):  # checkpoint_io.ShardedLeaf
        return leaf.zeros_like()
    return torch.zeros_like(leaf) if isinstance(leaf, torch.Tensor) else np.zeros_like(leaf)


def _int32(value):
    if isinstance(value, torch.Tensor):
        return value.detach().reshape(()).to(torch.int32)
    return np.asarray(value, dtype=np.int32).reshape(())


def _key_data(value) -> np.ndarray:
    if isinstance(value, (int, np.integer)):
        return keys.to_data(int(value))
    return np.asarray(value, dtype=np.uint32).reshape(2)


def train_state_to_jax(view: dict, chain, count=0) -> dict:
    """The port's checkpoint view -> the reference's train-state tree.

    ``view``: ``params``, ``step`` (int), ``base_key`` (the key int, or
    its two words), and as present ``model_state``, ``ema_params``,
    ``health``, ``grad_accum``/``loss_acc`` (all kept under their names)
    and ``optimizer`` (``{torch key: tree laid out as the params}``).
    ``chain`` (:class:`OptChain`, or None: an optimizer the reference has
    no chain for keeps the torch layout) places the moments under
    ``opt_state``, a param without one as zeros (torch makes its state at
    the first update, optax at init), and ``count`` (int or 0-dim tensor:
    the applied updates) in every ``count`` leaf as int32."""
    out = {k: v for k, v in view.items() if k not in ("step", "base_key", "optimizer")}
    out["step"] = _int32(view["step"])
    out["base_key"] = _key_data(view["base_key"])
    opt = view.get("optimizer")
    if opt is None:
        return out
    if chain is None:
        out["optimizer"] = opt
        return out
    opt_state: dict = {}
    for path, key in chain.moments:
        source = opt.get(key, {})
        tree: dict = {}
        for ppath, leaf in _paths(view["params"]):
            try:
                value = _get(source, ppath)
            except KeyError:
                value = None
            _put(tree, ppath, _zeros_like(leaf) if value is None else value)
        _put(opt_state, path, tree)
    for path in chain.counts:
        _put(opt_state, path, _int32(count))
    out["opt_state"] = opt_state
    return out


def train_state_from_jax(tree: dict, chain) -> dict:
    """The reference's train-state tree (numpy leaves, as
    ``checkpoint_io`` reads it) -> the port's checkpoint view, the inverse
    of :func:`train_state_to_jax`: ``step`` a host int, ``base_key`` the
    two uint32 words, the moments under their torch keys and, where the
    chain keeps a count, ``optimizer/step/<path>`` per param as f32 (torch
    Adam's per-param count). The chain's count leaves must agree. A view
    already in the port's old layout (``optimizer/...``, an int key)
    passes through."""
    view = {k: v for k, v in tree.items() if k not in ("step", "base_key", "opt_state")}
    view["step"] = int(np.asarray(tree["step"]))
    key = tree["base_key"]
    view["base_key"] = (int(key) if isinstance(key, (int, np.integer))
                        else np.asarray(key, dtype=np.uint32).reshape(2))
    if not view.get("model_state"):
        view.pop("model_state", None)
    opt_state = tree.get("opt_state")
    if opt_state is None:
        return view
    if chain is None:
        raise ValueError("train_state_from_jax: the checkpoint keeps optax's opt_state, but "
                         "this optimizer has no optax chain to read it into")
    opt = {key: _get(opt_state, path) for path, key in chain.moments}
    counts = {"/".join(path): int(np.asarray(_get(opt_state, path))) for path in chain.counts}
    if len(set(counts.values())) > 1:
        raise ValueError(f"train_state_from_jax: the optimizer's counts disagree: {counts}")
    if counts:
        count = next(iter(counts.values()))
        steps: dict = {}
        for ppath, _ in _paths(view["params"]):
            _put(steps, ppath, np.asarray(count, dtype=np.float32))
        opt["step"] = steps
    view["optimizer"] = opt
    return view


def local_params(params: dict, rule, runtime) -> dict:
    """The slices of the whole ``params`` (torch tensors, or numpy from
    :func:`params_from_jax`'s input) that this rank holds under ``rule``
    on ``runtime``'s mesh: a leaf sharded over an axis is cut into that
    axis's size on its dim, and the rank keeps its coordinate's chunk (an
    expert leaf under ``moe_rules`` on E, its dim 0 once unstacked); a
    layer placed on a pipeline stage is kept by that stage (cut on its
    model dim too under ``pipeline_over``) and left out elsewhere. A
    ``blocks_stacked`` subtree is unstacked into ``blocks/<i>`` first
    (:func:`params_from_jax`'s layout)."""
    from rocket_tpu_torch.parallel.grad_sync import shard_layout

    if "blocks_stacked" in params:
        params = dict(params)
        stacked = params.pop("blocks_stacked")
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        params["blocks"] = {str(i): _unstack(stacked, i) for i in range(np.shape(leaf)[0])}
    items = list(_paths(params))
    layouts = shard_layout([(path, leaf) for path, leaf in items], rule, runtime.mesh,
                           runtime.DATA_AXES)
    out: dict = {}
    for (path, leaf), lay in zip(items, layouts):
        if lay is not None and lay.stage is not None \
                and lay.stage != runtime.axis_index(lay.pipe_axis):
            continue  # another stage's layer
        t = leaf if isinstance(leaf, torch.Tensor) else tensor_from_numpy(np.asarray(leaf))
        if lay is not None and lay.dim is not None:
            t = t.chunk(int(runtime.mesh[lay.axis]), lay.dim)[runtime.axis_index(lay.axis)].clone()
        _put(out, path, t)
    return out


def gather_params(prepared, runtime) -> dict:
    """``{path: tensor}`` of a prepared model's whole params, copies on
    their device: each sharded leaf all-gathered over its axis's group and
    each other stage's layers broadcast (whole: a stage's model shards
    are gathered first) from their stage over the pipe group, so every
    rank calls it at the same point."""
    import torch.distributed as dist

    out = {}
    for i, (path, t) in enumerate(_paths(prepared.state["params"])):
        t = t.detach()
        lay = prepared.layout(i) if prepared.shard_dims is not None else None
        if lay is not None:
            parts = [torch.empty_like(t) for _ in range(lay[1])]
            dist.all_gather(parts, t.contiguous(),
                            group=runtime.axis_group(prepared.shard_axes[i]))
            t = torch.cat(parts, lay[0])
        out["/".join(path)] = t.clone() if lay is None else t
    if prepared.remote:
        # Layer by layer: the stage holding a layer broadcasts it over the
        # pipe group, every other stage receives it.
        axis = prepared.pipe_axis
        ranks, group = runtime.axis_ranks(axis), runtime.axis_group(axis)
        for path, shape, dtype, layout in prepared.stage_leaves:
            name, stage = "/".join(path), layout.stage
            buf = (out[name].clone() if stage == prepared.axis_index[axis]
                   else torch.empty(shape, dtype=dtype, device=runtime.device))
            dist.broadcast(buf, src=ranks[stage], group=group)
            out[name] = buf
        out = {"/".join(path): out["/".join(path)] for path in prepared.full_paths}
    return out
