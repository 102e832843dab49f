"""Module capsule — wraps a model and runs its train and eval steps
(counterpart of ``rocket_tpu/core/module.py``).

* children are the post-forward pipeline — Loss / Optimizer / Scheduler —
  and in eval the forward *replaces the batch*;
* the model is prepared once per raw model object through the runtime's
  ``models`` registry, so a train and an eval Module wrapping one model
  share one set of params (and a caller may pre-register a prepared
  record, as the JAX package allows);
* train/eval follow ``attrs.mode`` set by the Looper.

The train step is one function: the step's key ``fold_in(base key,
step)`` (``nn/keys.py``), the ``batch_transform`` (on-device augmentation,
once per step on the raw batch, keyed ``fold_in(step key, 0xA9517)``), the
forward (optionally under a whole-forward ``torch.utils.checkpoint``), the
objective, the backward, then gradient accumulation — the update happens
on every ``accum``-th step with the mean of the window's gradients, at
``opt_step = step // accum`` — and the optimizer update at the schedule's
lr for ``opt_step``. Params are f32 masters; ``compute_dtype`` casts float
batch inputs, and the model casts its params at use.

Model state: a model with ``init_state`` (the ResNets' BatchNorm running
statistics) gets ``state["model_state"]``, which the train forward takes
and replaces by its (detached) new state after each step, the eval
forward reads, and the checkpoint carries under ``model_state/...`` as the
JAX Checkpointer does. Models without it (the transformer) run exactly as
before.

EMA params (``ema_decay``): the train Module keeps ``state["ema_params"]``,
a real copy of the params at setup, and moves it as ``e += (1 - d) (p -
e)`` after every optimizer update (once per accumulation window); the
checkpoint carries it under ``ema_params/...``; an eval Module with
``use_ema=True`` forwards with it.

Health sentinels (``Runtime(health=True)``, ``obs/health.py``): the train
state gains ``state["health"]`` (``init_state``, checkpointed under
``health/...``), the step computes ``step_flags`` on the raw loss and
gradients, folds the step into the sentinels with ``update_sentinels`` and
hands the word to the monitor (``observe``), which reads it ``fetch_lag``
steps later. Under ``warn`` the update is the plain one above. Under a
gating action (``skip_step``, ``dump_and_halt``) it goes through
``optim.gated_step`` (the optimizer's count on the card, the lr read from
it), and a step with a non-finite loss or gradient changes no param,
moment, optimizer count or EMA (the gate is arithmetic on a device
predicate, never a branch on it); under accumulation its gradients and loss
are dropped from the window, whose boundary update applies the finite
rest — the reference's ``lax.cond`` structure (``rocket_tpu/core/
module.py:672-790``).

Data parallelism (a Runtime over several processes, ``parallel/``):
each rank runs the step on its stripe of the global batch under
``keys.data_shard`` (its dropout draws its rows of the global masks) and
the gradients are reduced to the global mean before the update by
``parallel.grad_sync.GradSync``, every multi-rank step's one reduction:
bucketed and asynchronous, on the ``grad_wire_dtype`` wire where the
reference's ``_grad_sync_plan`` (``rocket_tpu/core/module.py:232-280``)
would take its bucketed path (``grad_sync="bucketed"``, or the rule set's
``fsdp_axis`` marker under ``"auto"``), else an f32 mean all-reduce.
``param_sharding`` (``parallel.sharding``) holds each matched leaf as this
rank's shard of its spec's dim: the optimizer, its moments, the EMA shadow
and the accumulator live on the shard. A data-axis shard is all-gathered
at step entry (and for the eval forward) and its gradient reduce-scatters
back onto the shard. Global norms (``clip_norm``, the health sentinels'
gradient, update and param norms) sum each shard over its axis's group
and count each replicated leaf once, so every rank takes the same skip
decision. A model with state (BatchNorm) runs its train-mode statistics
over the global batch (sync-BN, ``nn/layers.bn_act_train``), so the
running statistics are the same on every rank.

Ring attention (a ``seq`` mesh axis): each rank holds its slice of every
sequence (``Runtime.shard_batch``), the model's objective is its share of
the global mean, and ``GradSync`` sums every leaf and the loss over the
sequence group.

Pipeline parallelism (a ``pipe`` axis and ``pipeline_rules``): each stage
holds its own layers (the other stages' are named in its checkpoint
views, each saved by its stage), and the train step is the model's
``pipelined_value_and_grad`` (GPipe or 1F1B, reference ``core/module.py:
568-570``); the leaves every stage holds carry partial gradients, summed
over the pipe group with the loss.

Expert parallelism (an ``expert`` mesh axis and ``moe_rules``, whose
``expert_axis`` marker installs ``parallel.collectives.expert_parallel``
around the forward and its backward): a rank holds E/n experts of every
MoE layer (its params, gradients and moments), never gathered; every rank
of an expert row reads the same stripe, routes it alike and computes its
experts' share, and the MoE's collectives make every other gradient
complete and equal on each, so every leaf reduces over the data group
only, the loss too.

Tensor parallelism (a ``model`` mesh axis and a rule with the
``tp_axis`` marker, ``gpt2_tp_rules``): a model-axis shard is never
gathered; the forward and its backward run under the rule's
``parallel.collectives.tp_overlap`` context (reference ``core/module.py:
511-535``), whose layers read their shards and communicate themselves;
the model's ``tp_partial`` names the replicated leaves whose gradients are
partial sums over the sequence shards, which ``GradSync`` sums over the
model group. All ranks of one model group read the same stripe.

The replicated program over the model group (the reference's plain GSPMD
program): where the tensor-parallel path does not serve a step (a model
without one, such as ViT or ResNet under ``gpt2_tp_rules``; a pipelined
model, whose stage bodies run the model axis gathered, ``pipeline_over``;
a seq axis beside the model axis; or a batch the model's ``tp_serves``
refuses, a sequence that does not divide the group) the model shards are
gathered whole at step entry, no TP context is entered, every rank of the
group runs the whole model, and each keeps its chunk of the gradients
(the same on every rank of the group; a ``tp_partial`` leaf contributes
1/n of its complete gradient to the group's sum).

Two split axes at once (``{"model", "seq"}``, ``{"model", "expert"}``,
``{"seq", "expert"}``, ``{"model", "pipe"}``): each leaf's gradient is
summed over the plane of the data axis and the axes it is partial over
(``GradSync``'s planes), never twice over one group.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rocket_tpu_torch import bridge
from rocket_tpu_torch import optim as optim_lib
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.dispatcher import Dispatcher
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.runtime import explicit_transfer

__all__ = ["Module", "PreparedModule"]

logger = logging.getLogger(__name__)


def _paths(tree, prefix=()):
    """The key paths of a nested param dict, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def _nest(items) -> dict:
    """{path tuple: value} pairs -> a nested dict."""
    tree: dict = {}
    for path, value in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _paths_leaves(tree, prefix=()):
    """``(path tuple, leaf)`` of a nested param dict, in ``param_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree: dict, path):
    for key in path:
        tree = tree[key]
    return tree


def _host(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


class PreparedModule:
    """The shared prepared record of one raw model: its live state —
    ``params`` (nested dict of f32 tensors), ``model_state`` (for a model
    with ``init_state``), ``ema_params`` (under a train Module's
    ``ema_decay``), ``step`` (host int), ``base_key`` (the counter-hash
    key the step keys fold from; ``base_key_data``, the two words it was
    loaded from, when a checkpoint gave it) and, once
    a train Module set up, ``optimizer`` and the accumulation buffers.
    Mutable on purpose: train and eval capsules wrapping one model see the
    same state. A train Module also records how optax would lay out its
    optimizer (``opt_chain``, ``bridge.OptChain`` or None), its
    accumulation and whether its updates go through the health gate."""

    def __init__(self, model, state: dict) -> None:
        self.model = model
        self.state = state
        self.opt_chain = None
        self.accum = 1
        self.gated = False
        #: Under a ``param_sharding`` rule: the rule, and per param leaf
        #: the dim it is sharded on (None: replicated) and the mesh axis
        #: (``shard_axes``: a data axis or ``"model"``); this process holds
        #: shard ``axis_index[axis]`` of ``axis_size[axis]`` of each, and
        #: chunk ``j`` of a leaf sharded over an axis is saved by the rank
        #: ``owners[axis][j]`` (coordinate 0 on the other axes). ``world``
        #: and ``rank`` are the data axis's.
        self.sharded_by = None
        self.shard_dims = None
        self.shard_axes = None
        self.axis_size, self.axis_index, self.owners = {}, {}, {}
        self.world, self.rank = 1, 0
        #: Per param leaf its ``grad_sync.Layout`` (None: replicated).
        self.layouts: list = []
        #: Under a pipeline rule: the pipe axis, every layer leaf of the
        #: whole tree placed on a stage as ``(path, shape, dtype, Layout)``,
        #: and the whole tree's paths (this process holds its stage's);
        #: under ``pipeline_over`` (dp x tp x pp) per stage the ranks that
        #: save its model shards.
        self.pipe_axis = None
        self.stage_leaves: list = []
        self.full_paths: list = []
        self.stage_owners: dict = {}

    def sharded(self) -> bool:
        return self.shard_dims is not None and any(d is not None for d in self.shard_dims)

    def held_bytes(self) -> dict:
        """The bytes this rank holds: ``params`` and ``moments`` (the
        optimizer's state tensors, once a step made them): under expert
        parallelism E/n experts of every MoE layer."""
        params = sum(t.numel() * t.element_size()
                     for t in optim_lib.param_leaves(self.state["params"]))
        opt = self.state.get("optimizer")
        moments = 0 if opt is None else sum(
            v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0)
        return {"params": params, "moments": moments}

    def spread(self) -> bool:
        """Whether some leaf lives on only some ranks (a shard, or a layer
        on its pipeline stage): global norms then sum over the groups."""
        return self.shard_axes is not None and any(a is not None for a in self.shard_axes)

    @property
    def remote(self) -> list:
        """The stage leaves of the other stages (held elsewhere)."""
        if self.pipe_axis is None:
            return []
        mine = self.axis_index.get(self.pipe_axis, 0)
        return [leaf for leaf in self.stage_leaves if leaf[3].stage != mine]

    def _owner(self, stage: int) -> int:
        return self.owners[self.pipe_axis][stage]

    def _placeholders(self, like=None) -> list:
        """``(path, OwnedLeaf)`` of the other stages' layers, each saved by
        its stage; ``like`` (a local stage leaf's optimizer value) gives a
        0-dim value's shape and dtype instead of the param's."""
        from rocket_tpu_torch.runtime.checkpoint_io import OwnedLeaf, ShardedLeaf

        out = []
        for path, shape, dtype, lay in self.remote:
            if like is not None and like.dim() == 0:
                shape, dtype = (), like.dtype
            if lay.dim is not None and shape:
                # Another stage's model shards, each saved by its own rank.
                out.append((path, ShardedLeaf(torch.empty(0, dtype=dtype), shape, lay.dim, 0,
                                              self.axis_size[lay.axis],
                                              self.stage_owners[lay.stage])))
            else:
                out.append((path, OwnedLeaf(None, shape, dtype, self._owner(lay.stage))))
        return out

    def layout(self, i: int):
        """Leaf ``i``'s ``(dim, count, index, owners)``, or None (a stage's
        model shard is saved by its stage's model row)."""
        if self.shard_dims is None or self.shard_dims[i] is None:
            return None
        axis, stage = self.shard_axes[i], self.layouts[i].stage
        owners = self.owners[axis] if stage is None else self.stage_owners[stage]
        return (self.shard_dims[i], self.axis_size[axis], self.axis_index[axis], owners)

    def _layout_of(self) -> dict:
        leaves = optim_lib.param_leaves(self.state["params"])
        return {id(p): self.layout(i) for i, p in enumerate(leaves)}

    def _wrap(self, leaves, values) -> list:
        """``values`` (one per param of ``leaves``) as the checkpoint sees
        them: a sharded param's shard-shaped value as its
        ``checkpoint_io.ShardedLeaf``."""
        if not self.spread():
            return list(values)
        from rocket_tpu_torch.runtime.checkpoint_io import OwnedLeaf, ShardedLeaf

        layout_of = self._layout_of()
        all_leaves = optim_lib.param_leaves(self.state["params"])
        staged = {id(p) for p, a, d in zip(all_leaves, self.shard_axes, self.shard_dims)
                  if a is not None and a == self.pipe_axis and d is None}
        owner = (self._owner(self.axis_index[self.pipe_axis]) if self.pipe_axis is not None
                 else 0)
        out = []
        for p, v in zip(leaves, values):
            lay = layout_of.get(id(p))
            if lay is not None and isinstance(v, torch.Tensor) and v.shape == p.shape:
                dim, count, index, owners = lay
                shape = list(p.shape)
                shape[dim] *= count
                v = ShardedLeaf(v, tuple(shape), dim, index, count, owners)
            elif id(p) in staged and isinstance(v, torch.Tensor):
                v = OwnedLeaf(v, v.shape, v.dtype, owner)
            out.append(v)
        return out

    def _local(self, value, like: torch.Tensor, lay) -> torch.Tensor:
        """This rank's part of a saved whole value for a live leaf ``like``
        (of layout ``lay``, or None): the resharding restore."""
        t = _host(value)
        if lay is not None and t.dim() == like.dim() and t.shape != like.shape:
            t = t.chunk(lay[1], lay[0])[lay[2]]
        return t

    def _count(self):
        """The optimizer's count of applied updates: torch's per-param
        ``step`` where it keeps one (Adam(W) always, every rule under the
        gate; a tensor, not read here), else the update count the step
        implies."""
        opt = self.state["optimizer"]
        leaves = optim_lib.param_leaves(self.state["params"])
        first = opt.state.get(leaves[0], {}) if leaves else {}
        if "step" in first:
            return first["step"]
        return int(self.state["step"]) // self.accum

    def checkpoint_state(self) -> dict:
        """The train state as the tree ``checkpoint_io`` saves, in the
        reference's layout (``bridge.train_state_to_jax``): ``params``;
        ``model_state`` when the model has one; ``opt_state`` under optax's
        chain indices and field names (an optimizer the reference has no
        chain for keeps torch's per-param layout, ``optimizer/<key>/...``);
        ``step`` (int32) and ``base_key`` (uint32[2] key data);
        ``ema_params``, ``health``, and ``grad_accum`` (as the params) and
        ``loss_acc`` under gradient accumulation."""
        state = self.state
        params = state["params"]
        paths = list(_paths(params))
        leaves = optim_lib.param_leaves(params)
        key = state["base_key"]
        data = state.get("base_key_data")
        remote = self._placeholders()
        view = {"params": _nest(list(zip(paths, self._wrap(leaves, [t.detach() for t in leaves])))
                                + remote),
                "step": int(state["step"]),
                "base_key": data if data is not None and keys.from_data(data) == key else key}
        if state.get("model_state"):
            view["model_state"] = map_params(lambda t: t.detach(), state["model_state"])
        if "ema_params" in state:
            view["ema_params"] = _nest(list(zip(paths, self._wrap(
                leaves, optim_lib.param_leaves(state["ema_params"])))) + remote)
        if "health" in state:
            view["health"] = dict(state["health"])
        opt = state.get("optimizer")
        count = 0
        if opt is not None:
            per_key: dict = {}
            example: dict = {}
            for p, path in zip(leaves, paths):
                for k, value in opt.state.get(p, {}).items():
                    if value is not None and not (k == "step" and self.opt_chain is not None):
                        example.setdefault(k, value)
                        per_key.setdefault(k, []).append((path, self._wrap([p], [value])[0]
                                                          if self.spread() else value))
            for k, value in example.items():
                per_key[k] += self._placeholders(value if isinstance(value, torch.Tensor)
                                                 else None)
            view["optimizer"] = {k: _nest(items) for k, items in per_key.items()}
            count = self._count()
        if "grad_accum" in state:
            view["grad_accum"] = _nest(list(zip(paths, self._wrap(leaves, state["grad_accum"])))
                                       + remote)
            view["loss_acc"] = state["loss_acc"]
        return bridge.train_state_to_jax(view, self.opt_chain, count)

    def load_checkpoint_state(self, view: dict) -> None:
        """The inverse of :meth:`checkpoint_state` (tensors or numpy
        leaves), from the reference's layout or the port's old one
        (``optimizer/<key>/<path>`` and an int ``base_key``, written before
        the layouts were unified): params are copied into the live tensors
        in place, so the optimizer keeps its references; the optimizer
        state goes through ``torch.optim``'s own ``load_state_dict``, the
        count into every param's ``step`` for Adam(W) and, under the gate,
        for every rule. A count that differs from the one the step implies
        (a run whose gate held updates, resumed off the gate) is logged:
        off the gate the lr follows the step."""
        state = self.state
        opt = state.get("optimizer")
        view = bridge.train_state_from_jax(
            {k: v for k, v in view.items() if opt is not None or k != "opt_state"},
            self.opt_chain)
        params = state["params"]
        paths = list(_paths(params))
        leaves = optim_lib.param_leaves(params)
        dims = [self.layout(i) for i in range(len(leaves))]
        dim_of = {id(p): d for p, d in zip(leaves, dims)}
        with torch.no_grad():
            for p, path, dim in zip(leaves, paths, dims):
                p.copy_(self._local(_at(view["params"], path), p, dim))
            if state.get("model_state") and "model_state" in view:
                mstate = state["model_state"]
                for t, path in zip(optim_lib.param_leaves(mstate), _paths(mstate)):
                    t.copy_(_host(_at(view["model_state"], path)))
            if "ema_params" in state:
                # A pre-EMA checkpoint arrives with the shadow seeded from
                # its params (checkpoint_io.seed_optional).
                for e, path, dim in zip(optim_lib.param_leaves(state["ema_params"]), paths, dims):
                    e.copy_(self._local(_at(view["ema_params"], path), e, dim))
            if "health" in state and view.get("health"):
                # A pre-health checkpoint keeps the fresh sentinels.
                for k, t in state["health"].items():
                    if k in view["health"]:
                        t.copy_(_host(view["health"][k]).reshape(t.shape))
        state["step"] = int(view["step"])
        key = view["base_key"]
        if isinstance(key, (int, np.integer)):
            state["base_key"], state["base_key_data"] = int(key), None
        else:
            state["base_key"], state["base_key_data"] = keys.from_data(key), key
        if opt is not None and view.get("optimizer"):
            saved_opt = dict(view["optimizer"])
            adam = isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
            if "step" in saved_opt and self.opt_chain is not None:
                count = int(np.asarray(_host(_at(saved_opt["step"], paths[0]))))
                implied = state["step"] // self.accum
                if count != implied and not self.gated:
                    logger.warning("checkpoint: the optimizer's count %d is not the %d updates "
                                   "its step %d implies; off the gate the lr follows the step",
                                   count, implied, state["step"])
                if not (adam or self.gated):
                    del saved_opt["step"]
            elif self.gated and not adam and paths:
                # A chain without a count (momentum at a constant lr): the
                # gate's count starts from the updates the step implies.
                saved_opt["step"] = _nest((path, torch.tensor(
                    float(state["step"] // self.accum))) for path in paths)
            path_of = {id(p): path for p, path in zip(leaves, paths)}
            order = [p for group in opt.param_groups for p in group["params"]]
            saved = opt.state_dict()
            saved["state"] = {
                i: {k: self._local(_at(tree, path_of[id(p)]), p, dim_of.get(id(p)))
                    for k, tree in saved_opt.items()}
                for i, p in enumerate(order)
            }
            opt.load_state_dict(saved)
        if "grad_accum" in state and "grad_accum" in view:
            for buf, path, dim in zip(state["grad_accum"], paths, dims):
                buf.copy_(self._local(_at(view["grad_accum"], path), buf, dim))
            state["loss_acc"] = _host(view["loss_acc"]).to(state["loss_acc"].device)


class Module(Dispatcher):
    """Capsule wrapping a model with ``init(generator, device) -> params``
    and ``apply(params, batch, *, mode, rng) -> batch`` — or, for a model
    with ``init_state(device) -> state``, ``apply(params, batch, *, state,
    mode, rng) -> (batch, new_state)``.

    ``compute_dtype``: float batch inputs are cast to it before the
    forward. ``remat``: run the train forward under
    ``torch.utils.checkpoint(use_reentrant=False)`` — activations are
    recomputed in the backward (the dropout keys are counter hashes, so
    the recompute draws the same masks); ignored, with the reference's log
    line, for a model whose config sets ``scan_layers`` and ``scan_remat``,
    whose blocks checkpoint themselves. ``ema_decay`` (in (0, 1), a train
    Module with an Optimizer child): keep an exponential moving average of
    the params, ``state["ema_params"]``, updated after each optimizer
    update and checkpointed with the model. ``use_ema``: this (eval)
    Module forwards with that shadow instead of the params; it raises
    when no train Module sharing the model set ``ema_decay``.
    ``param_sharding``: a rule set ``(path, leaf) -> spec`` of
    ``parallel.sharding`` (``fsdp_rules()`` over the data axis,
    ``gpt2_tp_rules()`` over the model axis): each matched leaf is held as
    this rank's shard (module docstring).
    ``return_outputs``: ``"eval"``
    (default) replaces ``attrs.batch`` with the forward's output in eval
    only; ``"always"`` in train too. ``batch_transform``: ``fn(batch,
    key) -> batch`` run on the raw train batch before the forward
    (``data/augment.image_augment``); eval is never transformed.
    """

    def __init__(self, model, capsules=(), compute_dtype=None, remat: bool = False,
                 param_sharding=None, return_outputs: str = "eval",
                 ema_decay: Optional[float] = None, use_ema: bool = False,
                 batch_transform=None, statefull: bool = False, priority: int = 1000,
                 runtime=None) -> None:
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"Module: ema_decay must be in (0, 1), got {ema_decay}")
        if return_outputs not in ("eval", "always", "never"):
            raise ValueError(f"Module: unknown return_outputs {return_outputs!r}")
        super().__init__(capsules, statefull=statefull, priority=priority, runtime=runtime)
        self._model = model
        self._compute_dtype = compute_dtype
        self._remat = remat
        self._param_sharding = param_sharding
        self._ema_decay = ema_decay
        self._use_ema = use_ema
        self._batch_transform = batch_transform
        self._return_outputs = return_outputs
        self._prepared: Optional[PreparedModule] = None
        self._objective = None
        self._health = None
        #: Under the health gate: the lr (a 0-dim tensor on the card) of
        #: the last update step, read from the optimizer's count.
        self.last_lr = None
        #: Over several ranks: the bucketed reduction
        #: (``parallel.grad_sync.GradSync``) when the step takes it.
        self.grad_sync = None
        #: A pipelined model's train step (``pipelined_value_and_grad``).
        self._pipelined = None
        self._split_masks: dict = {}

    @property
    def prepared(self) -> Optional[PreparedModule]:
        return self._prepared

    @property
    def state(self) -> Optional[dict]:
        return None if self._prepared is None else self._prepared.state

    def _find_contrib(self):
        from rocket_tpu_torch.core.loss import Loss
        from rocket_tpu_torch.core.optimizer import Optimizer
        from rocket_tpu_torch.core.scheduler import Scheduler

        losses, optimizers, schedulers = self.find(Loss), self.find(Optimizer), self.find(Scheduler)
        if len(losses) > 1 or len(optimizers) > 1 or len(schedulers) > 1:
            raise RuntimeError("Module: at most one Loss, Optimizer and Scheduler per Module.")
        return (losses[0] if losses else None, optimizers[0] if optimizers else None,
                schedulers[0] if schedulers else None)

    # -- events ------------------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        runtime = self._runtime
        prepared = runtime.models.lookup(self._model)
        if prepared is None:
            gen = torch.Generator().manual_seed(runtime.next_seed())
            params = self._model.init(gen, device=runtime.device)
            prepared = PreparedModule(self._model, {"params": params})
            runtime.models.add(self._model, prepared)
        state = prepared.state
        if hasattr(self._model, "init_state"):
            if "model_state" not in state:
                state["model_state"] = self._model.init_state(device=runtime.device)
            state["model_state"] = map_params(lambda t: t.to(runtime.device),
                                              state["model_state"])
        state.setdefault("step", 0)
        if "base_key" not in state:
            state["base_key"] = keys.key(runtime.next_seed())
        self._prepared = prepared
        cfg = getattr(self._model, "config", None)
        if (self._remat and getattr(cfg, "scan_layers", False)
                and getattr(cfg, "scan_remat", False)):
            # The blocks already checkpoint themselves (the scan + remat
            # recipe); an outer checkpoint would recompute the whole forward
            # and each block again inside it.
            self.log_info("remat=True ignored: scan_layers already remats per block")
            self._remat = False

        loss, opt, sched = self._find_contrib()
        if opt is not None:
            if loss is None:
                raise RuntimeError("Module: an Optimizer child requires a Loss child.")
            if "optimizer" not in state:
                state["params"] = map_params(
                    lambda t: t.detach().to(runtime.device).requires_grad_(t.is_floating_point()),
                    state["params"])
                self._shard(prepared)
                state["optimizer"] = optim_lib.resolve(opt.opt, state["params"])
                if runtime.gradient_accumulation_steps > 1:
                    state["grad_accum"] = [torch.zeros_like(p) for p in
                                           optim_lib.param_leaves(state["params"])]
                    state["loss_acc"] = torch.zeros((), device=runtime.device)
            if sched is not None:
                self._lr_fn = sched.schedule
            else:
                lr = opt.learning_rate if opt.learning_rate is not None else 1e-3
                self._lr_fn = optim_lib.constant_lr(lr)
            self._objective = loss.objective
            self._clip_norm = opt.clip_norm
            self._setup_grad_sync(prepared, opt)
            self._setup_health(state)
            prepared.opt_chain = bridge.opt_chain(state["optimizer"], schedule=sched is not None,
                                                  clip=opt.clip_norm is not None)
            prepared.accum = runtime.gradient_accumulation_steps
            prepared.gated = self._health is not None and self._health["config"].gated
            if self._ema_decay is not None and "ema_params" not in state:
                # A real copy: the shadow must not alias the params.
                state["ema_params"] = map_params(lambda t: t.detach().clone(), state["params"])
        elif loss is not None:
            raise RuntimeError("Module: a Loss child requires an Optimizer child.")
        elif self._ema_decay is not None:
            # Without an update rule the shadow would never move (likely a
            # confusion with use_ema).
            raise RuntimeError("Module: ema_decay requires an Optimizer child (use "
                               "use_ema=True on the eval module to READ the shadow).")
        elif self._batch_transform is not None:
            raise RuntimeError("Module: batch_transform runs in the TRAIN step and requires "
                               "Loss + Optimizer children (eval is never transformed).")
        else:
            state["params"] = map_params(lambda t: t.to(runtime.device), state["params"])
            self._shard(prepared)

    # -- data parallelism ------------------------------------------------------

    def _shard(self, prepared: PreparedModule) -> None:
        """Hold each leaf this Module's rule shards as this rank's shard,
        once per prepared model: a second capsule wrapping the model (the
        eval Module) finds the layout in place; two rules are an error."""
        rule = self._param_sharding
        if rule is None:
            return
        if prepared.sharded_by is not None:
            if prepared.sharded_by is not rule:
                raise RuntimeError("Module: model already placed by another capsule's "
                                   "param_sharding rule; only one rule per model.")
            return
        runtime = self._runtime
        from rocket_tpu_torch.parallel import grad_sync as gs

        params = prepared.state["params"]
        leaves = optim_lib.param_leaves(params)
        model_axis = getattr(rule, "tp_axis", None) or "model"
        if model_axis != "model":
            raise NotImplementedError(f"Module: tp_axis {model_axis!r}: the port's model axis is "
                                      "'model'")
        paths = list(_paths(params))
        layouts = gs.shard_layout(zip(paths, leaves), rule, runtime.mesh, runtime.DATA_AXES)
        prepared.sharded_by = rule
        for axis in runtime.mesh:
            prepared.axis_size[axis] = int(runtime.mesh[axis])
            prepared.axis_index[axis] = runtime.axis_index(axis)
            prepared.owners[axis] = tuple(runtime.axis_owners(axis))
        prepared.world, prepared.rank = runtime.data_axis_size, runtime.data_index
        staged = [(path, tuple(t.shape), t.dtype, lay) for path, t, lay
                  in zip(paths, leaves, layouts) if lay is not None and lay.stage is not None]
        if staged:
            prepared.pipe_axis = staged[0][3].pipe_axis
            prepared.stage_leaves, prepared.full_paths = staged, paths
            axis = next((leaf[3].axis for leaf in staged if leaf[3].dim is not None), None)
            if axis is not None:
                prepared.stage_owners = {
                    stage: tuple(runtime.axis_owners(axis, at={prepared.pipe_axis: stage}))
                    for stage in range(runtime.axis_size(prepared.pipe_axis))}
        local = dict(_paths_leaves(bridge.local_params(
            map_params(lambda t: t.detach(), params), rule, runtime)))
        kept, kept_layouts = [], []
        for path, t, lay in zip(paths, leaves, layouts):
            if path not in local:
                continue  # another stage's layer
            whole = lay is None or lay.dim is None
            kept.append((path, t if whole else local[path].requires_grad_(t.requires_grad)))
            kept_layouts.append(lay)
        prepared.layouts = kept_layouts
        prepared.shard_dims = [None if lay is None else lay.dim for lay in kept_layouts]
        # A leaf's axis: the one its dim is cut over, else its stage's.
        axes = [None if lay is None else lay.axis or lay.pipe_axis for lay in kept_layouts]
        prepared.shard_axes = axes
        if staged:
            prepared.state["params"] = _nest(kept)
        else:  # every leaf kept: map_params keeps the tree's empty subtrees too
            values = iter([t for _, t in kept])
            prepared.state["params"] = map_params(lambda t: next(values), params)
        self.log_info(f"param_sharding: {sum(a is not None for a in axes)} of {len(axes)} leaves "
                      f"laid out over {sorted({a for a in axes if a is not None})}; this rank "
                      f"holds {prepared.held_bytes()['params']} param bytes")

    def _setup_grad_sync(self, prepared: PreparedModule, opt) -> None:
        """The one reduction of a multi-rank step (``parallel.grad_sync``):
        over several ranks every step goes through :class:`GradSync`. It
        narrows to ``grad_wire_dtype`` under ``grad_sync="bucketed"``, or
        ``"auto"`` with the ``fsdp_axis`` marker (the reference's
        ``_grad_sync_plan``); otherwise (``"off"``, ``"auto"`` without it)
        it is an f32 mean all-reduce, the reference's GSPMD reduction. The
        port reduces every micro-step before it accumulates, and sync-BN
        keeps the model state global, so the reference's accumulation and
        model-state conditions have no cause here. Each leaf's gradient is
        summed over the split axes it is partial over, with the mean over
        the data axis, in one all-reduce over their plane: under tensor
        parallelism the leaves the model declares (``tp_partial``) over the
        model axis; under a seq axis every leaf and the loss over it; under
        the pipeline every leaf not placed on a stage, and the loss, over
        the pipe axis."""
        runtime = self._runtime
        self.grad_sync = None
        self._pipelined = None
        self._model_partial = None
        cfg = getattr(self._model, "config", None)
        pipe_axis = getattr(cfg, "pipeline_axis", None)
        if pipe_axis and runtime.axis_size(pipe_axis) > 1 and prepared.pipe_axis != pipe_axis:
            raise ValueError(f"Module: {type(self._model).__name__} runs pipelined over "
                             f"{pipe_axis!r}: lay its params out by stage with "
                             "param_sharding=parallel.sharding.pipeline_rules()")
        if pipe_axis:
            self._pipelined = self._model.pipelined_value_and_grad(self._objective)
        if runtime.process_count <= 1:
            return
        from rocket_tpu_torch.parallel.grad_sync import GradSync

        leaves = optim_lib.param_leaves(prepared.state["params"])
        n = len(leaves)
        # Only a data-axis shard reduce-scatters; a model or expert shard is
        # held as it is and reduces over the data group like a whole leaf.
        dims = [prepared.shard_dims[i] if prepared.shard_axes[i] in runtime.DATA_AXES else None
                for i in range(n)] if prepared.shard_dims is not None else [None] * n
        axes = prepared.shard_axes or [None] * n
        paths = list(_paths(prepared.state["params"]))
        # Per leaf, the split axes its gradient is a partial sum over.
        over = [set() for _ in range(n)]
        loss_over = set()
        if runtime.seq_axis_size > 1:
            for sums in over:
                sums.add(runtime.seq_axis)
            loss_over.add(runtime.seq_axis)
        if pipe_axis and runtime.axis_size(pipe_axis) > 1:
            for sums, lay in zip(over, prepared.layouts or [None] * n):
                if lay is None or lay.stage is None:  # a leaf every stage holds
                    sums.add(pipe_axis)
            loss_over.add(pipe_axis)
        if self._tp_path_possible(prepared):
            for sums, a, path in zip(over, axes, paths):
                if a is None and self._model.tp_partial(path):
                    sums.add("model")
        partial = [frozenset(sums) or None for sums in over]
        self._model_partial = ["model" in sums for sums in over]
        if runtime.data_axis_size <= 1 and not any(partial):
            return  # one data rank, every gradient complete: nothing to reduce
        groups = {key: runtime.plane_group(("data",) + tuple(sorted(key)))
                  for key in set(partial) | {frozenset(loss_over)} if key}
        shapes = []
        for t, d in zip(leaves, dims):
            shape = list(t.shape)
            if d is not None:
                shape[d] *= prepared.world
            shapes.append(tuple(shape))
        narrow = opt.grad_sync == "bucketed" or (
            opt.grad_sync == "auto" and getattr(self._param_sharding, "fsdp_axis", None))
        wire = opt.grad_wire_dtype if narrow else None
        self.grad_sync = GradSync(shapes, [t.dtype for t in leaves], dims,
                                  runtime.data_axis_size, group=runtime.axis_group("data"),
                                  bucket_bytes=opt.grad_bucket_bytes, wire_dtype=wire,
                                  partial=partial, loss_partial=frozenset(loss_over) or None,
                                  groups=groups)
        self.log_info(f"train step: bucketed async gradient reduction (wire={wire}, "
                      f"bucket={opt.grad_bucket_bytes >> 20}MiB, "
                      f"{len(self.grad_sync.buckets)} buckets, "
                      f"{sum(p is not None for p in partial)} leaves summed over the model, "
                      "seq or pipe group)")

    def _tp_path_possible(self, prepared) -> bool:
        """Whether the model's tensor-parallel path can serve a step here:
        a model axis larger than 1, a rule with the ``tp_axis`` marker, a
        model that declares ``tp_partial`` (its TP layers), and neither a
        pipeline nor a seq axis (whose programs run the model axis
        replicated, as the reference's stage body and ring program do)."""
        runtime = self._runtime
        rule = prepared.sharded_by
        cfg = getattr(self._model, "config", None)
        return (runtime.model_axis_size > 1 and getattr(rule, "tp_axis", None) is not None
                and getattr(self._model, "tp_partial", None) is not None
                and not getattr(cfg, "pipeline_axis", None) and runtime.seq_axis_size <= 1)

    def _replicated(self, batch) -> bool:
        """Whether this step runs the replicated program over the model
        group: a model axis larger than 1 where the tensor-parallel path
        does not serve the batch (no TP path, a pipeline, a seq axis, or a
        batch the model's ``tp_serves`` refuses). Its model shards are then
        gathered whole at step entry and each rank keeps its part of their
        complete gradients."""
        if self._runtime.model_axis_size <= 1:
            return False
        if not self._tp_path_possible(self._prepared):
            return True
        serves = getattr(self._model, "tp_serves", None)
        return serves is not None and not serves(batch, self._runtime.model_axis_size)

    def _tp(self, replicated: bool = False):
        """The parallel contexts of the rule that laid the model out (an
        eval Module sharing it reads the same shards), around a forward and
        its backward: tensor parallelism for the ``tp_axis`` marker (not
        for a ``replicated`` step), expert parallelism for
        ``expert_axis``, and for an MoE model over several data ranks the
        global batch's aux loss (``collectives.data_mean``); a null context
        without any."""
        import contextlib

        rule = self._prepared.sharded_by if self._prepared is not None else None
        axis = getattr(rule, "tp_axis", None)
        experts = getattr(rule, "expert_axis", None)
        stack = contextlib.ExitStack()
        if axis is not None and self._runtime.model_axis_size > 1 and not replicated:
            from rocket_tpu_torch.parallel.collectives import tp_overlap

            stack.enter_context(tp_overlap(
                self._runtime, axis=axis,
                vocab_sharded_embed=bool(getattr(rule, "tp_vocab_sharded", False))))
        if experts is not None and self._runtime.axis_size(experts) > 1:
            from rocket_tpu_torch.parallel.collectives import expert_parallel

            stack.enter_context(expert_parallel(self._runtime, axis=experts))
        cfg = getattr(self._model, "config", None)
        if (getattr(cfg, "num_experts", 0) > 0 and not getattr(cfg, "pipeline_axis", None)
                and self._runtime.data_axis_size > 1):
            # The load-balancing loss over the global batch, as the
            # reference's (a pipeline's aux is the microbatches' mean).
            from rocket_tpu_torch.parallel.collectives import data_mean

            stack.enter_context(data_mean(self._runtime))
        return stack

    def _full_params(self, params, grad: bool = False, replicated: bool = False):
        """The params the forward reads: under a data-sharded layout each
        shard all-gathered whole over the data group, and for a
        ``replicated`` step each model shard over the model group (every
        gather started before the first wait; otherwise a model shard stays
        this rank's, the tensor-parallel layers read it as it is); with
        ``grad`` the gathered tensors are fresh leaves that need a
        gradient. The gathers of one axis go in buckets, one flat
        all-gather each (``grad_sync.gather_buckets``: the reductions'
        bucket rule), not one a leaf. Returns ``(params, leaves in param
        order)``."""
        prepared = self._prepared
        leaves = optim_lib.param_leaves(params)
        axes = sorted(({"data"} | ({"model"} if replicated else set()))
                      & set(prepared.shard_axes or ()))
        if not prepared.sharded() or not axes:
            return params, leaves
        from rocket_tpu_torch.parallel.grad_sync import gather_buckets, gathered

        runtime = self._runtime
        started = [gather_buckets(
            [(i, t.detach(), d) for i, (t, d, a) in enumerate(
                zip(leaves, prepared.shard_dims, prepared.shard_axes)) if a == axis],
            prepared.axis_size[axis], group=runtime.axis_group(axis)) for axis in axes]
        if replicated:
            from rocket_tpu_torch.parallel import collectives as coll

            # The model group's share of the step: counted with its other
            # collectives.
            coll.note_gather([t for t, a in zip(leaves, prepared.shard_axes) if a == "model"],
                             prepared.axis_size.get("model", 1))
        t0 = time.perf_counter()
        full = list(leaves)
        for pending in started:
            for i, whole in gathered(pending):
                full[i] = whole.requires_grad_(True) if grad else whole
        if replicated:
            coll.STATS["wait_s"] += time.perf_counter() - t0
        it = iter(full)
        return map_params(lambda t: next(it), params), full

    def _grad_maps(self, replicated: bool):
        """Per param leaf, what turns the step's gradient into the one
        :class:`GradSync` reduces (None: as it is). On a ``replicated``
        step a gathered model shard's whole gradient, the same on every
        rank of the model group, gives this rank's chunk, and a leaf the
        tensor-parallel path sums over the model group (``tp_partial``)
        contributes its 1/n share of the complete gradient."""
        prepared = self._prepared
        n = len(optim_lib.param_leaves(prepared.state["params"]))
        if not replicated:
            return [None] * n
        m = self._runtime.model_axis_size
        index = self._runtime.axis_index("model")
        maps = [None] * n
        for i in range(n):
            if prepared.shard_axes is not None and prepared.shard_axes[i] == "model":
                dim = prepared.shard_dims[i]
                maps[i] = lambda g, d=dim: g.chunk(m, d)[index].contiguous()
            elif self._model_partial is not None and self._model_partial[i]:
                maps[i] = lambda g: g / m
        return maps

    def _sumsq(self, params, tensors) -> torch.Tensor:
        """Σ ||t||² over ``tensors`` (one per param of ``params``, in its
        layout): a sharded param's shards summed over its axis's group,
        each replicated param counted once."""
        import torch.distributed as dist

        if not params:
            return torch.zeros((), device=self._runtime.device)
        squares = torch.stack(torch._foreach_norm(list(tensors))).float().square()
        key = tuple(map(id, params))
        masks = self._split_masks.get(key)
        if masks is None:
            prepared = self._prepared
            # A stage's model shard sums over the model and pipe plane.
            kinds = [a if lay is None or lay.dim is None or lay.stage is None
                     else (a, lay.pipe_axis)
                     for a, lay in zip(prepared.shard_axes, prepared.layouts)]
            axis_of = dict(zip(map(id, optim_lib.param_leaves(prepared.state["params"])), kinds))
            axes = [axis_of.get(id(p)) for p in params]
            with explicit_transfer():
                masks = self._split_masks[key] = [
                    (axis, torch.tensor([a == axis for a in axes], device=squares.device))
                    for axis in sorted({a for a in axes if a is not None}, key=str)]
        total = squares
        out = None
        for axis, mask in masks:
            part = torch.where(mask, squares, 0.0).sum()
            dist.all_reduce(part, group=self._runtime.axis_group(axis) if isinstance(axis, str)
                            else self._runtime.plane_group(axis))
            total = torch.where(mask, 0.0, total)
            out = part if out is None else out + part
        total = total.sum()
        return total if out is None else total + out

    def _setup_health(self, state: dict) -> None:
        """With the health monitor on: the sentinel state, the step's label
        and branch layout, the leaves' branches, and, under a gating action,
        the gate's optimizer (its rule checked, its count kept on the card:
        ``capturable`` for Adam(W) on CUDA)."""
        monitor = getattr(self._runtime, "health", None)
        self._health = None
        if monitor is None or not monitor.enabled:
            return
        from rocket_tpu_torch.obs import health as health_lib

        device = self._runtime.device
        if "health" not in state:
            state["health"] = health_lib.init_state(device)
        opt = state["optimizer"]
        if monitor.config.gated:
            refusal = optim_lib.gate_refusal(opt)
            if refusal is not None:
                raise NotImplementedError(f"Module: anomaly_action={monitor.config.action!r} "
                                          f"updates through optim.gated_step, which has no "
                                          f"rule for {refusal}")
            if device.type == "cuda" and isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
                for group in opt.param_groups:
                    group["capturable"] = True
        params = state["params"]
        names = health_lib.branch_names(params)
        tops = [path[0] if isinstance(params, dict) and path else "params"
                for path in _paths(params)]
        self._health = {
            "lib": health_lib, "config": monitor.config,
            "label": monitor.register_step(f"train_step[{type(self._model).__name__}]", names),
            "branches": {name: [i for i, top in enumerate(tops) if str(top) == name]
                         for name in names},
        }

    # -- steps -------------------------------------------------------------

    def _forward(self, params, batch, mode, rng):
        """The model's forward: the output batch, or ``(batch, new_state)``
        for a model with state."""
        if self._compute_dtype is not None:
            batch = {k: v.to(self._compute_dtype)
                     if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                     for k, v in batch.items()}
        mstate = self._prepared.state.get("model_state")
        if mstate is None:
            fn = lambda b: self._model.apply(params, b, mode=mode, rng=rng)  # noqa: E731
        else:
            fn = lambda b: self._model.apply(params, b, state=mstate, mode=mode,  # noqa: E731
                                             rng=rng)
        if self._remat and mode == "train":
            return checkpoint(fn, batch, use_reentrant=False)
        return fn(batch)

    def _update(self, leaves, grads, opt_step, ok=None):
        """One optimizer update. Off the gate (``ok`` None): clip (optax's
        ``clip_by_global_norm``), set the schedule's lr for ``opt_step`` and
        take ``torch.optim``'s step. Under it (``ok`` a 0-dim bool):
        ``optim.gated_step``, held where ``ok`` is false. Returns
        ``(grad_norm, update_norm)``: the pre-clip global norm when
        clipping, else None; ||update|| under the health monitor, else
        None."""
        opt = self._prepared.state["optimizer"]
        decay = None if self._ema_decay is None else 1.0 - self._ema_decay
        sharded = self._prepared.spread()
        if ok is not None:
            update_norm, self.last_lr, norm = optim_lib.gated_step(
                opt, dict(zip(leaves, grads)), ok, self._lr_fn, self._clip_norm,
                sumsq=self._sumsq if sharded else None)
            if decay is not None:
                self._ema_step(leaves, torch.where(ok, decay, 0.0))
            return norm, update_norm
        norm = None
        if self._clip_norm is not None:
            # Under a sharded layout the global norm sums over every rank's shards.
            norm = (self._sumsq(leaves, grads).sqrt() if sharded else torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads])))
            factor = self._clip_norm / torch.clamp(norm, min=self._clip_norm)
            grads = [g * factor for g in grads]
        # The sentinels' ||update|| is the params' move: torch.optim's step
        # does not hand its update out.
        before = ([p.detach().clone() for p in leaves] if self._health is not None else None)
        for p, g in zip(leaves, grads):
            p.grad = g
        lr = float(self._lr_fn(opt_step))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for p in leaves:
            p.grad = None
        update_norm = None
        if before is not None:
            with torch.no_grad():
                torch._foreach_sub_(before, leaves)
                update_norm = (self._sumsq(leaves, before).sqrt() if sharded else
                               torch.stack(torch._foreach_norm(before)).float().square().sum()
                               .sqrt())
        if decay is not None:
            self._ema_step(leaves, decay)
        return norm, update_norm

    def _ema_step(self, leaves, weight) -> None:
        """e += w (p - e) over the shadow, one foreach pass; ``weight`` a
        float or a 0-dim device tensor (0 on a held step: e keeps its bits)."""
        with torch.no_grad():
            ema = optim_lib.param_leaves(self._prepared.state["ema_params"])
            diff = torch._foreach_sub(leaves, ema)
            torch._foreach_mul_(diff, weight)
            torch._foreach_add_(ema, diff)

    def _train_step(self, batch):
        state = self._prepared.state
        step = state["step"]
        accum = self._runtime.gradient_accumulation_steps
        leaves = optim_lib.param_leaves(state["params"])
        rng = keys.fold_in(state["base_key"], step)
        if self._batch_transform is not None:
            # A profiler range, so a trace can tell augmentation's kernels apart.
            with torch.profiler.record_function("Module.batch_transform"):
                batch = self._batch_transform(dict(batch), keys.fold_in(rng, 0xA9517))
        runtime = self._runtime
        ranks = runtime.data_axis_size
        replicated = self._replicated(batch)
        maps = self._grad_maps(replicated)
        if replicated:
            from rocket_tpu_torch.parallel.collectives import note_replicated

            note_replicated("model")
        with torch.enable_grad(), keys.data_shard(runtime.data_index if ranks > 1 else 0), \
                self._tp(replicated):
            params, compute = self._full_params(state["params"], grad=True,
                                                replicated=replicated)
            if self._pipelined is not None:
                # The pipeline computes its gradients over several backward
                # passes (one a microbatch under 1F1B): the reduction takes
                # the sums at the end, not the leaves' first hooks.
                if self.grad_sync is not None:
                    self.grad_sync.begin(compute, hook=False, maps=maps)
                loss, out, grads = self._pipelined(params, batch, rng, compute)
            else:
                if self.grad_sync is not None:
                    self.grad_sync.begin(compute, maps=maps)
                out = self._forward(params, batch, "train", rng)
                if "model_state" in state:
                    out, mstate = out
                    state["model_state"] = map_params(lambda t: t.detach(), mstate)
                loss = self._objective(out).float()
                # The backward runs inside the block: a remat recompute draws
                # this rank's dropout masks and issues the forward's
                # tensor-parallel and ring collectives again.
                grads = torch.autograd.grad(loss, compute, allow_unused=True)
        loss = loss.detach()
        if self.grad_sync is not None:
            grads, loss = self.grad_sync.finish(grads, loss)
        else:
            grads = [torch.zeros_like(p) if g is None else g if f is None else f(g)
                     for p, g, f in zip(leaves, grads, maps)]
        h = self._health
        keep = None  # the gate's predicate: None off the gate
        if h is not None:
            tree = {name: [grads[i] for i in idx] for name, idx in h["branches"].items()}
            g_sq = None
            if self._prepared.spread():
                g_sq = torch.stack([self._sumsq([leaves[i] for i in idx], tree[name])
                                    for name, idx in h["branches"].items()])
            flags = h["lib"].step_flags(loss, tree, g_sq=g_sq)
            if h["config"].gated:
                keep = flags[0]
                if h["config"].action == "dump_and_halt":
                    # The gate latches: once a step was held, every later
                    # one is held too until the lagged word halts the run,
                    # so the black box's emergency checkpoint is the state
                    # before the anomaly (the reference's lagged halt would
                    # save the steps after it).
                    keep = keep & (state["health"]["skipped"] == 0)
        metrics = {"loss": loss}
        grad_norm = update_norm = None
        if accum == 1:
            opt_step = step
            grad_norm, update_norm = self._update(leaves, grads, opt_step, keep)
            metrics["loss_window"] = loss
        else:
            opt_step = step // accum
            contrib = loss / accum
            if keep is not None:
                # A non-finite microbatch leaves the window: its gradients
                # and its loss are dropped, the boundary applies the rest.
                grads = [torch.where(keep, g, 0.0) for g in grads]
                contrib = torch.where(keep, contrib, 0.0)
            torch._foreach_add_(state["grad_accum"], grads)
            state["loss_acc"] = state["loss_acc"] + contrib
            if (step + 1) % accum == 0:
                apply = keep
                if keep is not None and h["config"].action != "dump_and_halt":
                    apply = torch.ones_like(keep)
                grad_norm, update_norm = self._update(
                    leaves, [a / accum for a in state["grad_accum"]], opt_step, apply)
                for a in state["grad_accum"]:
                    a.zero_()
                metrics["loss_window"] = state["loss_acc"]
                state["loss_acc"] = torch.zeros_like(state["loss_acc"])
            else:
                metrics["loss_window"] = torch.zeros_like(loss)
        metrics["lr"] = float(self._lr_fn(opt_step))
        if self._clip_norm is not None:
            metrics["grad_norm"] = grad_norm if grad_norm is not None else torch.zeros_like(loss)
        if h is not None:
            step_ok, loss_ok, grad_branch_ok, health_grad_norm = flags
            with torch.no_grad():
                p_sq = None
                if self._prepared.spread():
                    p_sq = torch.stack([self._sumsq(*([leaves[i] for i in idx],) * 2)
                                        for idx in h["branches"].values()])
                state["health"], word, extras = h["lib"].update_sentinels(
                    state["health"], loss=loss, step=step, step_ok=step_ok, loss_ok=loss_ok,
                    grad_branch_ok=grad_branch_ok, grad_norm=health_grad_norm,
                    update_norm=(update_norm if update_norm is not None
                                 else torch.zeros_like(loss)),
                    new_params=state["params"], gated=h["config"].gated,
                    ema_decay=h["config"].ema_decay, zscore_max=h["config"].zscore_max,
                    zscore_warmup=h["config"].zscore_warmup, p_sq=p_sq)
            metrics["health/update_ratio"] = extras["update_ratio"]
            metrics["health/param_norm"] = extras["param_norm"]
            metrics["health_word"] = word
        state["step"] = step + 1
        return out, metrics

    # -- launch ------------------------------------------------------------

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is None:
            return
        batch = dict(attrs.batch)
        state = self._prepared.state
        if attrs.mode == "train":
            if self._objective is None:
                raise RuntimeError("Module: train launch without Loss/Optimizer children — give "
                                   "this Module its post-forward pipeline or run it in an eval "
                                   "Looper.")
            out, metrics = self._train_step(batch)
            attrs.sync_gradients = state["step"] % self._runtime.gradient_accumulation_steps == 0
            word = metrics.pop("health_word", None)
            attrs.step_metrics = Attributes(metrics)
            if word is not None:
                # The monitor starts the word's copy to the host now and
                # decodes it fetch_lag steps later (under dump_and_halt the
                # decode raises).
                context = {}
                if attrs.looper is not None:
                    context["tag"] = attrs.looper.tag
                if attrs.launcher is not None:
                    context["epoch"] = attrs.launcher.epoch_idx
                if attrs.batch_info is not None and attrs.batch_info.index is not None:
                    context["batch_index"] = attrs.batch_info.index
                self._runtime.health.observe(self._health["label"], state["step"], word,
                                             context)
            if self._return_outputs == "always":
                attrs.batch = out
        else:
            if self._use_ema and "ema_params" not in state:
                # Checked here, not at setup: the train Module may set up
                # after this one.
                raise RuntimeError("Module(use_ema=True): no EMA shadow in the model state — "
                                   "the train Module wrapping this model must set ema_decay.")
            params = state["ema_params"] if self._use_ema else state["params"]
            replicated = self._replicated(batch)
            with torch.no_grad(), self._tp(replicated):
                out = self._forward(self._full_params(params, replicated=replicated)[0], batch,
                                    "eval", None)
            attrs.batch = out[0] if "model_state" in state else out
            attrs.step_metrics = None
            attrs.sync_gradients = None
        Dispatcher.launch(self, attrs)

    def destroy(self, attrs: Attributes | None = None) -> None:
        if self._prepared is not None and self._runtime is not None:
            self._runtime.models.remove(self._model)
        self._prepared = None
        super().destroy(attrs)

    def __repr__(self) -> str:
        head = f"Module({type(self._model).__name__})"
        if not self._capsules:
            return head
        lines = [head + "("]
        for capsule in self._capsules:
            lines.append("\n".join("    " + ln for ln in repr(capsule).splitlines()) + ",")
        lines.append(")")
        return "\n".join(lines)
