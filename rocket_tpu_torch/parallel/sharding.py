"""Param-sharding rule builders: map param-tree paths to partition specs
(counterpart of ``rocket_tpu/parallel/sharding.py``; the same paths give
the same specs).

A rule set is a list of ``(glob_pattern, spec)`` pairs matched against the
'/'-joined param path, first match wins; a spec is a tuple naming, per
dim, the mesh axis that dim is split over (or None). Pass the resulting
function as ``Module(..., param_sharding=rule_fn)``. The port's Module
applies specs over the data axis (``fsdp_rules``), the model axis
(``gpt2_tp_rules``, tensor parallelism), the pipe axis
(``pipeline_rules``: its specs are the reference's, for the stacked
layout; the port keeps a layer per ``blocks/<i>`` subtree, so its marker
has ``grad_sync.shard_layout`` place each of them whole on its stage,
:class:`LayerStage`) and the expert axis (``moe_rules``: in the port's
``blocks/<i>`` layout E is dim 0 of ``experts/{w_in,b_in,w_out,b_out}``,
and its ``expert_axis`` marker has the Module run the MoE expert-parallel).
"""

from __future__ import annotations

import fnmatch
from typing import Callable, Optional, Sequence, Tuple

__all__ = [
    "ShardingRuleError",
    "LayerStage",
    "make_rules",
    "gpt2_tp_rules",
    "fsdp_rules",
    "moe_rules",
    "pipeline_rules",
    "layer_stage",
    "pipeline_over",
    "combine_rules",
]

Spec = Optional[Tuple]
RuleFn = Callable[[Tuple[str, ...], object], Spec]


def _numel(leaf) -> int:
    """Element count of a torch tensor, a numpy array or any object with a
    ``shape`` (``Tensor.size`` is a method, numpy's an int)."""
    numel = getattr(leaf, "numel", None)
    if callable(numel):
        return int(numel())
    n = 1
    for dim in getattr(leaf, "shape", ()) or ():
        n *= int(dim)
    return n


class ShardingRuleError(ValueError):
    """A sharding rule matched a param it cannot describe: its spec names
    more dims than the param has. Raised when the rule set is applied to
    the param tree, carrying the matched glob."""

    def __init__(self, pattern: str, path: Tuple[str, ...], spec: Tuple,
                 shape: Tuple[int, ...]) -> None:
        self.pattern = pattern
        self.path = tuple(path)
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        super().__init__(
            f"sharding rule {pattern!r} matched param "
            f"{'/'.join(self.path)} with shape {self.shape} but its spec "
            f"{self.spec} names {len(self.spec)} dims — a PartitionSpec "
            "cannot be longer than the param rank (is the rule written "
            "for the scan-over-layers 'blocks_stacked' layout, or is the "
            "glob matching the wrong leaf?)"
        )


class LayerStage:
    """The placement of one layer's leaf under pipeline parallelism: the
    whole leaf lives on the stage of ``axis`` that runs ``layer``, which is
    ``layer // (L / P)`` of L layers over P stages (the reference's
    ``blocks_stacked`` split evenly on its layer dim)."""

    __slots__ = ("axis", "layer")

    def __init__(self, axis: str, layer: int) -> None:
        self.axis, self.layer = axis, int(layer)

    def __eq__(self, other) -> bool:
        return (isinstance(other, LayerStage)
                and (self.axis, self.layer) == (other.axis, other.layer))

    def __hash__(self) -> int:
        return hash((self.axis, self.layer))

    def __repr__(self) -> str:
        return f"LayerStage({self.axis!r}, {self.layer})"


def make_rules(rules: Sequence[Tuple[str, Spec]],
               stacked_prefixes: Tuple[str, ...] = ("blocks_stacked",)) -> RuleFn:
    """A param_sharding fn from ``[(glob, spec), ...]``; first match wins;
    no match -> replicated (None). Only leaves under a ``stacked_prefixes``
    subtree (the scan-over-layers layout, with a leading layer dim) get a
    short spec left-padded with None; elsewhere a short spec leaves its
    trailing dims replicated. A spec longer than the leaf's rank raises
    :class:`ShardingRuleError`. The fn exposes its table as
    ``rule_fn.patterns``."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        joined = "/".join(path)
        for pattern, spec in rules:
            if fnmatch.fnmatch(joined, pattern):
                shape = getattr(leaf, "shape", None)
                if (spec is not None and shape is not None and len(shape) > len(spec)
                        and path and path[0] in stacked_prefixes):
                    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
                if spec is not None and shape is not None and len(spec) > len(shape):
                    raise ShardingRuleError(pattern, path, spec, tuple(shape))
                return spec
        return None

    rule_fn.patterns = tuple((pattern, spec) for pattern, spec in rules)
    return rule_fn


def gpt2_tp_rules(axis: str = "model") -> RuleFn:
    """Megatron-style tensor parallelism for :class:`TransformerLM` params:
    QKV and MLP-in kernels and biases column-parallel, the attention
    projection and MLP-out kernels row-parallel, the embedding table over
    the vocab dim. The fn carries the ``tp_axis`` and ``tp_vocab_sharded``
    markers."""
    rule_fn = make_rules([
        ("*/attn/qkv/w", (None, axis)),
        ("*/attn/qkv/b", (axis,)),
        ("*/attn/proj/w", (axis, None)),
        ("*/mlp/fc_in/w", (None, axis)),
        ("*/mlp/fc_in/b", (axis,)),
        ("*/mlp/fc_gate/w", (None, axis)),
        ("*/mlp/fc_gate/b", (axis,)),
        ("*/mlp/fc_out/w", (axis, None)),
        ("wte/table", (axis, None)),
        ("head/w", (None, axis)),
    ])
    rule_fn.tp_axis = axis
    rule_fn.tp_vocab_sharded = True
    return rule_fn


def fsdp_rules(axis: str = "data", min_size: int = 2**16,
               stacked_prefixes: Tuple[str, ...] = ("blocks_stacked",)) -> RuleFn:
    """ZeRO-3-style fully-sharded layout: every param of at least
    ``min_size`` elements sharded on its first natural dim (under a
    ``stacked_prefixes`` subtree, the dim after the layer dim). The fn
    carries the ``fsdp_axis`` and ``fsdp_min_size`` markers: the first
    routes the Module's step through the bucketed gradient sync
    (``parallel.grad_sync``)."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        shape = getattr(leaf, "shape", ())
        if not shape or _numel(leaf) < min_size:
            return None
        spec = (axis,) + (None,) * (len(shape) - 1)
        if path and path[0] in stacked_prefixes and len(shape) > 1:
            spec = (None, axis) + (None,) * (len(shape) - 2)
        return spec

    rule_fn.fsdp_axis = axis
    rule_fn.fsdp_min_size = min_size
    return rule_fn


def moe_rules(axis: str = "expert",
              stacked_prefixes: Tuple[str, ...] = ("blocks_stacked",)) -> RuleFn:
    """Expert parallelism: stacked expert params (leading E dim, after the
    layer dim under a ``stacked_prefixes`` subtree) sharded over an
    'expert' axis. Composes with :func:`combine_rules`. The fn carries the
    ``expert_axis`` marker: the Module runs the MoE layers under
    ``collectives.expert_parallel`` over that axis."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        if "experts" not in path:
            return None
        shape = getattr(leaf, "shape", ())
        offset = 1 if path and path[0] in stacked_prefixes else 0
        if len(shape) <= offset:
            return None
        return (None,) * offset + (axis,) + (None,) * (len(shape) - offset - 1)

    rule_fn.expert_axis = axis
    return rule_fn


#: The attributes a rule function may carry for the Module.
_MARKERS = ("tp_axis", "tp_vocab_sharded", "expert_axis", "pipe_axis", "fsdp_axis",
            "fsdp_min_size")


def _carry(rule_fn: RuleFn, *inner: RuleFn) -> RuleFn:
    """``rule_fn`` with the markers of ``inner`` (the first that has each)."""
    for name in _MARKERS:
        for fn in inner:
            if hasattr(fn, name) and not hasattr(rule_fn, name):
                setattr(rule_fn, name, getattr(fn, name))
    return rule_fn


def pipeline_over(inner: RuleFn, axis: str = "pipe",
                  stacked_prefix: str = "blocks_stacked") -> RuleFn:
    """Pipeline-stage sharding on top of another rule set: stacked-layer
    leaves get their leading layer dim over ``axis`` beside whatever
    ``inner`` gives the layer's own dims (a short inner spec is left-padded);
    other leaves follow ``inner``. The fn carries the ``pipe_axis`` marker
    and ``inner``'s markers: in the port's ``blocks/<i>`` layout a layer's
    leaf lives on its stage and keeps ``inner``'s spec on its own dims
    (dp x tp x pp: ``grad_sync.shard_layout``'s ``(dim, axis, stage,
    pipe axis)``)."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        spec = inner(path, leaf)
        if not (path and path[0] == stacked_prefix):
            return spec
        shape = getattr(leaf, "shape", ())
        if spec is None:
            spec = (None,) * len(shape)
        spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
        return (axis,) + tuple(spec[1:])

    rule_fn.pipe_axis = axis
    return _carry(rule_fn, inner)


def combine_rules(*fns: RuleFn) -> RuleFn:
    """The first rule set returning a non-None spec wins. The fn carries the
    markers of the rule sets it combines (``combine_rules(moe_rules(),
    gpt2_tp_rules())``: expert parallelism and tensor parallelism)."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        for fn in fns:
            spec = fn(path, leaf)
            if spec is not None:
                return spec
        return None

    return _carry(rule_fn, *fns)


def pipeline_rules(axis: str = "pipe", stacked_prefix: str = "blocks_stacked") -> RuleFn:
    """Pipeline parallelism: the stacked layer dim sharded over a 'pipe'
    axis; everything else replicated. The fn carries the ``pipe_axis``
    marker, under which the port places each per-layer ``blocks/<i>``
    subtree whole on its layer's stage (:func:`layer_stage`)."""

    def rule_fn(path: Tuple[str, ...], leaf) -> Spec:
        if path and path[0] == stacked_prefix:
            shape = getattr(leaf, "shape", ())
            return (axis,) + (None,) * (len(shape) - 1)
        return None

    rule_fn.pipe_axis = axis
    return rule_fn


def layer_stage(rule_fn, path: Tuple[str, ...]) -> Optional[LayerStage]:
    """The :class:`LayerStage` of a per-layer leaf ``blocks/<i>/...`` under
    a rule set with the ``pipe_axis`` marker, else None."""
    axis = getattr(rule_fn, "pipe_axis", None)
    if axis is None or len(path) < 2 or path[0] != "blocks" or not str(path[1]).isdigit():
        return None
    return LayerStage(axis, int(path[1]))
