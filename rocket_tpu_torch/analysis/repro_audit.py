"""The determinism and replay audit (RKT901-906; counterpart of
``rocket_tpu/analysis/repro_audit.py``).

The port's headline contracts are bitwise: a resume, a drain, a replayed
serve wave, the held step. This audit proves what they stand on before
anything runs, on the step traced on meta tensors (shapes and dtypes, no
storage, no card) under :class:`ProgramTracer`, a ``TorchDispatchMode``
that records every aten op below autograd (the backward and a remat's
recompute included), every hand kernel's ``LaunchFact`` and every
collective's ``CommFact``, with a structural value number per tensor
(two tensors made by the same ops from the same inputs share one):

* **Key discipline** (RKT901): the port's keys are Python ints
  (``nn/keys.py``), so ``keys.record_draws`` notes every key made and
  folded and every draw with its key, the element indices it hashes and
  the code that drew it; a serve wave's Gumbel draw (``models/sampling.
  draw``) is keyed by its seed and its salt tensor's value number. One key
  and range drawn twice is reuse, unless the second draw is a
  checkpoint's recompute (made during the backward: the replay the counter
  keys exist for); one site drawing the same key over and over is a loop
  body that never folds in its position; a torch random op drawing from
  the global default generator is a draw no checkpoint replays.
* **Order-free sums** (RKT902): the aten ops whose float sums arrive in no
  fixed order on the card (:data:`NONDET_OPS`: ``index_add``,
  ``scatter_add``, ``scatter_reduce``, an accumulating ``index_put`` or
  ``put``, the embedding and gather backwards, and the ops the installed
  torch names nondeterministic on CUDA), each at the ``path:function``
  that issued it (a backward op at its forward's site, read from the
  autograd node's anomaly-mode traceback), and every hand kernel whose
  ``LaunchFact`` declares an order-free accumulation (none today: the
  kernels combine fixed-order partials, and ``fused_conv.cu``'s
  ``atomicAdd`` is its grid barrier's integer counter). Each target lists
  its reviewed sites with their reasons.
* **Resume identity** (RKT903): the step traced from fresh state and
  from state round-tripped through ``runtime/checkpoint_io`` must have
  one input signature (``trace_audit.trace_signature``) and one program
  fingerprint.
* **Wave identity** (RKT904): ``serve/engine.build_decode_wave`` at k in
  {1, 2, 4} must run k copies of one wave body.
* **The replay sentinel** (RKT905): the audit LM's train step runs twice
  on the CPU from identical state, on one intra-op thread (with more, the
  CPU's accumulating ``index_put`` is parallel and sums in no fixed
  order); params, loss and the health word (``obs/health.step_flags``,
  ``branch_sumsq``) must be byte-equal.
* **The budget** (RKT906): program fingerprints and the draw and
  derivation counts, under ``tests/fixtures/torch_budgets/repro/``.

CLI: ``python -m rocket_tpu_torch.analysis repro``. On the card,
``chip_smoke.py``'s ``repro`` phase runs GPT-2's and the MoE LM's steps
twice and once under ``torch.use_deterministic_algorithms``, and holds
what torch warns about to this audit's findings and reviewed sites.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from rocket_tpu_torch.analysis.prec_audit import caller_site
from rocket_tpu_torch.analysis.rules.repro_rules import (
    check_key_reuse,
    check_nondet_ops,
    check_replay_sentinel,
    check_resume_identity,
    check_wave_invariance,
)
from rocket_tpu_torch.ops._launch import CommFact, LaunchFact, record_launches

__all__ = [
    "NONDET_OPS",
    "KeyFlow",
    "ProgramTracer",
    "analyze_key_provenance",
    "trace_program",
    "program_fingerprint",
    "prove_wave_invariance",
    "run_replay_sentinel",
    "ReproAuditReport",
    "audit_train_repro",
    "audit_serve_repro",
    "audit_sentinel_repro",
    "ReproTarget",
    "REPRO_TARGETS",
    "run_repro_target",
    "warned_ops",
    "explained",
]

#: Aten ops whose float sums combine in no fixed order on CUDA: the
#: accumulating scatters and the backwards torch documents under
#: ``torch.use_deterministic_algorithms`` (deterministic there only when
#: the mode is on), and the ops it names as having no deterministic CUDA
#: form. ``index_put`` counts with ``accumulate=True`` only, ``scatter_reduce``
#: with a sum or mean, a convolution's backward while cuDNN may pick a
#: nondeterministic algorithm.
NONDET_OPS = frozenset({
    "aten::index_add", "aten::index_add_", "aten::scatter_add", "aten::scatter_add_",
    "aten::scatter_reduce", "aten::scatter_reduce_", "aten::index_put", "aten::index_put_",
    "aten::_index_put_impl_", "aten::put", "aten::put_", "aten::embedding_dense_backward",
    "aten::_embedding_bag_backward", "aten::_embedding_bag_dense_backward",
    "aten::index_reduce", "aten::index_reduce_",
    "aten::cumsum", "aten::cumsum_", "aten::nll_loss2d_forward", "aten::bincount",
    "aten::histc", "aten::kthvalue", "aten::median", "aten::_ctc_loss_backward",
    "aten::grid_sampler_2d_backward", "aten::grid_sampler_3d_backward",
    "aten::_adaptive_avg_pool2d_backward", "aten::_adaptive_avg_pool3d_backward",
    "aten::adaptive_max_pool2d_backward", "aten::adaptive_max_pool3d_backward",
    "aten::avg_pool3d_backward", "aten::max_pool3d_with_indices_backward",
    "aten::fractional_max_pool2d_backward", "aten::fractional_max_pool3d_backward",
    "aten::max_unpool2d", "aten::max_unpool3d",
    "aten::reflection_pad1d_backward", "aten::reflection_pad2d_backward",
    "aten::reflection_pad3d_backward", "aten::replication_pad1d_backward",
    "aten::replication_pad2d_backward", "aten::replication_pad3d_backward",
    "aten::upsample_linear1d_backward", "aten::upsample_bilinear2d_backward",
    "aten::upsample_bicubic2d_backward", "aten::upsample_trilinear3d_backward",
    "aten::convolution_backward",
})

#: The accumulating scatters among them (and the backwards made of one).
_SCATTERS = frozenset({"aten::index_add", "aten::index_add_", "aten::scatter_add",
                       "aten::scatter_add_", "aten::embedding_dense_backward",
                       "aten::_embedding_bag_backward", "aten::_embedding_bag_dense_backward",
                       "aten::index_reduce", "aten::index_reduce_"})

#: Aten ops that draw random numbers; without an explicit ``generator``
#: they draw from the global default one.
_RANDOM_OPS = frozenset({
    "aten::uniform", "aten::uniform_", "aten::normal", "aten::normal_", "aten::bernoulli",
    "aten::bernoulli_", "aten::rand", "aten::rand_like", "aten::randn", "aten::randn_like",
    "aten::randint", "aten::randint_like", "aten::randperm", "aten::random_",
    "aten::multinomial", "aten::exponential_", "aten::geometric_", "aten::cauchy_",
    "aten::log_normal_", "aten::native_dropout", "aten::rrelu_with_noise",
    "aten::poisson", "aten::_standard_gamma",
})

_TRACEBACK_RE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _canon(x) -> str:
    """A value's canonical text: tensors by dtype and shape, never by id."""
    if isinstance(x, torch.Tensor):
        return f"T{str(x.dtype).removeprefix('torch.')}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_canon(v) for v in x) + ")"
    if isinstance(x, torch.Generator):
        return "Generator"
    if isinstance(x, float):
        return repr(round(x, 12))
    return repr(x)


def _nondet_detail(name: str, args, kwargs, out) -> Optional[str]:
    """Why ``name`` with these arguments sums in no fixed order, or None."""
    if name not in NONDET_OPS:
        return None
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if name == "aten::bincount":
        weighted = (len(args) > 1 and args[1] is not None) or kwargs.get("weights") is not None
        return "weighted bincount on CUDA" if weighted else None
    if not any(t.is_floating_point() or t.is_complex() for t in outs):
        return None   # integer sums are exact in any order
    if name in ("aten::index_put", "aten::index_put_", "aten::_index_put_impl_",
                "aten::put", "aten::put_"):
        accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return "accumulate=True" if accumulate else None
    if name in ("aten::scatter_reduce", "aten::scatter_reduce_"):
        reduce = kwargs.get("reduce", args[3] if len(args) > 3 else "")
        return f"reduce={reduce!r}" if reduce in ("sum", "mean") else None
    if name == "aten::convolution_backward":
        if torch.backends.cudnn.deterministic:
            return None
        return "cuDNN may pick a nondeterministic algorithm (cudnn.deterministic off)"
    if name in _SCATTERS:
        return "float sum over duplicate indices in no fixed order on CUDA"
    return "torch names it nondeterministic on CUDA"


def _backward_site(node) -> str:
    """The forward site of the autograd node being run: the innermost frame
    of its anomaly-mode traceback that lies in the checkout."""
    try:
        trace = node.metadata.get("traceback_") or []
    except (AttributeError, RuntimeError):
        return ""
    for entry in reversed(trace):
        for path, _line, fn in reversed(_TRACEBACK_RE.findall(entry)):
            path = os.path.abspath(path)
            if path.startswith(_REPO) and "/torch/" not in path:
                return f"{os.path.relpath(path, _REPO)}:{fn}"
    return ""


def _op_site() -> str:
    """Where the current op came from: the Python frame that issued it, or
    for an op the autograd engine runs with no Python between (a built-in
    backward), its forward's site."""
    node = torch._C._current_autograd_node()
    site = caller_site()
    if node is None:
        return site
    # A custom Function's backward and a checkpoint's recompute are Python
    # code of the checkout: their frame is the site. Otherwise the engine
    # ran the node straight from torch.autograd.grad/backward.
    import sys

    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.endswith(os.path.join("torch", "autograd", "graph.py")) or path.endswith(
                os.path.join("torch", "autograd", "__init__.py")):
            return _backward_site(node) or site
        if path.startswith(_REPO) and "/torch/" not in path and not path.endswith(
                ("repro_audit.py", "prec_audit.py")):
            return site
        frame = frame.f_back
    return _backward_site(node) or site


class ProgramTracer(TorchDispatchMode):
    """Records a step run on meta tensors (module docstring): ``ops``, one
    canonical line per op that runs on the device (views and allocations
    included: the program's identity), ``nondet`` ``(op, site, detail)``
    triples, ``random_ops`` ``(op, site, explicit generator)`` and a value
    number per tensor (:meth:`vid`)."""

    def __init__(self, inputs: Sequence[torch.Tensor] = ()) -> None:
        super().__init__()
        self.ops: list = []
        self.nondet: list = []
        self.random_ops: list = []
        self._vids: dict = {}
        self._keep: list = []
        for i, t in enumerate(inputs):
            self._set(t, f"in{i}")

    def _set(self, t: torch.Tensor, vid: str) -> None:
        self._vids[id(t)] = vid
        self._keep.append(t)

    def vid(self, t) -> str:
        """The value number of ``t`` (its int value for a Python int)."""
        if not isinstance(t, torch.Tensor):
            return repr(t)
        got = self._vids.get(id(t))
        if got is None:
            got = f"fresh{len(self._vids)}"
            self._set(t, got)
        return got

    def _arg_key(self, x) -> str:
        if isinstance(x, torch.Tensor):
            return self.vid(x)
        if isinstance(x, (list, tuple)):
            return "(" + ",".join(self._arg_key(v) for v in x) + ")"
        return _canon(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        sig = (f"{name}({_canon(args)};{_canon(sorted(kwargs.items()))})->{_canon(outs)}")
        self.ops.append(sig)
        key = hashlib.sha256((name + self._arg_key((args, sorted(kwargs.items())))).encode()
                             ).hexdigest()[:16]
        for i, t in enumerate(outs):
            # An in-place op's output is its argument: the value changed,
            # and its number with it.
            self._set(t, f"{key}.{i}")
        detail = _nondet_detail(name, args, kwargs, out)
        if detail is not None:
            self.nondet.append((name, _op_site(), detail))
        if name in _RANDOM_OPS:
            gen = kwargs.get("generator")
            if gen is None:
                gen = next((a for a in args if isinstance(a, torch.Generator)), None)
            self.random_ops.append((name, caller_site(), gen is not None))
        return out

    def note(self, facts, inputs, outputs) -> None:
        """A hand kernel's or a collective's meta route."""
        for fact in facts:
            if isinstance(fact, LaunchFact):
                self.ops.append(f"launch {fact.name} {fact.geometry} {fact.acc_dtype} "
                                f"{fact.acc_order}")
                if fact.acc_order != "fixed":
                    self.nondet.append((f"kernel {fact.name}", caller_site(),
                                        "declares an order-free accumulation"))
            elif isinstance(fact, CommFact):
                self.ops.append(f"collective {fact.kind} {fact.bytes} {fact.group} "
                                f"{fact.overlapped}")
        for i, t in enumerate(outputs):
            self._set(t, f"launch{len(self.ops)}.{i}")


def program_fingerprint(ops: Sequence[str]) -> str:
    """The canonical hash of a traced program (the reference's
    ``jaxpr_fingerprint``): its ops' names, arguments' dtypes and shapes
    and constants, in issue order; 16 hex digits."""
    return hashlib.sha256("\n".join(ops).encode()).hexdigest()[:16]


def trace_program(step_fn: Callable, *args, anomaly: bool = True):
    """Run ``step_fn(*args)`` (meta tensors; any other tensor is replaced by
    a meta one) under a :class:`ProgramTracer` and ``keys.record_draws``;
    returns ``(tracer, key record, result)``. ``anomaly`` keeps each
    autograd node's forward traceback, so a backward op is sited at its
    forward."""
    from rocket_tpu_torch.analysis.sched_audit import DEFAULT_DEVICE_KIND
    from rocket_tpu_torch.analysis.trace_audit import _to_meta
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.tune import priced_device_kind

    args = _to_meta(args)
    tracer = ProgramTracer([t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)])
    with contextlib.ExitStack() as stack:
        if anomaly:
            stack.enter_context(torch.autograd.set_detect_anomaly(True, check_nan=False))
        stack.enter_context(priced_device_kind(DEFAULT_DEVICE_KIND))
        record = stack.enter_context(keys.record_draws())
        stack.enter_context(record_launches(sink=tracer))
        stack.enter_context(tracer)
        result = step_fn(*args)
    return tracer, record, result


# -- RKT901: key discipline ------------------------------------------------------------


@dataclass
class KeyFlow:
    """The facts :func:`check_key_reuse` reads, and the budget's counts."""

    consumptions: dict = field(default_factory=dict)
    unfolded: set = field(default_factory=set)
    n_creations: int = 0
    n_derivations: int = 0
    n_consumers: int = 0
    n_replays: int = 0


def _overlaps(a: tuple, b: tuple) -> bool:
    if a[0] == b[0] == "range":
        return a[1] < b[2] and b[1] < a[2]
    return a == b


def analyze_key_provenance(record, tracer: Optional[ProgramTracer] = None) -> KeyFlow:
    """The RKT901 facts from a ``keys.record_draws`` record (and the
    tracer's random ops and value numbers): every group of draws of one key
    over overlapping elements, outside a recompute, is a consumption set;
    a group drawn by one site alone is a loop body that never folds in its
    position; a random op without an explicit generator draws from the
    global default one."""
    flow = KeyFlow(n_creations=len(record.creations), n_derivations=len(record.derivations))
    groups: list = []   # (key, [domains], [sites])
    for draw in record.draws:
        if draw.replay:
            flow.n_replays += 1
            continue
        flow.n_consumers += 1
        k = draw.key
        if isinstance(k, tuple) and tracer is not None:
            k = (k[0], tracer.vid(k[1]))
        for key, domains, sites in groups:
            if key == k and any(_overlaps(d, draw.domain) for d in domains):
                domains.append(draw.domain)
                sites.append(draw.site)
                break
        else:
            groups.append((k, [draw.domain], [draw.site]))
    for key, domains, sites in groups:
        kid = (str(key), str(domains[0]))
        if len(sites) > 1 and len(set(sites)) == 1:
            origin = record.origin(key) if not isinstance(key, tuple) else ()
            flow.unfolded.add((sites[0], f"the same key on every iteration ({len(sites)} "
                               f"draws; folds from its root: {len(origin)})"))
        flow.consumptions[kid] = list(sites)
        if len(set(sites)) == 1:
            flow.consumptions[kid] = sites[:1]
    for op, site, explicit in (tracer.random_ops if tracer is not None else ()):
        flow.n_consumers += 1
        if not explicit:
            flow.unfolded.add((site, f"from the global default generator ({op}): no key, "
                               "so no checkpoint or resume replays it"))
    return flow


# -- RKT903: resume identity -----------------------------------------------------------


def _restored(state):
    """``state`` round-tripped through ``checkpoint_io``: zeros of its
    leaves saved and loaded back onto its devices (a program's identity
    depends on shapes, dtypes and layouts, not values)."""
    from rocket_tpu_torch.runtime.checkpoint_io import load_pytree, save_pytree

    zeros = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype)
                     if isinstance(t, torch.Tensor) else t, state)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        save_pytree(path, zeros)
        return load_pytree(path, template=state)


def _layout(tree) -> tuple:
    """``trace_audit.trace_signature`` and each tensor's strides."""
    from rocket_tpu_torch.analysis.trace_audit import trace_signature

    strides = tuple(t.stride() for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))
    return trace_signature(tree), strides


def _restored_fingerprint(step_fn, args, state) -> str:
    """The program of ``step_fn(*args)`` traced with every leaf of ``state``
    holding its restored tensor (``.data`` swapped in place, so a step that
    also reaches its state through a closure runs on it too), or the
    signature that already differs."""
    restored = _restored(state)
    if _layout(restored) != _layout(state):
        return "signature:" + hashlib.sha256(str(_layout(restored)).encode()).hexdigest()[:16]
    leaves = [t for t in tree_flatten(state)[0] if isinstance(t, torch.Tensor)]
    saved = [t.data for t in leaves]
    try:
        for t, r in zip(leaves, [t for t in tree_flatten(restored)[0]
                                 if isinstance(t, torch.Tensor)]):
            t.data = r
        return program_fingerprint(trace_program(step_fn, *args)[0].ops)
    finally:
        for t, d in zip(leaves, saved):
            t.data = d


# -- RKT904: wave identity -------------------------------------------------------------


def _wave_chunks(ops_by_k: Mapping[int, list]) -> dict:
    """Each k's per-wave body fingerprint: the k-wave program is k copies
    of one body and a tail that stacks the waves' results, so the body's
    length follows from the 1- and 2-wave programs; a k whose waves are not
    all one body fingerprints its first odd wave."""
    ks = sorted(ops_by_k)
    n1 = len(ops_by_k[ks[0]])
    n2 = len(ops_by_k[ks[1]]) if len(ks) > 1 else n1
    body = n2 - n1 if len(ks) > 1 else n1
    out = {}
    for k in ks:
        ops = ops_by_k[k]
        chunks = [ops[i * body:(i + 1) * body] for i in range(k)] if body > 0 else [ops]
        first = program_fingerprint(chunks[0])
        odd = next((c for c in chunks if program_fingerprint(c) != first), None)
        out[k] = first if odd is None else program_fingerprint(odd)
    return out


def _charlm_serve_parts():
    """The reference's char-LM serve configuration (``serve_audit.
    _charlm_serve_parts``: vocab 128, T 256, dim 256, 6 layers of 4 heads,
    bf16; 8 slots, 16-row blocks, 4 waves a dispatch)."""
    from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from rocket_tpu_torch.serve.api import ServeConfig

    config = TransformerConfig(vocab_size=128, max_seq_len=256, dim=256, num_layers=6,
                               num_heads=4, dropout=0.0, activation_dtype="bfloat16")
    return TransformerLM(config), ServeConfig(max_slots=8, block_len=16, prefill_chunk=32,
                                              max_model_len=256, decode_waves_per_dispatch=4)


def _decode_args(model, serve_config):
    """The decode dispatch's arguments on meta tensors, in
    ``build_decode_wave``'s order."""
    from rocket_tpu_torch.models.transformer import decode_params

    meta = torch.device("meta")
    spec, mb, _blocks, _waves = serve_config.resolve(model.config)
    with meta:
        params = decode_params(model.init(torch.Generator().manual_seed(0), device=meta),
                               model.config.activation_dtype)
    k_pages, v_pages = spec.init_pages(meta)
    s, i32 = serve_config.max_slots, torch.int32

    def vec(dtype=i32):
        return torch.empty(s, dtype=dtype, device=meta)

    return (params, k_pages, v_pages, torch.empty((s, mb), dtype=i32, device=meta), vec(),
            vec(), vec(torch.bool), vec(), vec(torch.float32), vec(), vec(torch.float32),
            vec(), vec(), 1234)


def prove_wave_invariance(model, serve_config, *, waves_list=(1, 2, 4)):
    """Trace the decode dispatch at each ``waves_per_dispatch`` and
    fingerprint its per-wave body; returns ``({k: fingerprint}, {k:
    (tracer, key record)})``."""
    from rocket_tpu_torch.serve.engine import build_decode_wave

    args = _decode_args(model, serve_config)
    ops, traced = {}, {}
    for k in waves_list:
        tracer, record, _ = trace_program(build_decode_wave(model, waves=int(k)), *args,
                                          anomaly=False)
        ops[int(k)] = tracer.ops
        traced[int(k)] = (tracer, record)
    return _wave_chunks(ops), traced


# -- RKT905: the replay sentinel -------------------------------------------------------


def _sentinel_step(seed: int = 0):
    """The audit LM's train step on the CPU with its health word: loss,
    gradients, ``step_flags`` and the SGD update (the reference's
    sentinel), from seed ``seed``'s params and a seeded batch. Returns a
    closure giving ``{name: tensor}``, the params after the step and the
    word."""
    import numpy as np

    from rocket_tpu_torch import optim
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _sgd_
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from rocket_tpu_torch.obs.health import branch_sumsq, step_flags

    model = TransformerLM(_lm_config())
    params = model.init(torch.Generator().manual_seed(seed), device=torch.device("cpu"))
    leaves = optim.param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, 256, size=(4, 64))
                              .astype(np.int32))

    def run():
        out = model.apply(params, {"tokens": tokens}, mode="train")
        loss = next_token_loss()(out).float()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with torch.no_grad():
            step_ok, loss_ok, _branch_ok, grad_norm = step_flags(loss.detach(),
                                                                 _like(params, grads))
            _sgd_(leaves, grads)
            param_norm = branch_sumsq(params).sum().sqrt()
            word = torch.stack([loss.detach(), grad_norm, param_norm, step_ok.float(),
                                loss_ok.float()])
        outs = {f"params/{i}": t.detach() for i, t in enumerate(leaves)}
        outs["word"] = word
        return outs

    return run


def _like(params, flat):
    from rocket_tpu_torch.nn.module import map_params

    it = iter(flat)
    return map_params(lambda _t: next(it), params)


def run_replay_sentinel() -> tuple:
    """Run the sentinel step twice, each from identical fresh state, and
    byte-compare every output; returns ``(mismatches, n_outputs)``. It runs
    on one intra-op thread: with more, the CPU's accumulating ``index_put``
    (the token embedding's gradient) sums in no fixed order, as torch
    documents for the CPU (on the card it sorts; ``chip_smoke.py``'s
    ``repro`` phase replays the card's steps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        first, second = _sentinel_step()(), _sentinel_step()()
    finally:
        torch.set_num_threads(threads)
    mismatches = [name for name in first
                  if first[name].numpy().tobytes() != second[name].numpy().tobytes()]
    return mismatches, len(first)


# -- the audits ------------------------------------------------------------------------


@dataclass
class ReproAuditReport:
    label: str
    findings: list = field(default_factory=list)
    record: dict = field(default_factory=dict)
    key_flow: Optional[KeyFlow] = None
    nondet: list = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def _key_record(flow: KeyFlow) -> dict:
    return {"random_consumers": int(flow.n_consumers), "key_creations": int(flow.n_creations),
            "key_derivations": int(flow.n_derivations)}


def audit_train_repro(step_fn: Callable, args: tuple, *, state=None, allow: Sequence = (),
                      label: str = "step") -> ReproAuditReport:
    """RKT901 + RKT902 + RKT903 over one train step ``step_fn(*args)``;
    ``state`` (default ``args[0]``) is the tree a checkpoint carries (not
    a dict: no resume to prove)."""
    report = ReproAuditReport(label=label)
    tracer, record, _ = trace_program(step_fn, *args)
    flow = analyze_key_provenance(record, tracer)
    report.key_flow, report.nondet = flow, list(tracer.nondet)
    findings = check_key_reuse(flow.consumptions, flow.unfolded, label=label)
    findings += check_nondet_ops(tracer.nondet, allow=allow, label=label)
    fresh = program_fingerprint(tracer.ops)
    state = args[0] if state is None else state
    restored_fp = _restored_fingerprint(step_fn, args, state) if isinstance(state, dict) \
        else None
    findings += check_resume_identity(fresh, restored_fp, label=label)
    report.record = {"program_fingerprint": fresh, "nondet_ops": len(tracer.nondet),
                     **_key_record(flow)}
    report.findings = findings
    return report


def audit_serve_repro(model, serve_config, *, allow: Sequence = (),
                      waves_list: Sequence[int] = (1, 2, 4),
                      label: str = "serve") -> ReproAuditReport:
    """RKT904 (one wave body for every k) and RKT901/902 on the decode
    dispatch the engine runs (at the configuration's own k)."""
    report = ReproAuditReport(label=label)
    fingerprints, traced = prove_wave_invariance(model, serve_config, waves_list=waves_list)
    findings = check_wave_invariance(fingerprints, label=label)
    _spec, _mb, _nb, waves = serve_config.resolve(model.config)
    probe = int(waves) if int(waves) in traced else max(traced)
    tracer, record = traced[probe]
    flow = analyze_key_provenance(record, tracer)
    report.key_flow, report.nondet = flow, list(tracer.nondet)
    findings += check_key_reuse(flow.consumptions, flow.unfolded, label=label)
    findings += check_nondet_ops(tracer.nondet, allow=allow, label=label)
    report.record = {"program_fingerprint": fingerprints[min(fingerprints)],
                     "waves_checked": sorted(fingerprints), "nondet_ops": len(tracer.nondet),
                     **_key_record(flow)}
    report.findings = findings
    return report


def audit_sentinel_repro(label: str = "gpt2_sentinel") -> ReproAuditReport:
    """RKT905, the run, plus the sentinel step's key walk and fingerprint."""
    report = ReproAuditReport(label=label)
    tracer, record, _ = trace_program(_sentinel_step())
    flow = analyze_key_provenance(record, tracer)
    report.key_flow = flow
    findings = check_key_reuse(flow.consumptions, flow.unfolded, label=label)
    try:
        mismatches, n = run_replay_sentinel()
        executed = True
    except (RuntimeError, ValueError):
        mismatches, n, executed = [], 0, False
    findings += check_replay_sentinel(mismatches, executed=executed, label=label)
    report.record = {"program_fingerprint": program_fingerprint(tracer.ops),
                     "replay_leaves_checked": int(n), **_key_record(flow)}
    report.findings = findings
    return report


# -- the targets -----------------------------------------------------------------------


@dataclass(frozen=True)
class ReproTarget:
    """One configuration the CLI audits. ``kind``: ``train`` (key walk,
    order-free sums, resume identity; ``build() -> (step, args)``),
    ``serve`` (the wave proof; ``build() -> (model, serve config)``),
    ``exec`` (the replay sentinel). ``allow``: reviewed ``(site, op,
    reason)`` entries for RKT902."""

    name: str
    kind: str
    build: Callable[[], tuple]
    allow: Tuple[tuple, ...] = ()
    demo: bool = False
    doc: str = ""


#: The reviewed sites, each with its reason (the reference's allowlists,
#: restated for CUDA where the reference's reason does not carry over).
#:
#: The next-token loss's gather backward: one scattered index per row,
#: provably unique, so no two terms meet.
_XENT_GRAD_ALLOW = (
    ("rocket_tpu_torch/models/transformer.py:_chunk_nll", "aten::scatter_add",
     "one index per (batch, position) row: unique, no two terms meet"),
    ("rocket_tpu_torch/models/transformer.py:_chunk_nll", "aten::scatter_add_",
     "one index per (batch, position) row: unique, no two terms meet"),
)
#: The embedding gradients. The reference allows them for a fixed combine
#: order on the CPU and TPU, which says nothing of CUDA. On CUDA an
#: accumulating index_put sorts its indices (a stable radix sort) and sums
#: each row's duplicates in that order: a fixed order, the form torch
#: itself switches index_add and scatter_add to under deterministic mode.
#: The dense embedding backward (``F.embedding``) is not allowed anywhere:
#: on the card two runs of one MoE step differed in it (PERF.md §6).
#: chip_smoke's repro phase holds these reasons to a byte-equal replay.
_EMBED_GRAD_ALLOW = (
    ("rocket_tpu_torch/nn/layers.py:apply", "aten::index_put",
     "the token embedding's gradient: CUDA sorts the ids and sums each row in that order"),
    ("rocket_tpu_torch/nn/layers.py:apply", "aten::index_put_",
     "the token embedding's gradient: CUDA sorts the ids and sums each row in that order"),
    ("rocket_tpu_torch/parallel/collectives.py:_scatter_rows", "aten::index_put_",
     "the vocab shard's gradient: CUDA sorts the ids and sums each row in that order"),
)


def _moe_allow(k: int) -> tuple:
    """The MoE combine's index_adds, allowed only where each token takes
    exactly two expert rows: two nonzero terms added onto +0 in either
    order give one result, and the gather-GMM's pad rows add zeros (their
    cotangents are zero: their outputs are never gathered back), which
    change nothing. A larger k could differ in its last bit. The routed
    rows' and gates' gathers are indexing, whose backward sorts."""
    sorted_ids = "CUDA sorts the ids and sums each row's terms in that order"
    rows = (("rocket_tpu_torch/nn/moe.py:_dropless_matmuls", "aten::index_put",
             "the routed rows' gather backward: " + sorted_ids),
            ("rocket_tpu_torch/nn/moe.py:_apply_dropless", "aten::index_put",
             "the sorted gates' gather backward (a permutation): " + sorted_ids))
    if k != 2:
        return rows
    reason = "k = 2: two nonzero rows onto +0 commute exactly; pad rows add zeros"
    return rows + (("rocket_tpu_torch/nn/moe.py:_apply_dropless", "aten::index_add", reason),
                   ("rocket_tpu_torch/ops/gather_gmm.py:backward", "aten::index_add_", reason))


#: The serve wave's nucleus cutoff: a cumsum over each slot's sorted
#: probabilities. Torch names a float cumsum nondeterministic on CUDA; a
#: last-bit difference moves the cutoff only for a token whose cumulative
#: mass ties top_p to that bit. Accepted as a reviewed risk (ROADMAP Queue
#: C 7), not proven fixed-order.
_TOP_P_ALLOW = (
    ("rocket_tpu_torch/models/sampling.py:_top_p", "aten::cumsum",
     "reviewed risk: the top-p cutoff moves only on a last-bit tie with top_p"),
)


def _sched_builder(name: str):
    def build():
        from rocket_tpu_torch.analysis import sched_audit

        return getattr(sched_audit, name)()
    return build


@contextlib.contextmanager
def _env(**values):
    previous = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in previous.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _resnet_parts():
    """``sched_audit``'s ResNet-18 data-parallel step, traced with cuDNN's
    deterministic algorithms on, as the card's ResNet slice runs it."""
    from rocket_tpu_torch.analysis.sched_audit import _dp_resnet_parts

    step, args = _dp_resnet_parts()

    def deterministic_step(*a):
        cudnn = torch.backends.cudnn
        previous, cudnn.deterministic = cudnn.deterministic, True
        try:
            return step(*a)
        finally:
            cudnn.deterministic = previous

    return deterministic_step, args


def _moe_parts():
    """The RNG-heavy target: the audit LM with a dropless top-2 MoE of 4
    experts (gelu), dropout 0.1 in every block, the gather-GMM forced
    fused (the card's main path: rows 11, gmm and tgmm, and both
    index_adds), keyed as the Module keys its step 0, ``fold_in(key(0),
    0)``, with the whole-forward remat (its recompute replays the masks)."""
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _train_parts
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss

    model = TransformerLM(_lm_config(num_experts=4, expert_top_k=2, mlp="gelu", dropout=0.1,
                                     expert_dispatch="dropless"))
    tokens = torch.zeros((16, model.config.max_seq_len), dtype=torch.int32, device="meta")
    step, args = _train_parts(model, {"tokens": tokens}, loss_fn=next_token_loss(),
                              remat=True)

    def moe_step(*a):
        with _env(ROCKET_TPU_MOE_GMM="fused"):
            return step(*a)

    moe_step.top_k = model.config.expert_top_k
    return moe_step, args


def _badrepro_parts():
    """The seeded-bad step: one key drawn by two draws (RKT901 reuse), a
    loop body drawing the same unfolded key every iteration (RKT901
    unfolded), and a float index_add over duplicate-capable ids (RKT902)."""
    from rocket_tpu_torch.nn import keys

    meta = torch.device("meta")
    w = torch.empty(64, 64, device=meta, requires_grad=True)
    emb = torch.empty(32, 64, device=meta)
    x = torch.empty(8, 64, device=meta)
    idx = torch.empty(8, dtype=torch.int64, device=meta)

    def bad_step(w, emb, x, idx):
        key = keys.key(0)
        noise_a = keys.uniform(key, (8, 64), x.device)            # draw 1
        noise_b = keys.bernoulli(key, 0.5, (8, 64), x.device)     # draw 2: the same key
        loop_key = keys.key(1)
        acc = torch.zeros((), device=x.device)
        for _ in range(4):
            # The unfolded loop key: every iteration draws the same eps.
            acc = acc + keys.uniform(loop_key, (64,), x.device).sum()
        h = (x + noise_a * noise_b) @ w
        emb = emb.index_add(0, idx % 32, h * 1e-3)               # duplicate ids, f32
        return (h * h).mean() + (emb * emb).mean() + acc * 0.0

    return bad_step, (w, emb, x, idx)


#: name -> target; the default sweep runs the non-demo ones.
REPRO_TARGETS: dict = {target.name: target for target in (
    ReproTarget("tp_1x8", "train", _sched_builder("_tp_1x8_parts"),
                allow=_XENT_GRAD_ALLOW + _EMBED_GRAD_ALLOW,
                doc="audit LM train step, one rank of model 8"),
    ReproTarget("fsdp_1x8", "train", _sched_builder("_fsdp_1x8_parts"),
                allow=_XENT_GRAD_ALLOW + _EMBED_GRAD_ALLOW,
                doc="audit LM train step, one rank of 8 FSDP ranks"),
    ReproTarget("dp_resnet_1x8", "train", _resnet_parts, allow=_XENT_GRAD_ALLOW,
                doc="ResNet-18 CIFAR train step with sync-BN, one rank of 8"),
    ReproTarget("moe", "train", _moe_parts,
                allow=_XENT_GRAD_ALLOW + _EMBED_GRAD_ALLOW + _moe_allow(2),
                doc="audit LM with a dropless top-2 MoE (forced fused), dropout 0.1"),
    ReproTarget("charlm_wave", "serve", _charlm_serve_parts, allow=_TOP_P_ALLOW,
                doc="char-LM decode dispatch at k in {1, 2, 4}"),
    ReproTarget("gpt2_sentinel", "exec", lambda: (), doc="the audit LM's step run twice "
                "on the CPU"),
    ReproTarget("badrepro", "train", _badrepro_parts, demo=True,
                doc="seeded-bad: a reused key, an unfolded loop key, an index_add"),
)}


def run_repro_target(target: ReproTarget) -> ReproAuditReport:
    if target.kind == "serve":
        model, serve_config = target.build()
        return audit_serve_repro(model, serve_config, allow=target.allow, label=target.name)
    if target.kind == "exec":
        return audit_sentinel_repro(label=target.name)
    step, args = target.build()
    return audit_train_repro(step, args, allow=target.allow, label=target.name)


def render_repro(label: str, record: Mapping) -> str:
    """One line of a target's determinism record."""
    extra = (f", waves {record['waves_checked']}" if "waves_checked" in record else
             f", {record['replay_leaves_checked']} outputs replayed"
             if "replay_leaves_checked" in record else "")
    return (f"{label}: program {record['program_fingerprint']}, {record['random_consumers']} "
            f"draws from {record['key_creations']} keys and {record['key_derivations']} "
            f"folds, {record.get('nondet_ops', 0)} order-free sums{extra}")


_WARN_RE = re.compile(r"^(\S+?) does not have a deterministic implementation")


def warned_ops(messages: Sequence[str]) -> tuple:
    """Split the warnings ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` raised into ``(op names, cuBLAS count)``: the first
    word of each "does not have a deterministic implementation" warning,
    and the number of cuBLAS workspace warnings (every GEMM without
    ``CUBLAS_WORKSPACE_CONFIG``)."""
    names, cublas = [], 0
    for text in messages:
        if "CuBLAS" in text or "CUBLAS_WORKSPACE_CONFIG" in text:
            cublas += 1
            continue
        found = _WARN_RE.match(text.strip())
        if found:
            names.append(found.group(1))
    return sorted(set(names)), cublas


def _stem(name: str) -> str:
    """An op's name with its namespace, overload and backend suffixes cut:
    ``aten::scatter_add_`` and ``scatter_add_cuda_kernel`` both give
    ``scatter_add``."""
    name = name.removeprefix("aten::").split(".")[0]
    for suffix in ("_out_cuda_template", "_cuda_template", "_cuda_kernel", "_cuda_", "_cuda",
                   "_kernel", "_out"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name.rstrip("_")


def explained(warned: Sequence[str], nondet: Sequence[tuple]) -> list:
    """The warned op names that no traced order-free op accounts for (an
    audit finding or a reviewed site alike): empty when the audit saw
    every op torch warned about."""
    seen = {_stem(op) for op, _site, _detail in nondet}
    return [name for name in warned if _stem(name) not in seen and not any(
        _stem(name).startswith(s) or s.startswith(_stem(name)) for s in seen)]
