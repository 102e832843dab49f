"""The offline search loop: sweep legal configs, time them with the build
excluded, reject numerical-parity failures, persist winners (counterpart of
``rocket_tpu/tune/tuner.py``).

``python -m rocket_tpu_torch.tune`` drives this on the card. Per
:class:`TuneCase` (a kernel at one representative shape):

1. every LEGAL config of the kernel's TuneSpace is enumerated
   (``TuneSpace.candidates``; illegal configs are never run);
2. the DEFAULT config runs first, passed explicitly, with every table
   lookup disabled for the whole sweep: its outputs are the parity
   reference and its time the speedup denominator;
3. each candidate runs once and is parity-checked against the default's
   outputs (forward outputs and gradients) within the dtype tolerance —
   **a faster wrong kernel is a rejected candidate**, never timed — then
   warmed up and timed over ``iters`` calls between two CUDA events;
4. the best surviving candidate becomes a table entry only when its
   speedup over the default reaches ``min_speedup`` (default 2%).

Every kernel is built before any case runs (``ops/_build.build``, all in
parallel), so no timing includes ``nvcc``.

The flash cases time rows 6-7 through ``ops/flash_attention.
flash_attention_qkv``. The reference's flash cases time ``flash_native``,
its fast TPU path; the port's ``flash_native`` kernels compile one tile
(``TILE = 64``), so they have nothing to sweep, and join the flash cases
once they compile more than one. The reference's GQA ``longctx`` flash
cases and its ``decode`` / ``bn`` cases are left out: the stacked-qkv
kernels take h_kv == h only, and the port's decode and BN-moment spaces
have one value each.

On the CPU every wrapper runs its plain version, so timings mean nothing:
``--allow-cpu`` runs the small ``smoke`` cases to exercise the loop and
never writes a table.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from rocket_tpu_torch.tune.space import TUNE_SPACES
from rocket_tpu_torch.tune.table import _local_kind, tuning_disabled, write_table
from rocket_tpu_torch.utils.perf import device_spec

__all__ = [
    "TuneCase", "CandidateResult", "CaseReport", "TUNE_CASES", "check_parity",
    "sweep_case", "run_cases", "entries_from_reports", "update_tables", "load_cases",
]

#: Parity tolerance per dtype: |tuned - default| <= atol + rtol * |default|,
#: element by element over every output (forward outputs AND gradients). A
#: kernel whose variants reassociate f32 sums widens its own bound
#: (``TuneSpace.parity_tol``).
_PARITY_TOL = {
    "bfloat16": (2e-2, 2e-2),
    "float16": (2e-2, 2e-2),
    "float32": (1e-5, 1e-5),
}


@dataclass(frozen=True)
class TuneCase:
    """One kernel at one representative shape. ``build(device)`` makes the
    operands (numpy-seeded) on ``device`` (``"cuda"`` or ``"cpu"``) and
    returns ``run(config) -> outputs``, which runs the kernel under the
    explicit ``config``; the outputs (a tensor or nested tuples of them)
    are both the parity surface and the timing payload."""

    name: str
    kernel: str
    shape: Mapping
    dtype: str
    build: Callable[[str], Callable[[Optional[dict]], object]]
    #: small enough to run through the plain versions on the CPU
    smoke: bool = False


@dataclass
class CandidateResult:
    config: dict
    mean_us: Optional[float] = None
    parity_ok: bool = True
    max_err: float = 0.0
    error: Optional[str] = None


@dataclass
class CaseReport:
    case: TuneCase
    device_kind: str
    default_config: dict = field(default_factory=dict)
    default_us: Optional[float] = None
    results: list = field(default_factory=list)
    winner: Optional[CandidateResult] = None

    @property
    def speedup(self) -> Optional[float]:
        if self.winner is None or not self.winner.mean_us or not self.default_us:
            return None
        return self.default_us / self.winner.mean_us


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _time_run(fn, iters: int, device: str) -> float:
    """Mean microseconds per call after two warm-up calls: CUDA events
    around ``iters`` calls on the card, the host clock on the CPU."""
    fn()
    fn()
    if device != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def check_parity(reference, candidate, dtype: str,
                 tol: Optional[tuple] = None) -> tuple[bool, float]:
    """Elementwise parity of every output within the dtype tolerance (or an
    explicit ``(atol, rtol)``). Returns ``(ok, max_scaled_err)`` with the
    error ``max |a - b| / (atol + rtol * |a|)`` (<= 1 passes); a non-finite
    candidate always fails."""
    atol, rtol = tol or _PARITY_TOL.get(dtype, (1e-5, 1e-5))
    ref_leaves, cand_leaves = _leaves(reference), _leaves(candidate)
    if len(ref_leaves) != len(cand_leaves):
        return False, math.inf
    worst = 0.0
    for a, b in zip(ref_leaves, cand_leaves):
        a, b = _as_numpy(a), _as_numpy(b)
        if a.shape != b.shape or not np.all(np.isfinite(b)):
            return False, math.inf
        err = np.abs(a - b) / (atol + rtol * np.abs(a))
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst <= 1.0, worst


def _check_device(device: str, where: str) -> str:
    """``device`` as given, when it is ``"cuda"`` with a card present or an
    explicit ``"cpu"``; raise otherwise (no silent fall back to the CPU,
    whose timings are no card's)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"{where}: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{where}: device='cuda' but no CUDA device is present; pass "
                           "device='cpu' to run the plain versions explicitly")
    return device


def sweep_case(case: TuneCase, *, device: str, iters: int = 20, min_speedup: float = 1.02,
               device_kind: Optional[str] = None,
               log: Callable[[str], None] = lambda s: None) -> CaseReport:
    """The whole search for one case on ``device`` (``"cuda"``, or ``"cpu"``
    named explicitly), table-blind (:func:`tuning_disabled`): the baseline is
    the TuneSpace default passed explicitly, and no run resolves anything
    through an existing entry."""
    _check_device(device, "sweep_case")
    kind = device_kind or _local_kind()
    report = CaseReport(case=case, device_kind=kind)
    with tuning_disabled():
        return _sweep_blind(case, TUNE_SPACES[case.kernel], device_spec(kind), report,
                            device=device, iters=iters, min_speedup=min_speedup, log=log)


def _sweep_blind(case, space, spec, report, *, device, iters, min_speedup, log):
    run = case.build(device)
    default = space.default(case.shape)
    report.default_config = default
    reference = run(default)
    _sync(device)
    report.default_us = _time_run(lambda: run(default), iters, device)
    log(f"{case.name}: default {default} -> {report.default_us:.1f} us")

    best: Optional[CandidateResult] = None
    for config in space.candidates(case.shape, spec, case.dtype):
        if config == default:
            continue
        result = CandidateResult(config=config)
        report.results.append(result)
        try:
            out = run(config)
            _sync(device)
            result.parity_ok, result.max_err = check_parity(
                reference, out, case.dtype, tol=space.parity_tol.get(case.dtype))
            del out
            if not result.parity_ok:
                log(f"{case.name}: {config} REJECTED (parity err={result.max_err:.3g})")
                continue
            result.mean_us = _time_run(lambda: run(config), iters, device)
            log(f"{case.name}: {config} -> {result.mean_us:.1f} us")
        except Exception as exc:  # noqa: BLE001 — a candidate that fails to run
            # is not a winner; the sweep goes on.
            result.error = f"{type(exc).__name__}: {exc}"[:300]
            result.parity_ok = False
            log(f"{case.name}: {config} FAILED ({result.error[:80]})")
            continue
        if result.mean_us and (best is None or result.mean_us < best.mean_us):
            best = result

    if best is not None and report.default_us / best.mean_us >= min_speedup:
        report.winner = best
        log(f"{case.name}: winner {best.config} ({report.default_us / best.mean_us:.3f}x)")
    else:
        log(f"{case.name}: no candidate beat the default by >= "
            f"{(min_speedup - 1) * 100:.0f}% — no table entry")
    return report


def entries_from_reports(reports) -> dict[str, list]:
    """kernel -> table entries for every winning report."""
    entries: dict[str, list] = {}
    for report in reports:
        if report.winner is None:
            continue
        space = TUNE_SPACES[report.case.kernel]
        entries.setdefault(report.case.kernel, []).append({
            "device_kind": report.device_kind,
            "dtype": report.case.dtype,
            "shape": dict(report.case.shape),
            "shape_bucket": space.bucket(report.case.shape),
            "config": dict(report.winner.config),
            "default_config": dict(report.default_config),
            "default_us": round(report.default_us, 3),
            "tuned_us": round(report.winner.mean_us, 3),
            "speedup": round(report.speedup, 4),
            "parity_max_err": round(report.winner.max_err, 6),
            "case": report.case.name,
        })
    return entries


def update_tables(reports, configs_dir: Optional[str] = None) -> list:
    """Write winning entries into the per-kernel tables. Existing entries
    for other (device, bucket, dtype) keys survive; a swept key without a
    winner loses its old entry. Returns the paths."""
    from rocket_tpu_torch.tune.table import load_table

    new = entries_from_reports(reports)
    swept: dict[str, set] = {}
    for report in reports:
        space = TUNE_SPACES[report.case.kernel]
        swept.setdefault(report.case.kernel, set()).add(
            (report.device_kind, space.bucket(report.case.shape), report.case.dtype))
    paths = []
    for kernel, keys in swept.items():
        table = load_table(kernel, configs_dir, use_cache=False)
        kept = [entry for entry in (table or {}).get("entries", [])
                if (entry.get("device_kind"), entry.get("shape_bucket"), entry.get("dtype"))
                not in keys]
        paths.append(write_table(kernel, kept + new.get(kernel, []), configs_dir))
    return paths


# -- the builtin case catalog -------------------------------------------------
#
# The reference's shapes (the bench configurations), synthetic operands
# from numpy seeds: parity is candidate vs default on the SAME operands.


def _normal(rng, shape, scale, dtype, device):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)
    return x.to(device=device, dtype=getattr(torch, dtype))


def _flash_case(name, kernel, b, t, h, d, dtype, smoke=False):
    """flash_fwd: the forward at the candidate's blocks; flash_bwd: the
    gradient of ``sum(out**2)`` with the candidate's backward blocks (the
    forward at the default's), as the reference's cases."""
    shape = {"t": t, "d": d, "h": h, "h_kv": h, "causal": True}

    def build(device):
        from rocket_tpu_torch.ops.flash_attention import flash_attention_qkv

        qkv = _normal(np.random.default_rng(0 if kernel == "flash_fwd" else 1),
                      (3, b, h, t, d), 0.2, dtype, device)

        def run(config):
            if kernel == "flash_fwd":
                return flash_attention_qkv(qkv, causal=True, block_q=config["block_q"],
                                           block_k=config["block_k"])
            x = qkv.detach().requires_grad_()
            out = flash_attention_qkv(x, causal=True, bwd_block_q=config["block_q"],
                                      bwd_block_k=config["block_k"])
            return torch.autograd.grad(out.float().square().sum(), x)[0]

        return run

    return TuneCase(name=name, kernel=kernel, shape=shape, dtype=dtype, build=build, smoke=smoke)


def _paged_case(name, s, mb, bl, hkv, hq, d, dtype, smoke=False):
    """paged_decode at a serve-engine decode wave (C = 1, every slot live
    mid-context) against a pool sized as ``ServeConfig`` sizes it: impl
    'pallas' (the CUDA kernel) vs 'xla' (the gather path)."""
    shape = {"s": s, "mb": mb, "bl": bl, "hkv": hkv, "hq": hq, "d": d}

    def build(device):
        from rocket_tpu_torch.ops.paged_attention import paged_attention

        rng = np.random.default_rng(5)
        nb = 1 + s * mb
        q = _normal(rng, (s, 1, hq, d), 0.2, dtype, device)
        k_new = _normal(rng, (s, 1, hkv, d), 0.2, dtype, device)
        k_pages = _normal(rng, (nb, bl, hkv, d), 0.2, dtype, device)
        v_new, v_pages = k_new * 0.5, k_pages * 0.5
        table = torch.from_numpy(1 + np.arange(s * mb, dtype=np.int32).reshape(s, mb))
        positions = torch.tensor([(mb * bl) // 2 + i * (bl // 2) for i in range(s)],
                                 dtype=torch.int32)
        valid = torch.ones((s,), dtype=torch.int32)
        table, positions, valid = (x.to(device) for x in (table, positions, valid))

        def run(config):
            # Writing the same rows at the same positions again leaves the
            # pool as it was, so every call sees the same operands.
            return paged_attention(q, k_new, v_new, k_pages, v_pages, table, positions, valid,
                                   impl=config["impl"])[0]

        return run

    return TuneCase(name=name, kernel="paged_decode", shape=shape, dtype=dtype, build=build,
                    smoke=smoke)


def _gmm_case(name, m, k, n, e, dtype, routed=True):
    """moe_gmm at the dropless dispatch's shape, both gmm cases: ``routed``
    gathers the rows in a fixed random order (the in-projection: impl 'gmm'
    times the explicit gather plus the grouped GEMM, 'fused' gather-GMM);
    without it the rows are contiguous (the out-projection: 'gmm' times no
    gather, 'fused' still pays its own). Uniform groups of m / e rows, a
    tile multiple for every candidate."""
    shape = {"m": m, "k": k, "n": n}

    def build(device):
        from rocket_tpu_torch.ops.gather_gmm import gather_gmm
        from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

        rng = np.random.default_rng(3)
        x = _normal(rng, (m, k), 0.1, dtype, device)
        rhs = _normal(rng, (e, k, n), 0.1, dtype, device)
        sizes = torch.full((e,), m // e, dtype=torch.int32, device=device)
        ids = torch.from_numpy((rng.permutation(m) if routed else np.arange(m))
                               .astype(np.int32)).to(device)

        def run(config):
            if config["impl"] == "fused":
                return gather_gmm(x, rhs, ids, sizes, tile_m=config["tile_m"],
                                  tile_n=min(512, n))
            return grouped_matmul(x[ids.long()] if routed else x, rhs, sizes)

        return run

    return TuneCase(name=name, kernel="moe_gmm", shape=shape, dtype=dtype, build=build)


def _fused_conv_case(name, b, hw, c, dtype, smoke=False):
    """fused_conv at a conv-stack activation: forward and backward of the
    BN(+relu) epilogue — impl 'reference' (the plain chain) is the parity
    baseline and the speedup denominator."""
    shape = {"n": b * hw * hw, "c": c}

    def build(device):
        from rocket_tpu_torch.ops.fused_conv import fused_bn_act, reference_bn_act

        x0 = _normal(np.random.default_rng(6), (b, hw, hw, c), 1.0, dtype, device) + 0.5
        scale0 = torch.full((c,), 1.5, device=device)
        bias0 = torch.zeros((c,), device=device)

        def run(config):
            x, scale, bias = (t.detach().requires_grad_() for t in (x0, scale0, bias0))
            if config["impl"] == "pallas":
                y, stats = fused_bn_act(x, scale, bias, eps=1e-5, act=True,
                                        schedule=config["schedule"],
                                        block_rows=config["block_rows"])
            else:
                y, stats = reference_bn_act(x, scale, bias, 1e-5, True)
            loss = y.float().square().sum()
            return (loss.detach(), stats.detach(), torch.autograd.grad(loss, (x, scale, bias)))

        return run

    return TuneCase(name=name, kernel="fused_conv", shape=shape, dtype=dtype, build=build,
                    smoke=smoke)


def _block_attn_case(name, b, t, d, h, dtype, smoke=False):
    """block_attn at a small-LM block shape: forward and backward of the
    attention half — impl 'reference' (the per-op chain) is the baseline;
    the 'separate' epilogue gets the projection applied outside, so every
    candidate has the same output."""
    shape = {"b": b, "t": t, "d": d, "h": h}

    def build(device):
        from rocket_tpu_torch.ops.fused_block import block_attn_half, reference_block_attn

        rng = np.random.default_rng(7)
        f32 = "float32"
        x0 = _normal(rng, (b, t, d), 0.5, dtype, device)
        ln_s = 1.0 + _normal(rng, (d,), 0.1, f32, device)
        ln_b = _normal(rng, (d,), 0.1, f32, device)
        wqkv0 = _normal(rng, (d, 3 * d), d ** -0.5, f32, device)
        bqkv = torch.zeros((3 * d,), device=device)
        wproj0 = _normal(rng, (d, d), d ** -0.5, f32, device)
        bproj = torch.zeros((d,), device=device)

        def run(config):
            x, wqkv, wproj = (w.detach().requires_grad_() for w in (x0, wqkv0, wproj0))
            if config["impl"] == "fused":
                y = block_attn_half(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, num_heads=h,
                                    epilogue=config["epilogue"], block_b=config["block_b"])
                if config["epilogue"] == "separate":
                    y = y @ wproj.to(y.dtype) + bproj.to(y.dtype)
            else:
                y = reference_block_attn(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, num_heads=h,
                                         epilogue="fused")
            loss = y.float().square().sum()
            return (loss.detach(), *torch.autograd.grad(loss, (x, wqkv, wproj)))

        return run

    return TuneCase(name=name, kernel="block_attn", shape=shape, dtype=dtype, build=build,
                    smoke=smoke)


def _builtin_cases() -> list:
    bf16, f32 = "bfloat16", "float32"
    return [
        _flash_case("flash_fwd/gpt2", "flash_fwd", b=8, t=1024, h=12, d=64, dtype=bf16),
        _flash_case("flash_fwd/charlm", "flash_fwd", b=64, t=256, h=4, d=64, dtype=bf16),
        _flash_case("flash_bwd/gpt2", "flash_bwd", b=8, t=1024, h=12, d=64, dtype=bf16),
        _flash_case("flash_bwd/charlm", "flash_bwd", b=64, t=256, h=4, d=64, dtype=bf16),
        _paged_case("paged/charlm", s=8, mb=16, bl=16, hkv=4, hq=4, d=64, dtype=bf16),
        _paged_case("paged/gpt2_geom", s=8, mb=16, bl=32, hkv=4, hq=12, d=64, dtype=bf16),
        _gmm_case("gmm/moe_bench", m=16384, k=768, n=3072, e=4, dtype=bf16),
        _gmm_case("gmm/moe_bench_out", m=16384, k=3072, n=768, e=4, dtype=bf16, routed=False),
        _fused_conv_case("fused_conv/resnet18", b=256, hw=32, c=64, dtype=bf16),
        _fused_conv_case("fused_conv/resnet50", b=128, hw=56, c=64, dtype=bf16),
        _block_attn_case("block_attn/charlm", b=64, t=256, d=256, h=4, dtype=bf16),
        # The smoke subset: small enough for the plain versions on the CPU.
        _flash_case("flash_fwd/smoke", "flash_fwd", b=2, t=256, h=2, d=64, dtype=bf16,
                    smoke=True),
        _flash_case("flash_bwd/smoke", "flash_bwd", b=1, t=256, h=2, d=64, dtype=bf16,
                    smoke=True),
        _paged_case("paged/smoke", s=2, mb=2, bl=16, hkv=2, hq=2, d=16, dtype=f32, smoke=True),
        _fused_conv_case("fused_conv/smoke", b=8, hw=8, c=16, dtype=f32, smoke=True),
        _block_attn_case("block_attn/smoke", b=4, t=64, d=128, h=2, dtype=f32, smoke=True),
    ]


#: name -> case, filled on first use.
TUNE_CASES: dict[str, TuneCase] = {}


def load_cases() -> dict[str, TuneCase]:
    if not TUNE_CASES:
        for case in _builtin_cases():
            TUNE_CASES[case.name] = case
    return TUNE_CASES


def run_cases(names=None, kernels=None, *, device: str, iters: int = 20,
              min_speedup: float = 1.02, smoke_only: bool = False,
              log: Callable[[str], None] = lambda s: None) -> list:
    """Sweep the selected builtin cases on ``device``: ``"cuda"``, which
    raises without a card, or ``"cpu"``, named explicitly (the plain
    versions; their timings are the CPU's). On the card every kernel is
    built first, so no case times ``nvcc``."""
    _check_device(device, "run_cases")
    selected = [case for name, case in load_cases().items()
                if (not names or name in names) and (not kernels or case.kernel in kernels)
                and case.smoke == smoke_only]
    if selected and device == "cuda":
        from rocket_tpu_torch.ops import _build

        _build.build()
    reports = []
    for case in selected:
        try:
            reports.append(sweep_case(case, device=device, iters=iters, min_speedup=min_speedup,
                                      log=log))
        except Exception as exc:  # noqa: BLE001 — one broken case must not stop the rest
            log(f"{case.name}: case failed entirely — {type(exc).__name__}: {exc}")
        if device == "cuda":
            torch.cuda.empty_cache()
    return reports
