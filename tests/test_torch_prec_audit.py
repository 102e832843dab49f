"""The port's precision audit (``rocket_tpu_torch/analysis/prec_audit.py``,
RKT401-406) against the reference's (``rocket_tpu/analysis/prec_audit.py``).

Each unit case of ``tests/test_prec_audit.py`` has a counterpart here: the
same construction written once in JAX and once in torch (meta tensors),
both audited, the same verdict asserted of both (the rule ids, and the
words of the message the reference's test reads where the port names the
same thing). Where torch has no such construct the port's form is stated
beside the case: a bf16 GEMM's accumulator is cuBLAS's (f32, its split-K
partials reduced in bf16 under ``allow_bf16_reduced_precision_reduction``,
which each case sets), a grouped product's a hand kernel's declared one, a
bf16 sum a chain of adds, a call boundary ``torch.utils.checkpoint``, a
``lax.cond`` a ``torch.where``, a collective the meta route of
``parallel.collectives.collective``. Then the budgets, the targets (every
non-demo target clean in both packages, the same count of certified
collectives), the demo's five ids, and the launch declarations the audit
reads (every kernel of every schedule target declares an f32 accumulator;
the schedule audit refuses an undeclared one).
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.analysis import prec_audit as ref
from rocket_tpu.analysis.budgets import PREC_GATED_KEYS as REF_PREC_KEYS
from rocket_tpu_torch.analysis import budgets
from rocket_tpu_torch.analysis import prec_audit as port
from rocket_tpu_torch.analysis.sched_audit import SCHED_TARGETS, audit_schedule, run_sched_target
from rocket_tpu_torch.ops import _launch

torch.set_num_threads(1)

META = torch.device("meta")
BF16, F32 = torch.bfloat16, torch.float32
REF_BUDGETS = Path(__file__).parent / "fixtures" / "budgets" / "prec"


def sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


def rules_in(findings):
    return sorted({f.rule for f in findings})


def ref_vars(**params):
    return {"params": dict(params), "state": {}}


def port_vars(**params):
    return {"params": dict(params), "state": {}}


@contextlib.contextmanager
def reduced_reduction(on: bool):
    """cuBLAS's bf16 split-K reduction flag, as the card would run the step."""
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = on
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = previous


def both(ref_step, ref_args, port_step, port_args, **kw):
    """Audit one construction in both packages: ``(reference, port)`` reports."""
    return (ref.audit_precision(ref_step, *ref_args, **kw),
            port.audit_precision(port_step, *port_args,
                                 **{k: (getattr(torch, str(jnp.dtype(v))) if k == "compute_dtype"
                                        and v is not None else v) for k, v in kw.items()}))


def _psum(t, n=8):
    from rocket_tpu_torch.parallel.collectives import collective

    out = torch.empty_like(t)
    collective("all_reduce", None, (t,), (out,), 2 * (n - 1) / n * t.numel() * 4, n, "d")
    return out


def _ref_psum(w):
    from jax.sharding import PartitionSpec as P

    from rocket_tpu.utils.compat import shard_map

    mesh = jax.sharding.Mesh(jax.devices()[:8], ("d",))
    return shard_map(lambda w: jax.lax.psum(w, "d"), mesh=mesh, in_specs=(P(),), out_specs=P(),
                     check_vma=False)(w)


# -- RKT401: low-precision accumulation ------------------------------------------------


def test_large_bf16_matmul_fires():
    def ref_step(vs, batch):
        return batch["x"] @ vs["params"]["w"].astype(jnp.bfloat16)

    def port_step(vs, batch):
        return batch["x"] @ vs["params"]["w"].to(BF16)

    with reduced_reduction(True):
        r, p = both(ref_step, (ref_vars(w=sds((4096, 64), jnp.float32)),
                               {"x": sds((4, 4096), jnp.bfloat16)}),
                    port_step, (port_vars(w=meta(4096, 64)), {"x": meta(4, 4096, dtype=BF16)}),
                    check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT401"]
    for report in (r, p):
        assert "4096-long contraction" in report.findings[0].message
        assert "params/w" in report.findings[0].message


def test_fp32_accumulated_or_small_matmuls_clean():
    """The port declares f32 accumulation of a bf16 GEMM by turning cuBLAS's
    reduced-precision split-K reduction off; a sub-threshold bf16 GEMM is
    the convention either way."""
    def ref_step(vs, batch):
        big = jnp.einsum("bk,kn->bn", batch["x"], vs["params"]["w"].astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        small = batch["xs"] @ vs["params"]["w_small"].astype(jnp.bfloat16)
        return big.sum() + small.sum()

    def port_step(vs, batch):
        big = batch["x"] @ vs["params"]["w"].to(BF16)
        small = batch["xs"] @ vs["params"]["w_small"].to(BF16)
        return big.float().sum() + small.float().sum()

    with reduced_reduction(False):
        r, p = both(ref_step, (ref_vars(w=sds((4096, 64), jnp.float32),
                                        w_small=sds((256, 64), jnp.float32)),
                               {"x": sds((4, 4096), jnp.bfloat16),
                                "xs": sds((4, 256), jnp.bfloat16)}),
                    port_step, (port_vars(w=meta(4096, 64), w_small=meta(256, 64)),
                                {"x": meta(4, 4096, dtype=BF16), "xs": meta(4, 256, dtype=BF16)}),
                    check_state=False)
    assert r.findings == [] and p.findings == []
    with reduced_reduction(True):   # the small one stays clean under the flag too
        small = port.audit_precision(lambda vs, b: b["xs"] @ vs["params"]["w"].to(BF16),
                                     port_vars(w=meta(256, 64)), {"xs": meta(4, 256, dtype=BF16)},
                                     check_state=False)
    assert small.findings == []


def _gmm_fact(acc):
    fact = _launch.LaunchFact("gmm", (132, 1, 1), 384, 0, 0)
    return _launch.with_work(fact, 0, 0, BF16, acc=acc)


def test_ragged_dot_fires_at_any_size_unless_fp32():
    """A grouped product: the reference's ragged_dot, the port's hand
    kernel, whose fact declares its accumulator (bf16 seeded; the real gmm
    wrapper declares f32)."""
    from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

    def ref_bad(vs, batch):
        return jax.lax.ragged_dot(batch["x"], vs["params"]["w"].astype(jnp.bfloat16),
                                  batch["sizes"], preferred_element_type=jnp.bfloat16)

    def ref_good(vs, batch):
        return jax.lax.ragged_dot(batch["x"], vs["params"]["w"].astype(jnp.bfloat16),
                                  batch["sizes"], preferred_element_type=jnp.float32
                                  ).astype(jnp.bfloat16)

    def port_bad(vs, batch):
        out = meta(128, 128, dtype=BF16)
        _launch.record([_gmm_fact(BF16)], (batch["x"],), (out,))
        return out

    def port_good(vs, batch):
        return grouped_matmul(batch["x"], vs["params"]["w"].to(BF16), batch["sizes"])

    # The kernel's shapes: K and N in 128s.
    ref_args = (ref_vars(w=sds((4, 128, 128), jnp.float32)),
                {"x": sds((128, 128), jnp.bfloat16), "sizes": sds((4,), jnp.int32)})
    port_args = (port_vars(w=meta(4, 128, 128)),
                 {"x": meta(128, 128, dtype=BF16), "sizes": meta(4, dtype=torch.int32)})
    r, p = both(ref_bad, ref_args, port_bad, port_args, check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT401"]
    assert all("grouped partial sums" in x.findings[0].message for x in (r, p))
    r, p = both(ref_good, ref_args, port_good, port_args, check_state=False)
    assert r.findings == [] and p.findings == []
    assert [d.acc_dtype for d in p.flow.dots if d.prim == "gmm"] == ["float32"]


def test_large_bf16_reduction_fires_small_or_fp32_clean():
    """A sum that runs in bf16: the reference's raw monoid reduce, the
    port's chain of bf16 adds (torch's own reductions accumulate in f32)."""
    import numpy as onp

    def ref_bad(vs, batch):
        return jax.lax.reduce(batch["big"], onp.array(0, jnp.bfloat16), jax.lax.add, (1,))

    def port_bad(vs, batch):
        acc = batch["big"][:, 0].clone()
        for i in range(1, batch["big"].shape[1]):
            acc.add_(batch["big"][:, i])
        return acc

    def ref_good(vs, batch):
        return (jnp.sum(batch["big"].astype(jnp.float32), axis=-1)
                + jnp.sum(batch["small"], axis=-1).astype(jnp.float32))

    def port_good(vs, batch):
        return batch["big"].float().sum(-1) + batch["small"].sum(-1).float()

    ref_args = ({}, {"big": sds((4, 8192), jnp.bfloat16), "small": sds((4, 128), jnp.bfloat16)})
    port_args = ({}, {"big": meta(4, 8192, dtype=BF16), "small": meta(4, 128, dtype=BF16)})
    r, p = both(ref_bad, ref_args, port_bad, port_args, check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT401"]
    assert all("8192 elements" in x.findings[0].message for x in (r, p))
    r, p = both(ref_good, ref_args, port_good, port_args, check_state=False)
    assert r.findings == [] and p.findings == []


# -- RKT402: sub-f32 transcendentals ---------------------------------------------------


def test_bf16_softmax_fires_fp32_softmax_clean():
    args = ({}, {"x": sds((4, 128), jnp.bfloat16)}), ({}, {"x": meta(4, 128, dtype=BF16)})
    r, p = both(lambda vs, b: jax.nn.softmax(b["x"], axis=-1), args[0],
                lambda vs, b: torch.softmax(b["x"], dim=-1), args[1], check_state=False)
    assert "RKT402" in rules_in(r.findings) and rules_in(p.findings) == ["RKT402"]
    assert "exp" in r.findings[0].message and "_softmax" in p.findings[0].message
    r, p = both(lambda vs, b: jax.nn.softmax(b["x"].astype(jnp.float32), axis=-1
                                             ).astype(b["x"].dtype), args[0],
                lambda vs, b: torch.softmax(b["x"].float(), dim=-1).to(b["x"].dtype), args[1],
                check_state=False)
    assert r.findings == [] and p.findings == []


def test_bounded_activations_stay_exempt():
    r, p = both(lambda vs, b: jax.nn.gelu(b["x"]) + jax.nn.silu(b["x"]),
                ({}, {"x": sds((4, 128), jnp.bfloat16)}),
                lambda vs, b: torch.nn.functional.gelu(b["x"]) + torch.nn.functional.silu(b["x"]),
                ({}, {"x": meta(4, 128, dtype=BF16)}), check_state=False)
    assert r.findings == [] and p.findings == []


# -- RKT403: state narrowing + collective operands -------------------------------------


def test_state_narrowed_on_exit_fires():
    ref_args = ({"params": {"w": sds((8, 8), jnp.float32)},
                 "state": {"ema": sds((8, 8), jnp.float32)}}, {"x": sds((4, 8), jnp.float32)})
    port_args = ({"params": {"w": meta(8, 8)}, "state": {"ema": meta(8, 8)}}, {"x": meta(4, 8)})

    def ref_bad(vs, batch):
        return {"params": vs["params"], "state": {
            "ema": (0.9 * vs["state"]["ema"]).astype(jnp.bfloat16)}}, 0.0

    def port_bad(vs, batch):
        return {"params": vs["params"], "state": {"ema": (0.9 * vs["state"]["ema"]).to(BF16)}}, 0.0

    r, p = both(ref_bad, ref_args, port_bad, port_args)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT403"]
    assert all("state/ema" in x.findings[0].message for x in (r, p))

    def ref_good(vs, batch):
        ema = 0.9 * vs["state"]["ema"] + 0.1 * jnp.sum(batch["x"])
        return {"params": vs["params"], "state": {"ema": ema}}, 0.0

    def port_good(vs, batch):
        ema = 0.9 * vs["state"]["ema"] + 0.1 * batch["x"].sum()
        return {"params": vs["params"], "state": {"ema": ema}}, 0.0

    r, p = both(ref_good, ref_args, port_good, port_args)
    assert r.findings == [] and p.findings == []


def test_state_narrowed_in_place_fires():
    """The port's in-place form of the same fault: a state leaf overwritten
    (``copy_``) with a value rounded to bf16 keeps its f32 dtype and loses
    its bits all the same."""
    args = ({"params": {"w": meta(8, 8)}, "state": {"ema": meta(8, 8)}}, {"x": meta(4, 8)})

    def bad(vs, batch):
        vs["state"]["ema"].copy_((0.9 * vs["state"]["ema"]).to(BF16))
        return vs["params"]["w"].sum()

    def good(vs, batch):
        vs["state"]["ema"].mul_(0.9).add_(batch["x"].sum() * 0.1)
        return vs["params"]["w"].sum()

    findings = port.audit_precision(bad, *args).findings
    assert rules_in(findings) == ["RKT403"] and "state/ema" in findings[0].message
    assert port.audit_precision(good, *args).findings == []


def test_collective_operand_narrowed_from_param_fires():
    ref_args = (ref_vars(w=sds((8, 8), jnp.float32)), {"x": sds((8, 8), jnp.float32)})
    port_args = (port_vars(w=meta(8, 8)), {"x": meta(8, 8)})
    r, p = both(lambda vs, b: _ref_psum(vs["params"]["w"].astype(jnp.bfloat16)), ref_args,
                lambda vs, b: _psum(vs["params"]["w"].to(BF16)), port_args, check_state=False)
    assert "RKT403" in rules_in(r.findings) and rules_in(p.findings) == ["RKT403"]
    assert "psum" in r.findings[0].message and "all_reduce" in p.findings[0].message
    r, p = both(lambda vs, b: _ref_psum(vs["params"]["w"]), ref_args,
                lambda vs, b: _psum(vs["params"]["w"]), port_args, check_state=False)
    assert r.findings == [] and p.findings == []


# -- RKT404: cast churn ----------------------------------------------------------------


def test_widen_narrow_roundtrip_fires_even_through_reshape():
    args = ({}, {"x": sds((4, 64), jnp.bfloat16)}), ({}, {"x": meta(4, 64, dtype=BF16)})
    r, p = both(lambda vs, b: b["x"].astype(jnp.float32).astype(jnp.bfloat16).sum(), args[0],
                lambda vs, b: b["x"].float().to(BF16).float().sum(), args[1], check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT404"]
    assert r.record["cast_churn"] == p.record["cast_churn"] == 1
    r, p = both(lambda vs, b: b["x"].astype(jnp.float32).reshape(8, 32).astype(jnp.bfloat16).sum(),
                args[0], lambda vs, b: b["x"].float().reshape(8, 32).to(BF16).float().sum(),
                args[1], check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT404"]


def test_work_inside_widened_window_is_not_churn():
    def ref_good(vs, b):
        wide = b["x"].astype(jnp.float32)
        return (wide - jnp.mean(wide, axis=-1, keepdims=True)).astype(jnp.bfloat16).sum()

    def port_good(vs, b):
        wide = b["x"].float()
        return (wide - wide.mean(-1, keepdim=True)).to(BF16).float().sum()

    r, p = both(ref_good, ({}, {"x": sds((4, 64), jnp.bfloat16)}),
                port_good, ({}, {"x": meta(4, 64, dtype=BF16)}), check_state=False)
    assert r.findings == [] and p.findings == []
    assert r.record["cast_churn"] == p.record["cast_churn"] == 0


# -- RKT405: params never cast at use --------------------------------------------------


def test_uncast_fp32_param_in_declared_bf16_step_fires():
    ref_args = (ref_vars(w=sds((512, 512), jnp.float32)), {"x": sds((4, 512), jnp.float32)})
    port_args = (port_vars(w=meta(512, 512)), {"x": meta(4, 512)})
    r, p = both(lambda vs, b: b["x"] @ vs["params"]["w"], ref_args,
                lambda vs, b: b["x"] @ vs["params"]["w"], port_args,
                compute_dtype=jnp.bfloat16, check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT405"]
    assert all("params/w" in x.findings[0].message for x in (r, p))
    r, p = both(lambda vs, b: b["x"] @ vs["params"]["w"], ref_args,
                lambda vs, b: b["x"] @ vs["params"]["w"], port_args, check_state=False)
    assert r.findings == [] and p.findings == []


def test_cast_at_use_island_and_small_params_exempt():
    def ref_good(vs, batch):
        p = vs["params"]
        y = batch["x"] @ p["w"].astype(batch["x"].dtype)
        r = batch["x"].astype(jnp.float32) @ p["w_island"]
        return (y * p["scale"].astype(y.dtype)).sum() + r.sum()

    def port_good(vs, batch):
        p = vs["params"]
        y = batch["x"] @ p["w"].to(batch["x"].dtype)
        r = batch["x"].float() @ p["w_island"]
        return (y * p["scale"].to(y.dtype)).float().sum() + r.sum()

    r, p = both(ref_good, (ref_vars(w=sds((512, 512), jnp.float32),
                                    w_island=sds((512, 512), jnp.float32),
                                    scale=sds((512,), jnp.float32)),
                           {"x": sds((4, 512), jnp.bfloat16)}),
                port_good, (port_vars(w=meta(512, 512), w_island=meta(512, 512),
                                      scale=meta(512)), {"x": meta(4, 512, dtype=BF16)}),
                compute_dtype=jnp.bfloat16, check_state=False)
    assert r.findings == [] and p.findings == []


def test_fp32_island_widened_inside_scan_stays_exempt():
    """The island survives a loop boundary: the reference's scan ys, the
    port's per-iteration widened rows stacked."""
    def ref_step(vs, batch):
        _, wide = jax.lax.scan(lambda c, x: (c, x.astype(jnp.float32)), jnp.zeros(()),
                               batch["x"])
        return (wide.reshape(-1, 512) @ vs["params"]["w"]).sum()

    def port_step(vs, batch):
        wide = torch.stack([x.float() for x in batch["x"]])
        return (wide.reshape(-1, 512) @ vs["params"]["w"]).sum()

    r, p = both(ref_step, (ref_vars(w=sds((512, 512), jnp.float32)),
                           {"x": sds((4, 4, 512), jnp.bfloat16)}),
                port_step, (port_vars(w=meta(512, 512)), {"x": meta(4, 4, 512, dtype=BF16)}),
                compute_dtype=jnp.bfloat16, check_state=False)
    assert r.findings == [] and p.findings == []


def test_provenance_threads_through_pjit():
    """A call boundary: the reference's jit, the port's checkpoint."""
    from torch.utils.checkpoint import checkpoint

    def ref_bad(vs, batch):
        return jax.jit(lambda w, x: x @ w)(vs["params"]["w"], batch["x"])

    def port_bad(vs, batch):
        return checkpoint(lambda w, x: x @ w, vs["params"]["w"], batch["x"], use_reentrant=False)

    r, p = both(ref_bad, (ref_vars(w=sds((512, 512), jnp.float32)),
                          {"x": sds((4, 512), jnp.float32)}),
                port_bad, (port_vars(w=meta(512, 512)), {"x": meta(4, 512)}),
                compute_dtype=jnp.bfloat16, check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT405"]


def test_cond_narrowing_survives_identity_branch():
    """A bf16 round trip on one side of a select must not hide behind the
    identity side: the reference's cond branches, the port's where."""
    def ref_bad(vs, batch):
        w = jax.lax.cond(batch["flag"], lambda w: w,
                         lambda w: w.astype(jnp.bfloat16).astype(jnp.float32), vs["params"]["w"])
        return _ref_psum(w)

    def port_bad(vs, batch):
        w = vs["params"]["w"]
        return _psum(torch.where(batch["flag"], w, w.to(BF16).float()))

    r, p = both(ref_bad, (ref_vars(w=sds((8, 8), jnp.float32)), {"flag": sds((), jnp.bool_)}),
                port_bad, (port_vars(w=meta(8, 8)), {"flag": meta(dtype=torch.bool)}),
                check_state=False)
    assert "RKT403" in rules_in(r.findings) and "RKT403" in rules_in(p.findings)


# -- suppression parity ----------------------------------------------------------------


def test_step_function_directive_suppresses_rule():
    def ref_step(vs, batch):
        # rocketlint: disable=RKT402 — demonstration: bf16 softmax waived
        probs = jax.nn.softmax(batch["x"], axis=-1)
        return jnp.sum(batch["x"].astype(jnp.float32).astype(jnp.bfloat16)) + probs.sum()

    def port_step(vs, batch):
        # rocketlint: disable=RKT402 — demonstration: bf16 softmax waived
        probs = torch.softmax(batch["x"], dim=-1)
        return batch["x"].float().to(BF16).float().sum() + probs.float().sum()

    r, p = both(ref_step, ({}, {"x": sds((4, 128), jnp.bfloat16)}),
                port_step, ({}, {"x": meta(4, 128, dtype=BF16)}), check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT404"]


# -- RKT406: numerics budgets ----------------------------------------------------------


def prec_record(fraction=0.5, widen=10, narrow=12):
    return {"fp32_bytes_fraction": fraction, "widen_casts": widen, "narrow_casts": narrow,
            "cast_churn": 0}


def test_prec_budget_diff_gates_fraction_and_casts(tmp_path):
    assert budgets.PREC_GATED_KEYS == REF_PREC_KEYS
    budgets.write_budget(str(tmp_path), "t", prec_record())
    committed = budgets.load_budget(str(tmp_path), "t")

    def diff(measured):
        return budgets.diff_budget("t", committed, measured, keys=budgets.PREC_GATED_KEYS,
                                   rule="RKT406", family="prec")

    assert diff(prec_record(0.54, 11, 13)) == []
    findings = diff(prec_record(0.58, 10, 12))
    assert rules_in(findings) == ["RKT406"] and "fp32_bytes_fraction" in findings[0].message
    assert findings[0].path == "<prec:t>"
    assert "widen_casts" in diff(prec_record(0.5, 14, 12))[0].message
    assert diff(prec_record(0.1, 2, 3)) == []


def test_prec_budget_missing_names_prec_cli():
    findings = budgets.diff_budget("absent", None, prec_record(), keys=budgets.PREC_GATED_KEYS,
                                   rule="RKT406", family="prec")
    assert rules_in(findings) == ["RKT406"] and "prec" in findings[0].message


# -- the targets -----------------------------------------------------------------------


def test_tp_target_is_clean_and_records_numerics():
    report = port.run_prec_target(port.PREC_TARGETS["tp_2x4"])
    assert report.findings == [], [f.render() for f in report.findings]
    assert 0.0 < report.record["fp32_bytes_fraction"] < 1.0
    assert report.record["narrow_casts"] > 0 and report.record["cast_churn"] == 0


@pytest.mark.parametrize("name", [n for n, t in port.PREC_TARGETS.items() if not t.demo])
def test_all_builtin_self_gate_targets_are_clean(name):
    """Each non-demo target is clean in both packages, and certifies as many
    low-precision collectives as the reference's committed record: the
    vocab-parallel lookup's table under tensor parallelism, the FSDP
    gradient wire."""
    report = port.run_prec_target(port.PREC_TARGETS[name])
    assert report.findings == [], [f.render() for f in report.findings]
    assert report.record["float_value_bytes"] > 0
    reference = ref.run_prec_target(ref.PREC_TARGETS[name])
    assert reference.findings == []
    committed = json.loads((REF_BUDGETS / f"{name}.json").read_text())
    assert report.record["certified_collectives"] == committed["certified_collectives"] == \
        reference.record["certified_collectives"]
    assert report.flow.collectives, "the certified wire was not seen"


def test_badprec_target_reports_all_five_families():
    want = ["RKT401", "RKT402", "RKT403", "RKT404", "RKT405"]
    assert rules_in(ref.run_prec_target(ref.PREC_TARGETS["badprec"]).findings) == want
    report = port.run_prec_target(port.PREC_TARGETS["badprec"])
    assert rules_in(report.findings) == want
    assert [f.rule for f in report.findings] == want   # one of each


def test_collect_dtype_flow_exposes_facts():
    flow, in_dtypes, _out = port.collect_dtype_flow(
        lambda vs, b: b["x"] @ vs["params"]["w"].to(BF16), port_vars(w=meta(256, 64)),
        {"x": meta(4, 256, dtype=BF16)})
    ref_flow, ref_in, _ = ref.collect_dtype_flow(
        lambda vs, b: b["x"] @ vs["params"]["w"].astype(jnp.bfloat16),
        ref_vars(w=sds((256, 64), jnp.float32)), {"x": sds((4, 256), jnp.bfloat16)})
    assert len(flow.dots) == len(ref_flow.dots) == 1
    assert flow.dots[0].contract_size == ref_flow.dots[0].contract_size == 256
    assert flow.dots[0].param_path == ref_flow.dots[0].param_path == ("params", "w")
    assert in_dtypes[("params", "w")] == "float32" and ref_in[("params", "w")] == jnp.float32
    assert flow.narrow_casts == ref_flow.narrow_casts == 1
    assert set(flow.reduced_precision_reduction) == {"bf16", "fp16"}


# -- RKT403 certification --------------------------------------------------------------


def _lowprec_parts():
    def ref_step(vs, batch):
        return _ref_psum(vs["params"]["w"].astype(jnp.bfloat16))

    def port_step(vs, batch):
        return _psum(vs["params"]["w"].to(BF16))

    return (ref_step, (ref_vars(w=sds((8, 8), jnp.float32)), {"x": sds((8, 8), jnp.float32)}),
            port_step, (port_vars(w=meta(8, 8)), {"x": meta(8, 8)}))


def test_certified_collective_passes_and_counts():
    ref_step, ref_args, port_step, port_args = _lowprec_parts()
    r = ref.audit_precision(ref.certify_collectives("params/w")(ref_step), *ref_args,
                            check_state=False)
    p = port.audit_precision(port.certify_collectives("params/w")(port_step), *port_args,
                             check_state=False)
    assert r.findings == [] and p.findings == []
    assert r.record["certified_collectives"] == p.record["certified_collectives"] == 1


def test_certification_kwarg_matches_decorator():
    ref_step, ref_args, port_step, port_args = _lowprec_parts()
    r, p = both(ref_step, ref_args, port_step, port_args, check_state=False,
                certified_collectives=("params/*",))
    assert r.findings == [] and p.findings == []


def test_uncertified_collective_still_fires_with_hint():
    r, p = both(*_lowprec_parts(), check_state=False)
    assert rules_in(r.findings) == rules_in(p.findings) == ["RKT403"]
    assert all("certify_collectives" in x.findings[0].message for x in (r, p))


def test_overlapping_certifications_both_count_as_used():
    ref_step, ref_args, port_step, port_args = _lowprec_parts()
    r = ref.audit_precision(ref.certify_collectives("params/*", "params/w")(ref_step), *ref_args,
                            check_state=False)
    p = port.audit_precision(port.certify_collectives("params/*", "params/w")(port_step),
                             *port_args, check_state=False)
    assert r.findings == [] and p.findings == []


def test_stale_certification_is_a_finding():
    ref_step, ref_args, port_step, port_args = _lowprec_parts()
    r = ref.audit_precision(ref.certify_collectives("params/w", "params/no_such_param")(ref_step),
                            *ref_args, check_state=False)
    p = port.audit_precision(
        port.certify_collectives("params/w", "params/no_such_param")(port_step), *port_args,
        check_state=False)
    for report in (r, p):
        assert rules_in(report.findings) == ["RKT403"]
        assert "no_such_param" in report.findings[0].message
        assert "matched no" in report.findings[0].message


# -- the hand kernels' declared accumulators -------------------------------------------


def test_every_schedule_target_kernel_declares_f32_accumulation():
    """Every launch of every schedule target (demos included: row 12 too)
    declares its accumulator and a fixed summation order."""
    names = set()
    for target in SCHED_TARGETS.values():
        for fact in run_sched_target(target).launches:
            names.add(fact.name)
            assert (fact.acc_dtype, fact.acc_order) == ("float32", "fixed"), fact.name
    assert {"flash_fwd", "flash_bwd", "flash_dq", "flash_qkv_fwd", "flash_qkv_bwd",
            "fused_block", "bn_twopass", "bn_normalize", "gather_gmm", "gmm", "tgmm",
            "paged_decode", "paged_decode_combine", "decode_attention",
            "decode_attention_combine", "bad_scale"} <= names


def test_an_undeclared_launch_fails_the_schedule_audit():
    def step(x):
        out = torch.empty_like(x)
        _launch.record([_launch.LaunchFact("k", (1, 1, 1), 128, 0, 0)], (x,), (out,))
        return out

    report = audit_schedule(step, meta(64, 64))
    assert [f.rule for f in report.findings] == ["RKT504"]
    assert "declares no accumulation dtype" in report.findings[0].message
    with pytest.raises(ValueError):
        _launch.with_work(_launch.LaunchFact("k", (1, 1, 1), 128, 0, 0), 0, 0, F32, acc=F32,
                          order="racy")


def test_the_audit_records_the_cublas_flag_as_set():
    step = port.PREC_TARGETS["badprec"]
    with reduced_reduction(False):
        step_fn, variables, batch, _ = port._badprec_parts()
        report = port.audit_precision(step_fn, variables, batch, compute_dtype=BF16)
    # Without the flag, the 4096-long bf16 GEMM accumulates in f32.
    assert "RKT401" not in rules_in(report.findings)
    assert report.record["bf16_reduced_precision_reduction"] is False
    assert rules_in(port.run_prec_target(step).findings)[0] == "RKT401"
    assert np.isfinite(report.record["fp32_bytes_fraction"])
