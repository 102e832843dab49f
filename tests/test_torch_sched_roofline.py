"""The schedule audit's roofline legs (``rocket_tpu_torch/analysis/
sched_audit.py``, ``rules/sched_rules.py``) against the reference.

* ``simulate`` (both modes) and ``_simulate_dataflow`` equal the
  reference's on the same hand-built ``OpCost`` lists, within 1e-12
  relative;
* RKT501-503 and RKT505 report what the reference's ``check_*`` report on
  the same facts;
* the budgets' ``diff_budget`` (RKT506's gate) agrees with the reference's;
* GPT-2 124M's priced step: its block matmuls' FLOPs equal the closed form
  (forward 2*N*tokens, backward twice that, the remat once more), its flash
  launches the kernels' count, at full width on meta tensors;
* the hand kernels' ``LaunchFact`` work equals PERF.md's bound formulas at
  two shapes a row; the collectives' meta route records what the card
  would count, with no process group;
* the demos report exactly the reference's rule ids; every other target is
  clean and states its prediction; ``sched`` exits 0 against the
  committed ``tests/fixtures/torch_budgets/sched/``.

Inputs are drawn from numpy seeds; torch runs on one thread.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rocket_tpu.analysis import budgets as ref_budgets
from rocket_tpu.analysis.rules import sched_rules as ref_rules
from rocket_tpu.analysis.sched_audit import OpCost as RefOpCost
from rocket_tpu.analysis.sched_audit import _simulate_dataflow as ref_dataflow
from rocket_tpu.analysis.sched_audit import simulate as ref_simulate
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis import budgets
from rocket_tpu_torch.analysis.rules import sched_rules
from rocket_tpu_torch.analysis.sched_audit import (
    SCHED_TARGETS,
    OpCost,
    _gpt2_parts,
    _simulate_dataflow,
    run_sched_target,
    simulate,
    trace_step,
)
from rocket_tpu_torch.ops import _launch
from rocket_tpu_torch.ops import decode_attention as da
from rocket_tpu_torch.ops import flash_attention as fqa
from rocket_tpu_torch.ops import flash_native as fa
from rocket_tpu_torch.ops import fused_block as fb
from rocket_tpu_torch.ops import fused_conv as fc
from rocket_tpu_torch.ops import grouped_matmul as gm
from rocket_tpu_torch.ops import paged_attention as pa
from rocket_tpu_torch.utils.perf import device_spec

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
COMM_OPCODES = ("all-reduce", "all-gather-start", "all-to-all", "collective-permute",
                "all-reduce-start")


def _random_ops(seed: int, n: int = 60) -> list:
    """A random DAG of op fields: compute, memory and free ops, sync and
    async collectives (each ``-start`` followed later by its ``-done``),
    point-to-point hops, operands among the earlier ops."""
    rng = np.random.default_rng(seed)
    ops, open_starts = [], []
    for i in range(n):
        name = f"op{i}"
        k = int(rng.integers(0, min(i, 3) + 1))
        operands = tuple(f"op{j}" for j in sorted(set(rng.integers(0, i, k).tolist()))) if i \
            else ()
        draw = rng.random()
        if open_starts and draw < 0.1:
            start = open_starts.pop(0)
            ops.append(dict(name=name, opcode=start[1].replace("-start", "-done"), kind="comm",
                            time_s=0.0, flops=0.0, hbm_bytes=0, comm_bytes=0, is_comm=True,
                            operands=(start[0],)))
            continue
        if draw < 0.35:
            opcode = COMM_OPCODES[int(rng.integers(0, len(COMM_OPCODES)))]
            if opcode.endswith("-start"):
                open_starts.append((name, opcode))
            nbytes = int(rng.integers(1, 1 << 22))
            ops.append(dict(name=name, opcode=opcode, kind="comm",
                            time_s=float(rng.uniform(1e-6, 5e-5)), flops=0.0, hbm_bytes=nbytes,
                            comm_bytes=nbytes, is_comm=True, operands=operands))
        elif draw < 0.45:
            ops.append(dict(name=name, opcode="aten::view", kind="free", time_s=0.0, flops=0.0,
                            hbm_bytes=0, comm_bytes=0, is_comm=False, operands=operands))
        else:
            kind = "compute" if rng.random() < 0.5 else "memory"
            nbytes = int(rng.integers(1, 1 << 24))
            ops.append(dict(name=name, opcode="aten::mm" if kind == "compute" else "aten::add",
                            kind=kind, time_s=float(rng.uniform(1e-7, 1e-4)),
                            flops=float(rng.uniform(0, 1e9)), hbm_bytes=nbytes, comm_bytes=0,
                            is_comm=False, operands=operands))
    return ops


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-18)


SIM_FIELDS = ("makespan_s", "compute_bound_s", "memory_bound_s", "comm_total_s",
              "exposed_comm_s", "stall_s")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("overlap", [False, True])
def test_simulate_equals_the_reference(seed, overlap):
    fields = _random_ops(seed)
    port = simulate([OpCost(**f) for f in fields], overlap=overlap)
    ref = ref_simulate([RefOpCost(**f) for f in fields], overlap=overlap)
    for name in SIM_FIELDS:
        assert _close(getattr(port, name), getattr(ref, name)), (name, seed)
    assert port.makespan_s > 0


@pytest.mark.parametrize("seed", range(3))
def test_dataflow_pass_equals_the_reference(seed):
    fields = _random_ops(100 + seed, n=80)
    port = _simulate_dataflow([OpCost(**f) for f in fields])
    ref = ref_dataflow([RefOpCost(**f) for f in fields])
    for name in SIM_FIELDS:
        assert _close(getattr(port, name), getattr(ref, name)), (name, seed)


def _rules(mod, fields, cost, *, ridge, floor, mfu, **kw):
    if mod is ref_rules:
        ops = [RefOpCost(**f) for f in fields]
        sim, ideal = ref_simulate(ops, overlap=False), ref_simulate(ops, overlap=True)
    else:
        ops = [cost(**f) for f in fields]
        sim, ideal = simulate(ops, overlap=False), simulate(ops, overlap=True)
    findings = mod.check_exposed_comm(sim, ideal, exposed_frac_min=kw["frac"],
                                      exposed_min_s=kw["min_s"], label="t")
    findings += mod.check_convoys(sim.ops, convoy_min=kw["convoy"], bucket_bytes=kw["bucket"],
                                  label="t")
    findings += mod.check_memory_bound(sim.ops, sim.makespan_s, ridge,
                                       memory_frac_max=kw["mem"], min_bytes=1 << 20, label="t")
    findings += mod.check_mfu_floor(mfu, floor, label="t")
    return findings


@pytest.mark.parametrize("seed", range(8))
def test_roofline_rules_report_what_the_reference_reports(seed):
    rng = np.random.default_rng(1000 + seed)
    fields = _random_ops(seed + 7, n=50)
    kw = dict(frac=float(rng.uniform(0.0, 0.3)), min_s=float(rng.uniform(0, 3e-5)),
              convoy=int(rng.integers(2, 6)), bucket=int(rng.integers(1 << 18, 1 << 23)),
              mem=float(rng.uniform(0.05, 0.8)))
    mfu, floor = float(rng.uniform(0, 0.5)), float(rng.uniform(0, 0.5))
    ridge = device_spec(H100).ridge
    port = _rules(sched_rules, fields, OpCost, ridge=ridge, floor=floor, mfu=mfu, **kw)
    ref = _rules(ref_rules, fields, None, ridge=ridge, floor=floor, mfu=mfu, **kw)
    assert [f.rule for f in port] == [f.rule for f in ref]
    assert [f.path for f in port] == [f.path for f in ref]
    # RKT501, RKT502 and RKT505 word their figures as the reference does.
    for p, r in zip(port, ref):
        if p.rule in ("RKT501", "RKT502"):
            assert p.message.split(" — ")[0] == r.message.split(" — ")[0]


def test_the_catalog_holds_rkt501_to_rkt506():
    ids = [rule for rule, _, _ in sched_rules.SCHED_RULES]
    assert ids == [rule for rule, _, _ in ref_rules.SCHED_RULES]


@pytest.mark.parametrize("case", [
    ({"predicted_step_time_us": 100.0, "exposed_comm_us": 10.0},
     {"predicted_step_time_us": 111.0, "exposed_comm_us": 10.0}),
    ({"predicted_step_time_us": 100.0, "exposed_comm_us": 0.0},
     {"predicted_step_time_us": 100.0, "exposed_comm_us": 1.0}),
    ({"predicted_step_time_us": 100.0, "exposed_comm_us": 5.0},
     {"predicted_step_time_us": 90.0, "exposed_comm_us": 5.4}),
    (None, {"predicted_step_time_us": 1.0, "exposed_comm_us": 1.0}),
    ({"abs_calib_error": 0.5, "unjoined_fraction": 0.1},
     {"abs_calib_error": 0.56, "unjoined_fraction": 0.2}),
])
def test_diff_budget_equals_the_reference(case):
    committed, measured = case
    for keys, rule, family in ((budgets.SCHED_GATED_KEYS, "RKT506", "sched"),
                               (budgets.CALIB_GATED_KEYS, "RKT701", "calib")):
        port = budgets.diff_budget("t", committed, measured, keys=keys, rule=rule,
                                   family=family)
        ref = ref_budgets.diff_budget("t", committed, measured, keys=keys, rule=rule,
                                      family=family)
        assert [(f.rule, f.path) for f in port] == [(f.rule, f.path) for f in ref]
        assert [f.message.replace("rocket_tpu_torch", "rocket_tpu") for f in port] == \
            [f.message for f in ref]
    assert budgets.TOLERANCE == ref_budgets.TOLERANCE
    assert budgets.SCHED_GATED_KEYS == ref_budgets.SCHED_GATED_KEYS
    assert budgets.CALIB_GATED_KEYS == ref_budgets.CALIB_GATED_KEYS


def test_budget_files_round_trip(tmp_path):
    record = {"predicted_step_time_us": 12.5, "exposed_comm_us": 0.0, "n_ops": 3}
    path = budgets.write_budget(str(tmp_path), "x", record)
    assert path.endswith("x.json") and budgets.load_budget(str(tmp_path), "x") == record
    assert budgets.load_budget(str(tmp_path), "missing") is None


# -- the traced steps -------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt2_trace():
    step, args = _gpt2_parts(1024)
    return trace_step(step, *args, device_kind=H100)


def test_gpt2_priced_matmul_flops_equal_the_closed_form(gpt2_trace):
    """GPT-2 124M, B=8, T=1024: the 12 layers' four projections (N = 12 d^2
    a layer) cost 2*N*tokens forward, twice that backward and once more
    under the whole-forward remat; the flash kernels' work is the kernels'
    count (forward twice a layer, backward once)."""
    layers, d, b, t, heads = 12, 768, 8, 1024, 12
    tokens = b * t
    blocks = sum(op.flops for op in gpt2_trace.ops if op.opcode == "aten::mm")
    assert blocks == (1 + 2 + 1) * 2 * tokens * 12 * layers * d * d
    pairs = b * heads * t * (t + 1) / 2
    fwd = [op for op in gpt2_trace.ops if op.opcode == "flash_fwd"]
    bwd = [op for op in gpt2_trace.ops if op.opcode == "flash_bwd"]
    assert len(fwd) == 2 * layers and len(bwd) == layers
    assert sum(op.flops for op in fwd) == 2 * layers * 4 * 64 * pairs
    assert sum(op.flops for op in bwd) == layers * 10 * 64 * pairs
    # AdamW's foreach passes and the flash kernels are priced; views are not.
    opcodes = {op.opcode for op in gpt2_trace.ops}
    assert "aten::_foreach_addcdiv_" in opcodes and "aten::view" not in opcodes
    assert all(op.nbytes > 0 for op in gpt2_trace.ops)


def _h100(dtype):
    return {torch.bfloat16: 989e12, torch.float32: 67e12}[dtype]


# PERF.md section 6's bound formulas, written out independently of the
# declarations: (bytes, flops) per row at its shapes.
def _flash_formula(kind, b, t, hq, hkv, d, item, causal, with_dq=True):
    qkv, act, stats = b * t * (hq + 2 * hkv) * d * item, b * t * hq * d * item, b * hq * t * 4
    pairs = b * hq * (t * (t + 1) / 2 if causal else t * t)
    dkv = 2 * b * t * hkv * d * item
    return {"flash_fwd": (qkv + act + stats, 4 * d * pairs),
            "flash_bwd": (qkv + 2 * act + 2 * stats + dkv if with_dq
                          else qkv + act + 2 * stats + dkv, (10 if with_dq else 8) * d * pairs),
            "flash_dq": (qkv + 2 * act + 2 * stats, 6 * d * pairs)}[kind]


@pytest.mark.parametrize("shape", [(8, 1024, 12, 12, 64, torch.bfloat16, True),
                                   (128, 256, 8, 4, 32, torch.float32, False)])
@pytest.mark.parametrize("kind", ["flash_fwd", "flash_bwd", "flash_dq"])
def test_flash_launch_work_equals_the_bound_formula(kind, shape):
    b, t, hq, hkv, d, dtype, causal = shape
    fact = fa.flash_launch(kind, b, t, hq, hkv, d, dtype, hq * d, hkv * d, causal=causal)
    item = 2 if dtype == torch.bfloat16 else 4
    assert (fact.bytes, fact.flops) == _flash_formula(kind, b, t, hq, hkv, d, item, causal)
    assert fact.flop_dtype == str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape", [(8, 12, 1024, 64, torch.bfloat16, True, 128),
                                   (2, 4, 512, 32, torch.float32, False, 64)])
def test_qkv_and_block_and_bn_work_equal_the_bound_formulas(shape):
    b, h, t, d, dtype, causal, bk = shape
    item = 2 if dtype == torch.bfloat16 else 4
    act, stats = b * h * t * d * item, b * h * t * 4
    pairs = b * h * (t * (t + 1) / 2 if causal else t * t)
    fwd = fqa.qkv_launch("fwd", b, h, t, d, dtype, bk, bk, causal)
    bwd = fqa.qkv_launch("bwd", b, h, t, d, dtype, bk, bk, causal)
    assert (fwd.bytes, fwd.flops) == (4 * act + stats, 4 * d * pairs)
    assert (bwd.bytes, bwd.flops) == (4 * act + 2 * stats + (t // bk) * act + 2 * act,
                                      10 * d * pairs)
    # Row 8 at the char-LM shape (and a ragged one), both epilogues.
    for bb, tt, dd, hh, ep in ((128, 256, 256, 4, "fused"), (3, 100, 256, 4, "separate")):
        fact = fb.fused_block_launch(bb, tt, dd, hh, dtype, ep)
        weights = (dd * 3 * dd + 3 * dd) * item + 2 * dd * 4 + ((dd * dd + dd) * item
                                                               if ep == "fused" else 0)
        flops = 2 * bb * tt * dd * 3 * dd + 2 * 2 * 64 * hh * bb * tt * (tt + 1) / 2 + (
            2 * bb * tt * dd * dd if ep == "fused" else 0)
        assert (fact.bytes, fact.flops) == (2 * bb * tt * dd * item + weights, flops)
    # Rows 9-10 at two ResNet-18 shapes: the launches' work sums to the function's.
    for n, c in ((524288, 64), (8192, 512)):
        for kind, flops_per in (("twopass", 7.0), ("normalize", 4.0)):
            facts = fc.bn_launches(kind, n, c, dtype, 264, 264, sms=132)
            xy = 2 * n * c * item
            extra = 16 * c
            assert sum(f.bytes for f in facts) == xy + extra
            assert sum(f.flops for f in facts) == flops_per * n * c
            assert {f.flop_dtype for f in facts} == {"float32"}


def test_decode_and_grouped_work_equal_the_bound_formulas():
    bf16 = torch.bfloat16
    for b, hq, hkv, d, pos, t in ((4, 12, 12, 64, 191, 192), (1, 8, 4, 32, 67, 68)):
        facts = da.decode_attention_launches(b, hq, hkv, t, d, bf16, pos)
        assert sum(f.bytes for f in facts) == (2 * b * hkv * pos * d * 2 + 2 * b * hq * d * 2
                                               + 4 * b * hkv * d * 2)
        assert sum(f.flops for f in facts) == 4 * b * hq * d * (pos + 1)
    positions = np.array([0, 15, 16, 17, 255, 511, 700, 1023])
    rows = positions + 1
    for mb in (64, 256):
        facts = pa.paged_decode_launches(8, 12, 4, 64, 1 + 8 * mb, 16, mb, bf16,
                                         int(rows.sum()), int(np.ceil(rows / 16).sum()))
        assert sum(f.bytes for f in facts) == (2 * rows.sum() * 4 * 64 * 2 + 2 * 8 * 12 * 64 * 2
                                               + 4 * np.ceil(rows / 16).sum() + 4 * 8)
        assert sum(f.flops for f in facts) == 4 * rows.sum() * 12 * 64
    for m, k, n, e, rows_in in ((18432, 768, 3072, 4, 16000), (4096, 256, 512, 8, 4096)):
        for dtype, item in ((bf16, 2), (torch.float32, 4)):
            g = gm.gmm_launch(m, k, n, e, dtype, sms=132, rows=rows_in)
            assert (g.bytes, g.flops) == (m * k * item + e * k * n * item + m * n * item + 4 * e,
                                          2.0 * rows_in * k * n)
            tg = gm.tgmm_launch(m, k, n, e, dtype, sms=132, rows=rows_in)
            assert (tg.bytes, tg.flops) == (m * k * item + m * n * item + e * k * n * item
                                            + 4 * e, 2.0 * rows_in * k * n)


def test_meta_collectives_record_what_the_card_counts_without_a_group():
    """The TP all-gather, the bulk reduce-scatter and a ring hop on meta
    tensors: a CommFact each, bytes equal to STATS' wire bytes, no process
    group; a real tensor never takes the route."""
    from rocket_tpu_torch.parallel import collectives as coll

    spec = coll.OverlapSpec(group=None, ranks=(0, 1, 2, 3), index=0, wire=None)
    x = torch.empty((2, 16, 32), dtype=torch.bfloat16, device="meta")
    coll.reset_stats()
    with _launch.record_launches() as facts:
        gathered = coll._all_gather(spec, x, 1)
        summed = coll._bulk_reduce_scatter(spec, gathered, wire=False)
        (received,) = coll.Hop(None, [(x, 1)], [(x, 3)]).wait()
    assert [f.kind for f in facts] == ["all_gather", "all_to_all", "send_recv"]
    assert gathered.shape == (2, 64, 32) and summed.shape == (2, 16, 32)
    assert received.shape == x.shape and received.device.type == "meta"
    nbytes = x.numel() * 2
    assert [f.bytes for f in facts] == [3 * nbytes, int(3 / 4 * 4 * nbytes), nbytes]
    assert coll.STATS["wire_bytes"] == sum(f.bytes for f in facts)
    assert [f.group for f in facts] == [4, 4, 2] and facts[2].overlapped
    with pytest.raises(TypeError):  # a CPU tensor issues the real collective
        coll.collective("all_reduce", None, (torch.zeros(2),), (), 8, 2)


def test_demos_report_exactly_the_reference_rule_ids():
    # tests/test_analysis_cli.py's DEMO_RULES for the reference's demos.
    want = {"badsched": {"RKT501", "RKT502", "RKT503", "RKT505"},
            "badoverlap": {"RKT501", "RKT502", "RKT503"}}
    for name, rules in want.items():
        report = run_sched_target(SCHED_TARGETS[name])
        assert {f.rule for f in report.findings} == rules, name
    bad = run_sched_target(SCHED_TARGETS["badpallas"])
    assert [f.rule for f in bad.findings] == ["RKT504", "RKT504"] and not bad.record


@pytest.mark.parametrize("name", ["tp_2x4", "tp_1x8", "fsdp_1x8", "tp_2x4_eval",
                                  "dp_resnet_1x8", "tp_flash"])
def test_multi_rank_targets_are_clean_and_price_their_collectives(name):
    report = run_sched_target(SCHED_TARGETS[name])
    assert report.clean, [f.render() for f in report.findings]
    record = report.record
    assert record["device_kind"] == "NVIDIA H100" and record["n_collectives"] > 0
    assert record["comm_total_us"] > 0 and record["predicted_mfu"] >= SCHED_TARGETS[name].mfu_floor
    assert record["mesh"] == dict(SCHED_TARGETS[name].mesh_shape)
    if name == "tp_flash":
        assert {f.name for f in report.launches} == {"flash_fwd", "flash_bwd"}


def test_sched_cli_gates_on_the_committed_budgets(tmp_path, capsys):
    assert cli.main(["sched", "--target", "tp_2x4", "--target", "serve"]) == 0
    assert "predicted step" in capsys.readouterr().err
    # A budget a tenth under the priced step time fails RKT506.
    record = run_sched_target(SCHED_TARGETS["serve"]).record
    budgets.write_budget(str(tmp_path), "serve", dict(
        record, predicted_step_time_us=record["predicted_step_time_us"] / 1.2))
    assert cli.main(["sched", "--target", "serve", "--budgets-dir", str(tmp_path),
                     "--format", "json"]) == 1
    assert '"RKT506"' in capsys.readouterr().out
    assert cli.main(["sched", "--target", "badsched", "--no-budgets"]) == 1
    assert cli.main(["fault"]) == 2
