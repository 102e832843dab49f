"""The memory audit (``rocket_tpu_torch/analysis/mem_audit.py``,
``rules/mem_rules.py``, RKT801-805) against the reference and closed forms.

* every ``check_*`` reports the reference's rule ids on the same seeded
  facts, with the reference's defaults (coverage 0.9, floor 0.5);
* ``simulate_liveness`` on hand-built steps whose peak and saved bytes have
  a closed form: an elementwise chain (two temps live at once, views add
  nothing, in-place writes into the state add nothing and count as covered,
  every buffer rounds up to the allocator's 512-byte block), and the
  reference's ``badmem`` chain: 12 saved 256x256 f32 links, 3,145,728
  bytes, and under a non-reentrant checkpoint only the region's input and
  the saves outside it; the saved-tensor hook's set equals the structural
  one (born before the forward/backward boundary, read after it) on both;
* a flash backward's f32 dq partials (402,653,184 bytes at GPT-2's shape)
  are born and freed inside the step;
* ``train_flash``'s expected state is exactly GPT-2 124M's f32 params and
  AdamW's two moments, 1,493,277,696 bytes, the step counters on the host;
* ``badmem`` reports RKT801, RKT802 and RKT804; every other target is
  clean; ``mem`` exits 0 against the committed
  ``tests/fixtures/torch_budgets/mem/`` and a shrunk budget fails RKT803;
  RKT805 fires on a measured peak outside the floor.

Inputs are drawn from numpy seeds; torch runs on one thread.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rocket_tpu.analysis.rules import mem_rules as ref_rules
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis import budgets, mem_audit
from rocket_tpu_torch.analysis.rules import MEM_RULES, mem_rules
from rocket_tpu_torch.utils.perf import DEVICE_SPECS

torch.set_num_threads(1)

META = torch.device("meta")
LINK = 256 * 256 * 4


def _rules(findings) -> list:
    return sorted(f.rule for f in findings)


def test_the_catalog_keeps_the_reference_ids_and_slugs():
    assert [r[:2] for r in MEM_RULES] == [r[:2] for r in ref_rules.MEM_RULES]


@pytest.mark.parametrize("seed", range(6))
def test_checks_equal_the_reference_on_seeded_facts(seed):
    rng = np.random.default_rng(seed)
    state, aliased = int(rng.integers(1, 1 << 30)), int(rng.integers(0, 1 << 30))
    expects = bool(rng.integers(0, 2))
    saved, ceiling = int(rng.integers(0, 1 << 26)), int(rng.choice([0, 1 << 16, 1 << 24]))
    peak, capacity = int(rng.integers(1, 1 << 34)), int(rng.choice([0, 2 << 20, 80 << 30]))
    frontier = {"a": int(rng.integers(0, 100)), "b": int(rng.integers(0, 100))}
    measured = None if seed == 0 else int(peak * rng.uniform(0.3, 3.0))
    pairs = [
        (mem_rules.check_donation_coverage(aliased, state, expects_donation=expects),
         ref_rules.check_donation_coverage(aliased, state, expects_donation=expects)),
        (mem_rules.check_remat_effectiveness(saved, ceiling),
         ref_rules.check_remat_effectiveness(saved, ceiling)),
        (mem_rules.check_oom_frontier(peak, capacity, frontier=frontier, batch_size=8),
         ref_rules.check_oom_frontier(peak, capacity, frontier=frontier, batch_size=8)),
        (mem_rules.check_reconciliation(peak, measured),
         ref_rules.check_reconciliation(peak, measured)),
    ]
    for got, want in pairs:
        assert [(f.rule, f.path) for f in got] == [(f.rule, f.path) for f in want]
        assert [f.message.split(":")[0] for f in got] == [f.message.split(":")[0] for f in want]


def test_reconciliation_floor_is_the_references():
    assert mem_rules.check_reconciliation(150, 100) == []
    assert _rules(mem_rules.check_reconciliation(151, 100)) == ["RKT805"]
    assert mem_rules.check_reconciliation(10**9, None) == []


def test_an_elementwise_chain_has_its_closed_form_peak():
    """``((x * 2) + 1) * 3``: two temps live at once, never three; a view
    adds nothing; an in-place write into the state adds nothing and is
    covered; a 10-element temp takes one 512-byte block."""
    n = 1 << 16
    x, p = torch.empty(n, device=META), torch.empty(n, device=META)

    def step(x, p):
        y = ((x * 2) + 1) * 3
        y.view(-1, 2).t()
        p.add_(y)
        return torch.empty(10, device=META) + 1

    result = mem_audit.simulate_liveness(step, x, p, state=[p])
    assert result.argument_bytes == 2 * n * 4 and result.state_bytes == n * 4
    assert result.peak_temp_bytes == 2 * n * 4
    assert result.peak_bytes == 4 * n * 4
    assert result.inplace_bytes == n * 4
    small = [b for b in result_buffers(step, x, p) if b.raw_bytes == 40]
    assert small and all(b.nbytes == mem_audit.BLOCK_BYTES for b in small)


def result_buffers(step, *args):
    tracer = mem_audit.LivenessTracer()
    with tracer.tracing():
        step(*args)
    return list(tracer.buffers.values())


@pytest.mark.parametrize("checkpointed", [False, True])
def test_badmem_chain_saves_its_closed_form(checkpointed):
    step, args = mem_audit._badmem_parts(checkpointed)
    result = mem_audit.simulate_liveness(step, *args, state=step.leaves)
    want = 2 * LINK if checkpointed else 12 * LINK  # h0 and the chain's output
    assert result.saved_activation_bytes == want
    assert result.saved == result.carried
    assert result.state_bytes == 12 * LINK and result.batch_bytes == LINK
    assert result.boundary_index is not None and result.peak_index > result.boundary_index
    if not checkpointed:
        assert result.saved_activation_bytes == 3_145_728


def test_flash_backward_scratch_is_born_and_freed_in_the_step():
    from rocket_tpu_torch.ops.flash_native import flash_fused

    qkv = torch.empty(8, 1024, 3 * 768, dtype=torch.bfloat16, device=META, requires_grad=True)

    def step(qkv):
        return torch.autograd.grad(flash_fused(qkv, 12).float().sum(), (qkv,))

    buffers = result_buffers(step, qkv)
    partials = 16 * 8 * 1024 * 768 * 4
    assert partials == 402_653_184
    assert any(b.raw_bytes == partials and b.died is not None for b in buffers)


def test_train_flash_state_is_gpt2_params_and_adamw_moments():
    report = mem_audit.run_mem_target(mem_audit.MEM_TARGETS["train_flash"])
    record = report.record
    assert report.clean, [f.message for f in report.findings]
    assert record["expected_state_bytes"] == 124_439_808 * 4 * 3 == 1_493_277_696
    assert record["donated_bytes"] == record["expected_state_bytes"]
    assert record["host_state_bytes"] == 148 * 4  # one f32 step counter a leaf
    assert record["batch_size"] == 8 and record["measured_peak_bytes"] is None
    assert sum(record["peak_breakdown"].values()) == record["predicted_peak_bytes"]
    for kind, batch in record["oom_frontier"].items():
        cap = DEVICE_SPECS[kind].hbm_bytes
        assert record["fixed_bytes"] + batch * record["per_sample_bytes"] <= cap
        assert record["fixed_bytes"] + (batch + 1) * record["per_sample_bytes"] > cap


def test_badmem_reports_rkt801_rkt802_rkt804():
    report = mem_audit.run_mem_target(mem_audit.MEM_TARGETS["badmem"])
    assert _rules(report.findings) == ["RKT801", "RKT802", "RKT804"]
    assert report.record["donated_bytes"] == 0
    assert report.record["saved_activation_bytes"] == 12 * LINK


@pytest.mark.parametrize("name", [n for n, t in mem_audit.MEM_TARGETS.items()
                                  if not t.demo and n != "train_flash"])
def test_multi_rank_targets_are_clean(name):
    target = mem_audit.MEM_TARGETS[name]
    report = mem_audit.run_mem_target(target)
    assert report.clean, [f.message for f in report.findings]
    record = report.record
    assert record["mesh"] == dict(target.mesh_shape)
    assert sum(record["peak_breakdown"].values()) == record["predicted_peak_bytes"]
    if target.expects_donation:
        assert record["donated_bytes"] >= 0.9 * record["expected_state_bytes"]


def test_rkt805_holds_the_peak_to_a_measured_one():
    step, args = mem_audit._badmem_parts()
    peak = mem_audit.simulate_liveness(step, *args, state=step.leaves).peak_bytes
    for measured, rules in ((int(peak * 1.4), []), (int(peak * 3), ["RKT805"])):
        step, args = mem_audit._badmem_parts()
        report = mem_audit.audit_memory(step, *args, state=step.leaves, expects_donation=False,
                                        measured_peak_bytes=measured, slope=False)
        assert _rules(report.findings) == rules
        assert report.record["measured_peak_bytes"] == measured


def test_mem_cli_gates_on_the_committed_budgets(tmp_path, capsys):
    assert cli.main(["mem", "--target", "tp_2x4", "--target", "dp_resnet_1x8"]) == 0
    assert "OOM frontier" in capsys.readouterr().err
    assert cli.main(["mem", "--target", "badmem"]) == 1
    record = mem_audit.run_mem_target(mem_audit.MEM_TARGETS["tp_2x4"]).record
    budgets.write_budget(str(tmp_path), "tp_2x4", dict(
        record, predicted_peak_bytes=int(record["predicted_peak_bytes"] / 1.2)))
    assert cli.main(["mem", "--target", "tp_2x4", "--budgets-dir", str(tmp_path),
                     "--format", "json"]) == 1
    assert '"RKT803"' in capsys.readouterr().out
    with pytest.raises(SystemExit) as refused:  # a card without a DeviceSpec: a usage error
        cli.main(["mem", "--target", "tp_2x4", "--device-kind", "TPU v5"])
    assert refused.value.code == 2


def test_mem_cli_sweep_exits_0():
    assert cli.main(["mem"]) == 0
