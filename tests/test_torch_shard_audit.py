"""The SPMD audit (``rocket_tpu_torch/analysis/shard_audit.py``,
``rules/spmd_rules.py``, RKT301-306) against the reference.

* every ``check_*`` reports the reference's rule ids, with messages naming
  the same param paths, on the same seeded facts;
* ``resolve_specs`` under ``gpt2_tp_rules`` and ``fsdp_rules(min_size=
  4096)`` gives the reference's (path, spec) pairs over the audit LM, the
  paths the bridge's;
* the ring model equals the reference's, and the FSDP target's step moves
  the bytes the reference's compiled step moves;
* ``collect_collectives`` keeps one op for each of one rank's explicit
  collectives, its ring-model bytes the rank's own count of its wire bytes;
* ``badrules`` reports exactly the reference's ids (RKT301, RKT304,
  RKT305); ``shard`` exits 0 against the committed
  ``tests/fixtures/torch_budgets/shard/``, a shrunk budget fails RKT306,
  ``--list-rules`` lists RKT201-206, 301-306 and 801-805, and an unported
  family (``fault``) still exits 2 naming A 9.

Inputs are drawn from numpy seeds; torch runs on one thread.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rocket_tpu.analysis import shard_audit as ref_shard
from rocket_tpu.analysis.rules import spmd_rules as ref_rules
from rocket_tpu.parallel import sharding as ref_sharding
from rocket_tpu.utils.pytree import key_path_names
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis import budgets, shard_audit
from rocket_tpu_torch.analysis.rules import SPMD_RULES, spmd_rules
from rocket_tpu_torch.analysis.sched_audit import _COMM_OPCODES, _parallel_lm_parts
from rocket_tpu_torch.ops._launch import CommFact, record_launches
from rocket_tpu_torch.parallel import sharding

torch.set_num_threads(1)

MESHES = [{"data": 2, "model": 4}, {"data": 1, "model": 8}, {"data": 8}, {"model": 3}]


def _leaf(shape, dtype=np.float32):
    return np.zeros(shape, dtype)


def _seeded_specs(seed: int) -> list:
    """(path, leaf, spec) triples: random 1-3 dim leaves, each replicated,
    split on a random dim over a random axis (some missing from the mesh),
    or given a spec one dim too long."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        shape = tuple(int(d) for d in rng.choice([3, 8, 12, 16, 96, 1024], size=rng.integers(1, 4)))
        kind = rng.integers(0, 4)
        if kind == 0:
            spec = None
        elif kind == 3:
            spec = (None,) * (len(shape) + 1)
        else:
            spec = [None] * len(shape)
            spec[int(rng.integers(0, len(shape)))] = str(rng.choice(["data", "model", "expert"]))
            spec = tuple(spec)
        out.append((("blocks", str(i), "w"), _leaf(shape), spec))
    return out


def test_the_catalog_keeps_the_reference_ids_and_slugs():
    assert [r[:2] for r in SPMD_RULES] == [r[:2] for r in ref_rules.SPMD_RULES]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_spec_and_replication_checks_equal_the_reference(seed, mesh):
    specs = _seeded_specs(seed)
    for port_check, ref_check in ((spmd_rules.check_specs, ref_rules.check_specs),
                                  (spmd_rules.check_replication, ref_rules.check_replication)):
        kwargs = {"replicated_bytes_limit": 4096} if port_check is spmd_rules.check_replication \
            else {}
        got, want = port_check(specs, mesh, **kwargs), ref_check(specs, mesh, **kwargs)
        assert [f.rule for f in got] == [f.rule for f in want]
        assert [f.path for f in got] == [f.path for f in want]
        for g, w in zip(got, want):
            assert g.message.split(" ")[:3] == w.message.split(" ")[:3]


@pytest.mark.parametrize("rules", [
    [("*/attn/qkv/w", (None, "model")), ("*/attn/qkv/w", ("model", None))],
    [("*/mlp/fc_in/w_typo", (None, "model")), ("head/w", (None, "model"))],
    [("*", None), ("wte/table", ("model", None))],
])
def test_dead_rule_check_equals_the_reference(rules):
    paths = [("blocks", str(i), "attn", "qkv", "w") for i in range(2)] + [("head", "w"),
                                                                          ("wte", "table")]
    got, want = spmd_rules.check_dead_rules(rules, paths), ref_rules.check_dead_rules(rules, paths)
    assert [(f.rule, f.message) for f in got] == [(f.rule, f.message) for f in want]


@pytest.mark.parametrize("seed", range(3))
def test_collective_check_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    kinds = shard_audit.COLLECTIVE_KINDS
    ops = []
    for _ in range(int(rng.integers(4, 20))):
        kind = str(rng.choice(kinds))
        n, size = int(rng.choice([2, 4, 8])), int(rng.integers(1, 1 << 20))
        ops.append((kind, (size // 4,), n, size, shard_audit._ring_bytes(kind, size, n)))
    port_ops = [shard_audit.CollectiveOp(k, "float32", s, n, b, m) for k, s, n, b, m in ops]
    ref_ops = [ref_shard.CollectiveOp(k, "f32", s, n, b, m) for k, s, n, b, m in ops]
    allow = {k: int(rng.integers(0, 4)) for k in kinds}
    got = spmd_rules.check_collectives(port_ops, allow)
    want = ref_rules.check_collectives(ref_ops, allow)
    assert [f.rule for f in got] == [f.rule for f in want]
    assert [f.message.split(" ")[1:3] for f in got] == [f.message.split(" ")[1:3] for f in want]
    assert spmd_rules.check_collectives(port_ops, None) == []


def test_ring_model_equals_the_reference():
    rng = np.random.default_rng(7)
    for kind in shard_audit.COLLECTIVE_KINDS:
        for _ in range(8):
            size, n = int(rng.integers(0, 1 << 24)), int(rng.integers(1, 16))
            assert shard_audit._ring_bytes(kind, size, n) == ref_shard._ring_bytes(kind, size, n)


def _ref_audit_lm_params():
    from rocket_tpu.models.transformer import TransformerLM

    model = TransformerLM(ref_shard._lm_config())
    return jax.eval_shape(model.init, jax.random.key(0))["params"]


@pytest.mark.parametrize("which", ["tp", "fsdp"])
def test_resolve_specs_gives_the_references_pairs(which):
    if which == "tp":
        port_rule, ref_rule = sharding.gpt2_tp_rules("model"), ref_sharding.gpt2_tp_rules("model")
    else:
        port_rule = sharding.fsdp_rules("data", min_size=4096)
        ref_rule = ref_sharding.fsdp_rules("data", min_size=4096)
    port_triples, port_findings = shard_audit.resolve_specs(port_rule,
                                                            shard_audit._whole_params())
    ref_triples, ref_findings = ref_shard.resolve_specs(ref_rule, _ref_audit_lm_params())
    assert port_findings == [] and ref_findings == []

    def pairs(triples):
        return {"/".join(p): (tuple(s) if s is not None else None) for p, _l, s in triples}

    assert pairs(port_triples) == pairs(ref_triples)
    mesh = {"data": 2, "model": 4} if which == "tp" else {"data": 8}
    got = shard_audit.estimate_hbm(port_triples, mesh)
    want = ref_shard.estimate_hbm(ref_triples, mesh)
    assert {k: got[k] for k in ("params_bytes", "optimizer_bytes")} == \
        {k: want[k] for k in ("params_bytes", "optimizer_bytes")}
    assert got["method"] == want["method"] == "shape-math"


def test_an_over_long_spec_is_rkt302_in_both():
    rule = [("blocks/*/attn/qkv/w", (None, None, "model"))]
    got = shard_audit.resolve_specs(sharding.make_rules(rule), shard_audit._whole_params())[1]
    want = ref_shard.resolve_specs(ref_sharding.make_rules(rule), _ref_audit_lm_params())[1]
    assert [f.rule for f in got] == [f.rule for f in want] == ["RKT302", "RKT302"]


def test_fsdp_step_moves_the_references_bytes_and_the_traces_agree():
    """One FSDP rank's explicit collectives, costed by the ring model, move
    exactly what the reference's compiled step moves (its committed
    record), and ``collect_collectives`` keeps one op a ``CommFact``, its
    ring bytes the rank's own count."""
    target = shard_audit.BUILTIN_TARGETS["fsdp_1x8"]
    report = shard_audit.run_target(target)
    assert report.clean and report.record["hbm"]["method"] == "liveness"
    with open(Path(__file__).parent / "fixtures" / "budgets" / "fsdp_1x8.json") as fh:
        reference = json.load(fh)
    assert report.record["collective_bytes_per_step"] == reference["collective_bytes_per_step"]
    assert report.record["hbm"]["params_bytes"] == reference["hbm"]["params_bytes"]
    step, args = _parallel_lm_parts(target.mesh_shape, target.rules())
    ops = shard_audit.collect_collectives(step, *args)
    step, args = _parallel_lm_parts(target.mesh_shape, target.rules())
    with record_launches() as facts:
        step(*args)
    facts = [f for f in facts if isinstance(f, CommFact)]
    # One op a fact, and the ring model on each payload is the rank's own
    # count of its wire bytes (each within a byte of rounding).
    assert [op.kind for op in ops] == [_COMM_OPCODES[f.kind] for f in facts]
    assert all(abs(op.bytes_moved - f.bytes) <= 1 for op, f in zip(ops, facts))
    assert {op.kind for op in ops} == {"all-gather", "all-to-all", "all-reduce"}


def test_badrules_reports_exactly_the_reference_ids():
    report = shard_audit.run_target(shard_audit.BUILTIN_TARGETS["badrules"])
    assert sorted({f.rule for f in report.findings}) == ["RKT301", "RKT304", "RKT305"]
    assert any("qkv/w_typo" in f.message for f in report.findings if f.rule == "RKT301")


@pytest.mark.parametrize("name", [n for n, t in shard_audit.BUILTIN_TARGETS.items() if not t.demo])
def test_targets_are_clean_and_count_their_collectives(name):
    report = shard_audit.run_target(shard_audit.BUILTIN_TARGETS[name])
    assert report.clean, [f.message for f in report.findings]
    assert report.record["mesh"] == dict(shard_audit.BUILTIN_TARGETS[name].mesh_shape)
    assert sum(report.record["collective_counts"].values()) == len(report.collectives) > 0
    assert report.record["hbm_per_device_bytes"] > report.record["hbm"]["params_bytes"] > 0


def test_shard_cli_gates_on_the_committed_budgets(tmp_path, capsys):
    assert cli.main(["shard"]) == 0
    assert "B a step" in capsys.readouterr().err
    assert cli.main(["shard", "--target", "badrules"]) == 1
    record = shard_audit.run_target(shard_audit.BUILTIN_TARGETS["tp_2x4"]).record
    budgets.write_budget(str(tmp_path), "tp_2x4", dict(
        record, collective_bytes_per_step=int(record["collective_bytes_per_step"] / 1.2)))
    assert cli.main(["shard", "--target", "tp_2x4", "--budgets-dir", str(tmp_path),
                     "--format", "json"]) == 1
    assert '"RKT306"' in capsys.readouterr().out
    assert cli.main(["shard", "--list-targets"]) == 0
    assert "[demo]" in capsys.readouterr().out


def test_list_rules_and_the_unported_families(capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines() if line}
    wanted = {f"RKT{n}" for n in (*range(201, 207), *range(301, 307), *range(801, 806))}
    assert wanted <= listed
    assert cli.main(["fault"]) == 2
    assert "A 9" in capsys.readouterr().err
    assert "trace" not in cli.UNPORTED and "shard" not in cli.UNPORTED


def test_key_path_names_are_the_ports_paths():
    """The bridge's names: the reference's key paths joined by '/' are the
    port's nested dict keys."""
    ref_paths = {"/".join(key_path_names(kp))
                 for kp, _ in jax.tree_util.tree_flatten_with_path(_ref_audit_lm_params())[0]}
    port_paths = {"/".join(p) for p, _l, _s in shard_audit.resolve_specs(
        lambda p, l: None, shard_audit._whole_params())[0]}
    assert port_paths == ref_paths


def test_a_placement_the_port_refuses_is_rkt303_not_a_crash():
    """A spec over an axis the mesh lacks: the static check reports it and
    the rank's step, which ``grad_sync.shard_layout`` refuses to build, is
    reported too (the reference's failed-compile finding)."""
    import dataclasses

    target = dataclasses.replace(
        shard_audit.BUILTIN_TARGETS["badrules"], name="missing_axis",
        rules=lambda: sharding.make_rules([("*/mlp/fc_in/w", ("expert", None))]))
    report = shard_audit.run_target(target)
    rules = [f.rule for f in report.findings]
    assert rules.count("RKT303") == 3  # two leaves' specs, and the step
    assert any("one rank's step failed" in f.message for f in report.findings)
