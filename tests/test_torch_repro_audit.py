"""The port's determinism audit (``rocket_tpu_torch/analysis/repro_audit.py``,
RKT901-906) against the reference's (``rocket_tpu/analysis/repro_audit.py``).

Each unit case of ``tests/test_repro_audit.py`` has a counterpart with the
same verdict on the same construction: the key walk (the reference's
jaxpr key provenance, the port's ``nn/keys.record_draws`` notes of its
integer keys), the order-free-sum scan (the reference's scatter-adds
without ``unique_indices``, the port's accumulating aten ops at the site
that issued them), the fingerprints, the budget's string branch and the
replay sentinel. Then the port's own legs: the demo's ids, every non-demo
target clean against its committed budget, the MoE combine's index_adds
seen and allowed only at k = 2, a checkpoint's recompute not read as
reuse, a global-generator draw, resume identity, the decode wave's one
body and its per-wave salts, and the warning names of deterministic mode
held to the traced ops.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from rocket_tpu.analysis import repro_audit as ref
from rocket_tpu.analysis.budgets import REPRO_GATED_KEYS as REF_REPRO_KEYS
from rocket_tpu.analysis.rules.repro_rules import check_key_reuse as ref_check_key_reuse
from rocket_tpu.analysis.rules.repro_rules import check_nondet_hlo as ref_check_nondet
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis import budgets
from rocket_tpu_torch.analysis import repro_audit as port
from rocket_tpu_torch.analysis.rules.repro_rules import check_key_reuse, check_nondet_ops
from rocket_tpu_torch.nn import keys

torch.set_num_threads(1)

META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def ref_key_findings(fn, *args):
    flow = ref.analyze_key_provenance(jax.make_jaxpr(fn)(*args))
    return ref_check_key_reuse(flow.consumptions, flow.unfolded), flow


def port_key_findings(fn, *args):
    tracer, record, _ = port.trace_program(fn, *args)
    flow = port.analyze_key_provenance(record, tracer)
    return check_key_reuse(flow.consumptions, flow.unfolded), flow


# -- RKT901: key discipline ------------------------------------------------------------


def test_key_reuse_fires_on_double_consumption():
    def ref_step(key, x):
        return x + jax.random.normal(key, x.shape) * jax.random.uniform(key, x.shape)

    def port_step(x):
        key = keys.key(0)
        a = keys.uniform(key, x.shape, x.device)
        b = keys.uniform(key, x.shape, x.device)   # the same key value again
        return x + a * b

    for findings, flow in (ref_key_findings(ref_step, jax.random.key(0), jnp.ones(4)),
                           port_key_findings(port_step, meta(4))):
        assert [f.rule for f in findings] == ["RKT901"]
        assert "consumed by 2" in findings[0].message
        assert flow.n_consumers == 2


def test_split_keys_are_clean():
    def ref_step(key, x):
        k1, k2 = jax.random.split(key)
        return x + jax.random.normal(k1, x.shape) * jax.random.uniform(k2, x.shape)

    def port_step(x):
        k1, k2 = keys.split(keys.key(0))
        return x + keys.uniform(k1, x.shape, x.device) * keys.uniform(k2, x.shape, x.device)

    for findings, flow in (ref_key_findings(ref_step, jax.random.key(0), jnp.ones(4)),
                           port_key_findings(port_step, meta(4))):
        assert findings == [] and flow.n_derivations >= 1


def test_unfolded_loop_key_fires():
    def ref_step(key, xs):
        def body(acc, x):
            return acc + jax.random.normal(key, x.shape) * x, None

        return jax.lax.scan(body, jnp.zeros(4), xs)[0]

    def port_step(xs):
        key, acc = keys.key(0), torch.zeros(4, device=xs.device)
        for x in xs:
            acc = acc + keys.uniform(key, x.shape, x.device) * x
        return acc

    for findings, flow in (ref_key_findings(ref_step, jax.random.key(0), jnp.ones((3, 4))),
                           port_key_findings(port_step, meta(3, 4))):
        assert any("loop" in f.message for f in findings), [f.message for f in findings]
        assert all(f.rule == "RKT901" for f in findings) and flow.unfolded


def test_fold_in_with_loop_carry_is_clean():
    def ref_step(key, xs):
        def body(carry, x):
            i, acc = carry
            return (i + 1, acc + jax.random.normal(jax.random.fold_in(key, i), x.shape) * x), None

        return jax.lax.scan(body, (0, jnp.zeros(4)), xs)[0][1]

    def port_step(xs):
        key, acc = keys.key(0), torch.zeros(4, device=xs.device)
        for i, x in enumerate(xs):
            acc = acc + keys.uniform(keys.fold_in(key, i), x.shape, x.device) * x
        return acc

    assert ref_key_findings(ref_step, jax.random.key(0), jnp.ones((3, 4)))[0] == []
    assert port_key_findings(port_step, meta(3, 4))[0] == []


def test_cond_branches_do_not_double_count():
    """One branch runs: the reference's cond, the port's host branch."""
    def ref_step(pred, key, x):
        return jax.lax.cond(pred, lambda k: jax.random.normal(k, x.shape),
                            lambda k: jax.random.uniform(k, x.shape), key)

    def port_step(x, pred=True):
        key = keys.key(0)
        if pred:
            return keys.uniform(key, x.shape, x.device)
        return keys.bernoulli(key, 0.5, x.shape, x.device).float()

    assert ref_key_findings(ref_step, jnp.bool_(True), jax.random.key(0), jnp.ones(4))[0] == []
    assert port_key_findings(port_step, meta(4))[0] == []


def test_recompute_and_the_default_generator():
    """A checkpoint's recompute redraws its forward's masks by design (not
    reuse); a torch random op without a generator draws from the global
    one, which nothing replays."""
    from torch.utils.checkpoint import checkpoint

    def remat(w, x):
        def body(x):
            return x * keys.bernoulli(keys.key(3), 0.9, x.shape, x.device) @ w
        return torch.autograd.grad(checkpoint(body, x, use_reentrant=False).sum(), w)

    findings, flow = port_key_findings(remat, meta(4, 4).requires_grad_(), meta(2, 4))
    assert findings == [] and flow.n_consumers == 1 and flow.n_replays == 1
    findings, flow = port_key_findings(lambda x: torch.nn.functional.dropout(x, 0.1), meta(4, 4))
    assert [f.rule for f in findings] == ["RKT901"]
    assert "global default generator" in findings[0].message


# -- RKT902: order-free sums -----------------------------------------------------------


def test_float_scatter_add_without_unique_indices_fires():
    closed = jax.make_jaxpr(lambda t, i, u: t.at[i].add(u))(jnp.zeros(8), jnp.array([1, 1, 2]),
                                                          jnp.ones(3))
    ops = ref.scan_nondet_jaxpr(closed)
    assert len(ops) == 1 and ops[0][0] == "scatter"
    assert ref_check_nondet(ops)[0].rule == "RKT902"

    def grad_like(table, idx, upd):
        return table.index_add(0, idx, upd)

    tracer, _, _ = port.trace_program(grad_like, meta(8), meta(3, dtype=torch.int64), meta(3))
    assert len(tracer.nondet) == 1 and tracer.nondet[0][0] == "aten::index_add"
    assert check_nondet_ops(tracer.nondet)[0].rule == "RKT902"


def test_unique_indices_and_int_scatters_are_clean():
    """Writes that do not accumulate, and integer sums (exact in any order):
    the reference's unique_indices and int scatter-add, the port's
    non-accumulating index_put and int index_add."""
    assert ref.scan_nondet_jaxpr(jax.make_jaxpr(
        lambda t, i, u: t.at[i].add(u, unique_indices=True))(
        jnp.zeros(8), jnp.array([1, 2, 3]), jnp.ones(3))) == []
    assert ref.scan_nondet_jaxpr(jax.make_jaxpr(lambda t, i, u: t.at[i].add(u))(
        jnp.zeros(8, jnp.int32), jnp.array([1, 1]), jnp.ones(2, jnp.int32))) == []
    idx = meta(3, dtype=torch.int64)
    tracer, _, _ = port.trace_program(
        lambda t, i, u: t.index_put((i,), u, accumulate=False), meta(8), idx, meta(3))
    assert tracer.nondet == []
    tracer, _, _ = port.trace_program(
        lambda t, i, u: t.index_add(0, i, u), meta(8, dtype=torch.int32), idx,
        meta(3, dtype=torch.int32))
    assert tracer.nondet == []


def test_scatter_allowlist_matches_source_site():
    ref_ops = [("scatter", "scatter-add@rocket_tpu/models/transformer.py:998 (embed_lookup)",
                "unique_indices=False (traced program)")]
    assert ref_check_nondet(ref_ops, scatter_allow=()) != []
    assert ref_check_nondet(ref_ops, scatter_allow=("rocket_tpu/models/transformer.py",)) == []
    ops = [("aten::index_put", "rocket_tpu_torch/nn/layers.py:apply", "accumulate=True")]
    assert check_nondet_ops(ops) != []
    assert check_nondet_ops(ops, allow=(("rocket_tpu_torch/nn/layers.py:apply",
                                          "aten::index_put", "reviewed"),)) == []
    # The op is part of the entry: another op at the site is not allowed.
    assert check_nondet_ops(ops, allow=(("rocket_tpu_torch/nn/layers.py:apply",
                                          "aten::index_add", "reviewed"),)) != []


def test_backward_ops_are_sited_at_their_forward():
    """A built-in backward runs with no Python of the checkout between the
    engine and the op: it is sited at its forward's frame."""
    def step(table, ids):
        return torch.autograd.grad(table[ids].sum(), table)

    tracer, _, _ = port.trace_program(step, meta(8, 4).requires_grad_(),
                                      meta(5, dtype=torch.int64))
    assert [(op, detail) for op, _site, detail in tracer.nondet] == [
        ("aten::index_put", "accumulate=True")]
    assert tracer.nondet[0][1].endswith("test_torch_repro_audit.py:step")


# -- fingerprints ----------------------------------------------------------------------


def ref_fn_a(x):
    return jnp.tanh(x) * 2.0


def ref_fn_b(x):
    return jnp.sin(x) + 1.0


def fn_a(x):
    return torch.tanh(x) * 2.0


def fn_b(x):
    return torch.sin(x) + 1.0


def test_jaxpr_fingerprint_is_stable_and_discriminating():
    x = jnp.ones((4, 4))
    assert ref.jaxpr_fingerprint(jax.make_jaxpr(ref_fn_a)(x)) == \
        ref.jaxpr_fingerprint(jax.make_jaxpr(ref_fn_a)(x)) != \
        ref.jaxpr_fingerprint(jax.make_jaxpr(ref_fn_b)(x))
    fp1 = port.program_fingerprint(port.trace_program(fn_a, meta(4, 4))[0].ops)
    fp2 = port.program_fingerprint(port.trace_program(fn_a, meta(4, 4))[0].ops)
    assert fp1 == fp2 and len(fp1) == 16
    assert fp1 != port.program_fingerprint(port.trace_program(fn_b, meta(4, 4))[0].ops)


def test_hlo_fingerprint_is_stable_and_discriminating():
    """The port has no compiled module: its fingerprint reads the program
    as issued, the same for any tensors of one shape and dtype (a CPU
    tensor traces as meta), another for another dtype."""
    x = jnp.ones((4, 4))
    hlo = [jax.jit(f).lower(x).compile().as_text() for f in (ref_fn_a, ref_fn_a, ref_fn_b)]
    assert ref.hlo_fingerprint(hlo[0]) == ref.hlo_fingerprint(hlo[1]) != \
        ref.hlo_fingerprint(hlo[2])
    fps = [port.program_fingerprint(port.trace_program(fn_a, t)[0].ops)
           for t in (torch.ones(4, 4), meta(4, 4), meta(4, 4, dtype=torch.bfloat16))]
    assert fps[0] == fps[1] != fps[2]


# -- RKT906 ----------------------------------------------------------------------------


def test_diff_budget_gates_fingerprints_on_exact_equality():
    assert budgets.REPRO_GATED_KEYS == REF_REPRO_KEYS
    committed = {"program_fingerprint": "a" * 16, "random_consumers": 3}
    kwargs = dict(keys=budgets.REPRO_GATED_KEYS, rule="RKT906", family="repro")
    assert budgets.diff_budget("t", committed, dict(committed), **kwargs) == []
    findings = budgets.diff_budget("t", committed, dict(committed, program_fingerprint="b" * 16),
                                   **kwargs)
    assert [f.rule for f in findings] == ["RKT906"]
    assert "program_fingerprint" in findings[0].message
    assert "--update-budgets" in findings[0].message


# -- RKT905 ----------------------------------------------------------------------------


def test_replay_sentinel_is_bitwise_equal():
    mismatches, n = port.run_replay_sentinel()
    assert mismatches == [] and n > 0
    threads = torch.get_num_threads()
    port.run_replay_sentinel()
    assert torch.get_num_threads() == threads


# -- the targets -----------------------------------------------------------------------


def test_badrepro_reports_the_references_ids():
    """The demo: RKT901 twice (a reused key, an unfolded loop key) and
    RKT902, as the reference's (whose scatter scan on the installed JAX
    also sees the scatter-add's transposed twin)."""
    reference = [f.rule for f in ref.run_repro_target(ref.REPRO_TARGETS["badrepro"]).findings]
    report = port.run_repro_target(port.REPRO_TARGETS["badrepro"])
    rules = sorted(f.rule for f in report.findings)
    assert rules == ["RKT901", "RKT901", "RKT902"]
    assert set(rules) == set(reference) and reference.count("RKT901") == 2
    assert cli.main(["repro", "--target", "badrepro", "--no-budgets"]) == 1


@pytest.mark.parametrize("name", [n for n, t in port.REPRO_TARGETS.items() if not t.demo])
def test_every_target_is_clean_against_its_budget(name):
    report = port.run_repro_target(port.REPRO_TARGETS[name])
    assert report.findings == [], [f.render() for f in report.findings]
    committed = budgets.load_budget("tests/fixtures/torch_budgets/repro", name)
    assert budgets.diff_budget(name, committed, report.record, keys=budgets.REPRO_GATED_KEYS,
                               rule="RKT906", family="repro") == []


def test_the_moe_combine_is_seen_and_allowed_only_at_k2():
    report = port.run_repro_target(port.REPRO_TARGETS["moe"])
    sites = {(op, site) for op, site, _ in report.nondet}
    assert ("aten::index_add", "rocket_tpu_torch/nn/moe.py:_apply_dropless") in sites
    assert ("aten::index_add_", "rocket_tpu_torch/ops/gather_gmm.py:backward") in sites
    assert report.findings == [] and report.record["random_consumers"] > 0
    k3 = dataclasses.replace(port.REPRO_TARGETS["moe"],
                             allow=port._XENT_GRAD_ALLOW + port._EMBED_GRAD_ALLOW
                             + port._moe_allow(3))
    flagged = {f.message.split(" at ")[1].split(" (")[0]
               for f in port.run_repro_target(k3).findings}
    assert flagged == {"rocket_tpu_torch/nn/moe.py:_apply_dropless",
                       "rocket_tpu_torch/ops/gather_gmm.py:backward"}


def test_resume_identity_sees_a_layout_drift():
    """A leaf the restore brings back in another layout (a transposed view
    comes back contiguous) is a different program input: RKT903."""
    w = meta(8, 4).t()

    def step(state, x):
        return x @ state["w"]

    report = port.audit_train_repro(step, ({"w": w}, meta(2, 4)), label="drift")
    assert [f.rule for f in report.findings] == ["RKT903"]
    assert port.audit_train_repro(step, ({"w": meta(8, 4)}, meta(2, 8))).findings == []


def test_the_wave_body_is_one_and_its_salts_fold_the_position():
    """RKT904 on a decode wave that leaks k into its math, and RKT901 on one
    whose sampling salt stops folding in the lengths (the same draw every
    wave)."""
    from rocket_tpu_torch.serve import engine

    model, serve_config = port._charlm_serve_parts()
    fingerprints, _ = port.prove_wave_invariance(model, serve_config)
    assert len(set(fingerprints.values())) == 1 and sorted(fingerprints) == [1, 2, 4]

    real = engine.build_decode_wave

    def leaky(model, waves=1):
        wave = real(model, waves)

        def decode_wave(params, *rest):
            if waves > 1:
                params = dict(params, ln_f={k: v * 1.0 for k, v in params["ln_f"].items()})
            return wave(params, *rest)
        return decode_wave

    engine.build_decode_wave = leaky
    try:
        report = port.audit_serve_repro(model, serve_config, label="leaky")
    finally:
        engine.build_decode_wave = real
    assert "RKT904" in [f.rule for f in report.findings]

    from rocket_tpu_torch.models import sampling

    real_draw, first = sampling.draw, []

    def fixed_salt_draw(scaled, seed, salt):
        # The bug the salts exist against: one salt for every wave.
        first.append(first[0] if first else salt.clone())
        return real_draw(scaled, seed, first[-1])

    sampling.draw = fixed_salt_draw
    try:
        report = port.audit_serve_repro(model, serve_config, label="frozen")
    finally:
        sampling.draw = real_draw
    assert "RKT901" in [f.rule for f in report.findings]


def test_warned_ops_are_held_to_the_traced_ones():
    messages = [
        "scatter_add_cuda_kernel does not have a deterministic implementation, but you set "
        "'torch.use_deterministic_algorithms(True, warn_only=True)'.",
        "Deterministic behavior was enabled with either `torch.use_deterministic_algorithms("
        "True)` or `at::Context::setDeterministicAlgorithms(true)`, but this operation is not "
        "deterministic because it uses CuBLAS and you have CUDA >= 10.2.",
        "cumsum_cuda_kernel does not have a deterministic implementation, but you set ...",
    ]
    names, cublas = port.warned_ops(messages)
    assert names == ["cumsum_cuda_kernel", "scatter_add_cuda_kernel"] and cublas == 1
    traced = [("aten::scatter_add_", "x.py:f", "d")]
    assert port.explained(names, traced) == ["cumsum_cuda_kernel"]
    assert port.explained(names, traced + [("aten::cumsum", "y.py:g", "d")]) == []
