"""The port's health sentinels and their update gate against the JAX
package's (``rocket_tpu/obs/health.py``, ``rocket_tpu/core/module.py``).

* ``step_flags`` and ``update_sentinels`` on seeded trees, NaN and Inf
  leaves among them: the words agree slot for slot within f32
  ``1e-6 * (1 + |x|)`` (NaN where the reference has NaN).
* A tiny GPT (2 layers, dim 64, T = 32) through both packages' Launcher
  trees under ``health=True, anomaly_action="skip_step"``, AdamW under
  warmup-cosine, a NaN loss at the third of six steps (a float column of
  the batch, NaN on that batch only, added to the loss by the objective):
  after every step params and both moments within f32 ``1e-5`` of each
  leaf's largest element (the k segment of the qkv bias by a bound: its
  gradient is rounding noise, see ``tests/test_torch_core.py``), the skip
  count and the decoded flags equal, and the optimizer's count — the lr
  the next update reads — equal. The same with ``gradient_accumulation_
  steps=2`` (the NaN on one microbatch) and with an EMA shadow (held on the
  skipped step).
* ``warn`` runs the plain update: bitwise the health-off run's params.
* ``optim.gate_refusal``: an option ``gated_step`` does not implement
  (Adam's L2 term, ``amsgrad``, ``maximize``, SGD's ``dampening``, another
  optimizer) raises at setup under a gating action, naming it.
* ``health/`` checkpoints read by both packages; a pre-health checkpoint
  resumes with fresh sentinels.
* ``dump_and_halt``: ``HealthAnomalyError``, a bundle whose ``checkpoint/``
  resumes to the last good state.

Test files that build models pin torch to one intra-op thread.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.models import transformer as jt
from rocket_tpu.obs import health as jh
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.obs import health as th
from rocket_tpu_torch.runtime import checkpoint_io as tio

torch.set_num_threads(1)

CFG = dict(vocab_size=96, max_seq_len=32, dim=64, num_layers=2, num_heads=2, dropout=0.0,
           loss_chunk=16)
B, T, STEPS, NAN_STEP = 2, 32, 6, 2
SCHEDULE = dict(base_lr=1e-2, warmup_steps=2, decay_steps=6)
TOL = 1e-5


# -- the sentinel math -----------------------------------------------------------


def _trees(seed, poison=None):
    rng = np.random.default_rng(seed)
    tree = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
            "blocks": [rng.standard_normal((5,)).astype(np.float32)],
            "head": rng.standard_normal((2, 2)).astype(np.float32)}
    if poison is not None:
        branch, value = poison
        leaf = tree[branch]["w"] if branch == "a" else tree[branch]
        leaf.flat[1] = value
    return tree


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_words(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-6 * (1 + np.abs(want[fin]))), (got, want)


CASES = {"finite": (None, 2.5), "nan_grad": (("a", np.nan), 2.5),
         "inf_grad": (("head", np.inf), 2.5), "nan_loss": (None, np.nan),
         "inf_loss": (None, -np.inf)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gated", [True, False])
def test_sentinel_words_match_the_reference(case, gated):
    poison, loss = CASES[case]
    grads, params = _trees(1, poison), _trees(2)
    jflags = jh.step_flags(jnp.float32(loss), grads)
    tflags = th.step_flags(torch.tensor(loss, dtype=torch.float32), _torch_tree(grads))
    for g, w in zip(tflags, jflags):
        _assert_words(np.atleast_1d(g.numpy()), np.atleast_1d(np.asarray(w)))
    assert th.branch_names(params) == jh.branch_names(params)
    jstate, tstate = jh.init_state(), th.init_state()
    # Two steps, so the z-score's moments have a history.
    for step, step_loss in enumerate((1.7, loss)):
        jf = jh.step_flags(jnp.float32(step_loss), grads)
        tf = th.step_flags(torch.tensor(step_loss, dtype=torch.float32), _torch_tree(grads))
        kw = dict(step=step + 1048577, update_norm=0.25, gated=gated, ema_decay=0.9,
                  zscore_max=1.0, zscore_warmup=1)
        jstate, jword, _ = jh.update_sentinels(
            jstate, loss=jnp.float32(step_loss), step_ok=jf[0], loss_ok=jf[1],
            grad_branch_ok=jf[2], grad_norm=jf[3], new_params=params, **kw)
        kw["update_norm"] = torch.tensor(0.25)
        tstate, tword, _ = th.update_sentinels(
            tstate, loss=torch.tensor(step_loss, dtype=torch.float32), step_ok=tf[0],
            loss_ok=tf[1], grad_branch_ok=tf[2], grad_norm=tf[3],
            new_params=_torch_tree(params), **kw)
        _assert_words(tword.numpy(), np.asarray(jword))
        for key in jstate:
            _assert_words(np.atleast_1d(tstate[key].numpy()), np.atleast_1d(jstate[key]))
    names = th.branch_names(params)
    got, want = th.decode_word(tword.numpy(), names), jh.decode_word(np.asarray(jword), names)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float):
            _assert_words([got[key]], [value])
        else:
            assert got[key] == value, key
    assert len(tword) == th.word_length(len(names)) == jh.word_length(len(names))


def test_branch_sumsq_is_one_foreach_pass(monkeypatch):
    """One ``torch._foreach_norm`` call over every leaf, not a reduction per
    leaf."""
    calls = []
    real = torch._foreach_norm
    monkeypatch.setattr(torch, "_foreach_norm",
                        lambda ts, *a: calls.append(len(ts)) or real(ts, *a))
    tree = _torch_tree(_trees(3))
    sums = th.branch_sumsq(tree)
    assert calls == [4]
    np.testing.assert_allclose(sums.numpy(), np.asarray(jh.branch_sumsq(_trees(3))), rtol=1e-6)


# -- the tiny GPT through both Launcher trees --------------------------------------


class _Data:
    """Token windows with a float ``poison`` column: NaN on one batch."""

    def __init__(self, n, nan_rows=()):
        rng = np.random.default_rng(4)
        self.tokens = rng.integers(0, CFG["vocab_size"], (n, T)).astype(np.int32)
        self.poison = np.zeros(n, np.float32)
        self.poison[list(nan_rows)] = np.nan

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return {"tokens": self.tokens[i], "poison": self.poison[i]}


def _jax_objective(batch):
    return jt.next_token_loss()(batch) + jnp.sum(batch["poison"])


def _torch_objective(batch):
    return tt.next_token_loss()(batch) + batch["poison"].sum()


def _adam_tree(opt_state, field):
    """``mu``/``nu`` of optax's ScaleByAdamState, and its ``count``."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return getattr(leaf, field)
    raise AssertionError("no ScaleByAdamState")


class _JKeep(JCapsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.rows = module, []

    def launch(self, attrs=None):
        state = self.module.state
        grab = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        opt = state["opt_state"]
        row = {"params": grab(state["params"]), "mu": grab(_adam_tree(opt, "mu")),
               "nu": grab(_adam_tree(opt, "nu")),
               "count": int(np.asarray(_adam_tree(opt, "count"))),
               "skipped": int(np.asarray(state["health"]["skipped"]))}
        if "ema_params" in state:
            row["ema"] = grab(state["ema_params"])
        self.rows.append(row)


class _Keep(Capsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.rows = module, []

    def launch(self, attrs=None):
        prepared = self.module.prepared
        view = prepared.checkpoint_state()
        grab = lambda tree: jax.tree.map(lambda t: t.detach().numpy().copy(), tree)  # noqa: E731
        params = grab(view["params"])
        opt = view["opt_state"]["0"]  # optax's ScaleByAdamState, zeros before an update
        row = {"params": params, "mu": grab(opt["mu"]), "nu": grab(opt["nu"]),
               "count": int(opt["count"]),
               "skipped": int(prepared.state["health"]["skipped"])
               if "health" in prepared.state else 0}
        if "ema_params" in view:
            row["ema"] = grab(view["ema_params"])
        self.rows.append(row)


def _jparams():
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    return jmodel, jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1))["params"])


def _run_jax(tmp_path, data, accum, ema, action="skip_step"):
    jmodel, jparams = _jparams()
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                       gradient_accumulation_steps=accum, project_dir=str(tmp_path / "jax"),
                       health=True, anomaly_action=action, health_fetch_lag=1)
    runtime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    module = jrt.Module(jmodel, [jrt.Loss(_jax_objective),
                                 jrt.Optimizer(joptim.adamw(weight_decay=0.1)),
                                 jrt.Scheduler(joptim.warmup_cosine_lr(**SCHEDULE))],
                        ema_decay=ema)
    keep = _JKeep(module)
    jrt.Launcher([jrt.Looper([jrt.Dataset(data, batch_size=B), module, keep], progress=False)],
                 runtime=runtime).launch()
    return jparams, keep.rows, runtime.health


def _port_tree(tmp_path, jparams, data, accum, ema, action="skip_step", extra=(), health=True,
               **runtime_kw):
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    runtime = rt.Runtime(device="cpu", seed=0, gradient_accumulation_steps=accum,
                         project_dir=str(tmp_path / "torch"), health=health,
                         anomaly_action=action, health_fetch_lag=1, **runtime_kw)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
    module = rt.Module(model, [rt.Loss(_torch_objective),
                               rt.Optimizer(toptim.adamw(weight_decay=0.1)),
                               rt.Scheduler(toptim.warmup_cosine_lr(**SCHEDULE))],
                       ema_decay=ema)
    keep = _Keep(module)
    launcher = rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=B), module, keep, *extra],
                                      progress=False)], runtime=runtime)
    return runtime, module, keep, launcher


def _split_k_bias(tree):
    """Moves the k segment of each qkv bias out of the tree (its gradient is
    rounding noise, which Adam turns into lr-sized steps of either sign)."""
    dim = CFG["dim"]
    out = {}
    for i, block in tree["blocks"].items():
        b = block["attn"]["qkv"]["b"]
        block["attn"]["qkv"]["b"] = np.concatenate([b[:dim], b[2 * dim:]])
        out[i] = b[dim:2 * dim]
    return out


def _close(got, want, what, split=False):
    if split:
        kg, kw = _split_k_bias(got), _split_k_bias(want)
        for i in kg:
            np.testing.assert_allclose(kg[i], kw[i], atol=2 * STEPS * SCHEDULE["base_lr"])
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        bound = TOL * max(1e-30, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= bound, f"{what} {jax.tree_util.keystr(path)}"


def _hold_trees(tmp_path, accum, ema):
    rows_per_step = B
    nan_rows = range(NAN_STEP * rows_per_step, (NAN_STEP + 1) * rows_per_step)
    if accum == 2:
        nan_rows = range(NAN_STEP * rows_per_step, NAN_STEP * rows_per_step + B)
    data = _Data(STEPS * B, nan_rows)
    jparams, want, jmon = _run_jax(tmp_path, data, accum, ema)
    runtime, module, keep, launcher = _port_tree(tmp_path, jparams, data, accum, ema)
    launcher.launch()
    return want, keep.rows, jmon, runtime.health


@pytest.mark.parametrize("accum,ema", [(1, None), (2, None), (1, 0.9)],
                         ids=["accum1", "accum2", "ema"])
def test_skip_step_run_matches_the_reference(tmp_path, accum, ema):
    want, got, jmon, mon = _hold_trees(tmp_path, accum, ema)
    assert len(got) == len(want) == STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        for key in ("params", "mu", "nu") + (("ema",) if ema else ()):
            _close(g[key], w[key], f"{key} after step {step}", split=key in ("params", "ema"))
        assert (g["count"], g["skipped"]) == (w["count"], w["skipped"]), step
    assert [r["count"] for r in got] == [r["count"] for r in want]
    if accum == 1:
        # The held step leaves count and moments as they were: the update
        # after it reads the lr at the count of APPLIED updates.
        assert [r["count"] for r in got] == [1, 2, 2, 3, 4, 5]
        assert got[NAN_STEP]["skipped"] == 1
        for key in ("params", "mu", "nu") + (("ema",) if ema else ()):
            for a, b in zip(jax.tree.leaves(got[NAN_STEP][key]),
                            jax.tree.leaves(got[NAN_STEP - 1][key])):
                assert np.array_equal(a, b), key
    else:
        assert [r["count"] for r in got] == [0, 1, 1, 2, 2, 3]
    assert mon.summary()["skipped_steps"] == jmon.summary()["skipped_steps"]
    assert mon.summary()["anomalies"] == jmon.summary()["anomalies"] == 1
    assert ([r["flag_names"] for r in mon.anomaly_records]
            == [r["flag_names"] for r in jmon.anomaly_records] == [["loss_nonfinite"]])
    # The lr of step 4 is the schedule at the applied count, in both.
    sched = toptim.warmup_cosine_lr(**SCHEDULE)
    jsched = joptim.warmup_cosine_lr(**SCHEDULE)
    count = got[NAN_STEP]["count"]
    np.testing.assert_allclose(float(sched(torch.tensor(float(count)))),
                               float(jsched(want[NAN_STEP]["count"])), rtol=1e-6, atol=1e-9)


def test_warn_action_lets_the_nan_through(tmp_path):
    """``warn`` gates nothing: the step with the NaN loss (its gradients are
    finite: the poison is a constant) updates, counts an anomaly and skips
    nothing, as in the reference. Its update is the plain ``torch.optim``
    step: the params are bitwise those of the same run with health off,
    and within the plain update's tolerance against the reference
    (``test_torch_core``: 2e-5 absolute and relative)."""
    data = _Data(STEPS * B, range(NAN_STEP * B, (NAN_STEP + 1) * B))
    jparams, want, jmon = _run_jax(tmp_path, data, 1, None, action="warn")
    runtime, module, keep, launcher = _port_tree(tmp_path, jparams, data, 1, None, "warn")
    launcher.launch()
    assert keep.rows[NAN_STEP]["count"] == want[NAN_STEP]["count"] == NAN_STEP + 1
    assert runtime.health.summary()["skipped_steps"] == jmon.summary()["skipped_steps"] == 0
    assert runtime.health.summary()["anomalies"] == jmon.summary()["anomalies"] == 1
    off = _port_tree(tmp_path / "off", jparams, data, 1, None, "warn", health=False)
    off[3].launch()
    for step, (g, o) in enumerate(zip(keep.rows, off[2].rows)):
        for a, b in zip(jax.tree.leaves(g["params"]), jax.tree.leaves(o["params"])):
            assert np.array_equal(a, b), step
    got, ref = keep.rows[-1]["params"], want[-1]["params"]
    got_k, ref_k = _split_k_bias(got), _split_k_bias(ref)
    for i in ref_k:
        np.testing.assert_allclose(got_k[i], ref_k[i], atol=2 * STEPS * SCHEDULE["base_lr"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


# -- what the gate's update rule takes ---------------------------------------------

REFUSED = {  # case -> (factory over the param leaves, what the refusal names)
    "adam_l2": (lambda ps: torch.optim.Adam(ps, lr=0.0, weight_decay=0.1), "weight_decay=0.1"),
    "amsgrad": (lambda ps: torch.optim.AdamW(ps, lr=0.0, amsgrad=True), "amsgrad=True"),
    "maximize": (lambda ps: torch.optim.SGD(ps, lr=0.0, maximize=True), "maximize=True"),
    "dampening": (lambda ps: torch.optim.SGD(ps, lr=0.0, momentum=0.9, dampening=0.1),
                  "dampening=0.1"),
    "rmsprop": (lambda ps: torch.optim.RMSprop(ps, lr=0.0), "RMSprop"),
}


class _Steps(Capsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.seen = module, []

    def launch(self, attrs=None):
        self.seen.append(self.module.state["step"])


@pytest.mark.parametrize("case", list(REFUSED))
def test_gate_refuses_a_rule_it_would_compute_otherwise(tmp_path, case):
    """``gated_step`` implements part of each rule: an option outside it is
    named at setup under a gating action, never dropped; ``warn`` takes the
    plain update and runs it."""
    make, named = REFUSED[case]
    assert named in toptim.gate_refusal(make([torch.zeros(3, requires_grad=True)]))
    _, jparams = _jparams()
    for action in ("skip_step", "warn"):
        model = tt.TransformerLM(tt.TransformerConfig(**CFG))
        runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path / action),
                             health=True, anomaly_action=action)
        runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
        module = rt.Module(model, [rt.Loss(_torch_objective),
                                   rt.Optimizer(lambda p: make(toptim.param_leaves(p)))])
        steps = _Steps(module)
        launcher = rt.Launcher([rt.Looper([rt.Dataset(_Data(B), batch_size=B), module, steps],
                                          progress=False)], runtime=runtime)
        if action == "warn":
            launcher.launch()
            assert steps.seen == [1]
            continue
        with pytest.raises(NotImplementedError, match=named):
            launcher.launch()


@pytest.mark.parametrize("factory", ["adamw", "adam", "lion", "sgd", "momentum"])
def test_gate_takes_the_ports_own_factories(factory):
    make = {"adamw": toptim.adamw(weight_decay=0.1), "adam": toptim.adam(),
            "lion": toptim.lion(), "sgd": toptim.sgd(weight_decay=0.1),
            "momentum": toptim.momentum(nesterov=True)}[factory]
    assert toptim.gate_refusal(make({"w": torch.zeros(3, 2, requires_grad=True),
                                     "b": torch.zeros(3, requires_grad=True)})) is None


# -- checkpoints ---------------------------------------------------------------------


def _health_state(seed):
    rng = np.random.default_rng(seed)
    return {"loss_ema": np.float32(rng.random()), "loss_sq_ema": np.float32(rng.random()),
            "count": np.int32(5), "skipped": np.int32(2), "anomalies": np.int32(3)}


def test_health_leaves_are_read_by_both_packages(tmp_path):
    state = _health_state(7)
    tio.save_pytree(str(tmp_path / "port"), {"params": {"w": torch.ones(2)},
                                             "health": {k: torch.from_numpy(np.array(v))
                                                        for k, v in state.items()}})
    read = jio.load_pytree(str(tmp_path / "port"))
    for key, value in state.items():
        assert np.array_equal(read[f"health/{key}"], value)
    jio.save_pytree(str(tmp_path / "jax"), {"params": {"w": jnp.ones(2)},
                                            "health": jax.tree.map(jnp.asarray, state)})
    flat = tio.load_pytree(str(tmp_path / "jax"))
    for key, value in state.items():
        assert np.array_equal(flat[f"health/{key}"], value)
    template = {"params": {"w": torch.zeros(2)}, "health": th.init_state()}
    back = tio.load_pytree(str(tmp_path / "jax"), template=template)
    assert float(back["health"]["loss_ema"]) == float(state["loss_ema"])
    assert int(back["health"]["skipped"]) == 2


def test_pre_health_checkpoint_resumes_with_fresh_sentinels(tmp_path):
    tio.save_pytree(str(tmp_path / "old"), {"params": {"w": torch.ones(2)}})
    template = {"params": {"w": torch.zeros(2)}, "health": th.init_state()}
    back = tio.load_pytree(str(tmp_path / "old"), template=template)
    assert torch.equal(back["params"]["w"], torch.ones(2))
    assert int(back["health"]["count"]) == 0 and int(back["health"]["skipped"]) == 0
    with pytest.raises(KeyError):  # any other missing leaf still fails
        tio.load_pytree(str(tmp_path / "old"), template={"params": {"w": torch.zeros(2)},
                                                         "healthy": torch.zeros(1)})
    # And through a Checkpointer: a tree resumed from a checkpoint written
    # without health runs with fresh sentinels.
    data = _Data(2 * B)
    _, jparams = _jparams()
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    plain = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path))
    plain.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
    module = rt.Module(model, [rt.Loss(_torch_objective), rt.Optimizer(toptim.adamw()),
                               rt.Scheduler(toptim.warmup_cosine_lr(**SCHEDULE))])
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=B), module,
                            rt.Checkpointer(str(tmp_path / "ck"), save_every=2)],
                           progress=False)], runtime=plain).launch()
    runtime, module, keep, launcher = _port_tree(tmp_path, jparams, data, 1, None, extra=(
        rt.Checkpointer(str(tmp_path / "ck2"), save_every=100,
                        resume_from=str(tmp_path / "ck" / "2"), resume_capsules=False),))
    launcher.launch()
    assert keep.rows[0]["count"] == 3 and keep.rows[0]["skipped"] == 0


# -- dump_and_halt ---------------------------------------------------------------------


def test_dump_and_halt_writes_a_resumable_bundle(tmp_path):
    data = _Data(STEPS * B, range(NAN_STEP * B, (NAN_STEP + 1) * B))
    _, jparams = _jparams()
    ck = rt.Checkpointer(str(tmp_path / "ck"), save_every=1000)
    runtime, module, keep, launcher = _port_tree(tmp_path, jparams, data, 1, None,
                                                 action="dump_and_halt", extra=(ck,))
    with pytest.raises(th.HealthAnomalyError) as err:
        launcher.launch()
    bundle = err.value.bundle
    assert bundle and os.path.isfile(os.path.join(bundle, "blackbox.json"))
    with open(os.path.join(bundle, "blackbox.json")) as f:
        manifest = json.load(f)
    assert manifest["checkpoint"] == "checkpoint" and manifest["last_good_step"] == NAN_STEP - 1
    # The bundle's state is the last good one: the held step changed nothing.
    last_good = keep.rows[NAN_STEP - 1]
    assert keep.rows[NAN_STEP]["count"] == last_good["count"]
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    again = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path / "again"))
    resumed = rt.Module(model, [rt.Loss(_torch_objective), rt.Optimizer(toptim.adamw()),
                                rt.Scheduler(toptim.warmup_cosine_lr(**SCHEDULE))])
    ck2 = rt.Checkpointer(str(tmp_path / "ck2"), resume_from=os.path.join(bundle, "checkpoint"),
                          resume_capsules=False)
    launcher = rt.Launcher([rt.Looper([rt.Dataset(_Data(B), batch_size=B), resumed, ck2],
                                      repeats=0, progress=False)], runtime=again)
    launcher.setup()
    try:
        view = resumed.prepared.checkpoint_state()
        for key, tree in (("params", view["params"]), ("mu", view["opt_state"]["0"]["mu"]),
                          ("nu", view["opt_state"]["0"]["nu"])):
            for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(lambda t: t.detach().numpy(), tree)),
                    jax.tree.leaves(last_good[key])):
                assert np.array_equal(g, w), (key, jax.tree_util.keystr(path))
        # The lagged word halted the run one step later (fetch lag 1); the
        # gate's latch held that step too, which only moved the data on.
        assert view["step"] == NAN_STEP + 2
    finally:
        launcher.destroy()
