"""The port's capsule core, optimizers and schedules against the JAX
package.

* Three (or four) Launcher steps of the port against the same steps of the
  JAX Launcher: ``Dataset(shuffle=False)`` over one token stream, AdamW
  with weight decay (and a clip), warmup-cosine, gradient accumulation 1
  and 2. Both trees start from the same bridged params, pre-registered in
  each runtime's models registry (the JAX mechanism,
  ``rocket_tpu/core/module.py:287``). Losses, learning rates and the final
  params must agree.
* Every schedule, value by value against the JAX (optax) functions.
* The capsule semantics the tree relies on: the nested-Looper guard,
  Loss/Optimizer pairing, ``run_every``, ``Dataset`` totals and seeded
  shuffles, the one-runtime binding.

Tolerances, float32: losses 1e-5; params 2e-5 after the updates, except
the k segment of the qkv bias (its true gradient is zero, see the test);
schedules 1e-6 relative (optax computes in f32, the port in Python
floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models import transformer as tt

CFG = dict(vocab_size=96, max_seq_len=64, dim=64, num_layers=2, num_heads=2, dropout=0.0,
           loss_chunk=16)
B, T = 2, 32


class _JRecord(JCapsule):
    """Per-step (loss, lr) and the params after the step (the JAX step
    donates its state, and destroy drops the prepared record)."""

    def __init__(self, module):
        super().__init__(priority=10)
        self.module = module
        self.rows = []

    def launch(self, attrs=None):
        m = attrs.step_metrics
        self.rows.append((float(np.asarray(m["loss"])), float(np.asarray(m["lr"]))))
        self.params = jax.tree.map(np.asarray, self.module.state["params"])


class _Record(Capsule):
    def __init__(self):
        super().__init__(priority=10)
        self.rows = []

    def launch(self, attrs=None):
        m = attrs.step_metrics
        self.rows.append((float(m["loss"]), float(m["lr"])))


@pytest.mark.parametrize("accum,steps,clip", [(1, 3, 0.5), (2, 4, None)])
def test_launcher_steps_match_the_jax_launcher(tmp_path, accum, steps, clip):
    tokens = np.random.default_rng(4).integers(0, CFG["vocab_size"], steps * B * T)
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1))["params"])
    schedule = dict(base_lr=1e-2, warmup_steps=1, decay_steps=4)

    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                        gradient_accumulation_steps=accum, project_dir=str(tmp_path))
    jruntime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32),
        "base_key": jax.random.key_data(jax.random.key(0))}))
    jmodule = jrt.Module(jmodel, [jrt.Loss(jt.next_token_loss()),
                                  jrt.Optimizer(joptim.adamw(weight_decay=0.1), clip_norm=clip),
                                  jrt.Scheduler(joptim.warmup_cosine_lr(**schedule))])
    jrec = _JRecord(jmodule)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokenDataset(tokens, T), batch_size=B), jmodule,
                              jrec], progress=False)], runtime=jruntime).launch()

    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    runtime = rt.Runtime(device="cpu", seed=0, gradient_accumulation_steps=accum)
    prepared = PreparedModule(model, {"params": params_from_jax(jparams)})
    runtime.models.add(model, prepared)
    rec = _Record()
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(toptim.adamw(weight_decay=0.1), clip_norm=clip),
                               rt.Scheduler(toptim.warmup_cosine_lr(**schedule))])
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(tokens, T), batch_size=B), module, rec],
                           progress=False)], runtime=runtime).launch()

    assert len(rec.rows) == len(jrec.rows) == steps
    np.testing.assert_allclose(rec.rows, jrec.rows, atol=1e-5, rtol=1e-5)
    assert prepared.state["step"] == steps
    got = jax.tree.map(lambda t: t.detach().numpy(), prepared.state["params"])
    dim = CFG["dim"]
    for i in map(str, range(CFG["num_layers"])):
        # The k segment of the qkv bias has a gradient of exactly zero in
        # exact arithmetic (softmax is shift-invariant per query row), so
        # both frameworks feed Adam pure rounding noise there, which its
        # g / (|g| + eps) turns into lr-sized steps of either sign. Only
        # a bound holds for it.
        for tree in (got, jrec.params):
            b = tree["blocks"][i]["attn"]["qkv"]["b"]
            tree["blocks"][i]["attn"]["qkv"]["b"] = np.concatenate([b[:dim], b[2 * dim:]])
            tree["blocks"][i]["attn"]["k_bias"] = b[dim:2 * dim]
        np.testing.assert_allclose(got["blocks"][i]["attn"].pop("k_bias"),
                                   jrec.params["blocks"][i]["attn"].pop("k_bias"),
                                   atol=2 * steps * schedule["base_lr"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jrec.params)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    # The updates moved the params (lr 0 only at the first update).
    assert not np.allclose(jax.tree.leaves(got)[0], jax.tree.leaves(jparams)[0])


SCHEDULES = [
    ("constant_lr", (3e-4,), {}),
    ("step_lr", (1e-2, 3), {"gamma": 0.5}),
    ("cosine_lr", (1e-2, 10), {"alpha": 0.1}),
    ("linear_lr", (1e-2, 7), {"end_lr": 1e-3}),
    ("warmup_stable_decay_lr", (1e-2, 3, 20, 5), {"end_lr": 1e-4}),
    ("warmup_cosine_lr", (6e-4, 4, 16), {}),
    ("warmup_cosine_lr", (6e-4, 0, 16), {"end_lr": 6e-5}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES, ids=[s[0] + str(i)
                                                          for i, s in enumerate(SCHEDULES)])
def test_schedules_match_optax(name, args, kw):
    ours, ref = getattr(toptim, name)(*args, **kw), getattr(joptim, name)(*args, **kw)
    for step in range(25):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-9)
    if name == "warmup_cosine_lr" and args[1] > 0:
        assert ours(0) == 0.0  # the first update of a warmup has lr 0


@pytest.mark.parametrize("factory", ["sgd", "adam", "adamw"])
def test_optimizer_update_matches_optax(factory):
    """Two updates of each factory against optax on one param tree (a
    matrix, a bias): the decay mask exempts the 1-D bias under adamw."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    kw = {"sgd": dict(weight_decay=0.1), "adam": {}, "adamw": dict(weight_decay=0.1)}[factory]
    tx = getattr(joptim, factory)(**kw)(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = toptim.resolve(getattr(toptim, factory)(**kw), tp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = 1e-2
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)


def test_capsule_tree_guards():
    with pytest.raises(RuntimeError, match="nested"):
        rt.Looper([rt.Looper([])])
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    data = TokenDataset(np.arange(4 * T), T)
    for capsules in ([rt.Loss(tt.next_token_loss())],
                     [rt.Optimizer(toptim.adamw())]):
        tree = rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=2),
                                       rt.Module(model, capsules)], progress=False)],
                           runtime=rt.Runtime(device="cpu"))
        with pytest.raises(RuntimeError, match="requires"):
            tree.launch()
    # Rebinding a capsule to a second runtime is refused.
    ds = rt.Dataset(data, batch_size=2)
    ds.bind(rt.Runtime(device="cpu"))
    with pytest.raises(RuntimeError, match="different runtime"):
        ds.bind(rt.Runtime(device="cpu"))
    # A sharding rule over a non-data axis (tensor parallelism) is refused
    # when the Module lays the params out.
    tree = rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=2), rt.Module(
        model, [rt.Loss(tt.next_token_loss()), rt.Optimizer(toptim.adamw())],
        param_sharding=lambda path, leaf: ("model",))], progress=False)],
        runtime=rt.Runtime(device="cpu"))
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        tree.launch()
    with pytest.raises(ValueError, match="ema_decay"):  # EMA is ported; its decay is checked
        rt.Module(model, ema_decay=1.5)


def test_dataset_totals_order_and_run_every():
    data = TokenDataset(np.arange(7 * 4), 4)  # 7 windows
    runtime = rt.Runtime(device="cpu", seed=3)
    seen = []

    class Grab(Capsule):
        def launch(self, attrs=None):
            seen.append(attrs.batch["tokens"][:, 0].tolist())

    for drop_last, total in ((True, 3), (False, 4)):
        ds = rt.Dataset(data, batch_size=2, drop_last=drop_last)
        ds.bind(runtime)
        assert ds.total == total
    seen.clear()
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=2, drop_last=True), Grab()],
                           progress=False)], runtime=runtime).launch()
    assert seen == [[0, 4], [8, 12], [16, 20]]
    shuffled = []
    for _ in range(2):
        seen.clear()
        rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=7, shuffle=True), Grab()],
                               progress=False)], num_epochs=2,
                    runtime=rt.Runtime(device="cpu", seed=3)).launch()
        shuffled.append([list(s) for s in seen])
    assert shuffled[0] == shuffled[1]                    # seeded: reproducible
    assert shuffled[0][0] != shuffled[0][1]              # reshuffled each epoch
    assert sorted(shuffled[0][0]) == list(range(0, 28, 4))
    seen.clear()
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=7), Grab()], run_every=2,
                           progress=False)], num_epochs=3,
                runtime=rt.Runtime(device="cpu")).launch()
    assert len(seen) == 2                                # epochs 0 and 2


def test_runtime_seeds_and_registry():
    a, b = rt.Runtime(device="cpu", seed=5), rt.Runtime(device="cpu", seed=5)
    assert [a.next_seed() for _ in range(3)] == [b.next_seed() for _ in range(3)]
    assert rt.Runtime.current() is b
    assert rt.Runtime(device="cpu", seed=6).next_seed() != rt.Runtime(device="cpu",
                                                                      seed=5).next_seed()
    model = object()
    a.models.add(model, "prepared")
    assert a.models.lookup(model) == "prepared"
    with pytest.raises(RuntimeError, match="already prepared"):
        a.models.add(model, "again")
    with pytest.raises(RuntimeError):
        rt.Runtime(device="cpu", gradient_accumulation_steps=0)
