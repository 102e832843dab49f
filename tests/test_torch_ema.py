"""EMA params of the port's ``Module`` against the JAX package's.

* A tiny MLP trained 4 steps with ``ema_decay=0.9`` (momentum SGD, at
  gradient accumulation 1 and 2) in both packages from one bridged start:
  params and ``ema_params`` within 1e-5 (float32, the same updates summed
  in another order); under accumulation the shadow moves once per window.
* An eval Module with ``use_ema=True`` forwards with the shadow: its
  logits are the model's at ``ema_params`` (and not at ``params``).
* The error cases: ``ema_decay`` outside (0, 1), ``ema_decay`` without an
  Optimizer child, ``use_ema`` with no shadow.
* Checkpoints: each package reads the ``ema_params/...`` leaves the other
  wrote, and a checkpoint written without EMA seeds the shadow from its
  params (the optional-leaf rule), while any other missing leaf fails.
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
from rocket_tpu.data.datasets import ArrayDataset as JArrayDataset
from rocket_tpu.models.mlp import MLP as JMLP
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.models.mlp import MLP
from rocket_tpu_torch.runtime import checkpoint_io as tio

TOL = 1e-5
B, STEPS, DECAY, LR = 4, 4, 0.9, 0.05
IN, HIDDEN, CLASSES = 12, (16,), 5


def _data(n=B * STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, IN)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _jax_ce(batch):
    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"].astype(jnp.float32),
                                                           batch["label"]).mean()


def _torch_ce(batch):
    return torch.nn.functional.cross_entropy(batch["logits"].float(), batch["label"].long())


def _jax_start():
    """The JAX MLP, its params and its (empty) layer state."""
    jmodel = JMLP(IN, CLASSES, hidden=HIDDEN)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(3)))
    return jmodel, variables["params"], variables["state"]


class _JKeep(JCapsule):
    """The live params and shadow after each step (the JAX step donates its
    state, and destroy drops the prepared record)."""

    def __init__(self, module):
        super().__init__(priority=10)
        self.module = module
        self.trace = []

    def launch(self, attrs=None):
        state = self.module.state
        self.trace.append((jax.tree.map(np.asarray, state["params"]),
                           jax.tree.map(np.asarray, state["ema_params"])))


def _run_jax(jmodel, params, mstate, images, labels, accum, tmp_path):
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                       gradient_accumulation_steps=accum, project_dir=str(tmp_path))
    runtime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, params), "model_state": mstate,
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    module = jrt.Module(jmodel, [jrt.Loss(_jax_ce), jrt.Optimizer(joptim.momentum(0.9),
                                                                  learning_rate=LR)],
                        ema_decay=DECAY)
    keep = _JKeep(module)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JArrayDataset(images, labels), batch_size=B), module,
                              keep], progress=False)], runtime=runtime).launch()
    return keep.trace


class _Keep(Capsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module = module
        self.trace = []

    def launch(self, attrs=None):
        state = self.module.state
        grab = lambda tree: jax.tree.map(lambda t: t.detach().numpy().copy(), tree)  # noqa: E731
        self.trace.append((grab(state["params"]), grab(state["ema_params"])))


def _port_tree(params, images, labels, accum, extra=()):
    model = MLP(IN, CLASSES, hidden=HIDDEN)
    runtime = rt.Runtime(device="cpu", seed=0, gradient_accumulation_steps=accum)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(params)}))
    module = rt.Module(model, [rt.Loss(_torch_ce), rt.Optimizer(toptim.momentum(0.9),
                                                                learning_rate=LR)],
                       ema_decay=DECAY)
    keep = _Keep(module)
    launcher = rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=B),
                                       module, keep, *extra], progress=False)], runtime=runtime)
    return model, module, keep, launcher


def _close(got, want, what):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("accum", [1, 2])
def test_ema_params_match_jax_over_four_steps(tmp_path, accum):
    jmodel, params, mstate = _jax_start()
    images, labels = _data()
    want = _run_jax(jmodel, params, mstate, images, labels, accum, tmp_path)
    _, _, keep, launcher = _port_tree(params, images, labels, accum)
    launcher.launch()
    assert len(keep.trace) == len(want) == STEPS
    for step, ((p, e), (jp, je)) in enumerate(zip(keep.trace, want)):
        _close(p, jp, f"params after step {step}")
        _close(e, je, f"ema_params after step {step}")
    # The shadow moves once per update: under accumulation it stands still
    # through the first step of a window; it lags the params once they moved.
    start = jax.tree.leaves(params)
    first_ema = jax.tree.leaves(keep.trace[0][1])
    assert all(np.array_equal(e, s) for e, s in zip(first_ema, start)) == (accum == 2)
    last_p, last_e = keep.trace[-1]
    assert not np.allclose(jax.tree.leaves(last_p)[0], jax.tree.leaves(last_e)[0])


def test_use_ema_eval_forwards_with_the_shadow():
    _, params, _ = _jax_start()
    images, labels = _data()
    seen = []

    model = MLP(IN, CLASSES, hidden=HIDDEN)
    runtime = rt.Runtime(device="cpu", seed=0)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(params)}))
    train = rt.Module(model, [rt.Loss(_torch_ce), rt.Optimizer(toptim.momentum(0.9),
                                                               learning_rate=LR)],
                      ema_decay=DECAY)

    class Grab(Capsule):
        """The eval logits, and the model's logits at the live shadow and
        params for the same batch."""

        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            state = train.state
            x = {"image": attrs.batch["image"]}
            with torch.no_grad():
                seen.append((attrs.batch["logits"].clone(),
                             model.apply(state["ema_params"], x, mode="eval")["logits"],
                             model.apply(state["params"], x, mode="eval")["logits"]))

    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=B), train],
                           tag="train", progress=False),
                 rt.Looper([rt.Dataset(ArrayDataset(images[:B], labels[:B]), batch_size=B),
                            rt.Module(model, use_ema=True), Grab()],
                           tag="val", grad_enabled=False, progress=False)],
                runtime=runtime).launch()
    assert len(seen) == 1
    got, at_ema, at_params = seen[0]
    assert torch.equal(got, at_ema)
    assert not torch.allclose(got, at_params)


def test_ema_error_cases():
    model = MLP(IN, CLASSES, hidden=HIDDEN)
    for bad in (0.0, 1.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="ema_decay"):
            rt.Module(model, ema_decay=bad)
    images, labels = _data(B)
    # ema_decay on a Module with no Optimizer child.
    tree = rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=B),
                                   rt.Module(model, ema_decay=0.9)], progress=False)],
                       runtime=rt.Runtime(device="cpu"))
    with pytest.raises(RuntimeError, match="ema_decay requires an Optimizer"):
        tree.launch()
    # use_ema with no train Module keeping a shadow.
    tree = rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=B),
                                   rt.Module(MLP(IN, CLASSES, hidden=HIDDEN), use_ema=True)],
                                  tag="val", grad_enabled=False, progress=False)],
                       runtime=rt.Runtime(device="cpu"))
    with pytest.raises(RuntimeError, match="no EMA shadow"):
        tree.launch()


def _jax_view(params, ema):
    return {"params": jax.tree.map(jnp.asarray, params),
            "ema_params": jax.tree.map(jnp.asarray, ema), "step": 3}


def test_checkpoints_carry_the_shadow_both_ways(tmp_path):
    _, params, _ = _jax_start()
    rng = np.random.default_rng(5)
    ema = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), params)
    # JAX writes, the port reads (template and flat).
    jio.save_pytree(str(tmp_path / "jax"), _jax_view(params, ema))
    template = {"params": params_from_jax(params), "ema_params": params_from_jax(params),
                "step": 0}
    got = tio.load_pytree(str(tmp_path / "jax"), template=template)
    _close(jax.tree.map(lambda t: t.numpy(), got["ema_params"]), ema, "port reads JAX's shadow")
    flat = tio.load_pytree(str(tmp_path / "jax"))
    assert sorted(k for k in flat if k.startswith("ema_params/")) == \
        sorted("ema_" + k for k in flat if k.startswith("params/"))
    # The port writes, JAX reads.
    tio.save_pytree(str(tmp_path / "port"), {"params": params_from_jax(params),
                                            "ema_params": params_from_jax(ema), "step": 3})
    back = jio.load_pytree(str(tmp_path / "port"), template=_jax_view(params, params))
    for g, w in zip(jax.tree.leaves(back["ema_params"]), jax.tree.leaves(ema)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_pre_ema_checkpoint_seeds_the_shadow_from_params(tmp_path, caplog):
    _, params, _ = _jax_start()
    tio.save_pytree(str(tmp_path), {"params": params_from_jax(params), "step": 2})
    template = {"params": params_from_jax(params),
                "ema_params": jax.tree.map(torch.zeros_like, params_from_jax(params)), "step": 0}
    with caplog.at_level("WARNING"):
        got = tio.load_pytree(str(tmp_path), template=template)
    assert sum("predates" in r.message for r in caplog.records) == 1   # one warning
    for g, w in zip(jax.tree.leaves(got["ema_params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g.numpy(), w)
    flat = tio.seed_optional(tio.load_pytree(str(tmp_path)), str(tmp_path))
    assert all(np.array_equal(flat["ema_" + k], v) for k, v in flat.items()
               if k.startswith("params/"))
    # The JAX package seeds the same leaves from the port's pre-EMA save.
    jback = jio.load_pytree(str(tmp_path), template=_jax_view(params, params))
    for g, w in zip(jax.tree.leaves(jback["ema_params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(g), w)
    # Any other missing leaf still fails ("health" is the other optional
    # leaf, matched exactly: a name merely starting with it is not).
    with pytest.raises(KeyError):
        tio.load_pytree(str(tmp_path), template={**template, "healthy": torch.zeros(2)})


def test_checkpointer_resumes_the_shadow_and_seeds_a_pre_ema_run(tmp_path):
    """Through the Checkpointer: an EMA run's checkpoint restores its shadow
    bitwise, and a run saved without EMA resumed with ``ema_decay`` starts
    the shadow at the restored params."""
    _, params, _ = _jax_start()
    images, labels = _data()

    def tree(ema, out_dir, resume_from=None, first=()):
        model = MLP(IN, CLASSES, hidden=HIDDEN)
        runtime = rt.Runtime(device="cpu", seed=0)
        runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(params)}))
        module = rt.Module(model, [rt.Loss(_torch_ce), rt.Optimizer(toptim.momentum(0.9),
                                                                    learning_rate=LR)],
                           ema_decay=DECAY if ema else None)
        ckpt = rt.Checkpointer(output_dir=str(out_dir), save_every=2, resume_from=resume_from)
        return module, rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels),
                                                          batch_size=B), *first, module, ckpt],
                                              progress=False)], runtime=runtime)

    plain_dir, ema_dir = tmp_path / "plain", tmp_path / "ema"
    _, launcher = tree(False, plain_dir)
    launcher.launch()
    _, launcher = tree(True, ema_dir)
    launcher.launch()
    saved = tio.load_pytree(str(ema_dir / "2" / "model_0"))
    assert any(k.startswith("ema_params/") for k in saved)

    class Peek(Capsule):
        """The shadow as the first resumed step finds it."""

        def __init__(self):
            super().__init__(priority=2000)   # ahead of the Module's step
            self.first = None

        def launch(self, attrs=None):
            if self.first is None:
                self.first = jax.tree.map(lambda t: t.detach().clone(),
                                          self.module.state["ema_params"])

    for src, from_ema in ((ema_dir, True), (plain_dir, False)):
        peek = Peek()
        module, launcher = tree(True, tmp_path / f"resumed_{from_ema}",
                                resume_from=str(src / "2"), first=(peek,))
        peek.module = module
        launcher.launch()
        flat = tio.load_pytree(str(src / "2" / "model_0"))
        for path, t in jax.tree_util.tree_leaves_with_path(peek.first):
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            key = ("ema_params/" if from_ema else "params/") + name
            np.testing.assert_array_equal(t.numpy(), flat[key], err_msg=key)
