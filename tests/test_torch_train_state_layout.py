"""A train-state checkpoint resumes across the packages: the port writes
the reference's leaf names (``opt_state`` under optax's chain indices and
field names, ``step`` int32, ``base_key`` uint32[2]) and reads them, and
still reads its own old layout (``optimizer/<key>/<path>``, an int key).

The same MLP tree (8 -> 16 -> 4, f32, bridged weights, dropout-free) runs
two epochs of four waves in each package under three optimizers: AdamW
with its decay mask under a warmup-cosine Scheduler, momentum SGD with
``clip_norm``, and Lion with both. Each package drains after wave 3; the
port resumes the JAX package's drain and the JAX package the port's, and
each resumed run ends within the plain f32 parity tolerance of
``tests/test_torch_core.py`` (2e-5 absolute and relative) of the
uninterrupted run of the other package, and the port's also of its own.
The leaf names, dtypes and shapes of the two drains are equal; the key
crosses both ways with the same bits; an old-layout file resumes bitwise
as its new-layout twin does.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.models.mlp import MLP as JMLP
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import bridge
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.models.mlp import MLP
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.runtime import checkpoint_io as tio

torch.set_num_threads(1)

#: Plain f32 optimizer parity (tests/test_torch_core.py).
TOL = 2e-5
STEPS = 8  # two epochs of four waves

#: name -> (port factory, JAX factory, schedule, clip_norm)
OPTS = {
    "adamw": (lambda: toptim.adamw(weight_decay=0.1), lambda: joptim.adamw(weight_decay=0.1),
              True, None),
    "momentum": (lambda: toptim.momentum(0.9), lambda: joptim.momentum(0.9), False, 1.0),
    "lion": (lambda: toptim.lion(weight_decay=0.1), lambda: joptim.lion(weight_decay=0.1),
             True, 1.0),
}
LR = {"adamw": 1e-2, "momentum": 5e-2, "lion": 1e-3}


def _data(n=128):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(size=8).astype(np.float32), "label": np.int32(i % 4)}
            for i in range(n)]


def _ce(batch):
    return F.cross_entropy(batch["logits"], batch["label"].long())


def _jce(batch):
    import optax

    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"], batch["label"]).mean()


def _jparams():
    model = JMLP(in_features=8, num_classes=4, hidden=(16,))
    return model, jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])


def _jstate():
    """The MLP's (empty) model state, laid out per layer."""
    model = JMLP(in_features=8, num_classes=4, hidden=(16,))
    return jax.jit(model.init)(jax.random.key(1)).get("state", {})


class _Drain(rt.Capsule):
    def __init__(self, after):
        super().__init__(priority=500)
        self._after, self._seen = after, 0

    def launch(self, attrs=None):
        self._seen += 1
        if self._seen == self._after:
            self._runtime.drain.request("test-preemption")


class _JDrain(jrt.Capsule):
    def __init__(self, after):
        super().__init__(priority=500)
        self._after, self._seen = after, 0

    def launch(self, attrs=None):
        self._seen += 1
        if self._seen == self._after:
            self._runtime.drain.request("test-preemption")


class _JGrab(jrt.Capsule):
    """The JAX step's state as numpy after each wave (it is donated)."""

    def __init__(self, prepared):
        super().__init__(priority=10)
        self._prepared = prepared
        self.step = self.params = None

    def launch(self, attrs=None):
        self.step = int(np.asarray(self._prepared.state["step"]))
        self.params = jax.tree.map(np.asarray, self._prepared.state["params"])


def _port_run(tmp, opt, ckpt, drain_after=None):
    """The port's tree; returns its PreparedModule after the run (or the
    drain's checkpoint path)."""
    make, _, schedule, clip = OPTS[opt]
    _, jparams = _jparams()
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp))
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    prepared = PreparedModule(model, {"params": params_from_jax(jparams)})
    runtime.models.add(model, prepared)
    children = [rt.Loss(_ce), rt.Optimizer(make(), learning_rate=LR[opt], clip_norm=clip)]
    if schedule:
        children.append(rt.Scheduler(toptim.warmup_cosine_lr(LR[opt], 2, STEPS)))
    capsules = [rt.Dataset(_data(), batch_size=32, device_cache=False), rt.Module(model, children)]
    if drain_after is not None:
        capsules.append(_Drain(drain_after))
    capsules.append(rt.Checkpointer(output_dir=str(ckpt), save_every=1000, resume_from="latest"))
    launcher = rt.Launcher([rt.Looper(capsules, tag="train", progress=False)], num_epochs=2,
                           runtime=runtime)
    if drain_after is not None:
        with pytest.raises(SystemExit) as drained:
            launcher.launch()
        return drained.value.checkpoint
    launcher.launch()
    return prepared


def _jax_run(tmp, opt, ckpt, drain_after=None):
    _, make, schedule, clip = OPTS[opt]
    jmodel, jparams = _jparams()
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                       project_dir=str(tmp))
    prepared = JPrepared(jmodel, {"params": jax.tree.map(jnp.asarray, jparams),
                                  "model_state": _jstate(), "step": jnp.zeros((), jnp.int32),
                                  "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(jmodel, prepared)
    children = [jrt.Loss(_jce), jrt.Optimizer(make(), learning_rate=LR[opt], clip_norm=clip)]
    if schedule:
        children.append(jrt.Scheduler(joptim.warmup_cosine_lr(LR[opt], 2, STEPS)))
    grab = _JGrab(prepared)
    capsules = [jrt.Dataset(_data(), batch_size=32, device_cache=False),
                jrt.Module(jmodel, children), grab]
    if drain_after is not None:
        capsules.append(_JDrain(drain_after))
    capsules.append(jrt.Checkpointer(output_dir=str(ckpt), save_every=1000,
                                     resume_from="latest"))
    launcher = jrt.Launcher([jrt.Looper(capsules, tag="train", progress=False)], num_epochs=2,
                            runtime=runtime)
    if drain_after is not None:
        with pytest.raises(SystemExit) as drained:
            launcher.launch()
        return drained.value.checkpoint
    launcher.launch()
    return grab


def _port_params(prepared):
    return jax.tree.map(lambda t: t.detach().numpy().copy(), prepared.state["params"])


def _close(got, want, tol=TOL):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=sorted(OPTS))
def runs(request, tmp_path_factory):
    """Each package's uninterrupted run and its drain after wave 3."""
    opt = request.param
    tmp = tmp_path_factory.mktemp(opt)
    return {"opt": opt, "tmp": tmp,
            "port": _port_params(_port_run(tmp / "pw", opt, tmp / "pw_ck")),
            "jax": _jax_run(tmp / "jw", opt, tmp / "jw_ck").params,
            "port_drain": _port_run(tmp / "pd", opt, tmp / "pd_ck", drain_after=3),
            "jax_drain": _jax_run(tmp / "jd", opt, tmp / "jd_ck", drain_after=3)}


def _index(step_dir):
    with open(os.path.join(step_dir, "model_0", "index.json")) as f:
        return json.load(f)


def test_the_drains_have_the_same_leaves(runs):
    got, want = _index(runs["port_drain"]), _index(runs["jax_drain"])
    assert sorted(got) == sorted(want)
    for name, meta in want.items():
        assert got[name]["kind"] == meta["kind"], name
        if meta["kind"] == "array":
            assert (got[name]["dtype"], got[name]["shape"]) == (meta["dtype"], meta["shape"]), name
    assert any(name.startswith("opt_state/") for name in got)
    assert not any(name.startswith("optimizer/") for name in got)
    assert (got["step"]["dtype"], got["base_key"]["dtype"], got["base_key"]["shape"]) == (
        "int32", "uint32", [2])


def test_the_port_resumes_the_references_drain(runs):
    tmp = runs["tmp"]
    ckpt = tmp / "port_from_jax"
    shutil.copytree(runs["jax_drain"], ckpt / "3")
    prepared = _port_run(tmp / "pj", runs["opt"], ckpt)
    assert prepared.state["step"] == STEPS
    _close(_port_params(prepared), runs["jax"])
    _close(_port_params(prepared), runs["port"])


def test_the_reference_resumes_the_ports_drain(runs):
    tmp = runs["tmp"]
    ckpt = tmp / "jax_from_port"
    shutil.copytree(runs["port_drain"], ckpt / "3")
    grab = _jax_run(tmp / "jp", runs["opt"], ckpt)
    assert grab.step == STEPS
    _close(grab.params, runs["port"])
    _close(grab.params, runs["jax"])


def test_an_old_layout_checkpoint_still_resumes(runs):
    """The port's drain rewritten in the layout of the port's earlier
    checkpoints (torch's per-param keys under ``optimizer/``, ``step`` a
    JSON int, ``base_key`` the int) resumes bitwise as the new file does."""
    tmp = runs["tmp"]
    step_dir = Path(runs["port_drain"])
    flat = tio.load_pytree(str(step_dir / "model_0"))
    chain = bridge.OptChain(*{"adamw": ("adamw", True, False),
                              "momentum": ("momentum", False, True),
                              "lion": ("lion", True, True)}[runs["opt"]])
    old = bridge.train_state_from_jax(tio.unflatten(flat), chain)
    old["base_key"] = keys.from_data(old["base_key"])
    if runs["opt"] != "adamw":
        old["optimizer"].pop("step", None)  # torch's SGD and Lion keep no count
    ckpt = tmp / "old_layout"
    shutil.copytree(step_dir, ckpt / "3")
    shutil.rmtree(ckpt / "3" / "model_0")
    tio.save_pytree(str(ckpt / "3" / "model_0"), old)
    index = _index(ckpt / "3")
    assert index["step"] == {"kind": "json", "value": 3}
    assert index["base_key"]["kind"] == "json" and "opt_state/0/count" not in index
    assert any(name.startswith("optimizer/") for name in index)
    from_old = _port_run(tmp / "po", runs["opt"], ckpt)
    new = tmp / "new_layout"
    shutil.copytree(step_dir, new / "3")
    from_new = _port_run(tmp / "pn", runs["opt"], new)
    for g, w in zip(jax.tree.leaves(_port_params(from_old)), jax.tree.leaves(
            _port_params(from_new))):
        np.testing.assert_array_equal(g, w)
    _close(_port_params(from_new), runs["port"])


# -- the key -------------------------------------------------------------------


def _prepared_with_key(key):
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    _, jparams = _jparams()
    return PreparedModule(model, {"params": params_from_jax(jparams), "step": 5,
                                  "base_key": key})


def _jax_template(jparams):
    return {"params": jax.tree.map(jnp.asarray, jparams), "model_state": _jstate(),
            "step": jnp.zeros((), jnp.int32),
            "base_key": jax.random.key_data(jax.random.key(0))}


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_the_key_round_trips_port_reference_port(tmp_path, seed):
    key = keys.key(seed)
    tio.save_pytree(str(tmp_path / "port"), _prepared_with_key(key).checkpoint_state())
    _, jparams = _jparams()
    jstate = jio.load_pytree(str(tmp_path / "port"), _jax_template(jparams))
    words = np.asarray(jstate["base_key"])
    np.testing.assert_array_equal(words, keys.to_data(key))
    assert int(jstate["step"]) == 5
    # The reference uses them as its key and writes them back.
    jax.random.fold_in(jax.random.wrap_key_data(jstate["base_key"]), 1)
    jio.save_pytree(str(tmp_path / "jax"), jstate)
    back = _prepared_with_key(0)
    back.load_checkpoint_state(tio.unflatten(tio.load_pytree(str(tmp_path / "jax"))))
    assert back.state["base_key"] == key and back.state["step"] == 5


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_the_key_round_trips_reference_port_reference(tmp_path, seed):
    _, jparams = _jparams()
    words = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), 3)[2]))
    assert words[0] != 0  # both words carry bits
    jio.save_pytree(str(tmp_path / "jax"), {**_jax_template(jparams),
                                            "base_key": jnp.asarray(words),
                                            "step": jnp.asarray(4, jnp.int32)})
    prepared = _prepared_with_key(0)
    prepared.load_checkpoint_state(tio.unflatten(tio.load_pytree(str(tmp_path / "jax"))))
    assert prepared.state["base_key"] == keys.from_data(words)
    tio.save_pytree(str(tmp_path / "port"), prepared.checkpoint_state())
    again = jio.load_pytree(str(tmp_path / "port"), _jax_template(jparams))
    np.testing.assert_array_equal(np.asarray(again["base_key"]), words)
    assert np.asarray(again["base_key"]).dtype == np.uint32


def test_key_data_maps_the_old_int_to_itself():
    for k in (0, 1, 0xFFFFFFFF, keys.key(3)):
        assert keys.from_data(keys.to_data(k)) == k
    assert keys.from_data([1, 0]) != keys.from_data([0, 1])


# -- the chain map ----------------------------------------------------------------


@pytest.mark.parametrize("kind,schedule,clip", [
    ("adamw", False, False), ("adamw", True, True), ("adam", True, False),
    ("lion", False, True), ("momentum", True, False), ("sgd", True, False),
    ("sgd_decay", True, True)])
def test_the_chain_names_optax_gives(kind, schedule, clip):
    """Every leaf name the port writes for a chain is one optax's state
    has for the same factory, and no optax leaf is missing."""
    import optax

    from rocket_tpu.utils.pytree import key_path_str

    factory = {"adamw": joptim.adamw(weight_decay=0.1), "adam": joptim.adam(),
               "lion": joptim.lion(weight_decay=0.1), "momentum": joptim.momentum(),
               "sgd": joptim.sgd(), "sgd_decay": joptim.sgd(weight_decay=0.1)}[kind]
    _, jparams = _jparams()
    tx = joptim.resolve(factory, joptim.warmup_cosine_lr(1e-2, 2, 10) if schedule else 1e-2)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(1.0), tx)
    want = {key_path_str(p): np.asarray(v).dtype
            for p, v in jax.tree_util.tree_flatten_with_path(tx.init(jparams))[0]}
    view = {"params": params_from_jax(jparams), "step": 0, "base_key": 0, "optimizer": {}}
    tree = bridge.train_state_to_jax(view, bridge.OptChain(kind, schedule, clip), count=0)
    got = {name[len("opt_state/"):]: np.asarray(leaf).dtype
           for name, leaf in ((n, v) for n, v in _flat(tree) if n.startswith("opt_state/"))}
    assert got == want


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat(v, name + "/")
        else:
            yield name, v


def test_opt_chain_of_the_ports_factories():
    params = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    assert bridge.opt_chain(toptim.adamw()(params)).kind == "adamw"
    assert bridge.opt_chain(toptim.adam()(params)).kind == "adam"
    assert bridge.opt_chain(toptim.lion()(params), schedule=True) == bridge.OptChain(
        "lion", True, False)
    assert bridge.opt_chain(toptim.momentum()(params)).kind == "momentum"
    assert bridge.opt_chain(toptim.sgd()(params)).kind == "sgd"
    assert bridge.opt_chain(toptim.sgd(weight_decay=0.1)(params)).kind == "sgd_decay"
    assert bridge.opt_chain(torch.optim.RMSprop([params["w"]])) is None
    with pytest.raises(ValueError):
        bridge.OptChain("rmsprop")


def test_counts_that_disagree_raise():
    view = {"params": {"w": np.zeros(2, np.float32)}, "step": 2, "base_key": 0,
            "optimizer": {}}
    chain = bridge.OptChain("adamw", schedule=True)
    tree = bridge.train_state_to_jax(view, chain, count=2)
    tree["opt_state"]["2"]["count"] = np.asarray(1, np.int32)
    with pytest.raises(ValueError, match="counts disagree"):
        bridge.train_state_from_jax(tree, chain)
