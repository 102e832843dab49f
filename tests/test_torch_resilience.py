"""The port's resilience plane against the JAX package's: fault plans, the
drain protocol through the real Looper, the supervisor's decisions and its
``supervisor.json``, the watchdog's escalation exit, and the slice as a
whole under ``python -m rocket_tpu_torch.launch --supervise``.

Parity with the reference:

* ``FaultPlan.parse`` / ``to_spec`` of the same specs and ``sample(seed)``
  for seeds 0-31 give the same faults;
* ``decide`` over a table of ``LoopState`` x ``GenEvent`` x policy gives the
  same ``Decision``;
* the ``Supervisor`` under the same scripted exit codes and fake clock
  writes the same ``supervisor.json`` (less the wall-clock start stamps);
* a drain through each package's Looper on the same MLP tree (AdamW, f32)
  leaves the same step directory, ``drain.json``, capsule positions and
  params (each package reading the other's files), and each package's run
  resumed from its own drain ends at the same params, within the plain
  AdamW tolerance of ``tests/test_torch_core.py`` (2e-5 absolute and
  relative).

A train-state checkpoint resumes across the packages: the port writes
and reads the reference's leaf names (optax's ``opt_state``, an int32
``step``, ``uint32[2]`` key data; ``tests/test_torch_train_state_layout.py``
holds the layout). Besides params, the step layout, the capsule states and
``drain.json``, each package resumes the other's drain and ends where its
own resume ends.

The slice: a two-layer, width-64 GPT-2 in ``examples.gpt2.build``'s tree
on the CPU (f32 activations), killed in generation 0 by ``ROCKET_TPU_FAULTS``, restarted
by the supervising launcher from its last complete checkpoint: its final
params are bitwise those of the port's uninterrupted run, and within 2e-5
of the JAX package's uninterrupted run of the same tree from the same
(bridged) weights, the qkv bias's k segment within its bound (its true
gradient is zero; see ``tests/test_torch_core.py``).
"""

import ast
import dataclasses
import itertools
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
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
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.models.mlp import MLP as JMLP
from rocket_tpu.resilience import faults as jfaults
from rocket_tpu.resilience import supervisor as jsup
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.models.mlp import MLP
from rocket_tpu_torch.resilience import (
    EXIT_DRAINED,
    EXIT_WEDGED,
    DrainState,
    FaultInjector,
    FaultPlan,
    GracefulDrain,
    RestartPolicy,
    Supervisor,
    install_signal_drain,
    is_complete_checkpoint,
    newest_complete_step,
)
from rocket_tpu_torch.resilience import supervisor as tsup
from rocket_tpu_torch.runtime import checkpoint_io as tio

ROOT = Path(__file__).resolve().parents[1]
#: Plain AdamW parity, float32 (tests/test_torch_core.py).
TOL = 2e-5


# -- FaultPlan ---------------------------------------------------------------------


SPECS = ["kill:step=23;sigterm:wall=3.5;wedge:step=7,secs=600;poison:step=3,rank=1,gen=1",
         "kill:step=8,gen=0;wedge:step=4,gen=1,secs=600;sigterm:step=4,gen=2",
         "poison:step=3", " sigterm:wall=0.25 ; ;kill:step=1,rank=0 "]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_and_spec_match_the_reference(spec):
    plan, want = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert [dataclasses.asdict(f) for f in plan] == [dataclasses.asdict(f) for f in want]
    assert plan.to_spec() == want.to_spec()
    assert FaultPlan.parse(plan.to_spec()).faults == plan.faults


@pytest.mark.parametrize("bad", ["frobnicate:step=1", "kill:when=now", "kill:gen=0",
                                 "sigterm:rank=1", "kill:step"])
def test_fault_plan_strict_parse(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


@pytest.mark.parametrize("nproc,n", [(1, 1), (4, 3)])
def test_fault_plan_sample_matches_the_reference_for_seeds_0_to_31(nproc, n):
    for seed in range(32):
        got = FaultPlan.sample(seed, max_step=50, nproc=nproc, n=n)
        want = jfaults.FaultPlan.sample(seed, max_step=50, nproc=nproc, n=n)
        assert got.to_spec() == want.to_spec(), seed
        assert got.faults == FaultPlan.sample(seed, max_step=50, nproc=nproc, n=n).faults
    assert FaultPlan.sample(7, nproc=4, n=3).faults != FaultPlan.sample(8, nproc=4, n=3).faults


def test_exit_codes_and_environment_names_are_the_references():
    from rocket_tpu_torch.resilience import faults as tfaults

    for name in ("EXIT_DRAINED", "EXIT_WEDGED", "FAULTS_ENV", "GENERATION_ENV", "SUPERVISED_ENV",
                 "DRAIN_ENV"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name
    assert (EXIT_DRAINED, EXIT_WEDGED) == (84, 85)


# -- FaultInjector -----------------------------------------------------------------


def test_injector_scopes_by_generation_and_rank():
    plan = FaultPlan.parse("kill:step=2,rank=1;sigterm:step=5,gen=1")
    assert FaultInjector(plan, process_index=0, generation=0).active == []
    assert [f.kind for f in FaultInjector(plan, process_index=1, generation=0).active] == ["kill"]
    assert [f.kind for f in FaultInjector(plan, process_index=1, generation=1).active] == [
        "sigterm"]
    assert FaultInjector.from_env(environ={}) is None
    inj = FaultInjector.from_env(environ={"ROCKET_TPU_FAULTS": "kill:step=4",
                                          "ROCKET_TPU_GENERATION": "2"})
    assert inj.generation == 2 and inj.active == []


def test_injector_step_hook_counts_its_own_waves():
    fired, slept = [], []
    inj = FaultInjector(FaultPlan.parse("kill:step=3;wedge:step=5,secs=123"),
                        kill_fn=lambda: fired.append("kill"), sleep_fn=slept.append)
    for i in range(10, 16):  # a resumed loop's batch indices do not matter
        inj.step_hook("train", i)
    assert fired == ["kill"] and slept == [123.0]
    assert inj.fired == ("kill@train[12]", "wedge@train[14]")


def test_injector_sigterm_at_a_step_and_a_wall_time():
    sent = []
    inj = FaultInjector(FaultPlan.parse("sigterm:step=2;sigterm:wall=0.01"),
                        sigterm_fn=lambda: sent.append(1))
    inj.install()
    inj.step_hook("train", 0)
    inj.step_hook("train", 1)
    for timer in inj._timers:
        timer.join(5)
    assert len(sent) == 2 and sorted(inj.fired) == ["sigterm@train[1]", "sigterm@wall"]


def test_poison_of_numpy_batches_matches_the_reference():
    batch = {"image": np.ones((4, 8), np.float32), "label": np.arange(4),
             "pair": [np.zeros(3, np.float64), np.ones(2, np.int8)]}
    got, want = FaultInjector(FaultPlan.parse("poison:step=2")), jfaults.FaultInjector(
        jfaults.FaultPlan.parse("poison:step=2"))
    for k in range(3):
        a, b = got.poison_hook(batch), want.poison_hook(batch)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert np.isnan(a["image"]).all() == (k == 1)
    assert got.fired == want.fired == ("poison@batch[2]",)


def test_poison_of_cpu_tensors_stays_on_the_tensors_device():
    inj = FaultInjector(FaultPlan.parse("poison:step=1"))
    batch = {"x": torch.ones(2, 3, dtype=torch.bfloat16), "y": torch.arange(2),
             "m": (torch.zeros(2, dtype=torch.bool), torch.ones(1, dtype=torch.float64))}
    out = inj.poison_hook(batch)
    assert out["x"].dtype == torch.bfloat16 and out["x"].device == batch["x"].device
    assert torch.isnan(out["x"]).all() and torch.isnan(out["m"][1]).all()
    assert out["y"] is batch["y"] and out["m"][0] is batch["m"][0]
    assert isinstance(out["m"], tuple) and inj.fired == ("poison@batch[1]",)


def test_poison_of_integer_only_batches_warns_and_does_not_fire(caplog):
    inj = FaultInjector(FaultPlan.parse("poison:step=1"))
    tokens = {"tokens": torch.arange(8).reshape(2, 4)}
    import logging

    inj._logger = logging.getLogger("test.faults")
    with caplog.at_level(logging.WARNING, logger="test.faults"):
        assert inj.poison_hook(tokens) is tokens
    assert inj.fired == () and "NOT firing" in caplog.text


class _Seen(rt.Capsule):
    """Keeps each wave's batch (after the Dataset, before the Module)."""

    def __init__(self):
        super().__init__(priority=900)
        self.batches = []

    def launch(self, attrs=None):
        self.batches.append({k: v.clone() for k, v in attrs.batch.items()})


def test_poison_of_a_device_cached_batch_through_the_dataset(monkeypatch):
    monkeypatch.setenv("ROCKET_TPU_FAULTS", "poison:step=2")
    runtime = rt.Runtime(device="cpu", seed=0)
    dataset = rt.Dataset(_class_data(), batch_size=32, device_cache=True)
    seen = _Seen()
    looper = rt.Looper([dataset, seen], progress=False)
    rt.Launcher([looper], runtime=runtime).launch()
    assert [bool(torch.isnan(b["image"]).all()) for b in seen.batches] == [False, True, False,
                                                                         False]
    assert [bool(torch.isnan(b["image"]).any()) for b in seen.batches] == [False, True, False,
                                                                         False]
    assert not seen.batches[1]["label"].is_floating_point()
    assert runtime.faults.fired == ("poison@batch[2]",)


# -- drain protocol ----------------------------------------------------------------


def test_graceful_drain_is_a_systemexit_with_the_drained_code():
    exc = GracefulDrain(checkpoint="/tmp/x", reason="SIGTERM")
    assert isinstance(exc, SystemExit) and not isinstance(exc, Exception)
    assert exc.code == EXIT_DRAINED and exc.checkpoint == "/tmp/x"
    drain = DrainState()
    drain.request("SIGTERM")
    drain.request("later")
    assert drain.requested and drain.reason == "SIGTERM" and drain.requested_at is not None


def test_install_signal_drain_routes_sigterm_and_the_first_sigint():
    drain = DrainState()
    previous, previous_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        assert install_signal_drain(drain)
        os.kill(os.getpid(), signal.SIGINT)
        assert drain.requested and drain.reason == "SIGINT"
        assert signal.getsignal(signal.SIGINT) is previous_int
        os.kill(os.getpid(), signal.SIGTERM)
        assert drain.reason == "SIGINT"  # the first request latches
    finally:
        signal.signal(signal.SIGTERM, previous)
        signal.signal(signal.SIGINT, previous_int)


def _class_data(n=128):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(size=8).astype(np.float32), "label": np.int32(i % 4)}
            for i in range(n)]


def _ce(batch):
    return F.cross_entropy(batch["logits"], batch["label"].long())


def _jce(batch):
    import optax

    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"], batch["label"]).mean()


class DrainAt(rt.Capsule):
    """Requests a drain after N waves (a SIGTERM's programmatic stand-in)."""

    def __init__(self, after):
        super().__init__(priority=500)
        self._after, self._seen = after, 0

    def launch(self, attrs=None):
        self._seen += 1
        if self._seen == self._after:
            self._runtime.drain.request("test-preemption")


class _JDrainAt(jrt.Capsule):
    def __init__(self, after):
        super().__init__(priority=500)
        self._after, self._seen = after, 0

    def launch(self, attrs=None):
        self._seen += 1
        if self._seen == self._after:
            self._runtime.drain.request("test-preemption")


def _jparams():
    model = JMLP(in_features=8, num_classes=4, hidden=(16,))
    return model, jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])


def _tree(runtime, ckpt_dir, jparams, drain_after=None, save_every=1000, num_epochs=2,
          keep_last=None):
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    prepared = PreparedModule(model, {"params": params_from_jax(jparams)})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(_ce), rt.Optimizer(toptim.adamw(weight_decay=0.1),
                                                          learning_rate=1e-2)])
    capsules = [rt.Dataset(_class_data(), batch_size=32, device_cache=False), module]
    if drain_after is not None:
        capsules.append(DrainAt(drain_after))
    capsules.append(rt.Checkpointer(output_dir=ckpt_dir, save_every=save_every,
                                    resume_from="latest", keep_last=keep_last))
    launcher = rt.Launcher([rt.Looper(capsules, tag="train", progress=False)],
                           num_epochs=num_epochs, runtime=runtime)
    return launcher, prepared


def _jtree(tmp, ckpt_dir, jmodel, jparams, drain_after=None):
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                       project_dir=str(tmp))
    state = jax.jit(jmodel.init)(jax.random.key(1)).get("state", {})
    prepared = JPrepared(jmodel, {"params": jax.tree.map(jnp.asarray, jparams),
                                  "model_state": state, "step": jnp.zeros((), jnp.int32),
                                  "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(jmodel, prepared)
    module = jrt.Module(jmodel, [jrt.Loss(_jce), jrt.Optimizer(joptim.adamw(weight_decay=0.1),
                                                               learning_rate=1e-2)])
    capsules = [jrt.Dataset(_class_data(), batch_size=32, device_cache=False), module]
    if drain_after is not None:
        capsules.append(_JDrainAt(drain_after))
    capsules.append(jrt.Checkpointer(output_dir=ckpt_dir, save_every=1000, resume_from="latest"))
    return jrt.Launcher([jrt.Looper(capsules, tag="train", progress=False)], num_epochs=2,
                        runtime=runtime), prepared


def test_looper_drain_checkpoints_exits_drained_and_resumes(tmp_path):
    _, jparams = _jparams()
    ckpt = str(tmp_path / "ck")
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path), telemetry=True)
    launcher, _ = _tree(runtime, ckpt, jparams, drain_after=3)
    with pytest.raises(SystemExit) as excinfo:
        launcher.launch()
    assert isinstance(excinfo.value, GracefulDrain) and excinfo.value.code == EXIT_DRAINED
    path = excinfo.value.checkpoint
    assert os.path.basename(path) == "3" and is_complete_checkpoint(path)
    assert newest_complete_step(ckpt) == 3 and runtime.checkpointers == []
    with open(os.path.join(path, "drain.json")) as f:
        marker = json.load(f)
    assert marker["reason"] == "drain" and marker["step"] == 3
    assert os.path.exists(os.path.join(path, "capsules.pkl"))
    with open(tmp_path / "runs" / "telemetry" / "telemetry.json") as f:
        assert json.load(f)["metrics"]["counters"]["resilience/drains"] == 1
    again = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path / "r2"))
    launcher2, prepared2 = _tree(again, ckpt, jparams)
    launcher2.launch()
    assert prepared2.state["step"] == 8
    assert all(torch.isfinite(p).all() for p in toptim.param_leaves(prepared2.state["params"]))


def test_drain_checkpoint_joins_keep_last_rotation_after_resume(tmp_path):
    _, jparams = _jparams()
    ckpt = str(tmp_path / "ck")
    launcher, _ = _tree(rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path)), ckpt,
                        jparams, drain_after=3)
    with pytest.raises(SystemExit):
        launcher.launch()
    launcher2, _ = _tree(rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path / "r2")),
                         ckpt, jparams, save_every=2, keep_last=2)
    launcher2.launch()
    assert not os.path.exists(os.path.join(ckpt, "3")) and newest_complete_step(ckpt) == 8


def test_drain_marker_written_over_a_complete_periodic_save(tmp_path):
    _, jparams = _jparams()
    launcher, _ = _tree(rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path)),
                        str(tmp_path / "ck"), jparams, drain_after=3, save_every=3)
    with pytest.raises(SystemExit) as excinfo:
        launcher.launch()
    path = excinfo.value.checkpoint
    assert os.path.basename(path) == "3" and is_complete_checkpoint(path)
    with open(os.path.join(path, "drain.json")) as f:
        assert json.load(f)["step"] == 3


def test_drain_in_a_checkpointerless_phase_saves_through_the_registry(tmp_path):
    _, jparams = _jparams()
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path))
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    module = rt.Module(model, [rt.Loss(_ce), rt.Optimizer(toptim.adam(), learning_rate=1e-2)])
    launcher = rt.Launcher([
        rt.Looper([rt.Dataset(_class_data(), batch_size=32, device_cache=False), module,
                   rt.Checkpointer(output_dir=str(tmp_path / "ck"), save_every=1000)],
                  tag="train", progress=False),
        rt.Looper([rt.Dataset(_class_data(), batch_size=32, device_cache=False),
                   rt.Module(MLP(in_features=8, num_classes=4, hidden=(16,))), DrainAt(2)],
                  tag="val", grad_enabled=False, progress=False)], num_epochs=1, runtime=runtime)
    with pytest.raises(SystemExit) as excinfo:
        launcher.launch()
    assert excinfo.value.code == EXIT_DRAINED
    path = excinfo.value.checkpoint
    assert path is not None and is_complete_checkpoint(path)
    assert os.path.exists(os.path.join(path, "drain.json"))


def test_drain_without_a_checkpointer_still_exits_drained(tmp_path):
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path))
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    module = rt.Module(model, [rt.Loss(_ce), rt.Optimizer(toptim.adam(), learning_rate=1e-2)])
    launcher = rt.Launcher([rt.Looper([rt.Dataset(_class_data(), batch_size=32,
                                                  device_cache=False), module, DrainAt(2)],
                                      tag="train", progress=False)], runtime=runtime)
    with pytest.raises(SystemExit) as excinfo:
        launcher.launch()
    assert excinfo.value.code == EXIT_DRAINED and excinfo.value.checkpoint is None


def test_a_slow_drain_save_is_not_a_wedge(tmp_path, monkeypatch):
    """The drain save (the whole train state, synchronously) may outlast a
    short watchdog's escalation: the Looper disarms its watchdog before it,
    so a supervised worker still exits drained, not wedged."""
    import time

    from rocket_tpu_torch.core.checkpoint import Checkpointer

    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    _, jparams = _jparams()
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path), watchdog_secs=0.1)
    runtime.telemetry.escalation_exit_code = EXIT_WEDGED
    real = Checkpointer.save_drain

    def slow(self):
        time.sleep(0.8)  # eight deadlines
        return real(self)

    monkeypatch.setattr(Checkpointer, "save_drain", slow)
    launcher, _ = _tree(runtime, str(tmp_path / "ck"), jparams, drain_after=2)
    with pytest.raises(GracefulDrain):
        launcher.launch()
    assert exits == [] and runtime.telemetry.watchdog.escalation_count == 0


def test_a_drain_matches_the_references_and_each_resume_ends_alike(tmp_path):
    """The same MLP tree (AdamW, f32, bridged weights) drained after wave 3
    in each package: the same step directory, marker and capsule positions,
    params that each package reads from the other's files alike, and the
    run each package resumes from its own drain ends at the same params."""
    jmodel, jparams = _jparams()
    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    launcher, _ = _tree(rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path / "p")),
                        port_ck, jparams, drain_after=3)
    with pytest.raises(SystemExit) as got:
        launcher.launch()
    jlauncher, _ = _jtree(tmp_path / "j", jax_ck, jmodel, jparams, drain_after=3)
    with pytest.raises(SystemExit) as want:
        jlauncher.launch()
    assert (got.value.code, os.path.basename(got.value.checkpoint)) == (
        want.value.code, os.path.basename(want.value.checkpoint)) == (EXIT_DRAINED, "3")
    assert sorted(os.listdir(port_ck)) == sorted(os.listdir(jax_ck)) == ["3"]
    for name in ("capsules.pkl", "drain.json", "rng.json", "model_0"):
        assert os.path.exists(os.path.join(port_ck, "3", name)), name
        assert os.path.exists(os.path.join(jax_ck, "3", name)), name
    with open(os.path.join(port_ck, "3", "capsules.pkl"), "rb") as f:
        port_caps = pickle.load(f)
    with open(os.path.join(jax_ck, "3", "capsules.pkl"), "rb") as f:
        jax_caps = pickle.load(f)
    positions = [{k: v for k, v in s.items() if k in ("epoch_idx", "batch_idx", "iter_idx",
                                                        "saved_steps")} for s in port_caps]
    want_positions = [{k: v for k, v in s.items() if k in ("epoch_idx", "batch_idx", "iter_idx",
                                                             "saved_steps")} for s in jax_caps]
    assert positions == want_positions and {"iter_idx": 3, "saved_steps": [3]} in positions
    with open(os.path.join(jax_ck, "3", "drain.json")) as f, \
            open(os.path.join(port_ck, "3", "drain.json")) as g:
        assert set(json.load(f)) == set(json.load(g)) == {"reason", "step", "unix"}
    # Each package reads the other's drain params; they agree.
    port_by_jax = jio.load_pytree(os.path.join(port_ck, "3", "model_0"))
    jax_by_port = tio.load_pytree(os.path.join(jax_ck, "3", "model_0"))
    for key in ("params/1/w", "params/1/b", "params/3/w", "params/3/b"):
        np.testing.assert_array_equal(port_by_jax[key], tio.load_pytree(
            os.path.join(port_ck, "3", "model_0"))[key])
        np.testing.assert_allclose(port_by_jax[key], jax_by_port[key], atol=TOL, rtol=TOL)
    assert port_by_jax["step"] == int(np.asarray(jax_by_port["step"])) == 3
    # Each package resumes its own drain and runs to the end of epoch 2.
    launcher2, prepared = _tree(rt.Runtime(device="cpu", seed=0,
                                           project_dir=str(tmp_path / "p2")), port_ck, jparams)
    launcher2.launch()
    jlauncher2, jprepared = _jtree(tmp_path / "j2", jax_ck, jmodel, jparams)
    grab = _JGrab(jprepared)
    looper = jlauncher2._capsules[0]
    looper._capsules = sorted([*looper._capsules, grab], key=lambda c: -c.priority)
    grab.bind(looper._runtime)
    jlauncher2.launch()
    got_params = jax.tree.map(lambda t: t.detach().numpy(), prepared.state["params"])
    assert prepared.state["step"] == grab.step == 8
    for g, w in zip(jax.tree.leaves(got_params), jax.tree.leaves(grab.params)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    # Across: the port resumes the JAX package's drain, the JAX package the
    # port's; each ends within the tolerance of the other package's resume.
    assert sorted(port_by_jax) == sorted(tio.load_pytree(os.path.join(jax_ck, "3", "model_0")))
    cross_port, cross_jax = str(tmp_path / "cross_port"), str(tmp_path / "cross_jax")
    shutil.copytree(os.path.join(jax_ck, "3"), os.path.join(cross_port, "3"))
    shutil.copytree(os.path.join(port_ck, "3"), os.path.join(cross_jax, "3"))
    launcher3, prepared3 = _tree(rt.Runtime(device="cpu", seed=0,
                                            project_dir=str(tmp_path / "p3")), cross_port, jparams)
    launcher3.launch()
    jlauncher3, jprepared3 = _jtree(tmp_path / "j3", cross_jax, jmodel, jparams)
    grab3 = _JGrab(jprepared3)
    looper = jlauncher3._capsules[0]
    looper._capsules = sorted([*looper._capsules, grab3], key=lambda c: -c.priority)
    grab3.bind(looper._runtime)
    jlauncher3.launch()
    assert prepared3.state["step"] == grab3.step == 8
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.detach().numpy(),
                                                 prepared3.state["params"])),
                    jax.tree.leaves(grab.params)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    for g, w in zip(jax.tree.leaves(grab3.params), jax.tree.leaves(got_params)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


class _JGrab(jrt.Capsule):
    """The JAX step's params as numpy after each wave (its state is donated)."""

    def __init__(self, prepared):
        super().__init__(priority=10)
        self._prepared = prepared
        self.step = self.params = None

    def launch(self, attrs=None):
        self.step = int(np.asarray(self._prepared.state["step"]))
        self.params = jax.tree.map(np.asarray, self._prepared.state["params"])


def test_fault_injected_kill_through_the_real_loop(tmp_path, monkeypatch):
    monkeypatch.setenv("ROCKET_TPU_FAULTS", "kill:step=2")
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path))
    assert runtime.faults is not None and not runtime.supervised
    died = []

    def kill():
        died.append(1)
        raise KeyboardInterrupt("injected-kill")

    runtime.faults._kill = kill
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    module = rt.Module(model, [rt.Loss(_ce), rt.Optimizer(toptim.adam(), learning_rate=1e-2)])
    launcher = rt.Launcher([rt.Looper([rt.Dataset(_class_data(), batch_size=32,
                                                  device_cache=False), module],
                                      tag="train", progress=False)], runtime=runtime)
    with pytest.raises(KeyboardInterrupt):
        launcher.launch()
    assert died == [1] and runtime.faults.fired == ("kill@train[1]",)


# -- the watchdog's escalation -----------------------------------------------------


def test_escalation_exits_with_the_wedged_code_only_under_supervision(monkeypatch):
    from rocket_tpu_torch.obs.telemetry import Telemetry

    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    telemetry = Telemetry(enabled=True)
    telemetry.escalation_exit_code = EXIT_WEDGED
    telemetry._on_escalation("wedged report")
    assert exits == [EXIT_WEDGED]
    exits.clear()
    telemetry.escalation_exit_code = None
    telemetry._on_escalation("wedged report")
    assert exits == []


def test_a_supervised_runtime_routes_sigterm_to_the_drain(tmp_path, monkeypatch):
    monkeypatch.setenv("ROCKET_TPU_SUPERVISED", "1")
    previous, previous_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path), telemetry=True)
        assert runtime.supervised and runtime.telemetry.escalation_exit_code == EXIT_WEDGED
        assert signal.getsignal(signal.SIGTERM) is not previous
        os.kill(os.getpid(), signal.SIGTERM)
        assert runtime.drain.requested and runtime.drain.reason == "SIGTERM"
    finally:
        signal.signal(signal.SIGTERM, previous)
        signal.signal(signal.SIGINT, previous_int)
    assert signal.getsignal(signal.SIGTERM) is previous
    monkeypatch.delenv("ROCKET_TPU_SUPERVISED")
    plain = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path))
    assert not plain.supervised and plain.telemetry.escalation_exit_code is None
    assert signal.getsignal(signal.SIGTERM) is previous  # not taken unasked


# -- the supervisor ----------------------------------------------------------------


def _touch_checkpoint(ckpt_dir, step):
    path = os.path.join(ckpt_dir, str(step))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "rng.json"), "w") as f:
        f.write("{}")


class ScriptedRunner:
    """A generation runner: each entry an exit code or ``fn(gen, nproc) ->
    rc``; the optional fourth element marks a coordinator failure."""

    def __init__(self, script, durations=None, clock=None, coord=False):
        self.script, self.calls = list(script), []
        self.durations, self.clock, self.coord = durations or {}, clock, coord

    def __call__(self, gen, nproc, drain_event, on_poll):
        self.calls.append((gen, nproc))
        entry = self.script.pop(0)
        rc = entry(gen, nproc) if callable(entry) else entry
        if self.clock is not None:
            self.clock.advance(self.durations.get(gen, 0.0))
        on_poll()
        out = (rc, [rc] * nproc, {"0": ["tail line"]})
        return out + (rc != 0,) if self.coord else out


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.01
        return self.t

    def advance(self, s):
        self.t += s


def _supervisor(cls, tmp_path, script, nproc=1, policy=None, ckpt_dir=None, durations=None,
                coord=False, name="state"):
    clock = FakeClock()
    runner = ScriptedRunner(script, durations=durations, clock=clock, coord=coord)
    policy_cls = tsup.RestartPolicy if cls is Supervisor else jsup.RestartPolicy
    sup = cls(nproc, "train.py", policy=policy or policy_cls(
        backoff_base_s=0.0, backoff_max_s=0.0, progress_grace_s=1e9),
        state_dir=str(tmp_path / name), ckpt_dir=ckpt_dir, run_generation=runner,
        sleep=lambda s: None, clock=clock)
    return sup, runner


def _crash_with_progress(ckpt):
    def run(gen, nproc):
        _touch_checkpoint(ckpt, 5 * (gen + 1))
        return -9
    return run


def test_supervisor_restarts_until_completion(tmp_path):
    ckpt = str(tmp_path / "ck")
    os.makedirs(ckpt)
    sup, _ = _supervisor(Supervisor, tmp_path, [_crash_with_progress(ckpt)] * 2 + [0],
                         ckpt_dir=ckpt)
    assert sup.run() == 0 and sup.outcome == "completed" and sup.restarts == 2
    assert [g.outcome for g in sup.generations] == ["crashed", "crashed", "completed"]
    with open(tmp_path / "state" / "supervisor.json") as f:
        state = json.load(f)
    assert state["last_ckpt_step"] == 10 and 0.0 <= state["goodput_fraction"] <= 1.0


@pytest.mark.parametrize("case", ["crash_loop", "budget", "drained", "drained_probe_empty",
                                  "wedged", "degrade", "degrade_to_floor", "coord_error",
                                  "probe_over_duration", "salvage"])
def test_supervisor_json_matches_the_references(tmp_path, case):
    """The same scripted exit codes and fake clock through both
    supervisors: the same outcome, rc, worker counts and ``supervisor.json``
    less the wall-clock start stamps."""
    cases = {
        "crash_loop": dict(script=[1] * 5, policy=dict(crash_loop_threshold=3, max_restarts=100,
                                                         backoff_base_s=0.0,
                                                         progress_grace_s=1e9)),
        "budget": dict(script=[7] * 4, policy=dict(max_restarts=2, crash_loop_threshold=100,
                                                   backoff_base_s=0.0, progress_grace_s=1e9)),
        "drained": dict(script=[EXIT_DRAINED]),
        "drained_probe_empty": dict(script=[EXIT_DRAINED], ckpt=True),
        "wedged": dict(script=[EXIT_WEDGED] * 2, policy=dict(crash_loop_threshold=2,
                                                             backoff_base_s=0.0,
                                                             progress_grace_s=1e9)),
        "degrade": dict(script=[1, 1, 1, 1, 0], nproc=3, policy=dict(
            degrade_after=2, min_procs=1, crash_loop_threshold=100, max_restarts=100,
            backoff_base_s=0.0, progress_grace_s=1e9)),
        "degrade_to_floor": dict(script=[1] * 7, nproc=3, policy=dict(
            degrade_after=2, crash_loop_threshold=3, min_procs=1, max_restarts=100,
            backoff_base_s=0.0, progress_grace_s=1e9)),
        "coord_error": dict(script=[1, 1, 1, 1, 0], nproc=2, coord=True, policy=dict(
            backoff_base_s=0.0, backoff_max_s=0.0, progress_grace_s=1e9,
            crash_loop_threshold=3, degrade_after=2, min_procs=1)),
        "probe_over_duration": dict(script=[1] * 4, ckpt=True, durations={0: 60.0, 1: 60.0,
                                                                           2: 60.0},
                                    policy=dict(backoff_base_s=0.0, backoff_max_s=0.0,
                                                progress_grace_s=5.0, crash_loop_threshold=3,
                                                max_restarts=50)),
        "salvage": dict(script="salvage", ckpt=True, durations={0: 10.0, 1: 20.0}),
    }[case]
    docs, calls = [], []
    for cls, policy_cls, name in ((Supervisor, tsup.RestartPolicy, "port"),
                                  (jsup.Supervisor, jsup.RestartPolicy, "ref")):
        ckpt = str(tmp_path / f"ck_{name}") if cases.get("ckpt") else None
        if ckpt:
            os.makedirs(ckpt)
        script = cases["script"]
        if script == "salvage":
            def crash(gen, nproc, ckpt=ckpt):
                _touch_checkpoint(ckpt, 5)
                return -9
            script = [crash, 0]
        policy = policy_cls(**cases["policy"]) if "policy" in cases else None
        sup, runner = _supervisor(cls, tmp_path, script, nproc=cases.get("nproc", 1),
                                  policy=policy, ckpt_dir=ckpt, durations=cases.get("durations"),
                                  coord=cases.get("coord", False), name=name)
        rc = sup.run()
        with open(tmp_path / name / "supervisor.json") as f:
            doc = json.load(f)
        doc.pop("started_unix")
        doc.pop("ckpt_dir", None)
        for gen in doc["generations"]:
            gen.pop("started_unix")
        docs.append((rc, doc))
        calls.append(runner.calls)
    assert docs[0] == docs[1]
    assert calls[0] == calls[1]


def test_decide_matches_the_reference_over_a_table_of_states():
    policies = [(tsup.RestartPolicy(), jsup.RestartPolicy()),
                (tsup.RestartPolicy(max_restarts=2, crash_loop_threshold=2, degrade_after=1,
                                    min_procs=2),
                 jsup.RestartPolicy(max_restarts=2, crash_loop_threshold=2, degrade_after=1,
                                    min_procs=2))]
    n = 0
    for (policy, jpolicy), nproc, restarts, cf, fa in itertools.product(
            policies, (1, 2, 3), (0, 1, 2, 16), (0, 1, 2, 3), (0, 1, 2)):
        for outcome, progressed, coord, drain, complete, probe in itertools.product(
                ("completed", "drained", "wedged", "crashed"), *([(False, True)] * 5)):
            event = dict(outcome=outcome, progressed=progressed, coord_error=coord,
                         drain_requested=drain, complete_ckpt=complete, probe=probe)
            got = tsup.decide(tsup.LoopState(nproc, restarts, cf, fa), policy,
                              tsup.GenEvent(**event))
            want = jsup.decide(jsup.LoopState(nproc, restarts, cf, fa), jpolicy,
                               jsup.GenEvent(**event))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (event, nproc, cf, fa)
            n += 1
    assert n == 2 * 3 * 4 * 4 * 3 * 128


def test_supervisor_backoff_and_the_drain_signal(tmp_path):
    policy = RestartPolicy(backoff_base_s=0.5, backoff_factor=2.0, backoff_max_s=4.0)
    assert [policy.backoff_s(n) for n in range(1, 6)] == [0.5, 1.0, 2.0, 4.0, 4.0]
    sup, _ = _supervisor(Supervisor, tmp_path, [1])
    sup.request_drain("SIGTERM")
    assert sup.run() != 0 and sup.outcome == "drain_failed"
    sup2, _ = _supervisor(Supervisor, tmp_path, [1, 0], name="two")
    sup2._sleep = lambda s: sup2._drain_event.set()  # SIGTERM during the backoff
    assert sup2.run() != 0 and sup2.outcome == "drain_failed" and len(sup2.generations) == 1
    sup3, _ = _supervisor(Supervisor, tmp_path, [0], name="three")
    prev_int, prev_term = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGTERM)
    try:
        sup3.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGINT)
        assert sup3.drain_signals == 1 and signal.getsignal(signal.SIGINT) is prev_int
        os.kill(os.getpid(), signal.SIGTERM)
        assert sup3.drain_signals == 2
    finally:
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)


def test_obs_report_renders_supervisor_json(tmp_path, capsys):
    from rocket_tpu_torch.obs.__main__ import main as obs_main

    doc = {"outcome": "completed", "restarts": 1, "drain_events": 0, "goodput_fraction": 0.83,
           "productive_wall_s": 10.0, "total_wall_s": 12.0, "generations": [
               {"gen": 0, "nproc": 1, "outcome": "crashed", "duration_s": 2.0,
                "productive_s": 0.5, "rc": -9, "ckpt_step": 5},
               {"gen": 1, "nproc": 1, "outcome": "completed", "duration_s": 10.0,
                "productive_s": 10.0, "rc": 0, "ckpt_step": 40}]}
    path = tmp_path / "supervisor.json"
    path.write_text(json.dumps(doc))
    assert obs_main(["report", str(path)]) == 0
    out = capsys.readouterr().out
    assert "supervisor: outcome=completed" in out and "goodput_fraction=0.83" in out
    assert "crashed" in out and "completed" in out
    assert obs_main(["report", str(tmp_path)]) == 0  # the run dir finds it too
    assert "supervisor: outcome=completed" in capsys.readouterr().out


# -- module-level imports ------------------------------------------------------------


STDLIB_ONLY = ["resilience/faults.py", "resilience/supervisor.py", "launch.py", "obs/export.py",
               "obs/slo.py"]


@pytest.mark.parametrize("module", STDLIB_ONLY)
def test_the_supervisor_side_modules_import_only_the_stdlib_at_module_level(module):
    """What the supervisor's parent imports stays off the device: the
    standard library only at module level (one of these modules may import
    another of them)."""
    tree = ast.parse((ROOT / "rocket_tpu_torch" / module).read_text(encoding="utf-8"))
    siblings = {"rocket_tpu_torch." + m[:-3].replace("/", ".") for m in STDLIB_ONLY}
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for name in names:
            assert (name == "__future__" or name.split(".")[0] in sys.stdlib_module_names
                    or name in siblings), (module, name)


# -- the slice: launch --supervise on the CPU --------------------------------------------

GPT_CFG = dict(vocab_size=96, max_seq_len=32, dim=64, num_layers=2, num_heads=2, dropout=0.0,
               loss_chunk=16)
GPT_B, GPT_T, GPT_STEPS = 2, 32, 6

WORKER = '''
import json, os, sys
import numpy as np
import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss
from rocket_tpu_torch.runtime import checkpoint_io

root, out = sys.argv[1], sys.argv[2]
with open(os.path.join(root, "setup.json")) as f:
    setup = json.load(f)
steps = setup["steps"]
model = TransformerLM(TransformerConfig(**setup["config"]))
runtime = rt.Runtime(device="cpu", seed=0, project_dir=out)
params = checkpoint_io.load_pytree(os.path.join(root, "init"),
                                   template={"params": model.init(device="cpu")})["params"]
prepared = PreparedModule(model, {"params": params})
runtime.models.add(model, prepared)
# examples.gpt2.build's tree, with f32 activations (the example's are bf16).
module = rt.Module(model, [
    rt.Loss(next_token_loss()), rt.Optimizer(optim.adamw(weight_decay=0.1)),
    rt.Scheduler(optim.warmup_cosine_lr(6e-4, warmup_steps=max(1, steps // 50),
                                        decay_steps=steps))], remat=True)
data = TokenDataset(np.load(os.path.join(root, "tokens.npy")), seq_len=setup["seq_len"])
rt.Launcher([rt.Looper([
    rt.Dataset(data, batch_size=setup["batch"], shuffle=True, drop_last=True), module,
    rt.Checkpointer(output_dir=os.path.join(out, "ck"), save_every=2, keep_last=3,
                    resume_from="latest")], tag="train", repeats=steps, progress=False)],
    statefull=True, runtime=runtime).launch()
checkpoint_io.save_pytree(os.path.join(out, "final"), {"params": prepared.state["params"],
                                                       "step": prepared.state["step"]})
print("WORKER-DONE gen", os.environ.get("ROCKET_TPU_GENERATION"), flush=True)
'''


def _jax_gpt2_run(jparams, tokens):
    """The JAX package's uninterrupted run of the worker's tree."""
    jmodel = jt.TransformerLM(jt.TransformerConfig(**GPT_CFG))
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0)
    prepared = JPrepared(jmodel, {"params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
                                  "step": jnp.zeros((), jnp.int32),
                                  "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(jmodel, prepared)
    module = jrt.Module(jmodel, [jrt.Loss(jt.next_token_loss()),
                                 jrt.Optimizer(joptim.adamw(weight_decay=0.1)),
                                 jrt.Scheduler(joptim.warmup_cosine_lr(
                                     6e-4, warmup_steps=max(1, GPT_STEPS // 50),
                                     decay_steps=GPT_STEPS))])
    grab = _JGrab(prepared)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokenDataset(tokens, GPT_T), batch_size=GPT_B,
                                          shuffle=True, drop_last=True), module, grab],
                             tag="train", repeats=GPT_STEPS, progress=False)],
                 runtime=runtime).launch()
    return grab


def _run(cmd, env, timeout):
    out = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True, text=True,
                         timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def test_a_supervised_gpt2_killed_in_generation_0_ends_as_the_uninterrupted_run(tmp_path):
    jmodel = jt.TransformerLM(jt.TransformerConfig(**GPT_CFG))
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(3))["params"])
    tokens = np.random.default_rng(5).integers(0, GPT_CFG["vocab_size"], 20 * GPT_T)
    root = tmp_path / "setup"
    root.mkdir()
    np.save(root / "tokens.npy", tokens)
    (root / "setup.json").write_text(json.dumps({"config": GPT_CFG, "seq_len": GPT_T,
                                                 "batch": GPT_B, "steps": GPT_STEPS}))
    tio.save_pytree(str(root / "init"), {"params": params_from_jax(jparams)})
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROCKET_TPU_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")

    rc, log = _run([sys.executable, str(worker), str(root), str(tmp_path / "plain")], env, 300)
    assert rc == 0, log[-3000:]
    sup_env = dict(env, ROCKET_TPU_FAULTS="kill:step=4,gen=0")
    rc, log = _run([sys.executable, "-m", "rocket_tpu_torch.launch", "--supervise", "-n", "1",
                    "--backoff", "0.05", "--ckpt-dir", str(tmp_path / "sup" / "ck"),
                    "--state-dir", str(tmp_path / "state"), str(worker), str(root),
                    str(tmp_path / "sup")], sup_env, 300)
    assert rc == 0, log[-3000:]
    with open(tmp_path / "state" / "supervisor.json") as f:
        state = json.load(f)
    assert [g["outcome"] for g in state["generations"]] == ["crashed", "completed"]
    assert state["generations"][0]["exit_codes"] == [-signal.SIGKILL]
    assert state["generations"][0]["ckpt_step"] == 2 and state["restarts"] == 1
    assert "[rank 0] WORKER-DONE gen 1" in log and "WORKER-DONE gen 0" not in log
    assert sorted(os.listdir(tmp_path / "sup" / "ck")) == ["2", "4", "6"]

    plain = tio.load_pytree(str(tmp_path / "plain" / "final"))
    supervised = tio.load_pytree(str(tmp_path / "sup" / "final"))
    assert plain.keys() == supervised.keys() and plain["step"] == supervised["step"] == GPT_STEPS
    for key in plain:
        np.testing.assert_array_equal(supervised[key], plain[key], err_msg=key)

    grab = _jax_gpt2_run(jparams, tokens)
    assert grab.step == GPT_STEPS
    flat_jax = {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(grab.params)}
    dim = GPT_CFG["dim"]
    for key, want in flat_jax.items():
        got = supervised[key]
        if key.endswith("attn/qkv/b"):
            # The k segment's true gradient is zero: Adam steps on rounding
            # noise of either sign there, so only a bound holds.
            np.testing.assert_allclose(got[dim:2 * dim], want[dim:2 * dim],
                                       atol=2 * GPT_STEPS * 6e-4)
            got, want = np.concatenate([got[:dim], got[2 * dim:]]), np.concatenate(
                [want[:dim], want[2 * dim:]])
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=key)
