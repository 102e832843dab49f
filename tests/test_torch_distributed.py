"""Data-parallel and FSDP-layout training across processes against the
reference on the virtual CPU mesh (``mesh_shape={"data": 2}``).

The port's ranks are spawned CPU processes whose Runtimes open a gloo
group from the launcher's environment; the JAX package runs in the test
process. Weights cross through ``bridge`` as numpy, inputs are made from
a numpy seed, dropout is 0.

* A tiny GPT-2 (2 layers, dim 128, T = 32, global batch 8) trains 3 steps
  under momentum SGD (beta 0.9, lr 0.1; its buffers are sharded with the
  params): data parallel with the bucketed reduction at master
  precision, against the reference's bucketed step (losses within 1e-5
  relative, params within 2e-5: f32 parity), and under ``fsdp_rules``
  with the default bf16 wire against the reference's FSDP step (losses
  within 1e-4 relative, params within 1e-3: the wire's 2^-7 relative
  gradient error carried through three momentum steps at lr 0.1). The
  FSDP run again with ``clip_norm`` below every step's global gradient
  norm: the clipped updates, and the pre-clip norm summed over both
  ranks' shards, hold to the reference's at the FSDP tolerances.
* The FSDP run's 2-rank checkpoint (one shard file a rank, the main rank
  writes the index) has the reference's leaves and reads in the
  reference's ``load_pytree``; the reference's checkpoint reads into two
  ranks, each keeping its shard (resharding), bitwise; a rank whose
  directory holds a newer step resumes the main rank's broadcast step.
* ``telemetry.json`` is written by the main rank only.
* The Meter's gathered, deduplicated batch and its device-reduced
  accuracy equal the reference's; a Module with model state (BatchNorm)
  runs in a multi-process run (sync-BN is ported: ``tests/test_torch_syncbn.py``
  holds its statistics to the reference's).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rocket_tpu as jrt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokens
from rocket_tpu.models import transformer as jt
from rocket_tpu.parallel import sharding as js
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu.utils.metrics import Accuracy as JAccuracy
from test_torch_grad_sync import run_ranks

T, BATCH, STEPS, LR, MIN_SIZE, CLIP = 32, 8, 3, 0.1, 4096, 0.05
CFG = dict(vocab_size=256, max_seq_len=T, dim=128, num_layers=2, num_heads=4, dropout=0.0)

COMMON = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch import bridge, optim
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.parallel.sharding import fsdp_rules

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])


def full_params(prepared):
    """The whole params: a shard gathered over the ranks."""
    import rocket_tpu_torch.optim as o
    leaves = o.param_leaves(prepared.state["params"])
    dims = prepared.shard_dims or [None] * len(leaves)
    out = {}
    for path, t, d in zip(__import__("rocket_tpu_torch.core.module", fromlist=["_paths"])._paths(
            prepared.state["params"]), leaves, dims):
        t = t.detach()
        if d is not None:
            parts = [torch.empty_like(t) for _ in range(prepared.world)]
            dist.all_gather(parts, t.contiguous())
            t = torch.cat(parts, d)
        out["/".join(path)] = t.numpy().copy()
    return out


class Grab(rt.Capsule):
    """Per-step losses; with ``before`` also the whole params before the
    first step (after a resume)."""

    def __init__(self, prepared, before=False):
        super().__init__(priority=2000 if before else 10)
        self.prepared, self.before, self.losses, self.start = prepared, before, [], None
        self.norms = []

    def launch(self, attrs=None):
        if self.before:
            if self.start is None:
                self.start = (int(self.prepared.state["step"]), full_params(self.prepared))
            return
        self.losses.append(float(attrs.step_metrics["loss"]))
        if "grad_norm" in attrs.step_metrics:
            self.norms.append(float(attrs.step_metrics["grad_norm"]))


def train_tree(runtime, mode, steps, ckpt_dir=None, resume=None, save_every=None):
    model = tt.TransformerLM(tt.TransformerConfig(**cfg["model"]))
    params = dict(np.load(os.path.join(out, "params.npz")))
    tree = {}
    for name, value in params.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(tree)})
    runtime.models.add(model, prepared)
    fsdp = mode.startswith("fsdp")
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()), rt.Optimizer(
        optim.momentum(0.9), learning_rate=cfg["lr"],
        clip_norm=cfg["clip"] if mode == "fsdp_clip" else None,
        grad_sync="auto" if fsdp else "bucketed", grad_wire_dtype="bfloat16" if fsdp else None)],
        param_sharding=fsdp_rules(min_size=cfg["min_size"]) if fsdp else None)
    data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), cfg["model"]["max_seq_len"])
    grab, before = Grab(prepared), Grab(prepared, before=True)
    caps = [rt.Dataset(data, batch_size=cfg["batch"]), before, module, grab]
    if ckpt_dir is not None:
        caps.append(rt.Checkpointer(output_dir=ckpt_dir, save_every=save_every or steps,
                                    resume_from=resume))
    launcher = rt.Launcher([rt.Looper(caps, tag="train", repeats=steps, progress=False)],
                           runtime=runtime)
    return launcher, prepared, grab, before, module
'''

TRAIN = COMMON + r'''
mode = cfg["mode"]
runtime = rt.Runtime(device="cpu", seed=0, telemetry=True,
                     project_dir=os.path.join(out, f"proj{rank}"))
launcher, prepared, grab, _, module = train_tree(runtime, mode, cfg["steps"],
                                                 ckpt_dir=os.path.join(out, "ckpt"))
launcher.launch()
full = full_params(prepared)
stats = module.grad_sync.stats if module.grad_sync is not None else {}
if rank == 0:
    np.savez(os.path.join(out, f"{mode}.npz"), losses=np.array(grab.losses),
             norms=np.array(grab.norms), **full)
json.dump({"buckets": stats.get("buckets"), "wire_bytes": stats.get("wire_bytes"),
           "shard_bytes": sum(int(t.numel()) * 4 for t in __import__(
               "rocket_tpu_torch.optim", fromlist=["x"]).param_leaves(prepared.state["params"])),
           "sharded": prepared.sharded()},
          open(os.path.join(out, f"{mode}_rank{rank}.json"), "w"))
'''

RESUME = COMMON + r'''
runtime = rt.Runtime(device="cpu", seed=0, project_dir=os.path.join(out, f"proj{rank}"))
# The Looper resumes at its saved iteration: one more step.
launcher, prepared, grab, before, _ = train_tree(
    runtime, "fsdp", cfg["steps"] + 1, ckpt_dir=cfg["ckpt_dirs"][rank], resume="latest",
    save_every=1000)
launcher.launch()
step, full = before.start
if rank == 0:
    np.savez(os.path.join(out, "resumed.npz"), step=step, losses=np.array(grab.losses), **full)
json.dump({"step": step}, open(os.path.join(out, f"resumed_rank{rank}.json"), "w"))
'''

METER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch.utils.metrics import Accuracy

out = sys.argv[2]
rank = int(os.environ["RANK"])
data = [dict(x) for x in np.load(os.path.join(out, "meter.npy"), allow_pickle=True)]
runtime = rt.Runtime(device="cpu", seed=0)


class Rec(rt.Metric):
    def __init__(self):
        super().__init__()
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(np.asarray(attrs.batch["label"]).tolist())

    def reset(self, attrs=None):
        pass


rec, acc = Rec(), Accuracy()
rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=4),
                        rt.Meter(["logits", "label"], [rec, acc])], tag="val",
                       grad_enabled=False, progress=False)], runtime=runtime).launch()


class Stateful:
    def init(self, gen, device):
        return {"w": torch.zeros(2, device=device)}

    def init_state(self, device):
        return {"mean": torch.zeros(2, device=device)}

    def apply(self, params, batch, *, state, mode, rng):
        return batch, state


try:
    # A Module with model state runs over the ranks (sync-BN keeps the
    # state global); a forward without Loss/Optimizer runs in eval.
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=4), rt.Module(Stateful())], tag="val",
                           grad_enabled=False, progress=False)], runtime=runtime).launch()
    refused = ""
except NotImplementedError as exc:
    refused = str(exc)
json.dump({"rows": rec.rows, "accuracy": acc.value, "refused": refused},
          open(os.path.join(out, f"meter{rank}.json"), "w"))
'''


def _jax_model():
    model = jt.TransformerLM(jt.TransformerConfig(**CFG))
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])
    return model, params


def _tokens():
    return np.random.default_rng(0).integers(0, CFG["vocab_size"], size=T * BATCH * 4,
                                             dtype=np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.norms = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        if attrs.step_metrics.grad_norm is not None:
            self.norms.append(float(np.asarray(attrs.step_metrics.grad_norm)))
        self.params = jax.tree.map(np.asarray, self.prepared.state["params"])


def _jax_run(tmp, mode, ckpt_dir=None):
    model, params = _jax_model()
    runtime = JRuntime(mesh_shape={"data": 2}, devices=jax.devices()[:2], seed=0,
                       project_dir=str(tmp))
    prepared = JPrepared(model, {"params": jax.tree.map(jnp.asarray, params),
                                 "model_state": {}, "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    fsdp = mode.startswith("fsdp")
    module = jrt.Module(model, [jrt.Loss(jt.next_token_loss()), jrt.Optimizer(
        joptim.momentum(0.9), learning_rate=LR, clip_norm=CLIP if mode == "fsdp_clip" else None,
        grad_sync="auto" if fsdp else "bucketed", grad_wire_dtype="bfloat16" if fsdp else None)],
        param_sharding=js.fsdp_rules(min_size=MIN_SIZE) if fsdp else None)
    grab = _JGrab(prepared)
    caps = [jrt.Dataset(JTokens(_tokens(), T), batch_size=BATCH, device_cache=False), module, grab]
    if ckpt_dir is not None:
        caps.append(jrt.Checkpointer(output_dir=str(ckpt_dir), save_every=STEPS))
    jrt.Launcher([jrt.Looper(caps, tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    return grab


def _setup_inputs(tmp):
    _, params = _jax_model()
    np.savez(tmp / "params.npz", **dict(_flat(params)))
    np.save(tmp / "tokens.npy", _tokens())


def _config(mode, **extra):
    return {"mode": mode, "steps": STEPS, "lr": LR, "batch": BATCH, "min_size": MIN_SIZE,
            "clip": CLIP, "model": CFG, **extra}


def _close(port, jax_params, tol):
    for name, want in _flat(jax_params):
        np.testing.assert_allclose(port[name], want, atol=tol, rtol=0, err_msg=name)


_RUNS: dict = {}


def _trained(mode, tmp_path_factory):
    """Both packages' 3-step runs of ``mode``, made once a module."""
    if mode not in _RUNS:
        tmp = tmp_path_factory.mktemp(mode)
        _setup_inputs(tmp)
        run_ranks(tmp, TRAIN, 2, _config(mode))
        ref = _jax_run(tmp / "jax", mode, ckpt_dir=tmp / "jax_ckpt")
        _RUNS[mode] = (mode, tmp, dict(np.load(tmp / f"{mode}.npz")), ref)
    return _RUNS[mode]


@pytest.fixture(scope="module", params=["dp", "fsdp", "fsdp_clip"])
def trained(request, tmp_path_factory):
    return _trained(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def fsdp_trained(tmp_path_factory):
    return _trained("fsdp", tmp_path_factory)


def test_two_ranks_train_as_the_reference(trained):
    mode, _, port, ref = trained
    loss_tol, param_tol = (1e-5, 2e-5) if mode == "dp" else (1e-4, 1e-3)
    np.testing.assert_allclose(port["losses"], ref.losses, rtol=loss_tol)
    _close(port, ref.params, param_tol)
    if mode == "fsdp_clip":
        # Clipping bites on every step: the norm is over both ranks' shards.
        assert len(port["norms"]) == STEPS and min(ref.norms) > 2 * CLIP
        np.testing.assert_allclose(port["norms"], ref.norms, rtol=loss_tol)
    else:
        assert port["norms"].size == 0 and not ref.norms


def test_fsdp_holds_shards_and_dp_buckets(trained):
    mode, tmp, _, _ = trained
    import json

    ranks = [json.load(open(tmp / f"{mode}_rank{r}.json")) for r in range(2)]
    _, params = _jax_model()
    whole = sum(v.size * 4 for _, v in _flat(params))
    if mode == "dp":
        assert not ranks[0]["sharded"] and ranks[0]["shard_bytes"] == whole
        # f32 master precision: every replicated byte crosses once a step.
        assert ranks[0]["wire_bytes"] == whole and ranks[0]["buckets"] >= 1
    else:
        big = sum(v.size * 4 for _, v in _flat(params) if v.size >= MIN_SIZE)
        for r in ranks:
            assert r["sharded"] and r["shard_bytes"] == whole - big // 2


def test_the_port_checkpoint_reads_in_the_reference(trained):
    mode, tmp, port, _ = trained
    step_dir = tmp / "ckpt" / str(STEPS)
    files = sorted(os.listdir(step_dir / "model_0"))
    assert files == ["index.json", "shard_p0.npz", "shard_p1.npz"]
    flat = jio.load_pytree(str(step_dir / "model_0"))
    want = jio.load_pytree(str(tmp / "jax_ckpt" / str(STEPS) / "model_0"))
    assert sorted(flat) == sorted(want)
    assert int(flat["step"]) == STEPS
    for name, value in flat.items():
        if name.startswith("params/"):
            np.testing.assert_array_equal(value, port[name[len("params/"):]], err_msg=name)
        assert np.shape(value) == np.shape(want[name]), name


def test_two_ranks_resume_the_references_checkpoint_and_the_main_ranks_step(fsdp_trained,
                                                                          tmp_path):
    _, tmp, _, ref = fsdp_trained
    jax_dir = tmp / "jax_ckpt"
    # Rank 1 sees a newer complete step the main rank does not.
    stale = tmp_path / "stale"
    shutil.copytree(jax_dir, stale)
    shutil.copytree(stale / str(STEPS), stale / str(STEPS + 5))
    _setup_inputs(tmp_path)
    run_ranks(tmp_path, RESUME, 2, _config("fsdp", ckpt_dirs=[str(jax_dir), str(stale)]))
    import json

    assert [json.load(open(tmp_path / f"resumed_rank{r}.json"))["step"] for r in range(2)] == [
        STEPS, STEPS]
    resumed = dict(np.load(tmp_path / "resumed.npz"))
    want = jio.load_pytree(str(jax_dir / str(STEPS) / "model_0"))
    for name, value in want.items():
        if name.startswith("params/"):
            np.testing.assert_array_equal(resumed[name[len("params/"):]], value, err_msg=name)


def test_telemetry_is_written_by_the_main_rank_only(trained):
    _, tmp, _, _ = trained
    assert os.path.exists(tmp / "proj0" / "runs" / "telemetry" / "telemetry.json")
    assert not os.path.exists(tmp / "proj1" / "runs" / "telemetry" / "telemetry.json")


def _meter_data():
    rng = np.random.default_rng(5)
    return [{"logits": rng.normal(size=3).astype(np.float32), "label": np.int32(i % 3)}
            for i in range(10)]


class _JRec(jrt.Metric):
    def __init__(self):
        super().__init__()
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(np.asarray(attrs.batch["label"]).tolist())

    def reset(self, attrs=None):
        pass


@pytest.fixture(scope="module")
def metered(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meter")
    data = _meter_data()
    np.save(tmp / "meter.npy", np.array(data, dtype=object), allow_pickle=True)
    run_ranks(tmp, METER, 2, {})
    import json

    ranks = [json.load(open(tmp / f"meter{r}.json")) for r in range(2)]
    runtime = JRuntime(mesh_shape={"data": 2}, devices=jax.devices()[:2], seed=0,
                       project_dir=str(tmp))
    rec, acc = _JRec(), JAccuracy()
    jrt.Launcher([jrt.Looper([jrt.Dataset(data, batch_size=4, device_cache=False),
                              jrt.Meter(["logits", "label"], [rec, acc])], tag="val",
                             grad_enabled=False, progress=False)], runtime=runtime).launch()
    return ranks, rec, acc


def test_the_meter_gathers_and_dedups_as_the_reference(metered):
    ranks, rec, acc = metered
    assert rec.rows[-1] == [8 % 3, 9 % 3]  # the last batch's two real rows
    for r in ranks:
        assert r["rows"] == rec.rows
        assert r["accuracy"] == pytest.approx(float(acc.value), abs=1e-7)


def test_model_state_refuses_a_multi_process_run(metered):
    """No longer refused: sync-BN keeps a model's state global, so a Module
    with model state runs over several processes (an eval Looper here; the
    multi-process train path is ``test_torch_syncbn.py``'s). The name is
    the test's first meaning, kept: it now asserts the opposite."""
    ranks, _, _ = metered
    for r in ranks:
        assert r["refused"] == ""


TEARDOWN = r'''
import time

import torch
import torch.distributed as dist

torch.set_num_threads(1)
from rocket_tpu_torch.runtime import Runtime

runtime = Runtime(device="cpu")  # opens the gloo group from the environment
t = torch.ones(4)
dist.all_reduce(t)
assert t.tolist() == [2.0] * 4
if runtime.process_index == 1:
    time.sleep(0.5)
'''


def test_ranks_that_leave_apart_both_exit_zero(tmp_path):
    """The group a Runtime opened closes collectively (ROADMAP C5): rank 0
    returns at once, rank 1 half a second later, and neither is aborted by
    the other's teardown (``run_ranks`` fails on any exit code but 0),
    five times in a row."""
    for attempt in range(5):
        work = tmp_path / f"run{attempt}"
        work.mkdir()
        run_ranks(work, TEARDOWN, 2, {}, timeout=60)
