"""Tensor-parallel training (``Module(param_sharding=gpt2_tp_rules())`` on a
``{"model": 2}`` and a ``{"data": 2, "model": 2}`` mesh) against the
reference's ``Module`` step under the same rules and mesh on the virtual
CPU devices.

The port's ranks are spawned gloo processes, one group a mesh running
every case in turn; weights come from the reference's init through
``bridge``, tokens from a numpy seed. Each case trains two steps of plain
SGD (lr 0.5), so the step-1 gradient of every leaf is ``(p0 - p1) / lr``,
gathered whole from the ranks' shards (exact to two ulps of the params):

* GPT-2 style (learned ``wpe``, gelu, tied head, the fused chunked loss)
  and Llama style (RoPE, RMSNorm, swiglu, GQA with 2 kv heads over 4
  query heads, untied head: the vocab-parallel embedding), vocab 256, with
  the head as a collective matmul (no fused loss) once each;
* bulk and ring modes and ``ROCKET_TPU_OVERLAP=0`` (the reference's plain
  GSPMD program there, bulk f32 collectives here);
* at the f32 wire the losses within 1e-5 (relative), every gradient leaf
  and the updated params within 2e-5 of the largest element of the leaf;
  at the bf16 wire (the default, in both packages) within 2^-7 of it;
* GPT-2 style at vocab 251, which no model axis divides, so ``wte`` stays
  whole, as GPT-2's 50257 rows do, with dropout 0.1 at ``{"model": 2}``:
  the reference cannot place such a table under ``gpt2_tp_rules`` (its
  ``device_put`` refuses the uneven split), so this run is held to the
  port's own one-process run. The ranks draw that run's masks
  (``keys.dropout_mask``; the masks themselves are compared bitwise in
  ``tests/test_torch_tp.py``), so the losses and params agree to f32
  rounding (the row-parallel partial sums reassociate: not bitwise);
* ``clip_norm`` below every step's norm (``{"data": 2, "model": 2}``):
  the pre-clip global norm within 1e-5 of the reference's, each shard
  summed over its group and each replicated leaf counted once;
* the model group's replicated leaves are bitwise equal across its ranks;
* a ``{"data": 2, "model": 2}`` checkpoint has the reference's leaves,
  one writer per model shard, reads in the reference's ``load_pytree`` and
  into one port process bitwise, and the reference's checkpoint of the
  same run resumes into the four ranks bitwise;
* ``python -m rocket_tpu_torch.launch -n 2`` runs ``examples.gpt2 --small
  --model-axis 2`` on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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
from test_torch_grad_sync import REPO, _free_port, run_ranks

T, BATCH, STEPS, LR = 16, 4, 2, 0.5
GPT2 = dict(vocab_size=256, max_seq_len=T, dim=64, num_layers=2, num_heads=4, dropout=0.0,
            loss_chunk=8)
LLAMA = dict(vocab_size=256, max_seq_len=T, dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
             pos_embedding="rope", norm="rmsnorm", mlp="swiglu", tied_embeddings=False,
             dropout=0.0, loss_chunk=8)

#: name -> (model config, environment, mesh). "wire" None is the f32 wire.
CASES = {
    "gpt2_bulk": (GPT2, {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}, "m2"),
    "llama_ring": (LLAMA, {"ROCKET_TPU_OVERLAP_WIRE": "fp32", "ROCKET_TPU_OVERLAP": "ring"}, "m2"),
    "gpt2_head_off": (dict(GPT2, loss_chunk=0),
                      {"ROCKET_TPU_OVERLAP_WIRE": "fp32", "ROCKET_TPU_OVERLAP": "0"}, "m2"),
    "gpt2_dropout": (dict(GPT2, vocab_size=251, dropout=0.1), {"ROCKET_TPU_OVERLAP_WIRE": "fp32"},
                     "m2"),
    "gpt2_ring_bf16": (GPT2, {"ROCKET_TPU_OVERLAP": "ring"}, "d2m2"),
    "llama_head_bulk": (dict(LLAMA, loss_chunk=0), {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}, "d2m2"),
    "gpt2_clip": (GPT2, {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}, "d2m2"),
}
#: Cases that clip the gradients' global norm below every step's norm.
CLIP = {"gpt2_clip": 0.05}
#: Cases that end with an eval pass through a Meter.
EVAL = ("gpt2_bulk", "llama_head_bulk")
MESHES = {"m2": {"model": 2}, "d2m2": {"data": 2, "model": 2}}
#: The case whose run saves the checkpoint the resume tests read.
SAVED = "llama_head_bulk"

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch import bridge, optim
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])


def tree_of(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


class Grab(rt.Capsule):
    """Per step: the loss and the whole params; with ``before`` the whole
    params before the first step (after a resume)."""

    def __init__(self, prepared, runtime, before=False):
        super().__init__(priority=2000 if before else 10)
        self.prepared, self.rt, self.before = prepared, runtime, before
        self.losses, self.params, self.norms = [], [], []

    def launch(self, attrs=None):
        if self.before:
            if not self.params:
                self.params.append(bridge.gather_params(self.prepared, self.rt))
            return
        self.losses.append(float(attrs.step_metrics["loss"]))
        if "grad_norm" in attrs.step_metrics:
            self.norms.append(float(attrs.step_metrics["grad_norm"]))
        self.params.append(bridge.gather_params(self.prepared, self.rt))


for case in cfg["cases"]:
    os.environ.pop("ROCKET_TPU_OVERLAP", None)
    os.environ.pop("ROCKET_TPU_OVERLAP_WIRE", None)
    os.environ.update(case["env"])
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=cfg["mesh"],
                         project_dir=os.path.join(out, f"proj{rank}"))
    model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
    flat = dict(np.load(os.path.join(out, case["name"] + ".npz")))
    params = bridge.params_from_jax(tree_of(flat))
    prepared = PreparedModule(model, {"params": params})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"],
                                            clip_norm=case.get("clip"))],
                       param_sharding=gpt2_tp_rules())
    data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), case["model"]["max_seq_len"])
    grab, before = Grab(prepared, runtime), Grab(prepared, runtime, before=True)
    caps = [rt.Dataset(data, batch_size=cfg["batch"]), before, module, grab]
    steps = cfg["steps"]
    if case.get("save"):
        caps.append(rt.Checkpointer(output_dir=os.path.join(out, "ckpt"), save_every=steps))
    if case.get("resume"):
        steps += 1
        caps.append(rt.Checkpointer(output_dir=case["resume"], save_every=1000,
                                    resume_from="latest"))
    loopers = [rt.Looper(caps, tag="train", repeats=steps, progress=False)]
    logits = []
    if case.get("eval"):
        # An eval Module sharing the model reads its shards under the same
        # context; the Meter gathers the logits over the data axis only.
        class Rec(rt.Metric):
            def launch(self, attrs=None):
                logits.append(attrs.batch["logits"].detach().float().numpy().copy())

            def reset(self, attrs=None):
                pass

        loopers.append(rt.Looper([rt.Dataset(data, batch_size=cfg["batch"]), rt.Module(model),
                                  rt.Meter(["logits"], [Rec()])], tag="val", repeats=1,
                                 grad_enabled=False, progress=False))
    rt.Launcher(loopers, runtime=runtime).launch()
    if logits and rank == 0:
        np.save(os.path.join(out, f"{case['name']}_eval.npy"), logits[0])
    # The model group's replicated leaves, bitwise across its ranks.
    leaves = optim.param_leaves(prepared.state["params"])
    digest = [float(t.detach().double().sum()) for i, t in enumerate(leaves)
              if prepared.layout(i) is None]
    json.dump({"digest": digest, "sharded": sum(prepared.layout(i) is not None
                                                for i in range(len(leaves)))},
              open(os.path.join(out, f"{case['name']}_rank{rank}.json"), "w"))
    if rank == 0:
        snaps = {f"before/{k}": v.numpy() for k, v in before.params[0].items()}
        for s, p in enumerate(grab.params):
            snaps.update({f"step{s + 1}/{k}": v.numpy() for k, v in p.items()})
        np.savez(os.path.join(out, f"{case['name']}_out.npz"), losses=np.array(grab.losses),
                 norms=np.array(grab.norms), **snaps)
'''


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _tokens():
    """Token ids below the smallest vocab (251), so every case reads one file."""
    return np.random.default_rng(3).integers(0, 251, size=T * BATCH * 6, dtype=np.int32)


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.params, self.norms = prepared, [], [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        if attrs.step_metrics.grad_norm is not None:
            self.norms.append(float(np.asarray(attrs.step_metrics.grad_norm)))
        self.params.append(dict(_flat(jax.tree.map(np.asarray, self.prepared.state["params"]))))


def _reference(name, tmp, monkeypatch, ckpt_dir=None):
    """The reference's two steps of ``name`` on its mesh: (losses, the
    params after each step, the initial params); the dropout case only
    draws its initial params."""
    model_cfg, env, mesh = CASES[name]
    if name == "gpt2_dropout":
        model = jt.TransformerLM(jt.TransformerConfig(**model_cfg))
        params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])
        return None, None, dict(_flat(params)), None
    for key in ("ROCKET_TPU_OVERLAP", "ROCKET_TPU_OVERLAP_WIRE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    shape = MESHES[mesh]
    model = jt.TransformerLM(jt.TransformerConfig(**model_cfg))
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])
    runtime = JRuntime(mesh_shape={"data": shape.get("data", 1), "model": shape["model"]},
                       devices=jax.devices()[:int(np.prod(list(shape.values())))], seed=0,
                       project_dir=str(tmp / f"jax_{name}"))
    prepared = JPrepared(model, {"params": jax.tree.map(jnp.asarray, params), "model_state": {},
                                 "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    module = jrt.Module(model, [jrt.Loss(jt.next_token_loss()),
                                jrt.Optimizer(joptim.sgd(), learning_rate=LR,
                                              clip_norm=CLIP.get(name))],
                        param_sharding=js.gpt2_tp_rules())
    grab = _JGrab(prepared)
    caps = [jrt.Dataset(JTokens(_tokens(), T), batch_size=BATCH,
                        device_cache=False), module, grab]
    if ckpt_dir is not None:
        caps.append(jrt.Checkpointer(output_dir=str(ckpt_dir), save_every=STEPS))
    jrt.Launcher([jrt.Looper(caps, tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    return grab.losses, grab.params, dict(_flat(params)), grab.norms


_RUNS: dict = {}


def _mesh_run(mesh, tmp_path_factory, monkeypatch_factory):
    """Every case of ``mesh`` on its spawned group, and the reference's runs."""
    if mesh in _RUNS:
        return _RUNS[mesh]
    tmp = tmp_path_factory.mktemp(f"tp_{mesh}")
    names = [n for n, (_, _, m) in CASES.items() if m == mesh]
    refs = {}
    for name in names:
        with monkeypatch_factory() as mp:
            refs[name] = _reference(name, tmp, mp,
                                    ckpt_dir=tmp / "jax_ckpt" if name == SAVED else None)
        np.savez(tmp / f"{name}.npz", **refs[name][2])
    np.save(tmp / "tokens.npy", _tokens())
    cases = []
    for name in names:
        model_cfg, env, _ = CASES[name]
        cases.append({"name": name, "model": model_cfg, "env": env, "save": name == SAVED,
                      "clip": CLIP.get(name), "eval": name in EVAL})
        if name == SAVED:
            cases.append({"name": "resumed", "model": model_cfg, "env": env,
                          "resume": str(tmp / "jax_ckpt")})
            np.savez(tmp / "resumed.npz", **refs[name][2])
    world = int(np.prod(list(MESHES[mesh].values())))
    run_ranks(tmp, WORKER, world, {"mesh": MESHES[mesh], "cases": cases, "lr": LR,
                                   "batch": BATCH, "steps": STEPS}, timeout=400)
    _RUNS[mesh] = (tmp, refs, world)
    return _RUNS[mesh]


@pytest.fixture(scope="module")
def monkeypatch_factory():
    return pytest.MonkeyPatch.context


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, tmp_path_factory, monkeypatch_factory):
    return request.param, *_mesh_run(request.param, tmp_path_factory, monkeypatch_factory)


def _tolerance(name):
    env = CASES[name][1]
    return 2e-5 if env.get("ROCKET_TPU_OVERLAP_WIRE") == "fp32" else 2.0 ** -7


def _cases(mesh):
    return [n for n, (_, _, m) in CASES.items() if m == mesh and n != "gpt2_dropout"]


def test_tp_losses_match_the_reference(mesh_run):
    mesh, tmp, refs, _ = mesh_run
    for name in _cases(mesh):
        port = dict(np.load(tmp / f"{name}_out.npz"))
        rtol = 1e-5 if _tolerance(name) < 1e-4 else 1e-3
        np.testing.assert_allclose(port["losses"], refs[name][0], rtol=rtol, err_msg=name)


def test_tp_step1_gradients_of_every_leaf_match_the_reference(mesh_run):
    mesh, tmp, refs, _ = mesh_run
    for name in _cases(mesh):
        port = dict(np.load(tmp / f"{name}_out.npz"))
        _, ref_params, init, _ = refs[name]
        for leaf, p0 in init.items():
            got = (port[f"before/{leaf}"] - port[f"step1/{leaf}"]) / LR
            want = (p0 - ref_params[0][leaf]) / LR
            scale = float(np.abs(want).max()) + 1e-12
            err = float(np.abs(got - want).max())
            # A gradient read off two f32 params is exact to their ulp.
            floor = 2 * float(np.spacing(np.abs(p0).max())) / LR
            assert err <= max(_tolerance(name) * scale, floor), (name, leaf, err, scale)


def test_tp_updated_params_match_the_reference(mesh_run):
    mesh, tmp, refs, _ = mesh_run
    for name in _cases(mesh):
        port = dict(np.load(tmp / f"{name}_out.npz"))
        for leaf, want in refs[name][1][-1].items():
            got = port[f"step{STEPS}/{leaf}"]
            scale = float(np.abs(want).max()) + 1e-12
            assert float(np.abs(got - want).max()) <= _tolerance(name) * scale, (name, leaf)


def test_clip_norm_sums_each_shard_once_as_the_reference(mesh_run):
    """``clip_norm`` below every step's norm: the global norm sums each
    model shard over its group and each replicated leaf once, as the
    reference's norm of the global arrays; the clipped step above holds
    every leaf to the reference's."""
    mesh, tmp, refs, _ = mesh_run
    for name in (n for n in CLIP if CASES[n][2] == mesh):
        port = dict(np.load(tmp / f"{name}_out.npz"))
        ref_norms = refs[name][3]
        assert len(port["norms"]) == STEPS and min(ref_norms) > 2 * CLIP[name]
        np.testing.assert_allclose(port["norms"], ref_norms, rtol=1e-5)


def test_tp_eval_logits_are_the_one_process_forward_gathered_once(mesh_run):
    """An eval Module sharing the TP model gives the logits of the port's
    one-process forward on the trained params, and the Meter gathers the
    global batch once (over the data axis, not every rank)."""
    import torch

    from rocket_tpu_torch import bridge
    from rocket_tpu_torch.models import transformer as tt

    mesh, tmp, refs, _ = mesh_run
    for name in (n for n in EVAL if CASES[n][2] == mesh):
        got = np.load(tmp / f"{name}_eval.npy")
        port = dict(np.load(tmp / f"{name}_out.npz"))
        tree: dict = {}
        for leaf in refs[name][2]:
            node = tree
            *parents, last = leaf.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = port[f"step{STEPS}/{leaf}"]
        model = tt.TransformerLM(tt.TransformerConfig(**CASES[name][0]))
        tokens = torch.from_numpy(np.load(tmp / "tokens.npy")[:BATCH * T].reshape(BATCH, T))
        with torch.no_grad():
            want = model.apply(bridge.params_from_jax(tree), {"tokens": tokens},
                               mode="eval")["logits"].numpy()
        assert got.shape == want.shape == (BATCH, T, CASES[name][0]["vocab_size"]), name
        assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max()), name


def test_replicated_leaves_agree_bitwise_across_the_ranks(mesh_run):
    mesh, tmp, _, world = mesh_run
    for name in _cases(mesh):
        digests = [json.load(open(tmp / f"{name}_rank{r}.json")) for r in range(world)]
        assert all(d == digests[0] for d in digests), name
        # The blocks' projections are sharded; some replicated leaves remain.
        assert digests[0]["sharded"] > 0 and digests[0]["digest"], name


def test_dropout_under_tp_is_the_one_rank_run(tmp_path_factory, monkeypatch_factory):
    """TP at ``{"model": 2}`` with dropout 0.1 against the port's own
    one-process run of the same step (same keys, same global masks)."""
    import torch

    import rocket_tpu_torch as rt
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.data.text import TokenDataset
    from rocket_tpu_torch.models import transformer as tt

    tmp, refs, _ = _mesh_run("m2", tmp_path_factory, monkeypatch_factory)
    port = dict(np.load(tmp / "gpt2_dropout_out.npz"))
    cfg = CASES["gpt2_dropout"][0]
    with monkeypatch_factory() as mp:
        mp.setenv("ROCKET_TPU_OVERLAP_WIRE", "fp32")
        runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp / "one"))
        tree: dict = {}
        for name, value in refs["gpt2_dropout"][2].items():
            node = tree
            *parents, last = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = value
        model = tt.TransformerLM(tt.TransformerConfig(**cfg))
        prepared = PreparedModule(model, {"params": bridge.params_from_jax(tree)})
        runtime.models.add(model, prepared)
        losses = []

        class Grab(rt.Capsule):
            def launch(self, attrs=None):
                losses.append(float(attrs.step_metrics["loss"]))

        module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                                   rt.Optimizer(optim.sgd(), learning_rate=LR)])
        data = TokenDataset(np.load(tmp / "tokens.npy"), T)
        torch.set_num_threads(1)
        rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=BATCH), module, Grab(priority=10)],
                               tag="train", repeats=STEPS, progress=False)],
                    runtime=runtime).launch()
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-6)
    for leaf, value in bridge_flat(prepared.state["params"]).items():
        got = port[f"step{STEPS}/{leaf}"]
        scale = float(np.abs(value).max()) + 1e-12
        assert float(np.abs(got - value).max()) <= 2e-5 * scale, leaf


def bridge_flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(bridge_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v.detach().numpy()
    return out


def test_tp_checkpoint_reads_in_the_reference_and_one_rank(tmp_path_factory, monkeypatch_factory):
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.models import transformer as tt
    from rocket_tpu_torch.runtime import checkpoint_io as tio

    tmp, refs, world = _mesh_run("d2m2", tmp_path_factory, monkeypatch_factory)
    port = dict(np.load(tmp / f"{SAVED}_out.npz"))
    step_dir = tmp / "ckpt" / str(STEPS) / "model_0"
    # One writer per model shard (data coordinate 0: ranks 0 and 1); the
    # other ranks' files hold nothing.
    assert sorted(os.listdir(step_dir)) == ["index.json"] + [f"shard_p{r}.npz"
                                                              for r in range(world)]
    assert [len(np.load(step_dir / f"shard_p{r}.npz").files) > 0 for r in range(world)] == [
        True, True, False, False]
    flat = jio.load_pytree(str(step_dir))
    want = jio.load_pytree(str(tmp / "jax_ckpt" / str(STEPS) / "model_0"))
    assert sorted(flat) == sorted(want)
    for name, value in flat.items():
        if name.startswith("params/"):
            np.testing.assert_array_equal(value, port[f"step{STEPS}/{name[7:]}"], err_msg=name)
    # One port process reads the four ranks' shards whole.
    model = tt.TransformerLM(tt.TransformerConfig(**CASES[SAVED][0]))
    prepared = PreparedModule(model, {"params": model.init(device="cpu")})
    prepared.load_checkpoint_state(tio.unflatten(tio.load_pytree(str(step_dir))))
    for name, value in bridge_flat(prepared.state["params"]).items():
        np.testing.assert_array_equal(value, port[f"step{STEPS}/{name}"], err_msg=name)


def test_four_ranks_resume_the_references_tp_checkpoint(tmp_path_factory, monkeypatch_factory):
    tmp, _, _ = _mesh_run("d2m2", tmp_path_factory, monkeypatch_factory)
    resumed = dict(np.load(tmp / "resumed_out.npz"))
    want = jio.load_pytree(str(tmp / "jax_ckpt" / str(STEPS) / "model_0"))
    for name, value in want.items():
        if name.startswith("params/"):
            np.testing.assert_array_equal(resumed[f"before/{name[7:]}"], value, err_msg=name)
    assert len(resumed["losses"]) >= 1 and np.isfinite(resumed["losses"]).all()


def test_launcher_runs_the_gpt2_example_over_a_model_axis(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "MASTER_PORT": str(_free_port())}
    proc = subprocess.run(
        [sys.executable, "-m", "rocket_tpu_torch.launch", "-n", "2",
         str(Path(REPO) / "rocket_tpu_torch" / "examples" / "gpt2.py"), "--small",
         "--seq-len", "32", "--batch", "4", "--steps", "2", "--device", "cpu",
         "--model-axis", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    runs = list((tmp_path / "runs").glob("**/*.jsonl"))
    assert runs, os.listdir(tmp_path)
    lines = [json.loads(line) for line in runs[0].read_text().splitlines() if line.strip()]
    losses = [line["train/loss"] for line in lines if "train/loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
