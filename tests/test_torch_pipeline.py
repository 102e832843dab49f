"""The pipeline (``parallel/pipeline.py``) and the transformer over a
``pipe`` mesh axis, against the reference on the virtual CPU mesh.

The port's ranks are spawned gloo processes (``test_torch_grad_sync.
run_ranks``), one a stage; the weights are the reference's init, its
``blocks_stacked`` tree split over the stages by ``bridge.local_params``
under ``pipeline_rules``; tokens come from a numpy seed. The config is the
reference test's (``tests/test_transformer.py:652``): vocab 64, T=32,
dim 32, 4 layers, 4 heads, ``scan_layers``, 4 microbatches of 2 rows.

* Both schedules' loss and every gradient leaf, GPT-2 style and Llama style
  (RoPE, RMSNorm, SwiGLU, GQA, untied head), from
  ``pipelined_value_and_grad`` on two stages, against the reference's
  1F1B ``pipelined_value_and_grad`` at ``{"data": 1, "pipe": 2}``: loss
  within 1e-5 relative, each stage's leaves within 2e-5 of the leaf's
  largest element, the shared leaves' partial gradients summed over the
  stages. The reference's GPipe program does not trace on the installed
  JAX (its ``psum`` over the pipe axis raises "psum is a variant->invariant
  collective"), so the port's GPipe is held to the reference's 1F1B, which
  the reference's own test holds equal to its GPipe
  (``tests/test_transformer.py:652``).
* GPipe eval logits on every stage within 1e-5 of the reference's looped
  model (``tests/test_transformer.py:308``).
* The 1F1B live-input counter at M = 4 and M = 8: at most ``2P - 1`` = 3
  on every stage (stage 0 reaches it; the last stage saves none).
* Dropout 0.1: both schedules draw bitwise the masks of the port's own
  unpipelined run of the same batch and key (the JAX package's bits differ
  by design, ``nn/keys.py``).
* The ``Module`` trains two SGD steps (lr 0.5) at ``{"data": 1, "pipe":
  2}`` under 1F1B and at ``{"data": 2, "pipe": 2}`` (four ranks) under
  GPipe, against the reference's 1F1B ``Module`` at the same meshes: losses
  within 1e-5 relative, every step-1 gradient leaf within 2e-5 of its
  largest element. The two-stage run's checkpoint (one shard file a stage)
  resumes on one process bitwise.
* ``scan_layers=False`` with ``pipeline_axis`` raises, as the reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rocket_tpu as jrt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokens
from rocket_tpu.models import transformer as jt
from rocket_tpu.parallel import sharding as js
from rocket_tpu.runtime.context import Runtime as JRuntime
from test_torch_grad_sync import run_ranks

T, BATCH, M, STEPS, LR = 32, 8, 4, 2, 0.5
LOSS_RTOL, GRAD_TOL, LOGIT_TOL = 1e-5, 2e-5, 1e-5
BASE = dict(vocab_size=64, max_seq_len=T, dim=32, num_layers=4, num_heads=4, dropout=0.0,
            scan_layers=True, pipeline_axis="pipe", pipeline_microbatches=M)
LLAMA = dict(num_kv_heads=2, pos_embedding="rope", norm="rmsnorm", mlp="swiglu",
             tied_embeddings=False)
FAMILIES = {"gpt2": BASE, "llama": dict(BASE, **LLAMA)}
SCHEDULES = ("gpipe", "1f1b")
#: The Module runs: name -> (family, schedule, mesh).
TRAIN = {"train_1f1b": ("gpt2", "1f1b", {"data": 1, "pipe": 2}),
         "train_d2p2": ("gpt2", "gpipe", {"data": 2, "pipe": 2})}

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch import bridge, optim
from rocket_tpu_torch.core.module import PreparedModule, _paths
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.parallel import pipeline as pl
from rocket_tpu_torch.parallel.sharding import pipeline_rules

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])
masks = {}
draw = keys.dropout_mask


def recorded(k, p, shape, device, split=None):
    mask = draw(k, p, shape, device, split)
    if split is None:
        n = int(np.prod(shape))
        idx = torch.arange(keys.shard_offset(n), keys.shard_offset(n) + n).reshape(shape)
    else:
        idx = keys.global_index(shape, device, split)
    masks.setdefault(k, {}).update(zip(idx.reshape(-1).tolist(), mask.reshape(-1).tolist()))
    return mask


keys.dropout_mask = recorded


def tree_of(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def stacked(flat):
    """The reference's scanned tree (``blocks_stacked``) as numpy."""
    return tree_of(flat)


tokens = torch.from_numpy(np.load(os.path.join(out, "tokens.npy"))[:cfg["batch"] * cfg["t"]]
                          .reshape(cfg["batch"], cfg["t"]).astype(np.int64))
if rank < 2 and cfg.get("vag"):
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape={"data": 1, "pipe": 2})
    res = {}
    for case in cfg["vag"]:
        model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
        flat = dict(np.load(os.path.join(out, case["family"] + "_init.npz")))
        local = bridge.local_params(stacked(flat), pipeline_rules(), runtime)
        leaves = [t.requires_grad_(True) for t in optim.param_leaves(local)]
        vag = model.pipelined_value_and_grad(tt.next_token_loss())
        pl.reset_stats()
        masks.clear()
        rng = keys.key(7) if case["model"]["dropout"] else None
        loss, _, grads = vag(local, {"tokens": tokens[:case["batch"]]}, rng, leaves)
        tag = case["name"]
        res[f"{tag}/loss"] = np.array(float(loss))
        res[f"{tag}/live_max"] = np.array(pl.STATS["live_max"])
        for path, g in zip(_paths(local), grads):
            if g is not None:
                res[f"{tag}/grad/" + "/".join(path)] = g.numpy()
        if case["model"]["dropout"]:
            json.dump({str(k): sorted(v.items()) for k, v in masks.items()},
                      open(os.path.join(out, f"{tag}_masks{rank}.json"), "w"))
        if case.get("eval"):
            with torch.no_grad():
                logits = model.apply(local, {"tokens": tokens}, mode="eval")["logits"]
            res[f"{tag}/logits"] = logits.numpy()
    np.savez(os.path.join(out, f"vag_rank{rank}.npz"), **res)


class Grab(rt.Capsule):
    def __init__(self, prepared, runtime):
        super().__init__(priority=10)
        self.prepared, self.rt, self.losses, self.params = prepared, runtime, [], []

    def launch(self, attrs=None):
        self.losses.append(float(attrs.step_metrics["loss"]))
        whole = bridge.gather_params(self.prepared, self.rt)
        self.params.append({k: v.numpy() for k, v in whole.items()})


for case in cfg.get("train", []):
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=case["mesh"],
                         project_dir=os.path.join(out, f"proj{rank}"))
    model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
    flat = dict(np.load(os.path.join(out, case["family"] + "_init.npz")))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(stacked(flat))})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"])],
                       param_sharding=pipeline_rules())
    data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), cfg["t"])
    grab = Grab(prepared, runtime)
    caps = [rt.Dataset(data, batch_size=cfg["batch"]), module, grab]
    if case.get("save"):
        caps.append(rt.Checkpointer(output_dir=os.path.join(out, case["name"] + "_ckpt"),
                                    save_every=cfg["steps"]))
    rt.Launcher([rt.Looper(caps, tag="train", repeats=cfg["steps"], progress=False)],
                runtime=runtime).launch()
    if rank == 0:
        snaps = {f"step{s + 1}/{k}": v for s, p in enumerate(grab.params) for k, v in p.items()}
        np.savez(os.path.join(out, f"{case['name']}_out.npz"), losses=np.array(grab.losses),
                 **snaps)
    json.dump(["/".join(p) for p in _paths(prepared.state["params"])],
              open(os.path.join(out, f"{case['name']}_held{rank}.json"), "w"))
'''


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _tokens():
    return np.random.default_rng(3).integers(0, 64, size=T * BATCH * 4, dtype=np.int32)


def _batch(rows=BATCH):
    return jnp.asarray(_tokens()[:rows * T].reshape(rows, T))


def _init(family):
    model = jt.TransformerLM(jt.TransformerConfig(**FAMILIES[family]))
    return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0))["params"])


def _unstack(flat: dict) -> dict:
    """A scanned tree's ``blocks_stacked/<leaf>`` as ``blocks/<i>/<leaf>``."""
    out = {}
    for name, value in flat.items():
        if name.startswith("blocks_stacked/"):
            rest = name[len("blocks_stacked/"):]
            for i in range(value.shape[0]):
                out[f"blocks/{i}/{rest}"] = value[i]
        else:
            out[name] = value
    return out


_REF_VAG: dict = {}


def _reference_vag(family, tmp):
    """The reference's 1F1B loss and gradients (module docstring)."""
    if family in _REF_VAG:
        return _REF_VAG[family]
    JRuntime(mesh_shape={"data": 1, "pipe": 2}, devices=jax.devices()[:2], seed=0,
             project_dir=str(tmp / "jax"))
    model = jt.TransformerLM(jt.TransformerConfig(**dict(FAMILIES[family],
                                                         pipeline_schedule="1f1b")))
    params = jax.tree.map(jnp.asarray, _init(family))
    (loss, _), grads = jax.jit(model.pipelined_value_and_grad(jt.next_token_loss()))(
        params, {}, {"tokens": _batch()}, None)
    _REF_VAG[family] = float(loss), _unstack(dict(_flat(jax.tree.map(np.asarray, grads))))
    return _REF_VAG[family]


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.params = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        self.params.append(_unstack(dict(_flat(jax.tree.map(np.asarray,
                                                            self.prepared.state["params"])))))


def _reference_train(name, tmp):
    family, _, mesh = TRAIN[name]
    model = jt.TransformerLM(jt.TransformerConfig(**dict(FAMILIES[family],
                                                         pipeline_schedule="1f1b")))
    params = _init(family)
    n = int(np.prod(list(mesh.values())))
    runtime = JRuntime(mesh_shape=mesh, devices=jax.devices()[:n], seed=0,
                       project_dir=str(tmp / f"jax_{name}"))
    prepared = JPrepared(model, {"params": jax.tree.map(jnp.asarray, params), "model_state": {},
                                 "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    module = jrt.Module(model, [jrt.Loss(jt.next_token_loss()),
                                jrt.Optimizer(joptim.sgd(), learning_rate=LR)],
                        param_sharding=js.pipeline_rules())
    grab = _JGrab(prepared)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokens(_tokens(), T), batch_size=BATCH,
                                          device_cache=False), module, grab],
                             tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    return {"losses": grab.losses, "params": grab.params,
            "init": _unstack(dict(_flat(params)))}


def _vag_cases():
    cases = []
    for family in FAMILIES:
        for schedule in SCHEDULES:
            cases.append({"name": f"{family}_{schedule}", "family": family, "batch": BATCH,
                          "model": dict(FAMILIES[family], pipeline_schedule=schedule),
                          "eval": schedule == "gpipe"})
    for m in (4, 8):  # the live-input bound at 2-row microbatches
        cases.append({"name": f"live_m{m}", "family": "gpt2", "batch": 2 * m,
                      "model": dict(BASE, pipeline_schedule="1f1b", pipeline_microbatches=m)})
    for schedule in SCHEDULES:
        cases.append({"name": f"dropout_{schedule}", "family": "gpt2", "batch": BATCH,
                      "model": dict(BASE, pipeline_schedule=schedule, dropout=0.1)})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    for family in FAMILIES:
        np.savez(tmp / f"{family}_init.npz", **dict(_flat(_init(family))))
    np.save(tmp / "tokens.npy", _tokens())
    common = {"lr": LR, "batch": BATCH, "steps": STEPS, "t": T}
    train = [{"name": "train_1f1b", "family": "gpt2", "mesh": TRAIN["train_1f1b"][2],
              "model": dict(BASE, pipeline_schedule="1f1b"), "save": True}]
    run_ranks(tmp, WORKER, 2, {**common, "vag": _vag_cases(), "train": train}, timeout=400)
    tmp4 = tmp_path_factory.mktemp("pipe4")
    np.savez(tmp4 / "gpt2_init.npz", **dict(_flat(_init("gpt2"))))
    np.save(tmp4 / "tokens.npy", _tokens())
    run_ranks(tmp4, WORKER, 4, {**common, "train": [
        {"name": "train_d2p2", "family": "gpt2", "mesh": TRAIN["train_d2p2"][2],
         "model": dict(BASE, pipeline_schedule="gpipe")}]}, timeout=400)
    vag = [dict(np.load(tmp / f"vag_rank{r}.npz")) for r in range(2)]
    trained = {"train_1f1b": dict(np.load(tmp / "train_1f1b_out.npz")),
               "train_d2p2": dict(np.load(tmp4 / "train_d2p2_out.npz"))}
    return tmp, vag, trained


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_loss_and_every_gradient_leaf_match_the_reference(runs, tmp_path, family,
                                                                    schedule):
    _, vag, _ = runs
    loss, grads = _reference_vag(family, tmp_path)
    tag = f"{family}_{schedule}"
    # The loss lives on the last stage; stage 0 holds 0 before the sum.
    np.testing.assert_allclose(float(vag[1][f"{tag}/loss"]), loss, rtol=LOSS_RTOL)
    assert float(vag[0][f"{tag}/loss"]) == 0.0
    prefix = f"{tag}/grad/"
    held = [{k[len(prefix):] for k in v if k.startswith(prefix)} for v in vag]
    assert held[0] & {k for k in grads if k.startswith("blocks/")} == {
        k for k in grads if k.startswith(("blocks/0/", "blocks/1/"))}
    for leaf, want in grads.items():
        got = sum(v[prefix + leaf] for v in vag if prefix + leaf in v)
        scale = float(np.abs(want).max()) + 1e-12
        assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, (tag, leaf)


def test_gpipe_eval_logits_match_the_looped_model(runs):
    _, vag, _ = runs
    for family in FAMILIES:
        cfg = {k: v for k, v in FAMILIES[family].items()
               if not k.startswith("pipeline") and k != "scan_layers"}
        model = jt.TransformerLM(jt.TransformerConfig(**cfg))
        tree: dict = {}
        for name, value in _unstack(dict(_flat(_init(family)))).items():
            node = tree
            *parents, last = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = jnp.asarray(value)
        out, _ = model.apply({"params": tree, "state": {}}, {"tokens": _batch()}, mode="eval")
        for rank in vag:
            np.testing.assert_allclose(rank[f"{family}_gpipe/logits"], np.asarray(out["logits"]),
                                       rtol=0, atol=LOGIT_TOL)


def test_1f1b_live_inputs_stay_within_2p_minus_1(runs):
    _, vag, _ = runs
    for m in (4, 8):
        live = [int(v[f"live_m{m}/live_max"]) for v in vag]
        assert live == [3, 0], (m, live)


def test_dropout_masks_are_the_unpipelined_runs_bitwise(runs):
    import json

    from rocket_tpu_torch import bridge
    from rocket_tpu_torch.models import transformer as tt
    from rocket_tpu_torch.nn import keys

    tmp, _, _ = runs
    cfg = dict(BASE, dropout=0.1, pipeline_axis=None, pipeline_microbatches=None)
    model = tt.TransformerLM(tt.TransformerConfig(**cfg))
    params = bridge.params_from_jax(_nested(_init("gpt2")))
    want: dict = {}
    draw = keys.dropout_mask

    def recorded(k, p, shape, device, split=None):
        mask = draw(k, p, shape, device, split)
        want[k] = mask.reshape(-1).tolist()
        return mask

    keys.dropout_mask = recorded
    try:
        with torch.no_grad():
            model.apply(params, {"tokens": torch.from_numpy(np.asarray(_batch()).astype(np.int64))},
                        mode="train", rng=keys.key(7))
    finally:
        keys.dropout_mask = draw
    assert len(want) == 1 + 4 * 3  # the embedding's and three a block
    for schedule in SCHEDULES:
        got: dict = {}
        for r in range(2):
            for k, pairs in json.load(open(tmp / f"dropout_{schedule}_masks{r}.json")).items():
                got.setdefault(int(k), {}).update(dict(pairs))
        assert sorted(got) == sorted(want), schedule
        for k, bits in want.items():
            assert [got[k][i] for i in range(len(bits))] == bits, (schedule, k)


def _nested(params: dict) -> dict:
    return {k: _nested(v) if isinstance(v, dict) else v for k, v in params.items()}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_pipelined_module_steps_match_the_reference(runs, tmp_path, name):
    _, _, trained = runs
    ref = _reference_train(name, tmp_path)
    port = trained[name]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL)
    for leaf, p0 in ref["init"].items():
        got = (p0 - port[f"step1/{leaf}"]) / LR
        want = (p0 - ref["params"][0][leaf]) / LR
        floor = 2 * float(np.spacing(np.abs(p0).max())) / LR
        err = float(np.abs(got - want).max())
        assert err <= max(GRAD_TOL * float(np.abs(want).max()), floor), (name, leaf, err)


def test_pipe_checkpoint_resumes_on_one_rank(runs):
    import os

    import rocket_tpu_torch as rt
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.models import transformer as tt

    tmp, _, trained = runs
    step_dir = tmp / "train_1f1b_ckpt" / str(STEPS) / "model_0"
    assert sorted(os.listdir(step_dir)) == ["index.json", "shard_p0.npz", "shard_p1.npz"]
    # Each stage wrote its own layers.
    stage1 = dict(np.load(step_dir / "shard_p1.npz"))
    assert {k.split("/")[2] for k in stage1 if k.startswith("params/blocks/")} == {"2", "3"}
    from rocket_tpu_torch.core.module import _paths
    from rocket_tpu_torch.data.text import TokenDataset

    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp / "resume"))
    model = tt.TransformerLM(tt.TransformerConfig(**dict(BASE, pipeline_axis=None,
                                                         pipeline_microbatches=None)))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(_nested(_init("gpt2")))})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=LR)])
    seen = {}

    class Before(rt.Capsule):
        def __init__(self):
            super().__init__(priority=2000)

        def launch(self, attrs=None):
            if not seen:
                seen["step"] = prepared.state["step"]
                seen.update({"/".join(p): _leaf(prepared.state["params"], p).detach().numpy()
                             .copy() for p in _paths(prepared.state["params"])})

    ckpt = rt.Checkpointer(output_dir=str(tmp / "train_1f1b_ckpt"), resume_from="latest",
                           resume_capsules=False, save_every=1000)
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(_tokens(), T), batch_size=BATCH), Before(),
                            module, ckpt], tag="train", repeats=1, progress=False)],
                runtime=runtime).launch()
    assert seen.pop("step") == STEPS
    assert len(seen) == (len(trained["train_1f1b"]) - 1) // STEPS  # every leaf, every stage
    for name, value in seen.items():
        np.testing.assert_array_equal(value, trained["train_1f1b"][f"step{STEPS}/{name}"],
                                      err_msg=name)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_pipeline_without_scan_layers_raises():
    import rocket_tpu_torch as rt
    from rocket_tpu_torch.models import transformer as tt

    rt.Runtime(device="cpu", seed=0, mesh_shape={"data": 1, "pipe": 1})
    model = tt.TransformerLM(tt.TransformerConfig(**dict(BASE, scan_layers=False)))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="scan_layers"), torch.no_grad():
        model.apply(params, {"tokens": torch.zeros((4, 16), dtype=torch.long)}, mode="eval")


def test_launcher_runs_the_pipeline_example_under_1f1b(tmp_path):
    """``python -m rocket_tpu_torch.launch -n 2`` on ``examples/pipeline_lm.py
    --schedule 1f1b`` at the reference's defaults (one epoch), on the CPU:
    the reference's printed line, the loss falling."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_grad_sync import REPO, _free_port

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "MASTER_PORT": str(_free_port())}
    proc = subprocess.run(
        [sys.executable, "-m", "rocket_tpu_torch.launch", "-n", "2",
         str(Path(REPO) / "rocket_tpu_torch" / "examples" / "pipeline_lm.py"),
         "--schedule", "1f1b", "--epochs", "1", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    lines = [ln for ln in text.splitlines() if "1f1b over 2 stages x 1 data shards: loss" in ln]
    assert len(lines) == 2, text[-3000:]  # one a rank, "[rank r] " before each
    line = lines[0]
    first, last = (float(v) for v in line.split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first, line
