"""Expert parallelism (an ``expert`` mesh axis) and the MoE LM under the
model, seq and pipe axes, against the reference on one process.

The port's ranks are spawned gloo processes (``test_torch_grad_sync.
run_ranks``), one group a mesh running its cases in turn, one intra-op
thread each; weights come from the reference's init through ``bridge``,
inputs and tokens from numpy seeds. The reference runs in this process on
one device: it computes the same function (its expert axis, data axis and
sequence sharding are GSPMD layouts of one program).

* The MoE layer at ``{"expert": 2}`` (``moe_rules``' E/2 experts a rank)
  for the einsum, scatter, dropless and dropless fused
  (``ROCKET_TPU_MOE_GMM=fused``) routes: the routing (top-k ids)
  identical, ``y``, ``aux_loss`` and ``frac_dropped`` within 2e-5 and every
  gradient (router, each rank's experts, the input) within 1e-4 of the
  leaf's largest element (``tests/test_torch_moe.py``'s tolerances).
* A 2-layer MoE LM trained two steps of SGD (lr 0.5) by the port's
  ``Module`` at ``{"expert": 2}`` and ``{"data": 2, "expert": 2}``, with
  ``scan_layers`` both ways, under ``{"model": 2}`` (``gpt2_tp_rules``, the
  f32 wire), under ``{"seq": 2}`` (ring attention; the routing groups span
  the whole sequence) and under ``{"pipe": 2}`` GPipe at M = 2: both
  losses (the aux loss included, counted once) within 1e-5 relative and
  every step-1 gradient leaf (``(p0 - p1) / lr``, gathered whole) within
  1e-4 of its largest element, against the reference's ``value_and_grad``
  of the same loss at the same params (under the pipe axis applied to each
  microbatch and averaged: each microbatch is its own routing group).
* An ``{"expert": 2}`` checkpoint has one writer per expert shard and
  resumes on one process bitwise; a one-process checkpoint resumes at
  ``{"expert": 2}`` bitwise.
* ``python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/
  moe_lm.py --expert-axis 2`` at tiny flags on the CPU.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.models import transformer as jt
from rocket_tpu.nn.moe import MoE as JMoE
from test_torch_grad_sync import REPO, _free_port, run_ranks

TOL, GRAD_TOL, LOSS_RTOL = 2e-5, 1e-4, 1e-5
T, BATCH, STEPS, LR = 16, 4, 2, 0.5
#: (dispatch, ROCKET_TPU_MOE_GMM) of the four routes.
ROUTES = {"einsum": ("einsum", None), "scatter": ("scatter", None),
          "dropless": ("dropless", None), "dropless_fused": ("dropless", "fused")}
LAYER = dict(dim=32, hidden=128, experts=4, b=2, t=16)
LM = dict(vocab_size=64, max_seq_len=T, dim=32, num_layers=2, num_heads=4, dropout=0.0,
          num_experts=4, expert_top_k=2)
#: name -> (the model's config, the port's extra config, environment, mesh).
CASES = {
    "e2_einsum": (dict(LM, expert_dispatch="einsum"), {}, {}, "e2"),
    "e2_fused_scan": (dict(LM, expert_dispatch="dropless", scan_layers=True), {},
                      {"ROCKET_TPU_MOE_GMM": "fused"}, "e2"),
    "d2e2_dropless": (dict(LM, expert_dispatch="dropless"), {}, {}, "d2e2"),
    "d2e2_einsum_scan": (dict(LM, expert_dispatch="einsum", scan_layers=True), {}, {}, "d2e2"),
    "m2_dropless": (dict(LM, expert_dispatch="dropless", loss_chunk=8), {},
                    {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}, "m2"),
    "s2_einsum": (dict(LM, expert_dispatch="einsum"), {"attention_impl": "ring"}, {}, "s2"),
    "p2_dropless": (dict(LM, expert_dispatch="dropless", scan_layers=True),
                    {"pipeline_axis": "pipe", "pipeline_microbatches": 2}, {}, "p2"),
}
MESHES = {"e2": {"data": 1, "expert": 2}, "d2e2": {"data": 2, "expert": 2},
          "m2": {"data": 1, "model": 2}, "s2": {"data": 1, "seq": 2},
          "p2": {"data": 1, "pipe": 2}}
RULES = {"e2": "moe", "d2e2": "moe", "m2": "tp", "s2": None, "p2": "pipe"}
#: The case whose run saves the expert checkpoint; the one-process
#: checkpoint the expert ranks resume.
SAVED, RESUMED = "e2_einsum", "e2_resumed"

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
from rocket_tpu_torch.nn.moe import MoE
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.parallel import sharding

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])
RULES = {"moe": sharding.moe_rules, "tp": sharding.gpt2_tp_rules, "pipe": sharding.pipeline_rules}


def tree_of(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def env(values):
    for key in ("ROCKET_TPU_MOE_GMM", "ROCKET_TPU_OVERLAP_WIRE"):
        os.environ.pop(key, None)
    os.environ.update(values)


if cfg.get("layer"):
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=cfg["mesh"])
    lay = cfg["layer"]
    data = dict(np.load(os.path.join(out, "layer.npz")))
    res = {}
    for route, (dispatch, forced) in cfg["routes"].items():
        env({"ROCKET_TPU_MOE_GMM": forced} if forced else {})
        moe = MoE(lay["dim"], lay["hidden"], lay["experts"], top_k=2, dispatch=dispatch)
        whole = bridge.params_from_jax(tree_of({k[7:]: v for k, v in data.items()
                                                if k.startswith("params/")}))
        local = bridge.local_params(whole, sharding.moe_rules(), runtime)
        leaves = [t.requires_grad_(True) for t in optim.param_leaves(local)]
        x = torch.from_numpy(data["x"]).requires_grad_(True)
        with coll.expert_parallel(runtime):
            y, aux = moe.apply(local, x)
            loss = (y * torch.from_numpy(data["cot"])).sum() + 3.0 * aux["aux_loss"]
            grads = torch.autograd.grad(loss, leaves + [x])
        res[f"{route}/top_idx"] = moe.route(local, x)[2].numpy()
        res[f"{route}/y"] = y.detach().numpy()
        res[f"{route}/aux"] = aux["aux_loss"].detach().numpy()
        res[f"{route}/frac_dropped"] = aux["frac_dropped"].detach().numpy()
        for (path, _), g in zip(bridge._paths(local), grads[:-1]):
            res[f"{route}/grad/{'/'.join(path)}"] = g.numpy()
        res[f"{route}/grad/x"] = grads[-1].numpy()
    np.savez(os.path.join(out, f"layer_rank{rank}.npz"), **res)


class Grab(rt.Capsule):
    """Per step: the loss and the whole params; with ``before`` the whole
    params before the first step (after a resume)."""

    def __init__(self, prepared, runtime, before=False):
        super().__init__(priority=2000 if before else 10)
        self.prepared, self.rt, self.before = prepared, runtime, before
        self.losses, self.params = [], []

    def launch(self, attrs=None):
        if self.before:
            if not self.params:
                self.params.append(bridge.gather_params(self.prepared, self.rt))
            return
        self.losses.append(float(attrs.step_metrics["loss"]))
        self.params.append(bridge.gather_params(self.prepared, self.rt))


for case in cfg["cases"]:
    env(case["env"])
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=cfg["mesh"],
                         project_dir=os.path.join(out, f"proj{rank}"))
    model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
    flat = dict(np.load(os.path.join(out, case["init"] + ".npz")))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(tree_of(flat))})
    runtime.models.add(model, prepared)
    rule = RULES[cfg["rule"]]() if cfg["rule"] else None
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"])],
                       param_sharding=rule)
    data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), cfg["t"])
    grab, before = Grab(prepared, runtime), Grab(prepared, runtime, before=True)
    caps = [rt.Dataset(data, batch_size=cfg["batch"]), before, module, grab]
    steps = cfg["steps"]
    if case.get("save"):
        caps.append(rt.Checkpointer(output_dir=os.path.join(out, "ckpt"), save_every=steps))
    if case.get("resume"):
        steps = 1
        caps.append(rt.Checkpointer(output_dir=case["resume"], save_every=1000,
                                    resume_from="latest", resume_capsules=False))
    rt.Launcher([rt.Looper(caps, tag="train", repeats=steps, progress=False)],
                runtime=runtime).launch()
    held = prepared.held_bytes()
    json.dump({"held": held, "step": prepared.state["step"]},
              open(os.path.join(out, f"{case['name']}_rank{rank}.json"), "w"))
    if rank == 0:
        snaps = {f"before/{k}": v.numpy() for k, v in before.params[0].items()}
        for s, p in enumerate(grab.params):
            snaps.update({f"step{s + 1}/{k}": v.numpy() for k, v in p.items()})
        np.savez(os.path.join(out, f"{case['name']}_out.npz"), losses=np.array(grab.losses),
                 **snaps)
'''


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _tree(flat):
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def _tokens():
    return np.random.default_rng(3).integers(0, LM["vocab_size"], size=T * BATCH * 6,
                                             dtype=np.int32)


def _batches():
    """The two global batches the two steps read, (B, T) each."""
    tok = _tokens()
    return [tok[i * BATCH * T:(i + 1) * BATCH * T].reshape(BATCH, T) for i in range(STEPS)]


def _port_flat(tree):
    """A JAX-layout tree (stacked or not) as the port's ``blocks/<i>`` paths."""
    from rocket_tpu_torch import bridge

    return {k: np.asarray(v) for k, v in _flat(bridge.params_from_jax(
        jax.tree.map(np.asarray, tree)))}


def _reference(name):
    """The reference's losses of both steps and its step-1 gradient (port
    paths), one process: ``value_and_grad`` of ``next_token_loss`` (the aux
    loss included) at the initial params on batch 1, then at ``p0 - lr·g``
    on batch 2; under the pipe axis each microbatch's and averaged."""
    model_cfg = CASES[name][0]
    model = jt.TransformerLM(jt.TransformerConfig(**model_cfg))
    params = jax.jit(model.init)(jax.random.key(1))["params"]
    micro = CASES[name][3] == "p2"

    @jax.jit
    def vag(p, tokens):
        def loss(p, tok):
            out, _ = model.apply({"params": p, "state": {}}, {"tokens": tok}, mode="train")
            return jt.next_token_loss()(out)

        if not micro:
            return jax.value_and_grad(loss)(p, tokens)
        parts = [jax.value_and_grad(loss)(p, tok) for tok in jnp.split(tokens, 2)]
        return (sum(v for v, _ in parts) / 2,
                jax.tree.map(lambda *g: sum(g) / 2, *[g for _, g in parts]))

    batches = [jnp.asarray(b) for b in _batches()]
    loss1, grads = vag(params, batches[0])
    p1 = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    loss2, _ = vag(p1, batches[1])
    return (np.array([float(loss1), float(loss2)]), _port_flat(grads),
            dict(_flat(jax.tree.map(np.asarray, params))))


def _one_process_checkpoint(tmp):
    """Two SGD steps of ``SAVED``'s model on one port process, saved:
    the checkpoint the expert ranks resume, and its step-2 params."""
    import rocket_tpu_torch as rt
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.data.text import TokenDataset
    from rocket_tpu_torch.models import transformer as tt

    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp / "one"))
    model = tt.TransformerLM(tt.TransformerConfig(**CASES[SAVED][0]))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(
        _tree(dict(np.load(tmp / f"{SAVED}.npz"))))})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=LR)])
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(_tokens(), T), batch_size=BATCH), module,
                            rt.Checkpointer(output_dir=str(tmp / "one_ckpt"),
                                            save_every=STEPS)],
                           tag="train", repeats=STEPS, progress=False)],
                runtime=runtime).launch()
    return {"/".join(p): t for p, t in bridge._paths(
        {k: v for k, v in prepared.state["params"].items()})}


_RUNS: dict = {}


def _mesh_run(mesh, tmp_path_factory):
    """Every case of ``mesh`` on its spawned group (the layer cases on
    ``e2``), and the reference's values."""
    if mesh in _RUNS:
        return _RUNS[mesh]
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp(f"ep_{mesh}")
    names = [n for n, c in CASES.items() if c[3] == mesh]
    refs = {name: _reference(name) for name in names}
    np.save(tmp / "tokens.npy", _tokens())
    cases = []
    for name in names:
        np.savez(tmp / f"{name}.npz", **refs[name][2])
        model_cfg, extra, env, _ = CASES[name]
        cases.append({"name": name, "model": dict(model_cfg, **extra), "env": env,
                      "init": name, "save": name == SAVED})
    config = {"mesh": MESHES[mesh], "rule": RULES[mesh], "cases": cases, "lr": LR,
              "batch": BATCH, "steps": STEPS, "t": T}
    extra = {}
    if mesh == "e2":
        extra["layer"] = _layer_reference(tmp)
        extra["one"] = _one_process_checkpoint(tmp)
        cases.append({"name": RESUMED, "model": CASES[SAVED][0], "env": {}, "init": SAVED,
                      "resume": str(tmp / "one_ckpt")})
        config.update(layer=LAYER, routes=ROUTES)
    world = int(np.prod(list(MESHES[mesh].values())))
    run_ranks(tmp, WORKER, world, config, timeout=400)
    _RUNS[mesh] = (tmp, refs, world, extra)
    return _RUNS[mesh]


def _layer_reference(tmp):
    """The reference layer's routing, outputs and gradients for each route,
    its params, input and cotangent saved for the ranks."""
    lay = LAYER
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(lay["b"], lay["t"], lay["dim"])) * 0.5).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    params = None
    want = {}
    for route, (dispatch, forced) in ROUTES.items():
        jmoe = JMoE(lay["dim"], lay["hidden"], lay["experts"], top_k=2, dispatch=dispatch)
        params = jmoe.init_params(jax.random.key(0))

        def loss(p, xx, jmoe=jmoe):
            y, aux = jmoe.apply({"params": p, "state": {}}, xx)
            return jnp.sum(y * cot) + 3.0 * aux["aux_loss"], (y, aux)

        old = os.environ.pop("ROCKET_TPU_MOE_GMM", None)
        if forced:
            os.environ["ROCKET_TPU_MOE_GMM"] = forced
        try:
            (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
                params, jnp.asarray(x))
        finally:
            os.environ.pop("ROCKET_TPU_MOE_GMM", None)
            if old is not None:
                os.environ["ROCKET_TPU_MOE_GMM"] = old
        logits = jnp.asarray(x) @ params["router"]["w"]
        want[route] = {"top_idx": np.asarray(jax.lax.top_k(jax.nn.softmax(logits), 2)[1]),
                       "y": np.asarray(y), "aux": np.asarray(aux["aux_loss"]),
                       "frac_dropped": np.asarray(aux["frac_dropped"]),
                       "grad/x": np.asarray(gx),
                       **{f"grad/{k}": v for k, v in _flat(jax.tree.map(np.asarray, gp))}}
    np.savez(tmp / "layer.npz", x=x, cot=cot,
             **{f"params/{k}": v for k, v in _flat(jax.tree.map(np.asarray, params))})
    return want


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-12
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= tol * scale, (what, err, scale)


# -- the layer --------------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_moe_layer_over_two_expert_ranks_matches_the_reference(route, tmp_path_factory):
    """Each rank routes alike and computes its two experts; ``y``, the aux
    loss, the dropped fraction and every gradient (the rank's experts' own)
    against the reference's layer on one process."""
    tmp, _, world, extra = _mesh_run("e2", tmp_path_factory)
    want = extra["layer"][route]
    for rank in range(world):
        got = dict(np.load(tmp / f"layer_rank{rank}.npz"))
        np.testing.assert_array_equal(got[f"{route}/top_idx"], want["top_idx"])
        np.testing.assert_allclose(got[f"{route}/y"], want["y"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[f"{route}/aux"], want["aux"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[f"{route}/frac_dropped"], want["frac_dropped"],
                                   rtol=TOL, atol=TOL)
        for key, value in want.items():
            if not key.startswith("grad/"):
                continue
            mine = value
            if "/experts/" in key:  # the rank's two experts
                mine = np.split(value, world, axis=0)[rank]
            assert got[f"{route}/{key}"].shape == mine.shape, key
            _close(got[f"{route}/{key}"], mine, GRAD_TOL, (route, rank, key))


# -- the LM on every axis -----------------------------------------------------------------


def _lm_cases():
    return [n for n in CASES]


@pytest.mark.parametrize("name", _lm_cases())
def test_moe_lm_losses_and_step1_gradients_match_the_reference(name, tmp_path_factory):
    """Both steps' losses (the aux loss included, once) and every step-1
    gradient leaf against the reference's ``value_and_grad``."""
    mesh = CASES[name][3]
    tmp, refs, _, _ = _mesh_run(mesh, tmp_path_factory)
    port = dict(np.load(tmp / f"{name}_out.npz"))
    losses, grads, init = refs[name]
    np.testing.assert_allclose(port["losses"], losses, rtol=LOSS_RTOL, err_msg=name)
    assert sorted(grads) == sorted(k[7:] for k in port if k.startswith("before/"))
    for leaf, want in grads.items():
        got = (port[f"before/{leaf}"] - port[f"step1/{leaf}"]) / LR
        # A gradient read off two f32 params is exact to their ulp.
        floor = 2 * float(np.spacing(np.abs(port[f"before/{leaf}"]).max())) / LR
        scale = float(np.abs(want).max()) + 1e-12
        err = float(np.abs(got - want).max())
        assert err <= max(GRAD_TOL * scale, floor), (name, leaf, err, scale)


def test_an_expert_rank_holds_half_the_experts(tmp_path_factory):
    """Under ``moe_rules`` at ``{"expert": 2}`` each rank holds two of the
    four experts of every layer: its param bytes are the whole tree's less
    half the experts'."""
    tmp, refs, world, _ = _mesh_run("e2", tmp_path_factory)
    init = refs[SAVED][2]
    whole = sum(v.size * 4 for v in init.values())
    experts = sum(v.size * 4 for k, v in init.items() if "/experts/" in k)
    for rank in range(world):
        held = json.load(open(tmp / f"{SAVED}_rank{rank}.json"))["held"]
        assert held["params"] == whole - experts // 2
        assert held["moments"] == 0  # plain SGD keeps no moments


# -- checkpoints --------------------------------------------------------------------------


def test_expert_checkpoint_has_one_writer_a_shard_and_resumes_on_one_process(
        tmp_path_factory):
    import rocket_tpu_torch as rt
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.data.text import TokenDataset
    from rocket_tpu_torch.models import transformer as tt

    tmp, _, world, _ = _mesh_run("e2", tmp_path_factory)
    port = dict(np.load(tmp / f"{SAVED}_out.npz"))
    step_dir = tmp / "ckpt" / str(STEPS) / "model_0"
    assert sorted(os.listdir(step_dir)) == ["index.json"] + [f"shard_p{r}.npz"
                                                              for r in range(world)]
    files = {r: set(np.load(step_dir / f"shard_p{r}.npz").files) for r in range(world)}
    # Rank 1 writes its own expert shards only; rank 0 everything else.
    assert files[1] and all("experts" in key for key in files[1])
    assert any("experts" in key for key in files[0]) and not files[0] & files[1]
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp / "resume_one"))
    model = tt.TransformerLM(tt.TransformerConfig(**CASES[SAVED][0]))
    prepared = PreparedModule(model, {"params": model.init(device="cpu")})
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
                seen.update({"/".join(p): t.detach().numpy().copy()
                             for p, t in bridge._paths(prepared.state["params"])})

    losses = []

    class Loss(rt.Capsule):
        def launch(self, attrs=None):
            losses.append(float(attrs.step_metrics["loss"]))

    torch.set_num_threads(1)
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(_tokens(), T), batch_size=BATCH), Before(),
                            module, Loss(priority=10),
                            rt.Checkpointer(output_dir=str(tmp / "ckpt"), resume_from="latest",
                                            resume_capsules=False, save_every=1000)],
                           tag="train", repeats=1, progress=False)], runtime=runtime).launch()
    assert seen.pop("step") == STEPS
    assert sorted(seen) == sorted(k[7:] for k in port if k.startswith("before/"))
    for name, value in seen.items():
        np.testing.assert_array_equal(value, port[f"step{STEPS}/{name}"], err_msg=name)
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_one_process_checkpoint_resumes_at_two_expert_ranks(tmp_path_factory):
    tmp, _, world, extra = _mesh_run("e2", tmp_path_factory)
    resumed = dict(np.load(tmp / f"{RESUMED}_out.npz"))
    assert sorted(extra["one"]) == sorted(k[7:] for k in resumed if k.startswith("before/"))
    for name, value in extra["one"].items():
        np.testing.assert_array_equal(resumed[f"before/{name}"], value.detach().numpy(),
                                      err_msg=name)
    assert all(json.load(open(tmp / f"{RESUMED}_rank{r}.json"))["step"] == STEPS + 1
               for r in range(world))
    assert len(resumed["losses"]) == 1 and np.isfinite(resumed["losses"]).all()


# -- the refusals and the example ----------------------------------------------------------


def test_two_split_axes_refuse_naming_item_8_and_1f1b_refuses_moe():
    from rocket_tpu_torch.models import transformer as tt
    from rocket_tpu_torch.runtime import Runtime

    # The model and seq axes beside an expert axis are item 8's pairs: one
    # process cannot hold them; the pipe axis beside it still refuses, as
    # the reference's GPipe fails there and its 1F1B refuses the MoE.
    for other in ("model", "seq"):
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            Runtime(device="cpu", mesh_shape={"data": 1, other: 2, "expert": 2})
    with pytest.raises(NotImplementedError, match="item 8"):
        Runtime(device="cpu", mesh_shape={"data": 1, "pipe": 2, "expert": 2})
    msg = "pipeline_schedule='1f1b' does not carry the MoE aux-loss channel"
    with pytest.raises(ValueError, match=re.escape(msg)):
        tt.TransformerConfig(**dict(LM, scan_layers=True, pipeline_axis="pipe",
                                    pipeline_schedule="1f1b")).validate()
    with pytest.raises(ValueError, match=re.escape(msg)):
        jt.TransformerConfig(**dict(LM, scan_layers=True, pipeline_axis="pipe",
                                    pipeline_schedule="1f1b")).validate()


def test_launcher_runs_the_moe_example_over_an_expert_axis(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "MASTER_PORT": str(_free_port()), "TEXT_ROOT": str(tmp_path)}
    (tmp_path / "tinyshakespeare.txt").write_text(
        "".join(chr(97 + (i * 7 + i // 13) % 26) + (" " if i % 5 == 4 else "")
                for i in range(6000)))
    proc = subprocess.run(
        [sys.executable, "-m", "rocket_tpu_torch.launch", "-n", "2",
         str(Path(REPO) / "rocket_tpu_torch" / "examples" / "moe_lm.py"), "--expert-axis", "2",
         "--device", "cpu", "--epochs", "1", "--batch", "4", "--seq-len", "32", "--steps", "3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = re.search(r"moe_lm over 2 expert ranks x 1 data: loss ([\d.]+) -> ([\d.]+) "
                     r"\((\d+) steps\)", proc.stdout + proc.stderr)
    assert line is not None, proc.stdout[-2000:] + proc.stderr[-2000:]
    first, last, steps = float(line.group(1)), float(line.group(2)), int(line.group(3))
    assert steps == 3 and np.isfinite([first, last]).all()


def test_local_params_split_a_stacked_tree_on_the_expert_dim():
    """``bridge.local_params`` under ``moe_rules`` cuts a scanned JAX tree's
    stacked experts (L, E, ...) into each rank's E/2 experts of every layer,
    as the unstacked tree's (E, ...), and keeps every other leaf whole;
    ``gather_params``' concatenation of the ranks' chunks is the whole."""
    from rocket_tpu_torch import bridge
    from rocket_tpu_torch.parallel.sharding import moe_rules

    model = jt.TransformerLM(jt.TransformerConfig(**dict(LM, scan_layers=True)))
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(4))["params"])
    whole = bridge.params_from_jax(params)

    class _Rank:
        DATA_AXES = ("data",)
        mesh = {"data": 1, "expert": 2}

        def __init__(self, index):
            self.index = index

        def axis_index(self, axis):
            return self.index if axis == "expert" else 0

    parts = [dict(_flat(bridge.local_params(params, moe_rules(), _Rank(r)))) for r in (0, 1)]
    flat = {k: v for k, v in _flat(whole)}
    assert sorted(parts[0]) == sorted(parts[1]) == sorted(flat)
    for name, value in flat.items():
        if "/experts/" in name:
            assert parts[0][name].shape[0] == value.shape[0] // 2 == 2, name
            np.testing.assert_array_equal(np.concatenate([parts[0][name], parts[1][name]]),
                                          value, err_msg=name)
        else:
            np.testing.assert_array_equal(parts[0][name], value, err_msg=name)
