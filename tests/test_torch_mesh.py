"""The flash mesh seams and every mesh the reference runs beyond one split
axis (ROADMAP Queue A 6 items 6 and 8), against the reference on the
virtual CPU mesh.

The port's ranks are spawned gloo processes (``test_torch_grad_sync.
run_ranks``), one group a mesh running its cases in turn, one intra-op
thread each; weights come from the reference's init through ``bridge``,
tokens and images from numpy seeds. The reference runs its ``Module`` on
its own mesh of virtual devices (the conftest's eight), two SGD steps at lr
0.5, and the port's ``Module`` the same steps on its ranks:

* the seams (``flash_attention_qkv_sharded``, ``flash_fused_sharded``,
  ``flash_bthd_sharded``) on each rank's local shard, concatenated, against
  the reference's ``shard_map`` calls (interpret mode) within 2e-5, with
  no process group; ``shardable_axes`` over a table of meshes;
* ``{"seq": 2}`` with ``"xla"`` (GPT-2 and Llama style), and with
  ``"flash"`` (the kernels' plain versions here) held to the reference's
  ``"xla"`` run: each attention gathers the sequence;
* ``{"model": 4}`` with 6 heads (the attention runs the replicated program
  over the model group), with an MLP width and heads that do not divide
  (held to the reference's plain program on the same mesh: the reference
  cannot place that model's kernels over four ranks), and with a T that
  does not divide (the whole model's replicated program);
* ViT under ``gpt2_tp_rules`` at ``{"model": 2}`` (no TP path: its 13
  model shards gathered at step entry);
* the pairs ``{"model": 2, "seq": 2}`` (ring attention), ``{"model": 2,
  "expert": 2}`` (``combine_rules(moe_rules(), gpt2_tp_rules())``),
  ``{"seq": 2, "expert": 2}`` (ring, ``moe_rules``) and ``{"model": 2,
  "pipe": 2}`` under ``pipeline_over(gpt2_tp_rules())`` with 1F1B against
  the reference's 1F1B; the port's GPipe at that mesh is held to the
  port's 1F1B (the reference's GPipe does not trace on the installed JAX:
  "psum is a variant->invariant collective");
* losses within 1e-5 relative and every step-1 gradient leaf (``(p0 -
  p1) / lr``, gathered whole) within 2e-5 of its largest element (1e-4 for
  the MoE pairs, ``test_torch_expert``'s bound); the TP cases cross an f32
  wire (``ROCKET_TPU_OVERLAP_WIRE=fp32``);
* a dp x tp x pp checkpoint (one writer per stage and model shard)
  resumes on one process bitwise, and a one-process checkpoint resumes at
  dp x tp x pp bitwise;
* ``{"seq", "pipe"}`` and ``{"pipe", "expert"}`` refuse, naming the
  reference's own failure.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import rocket_tpu as jrt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.datasets import ArrayDataset as JArrayDataset
from rocket_tpu.data.text import TokenDataset as JTokens
from rocket_tpu.models import transformer as jt
from rocket_tpu.models.vit import ViT as JViT
from rocket_tpu.parallel import sharding as js
from rocket_tpu.runtime.context import Runtime as JRuntime
from test_torch_grad_sync import run_ranks

T, BATCH, STEPS, LR = 16, 4, 2, 0.5
LOSS_RTOL, GRAD_TOL, MOE_GRAD_TOL = 1e-5, 2e-5, 1e-4
FP32 = {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}
GPT2 = dict(vocab_size=64, max_seq_len=T, dim=32, num_layers=2, num_heads=4, dropout=0.0)
LLAMA = dict(GPT2, num_kv_heads=2, pos_embedding="rope", norm="rmsnorm", mlp="swiglu",
             tied_embeddings=False)
MOE = dict(GPT2, num_experts=4, expert_top_k=2, expert_dispatch="dropless")
PIPE = dict(GPT2, scan_layers=True, pipeline_axis="pipe", pipeline_microbatches=2)
VIT = dict(image_size=8, patch_size=4, dim=48, depth=2, num_heads=3)
#: name -> (family, reference config, the port's extra config, environment,
#: mesh, rule). The port's config is the reference's with the extra keys.
CASES = {
    "s2_xla": ("lm", dict(GPT2, attention_impl="xla"), {}, {}, "s2", None),
    "s2_flash": ("lm", dict(GPT2, attention_impl="xla"), {"attention_impl": "flash"}, {}, "s2",
                 None),
    "s2_llama": ("lm", dict(LLAMA, attention_impl="xla"), {}, {}, "s2", None),
    "m4_heads6": ("lm", dict(GPT2, dim=48, num_heads=6, loss_chunk=8), {}, FP32, "m4", "tp"),
    "m4_mlp": ("lm", dict(GPT2, dim=30, num_heads=6, mlp_ratio=3), {}, FP32, "m4", "tp"),
    "m4_t14": ("lm", dict(GPT2, max_seq_len=14), {}, FP32, "m4", "tp"),
    "vit_m2": ("vit", VIT, {}, FP32, "m2", "tp"),
    "m2s2": ("lm", dict(GPT2, attention_impl="ring"), {}, FP32, "m2s2", "tp"),
    "m2e2": ("lm", dict(MOE, loss_chunk=8), {}, FP32, "m2e2", "tp_moe"),
    "s2e2": ("lm", dict(MOE, expert_dispatch="einsum", attention_impl="ring"), {}, {}, "s2e2",
             "moe"),
    "m2p2_1f1b": ("lm", dict(PIPE, pipeline_schedule="1f1b"), {}, FP32, "m2p2", "pp_tp"),
    "m2p2_gpipe": ("lm", dict(PIPE, pipeline_schedule="1f1b"), {"pipeline_schedule": "gpipe"},
                   FP32, "m2p2", "pp_tp"),
}
MESHES = {"s2": {"data": 1, "seq": 2}, "m4": {"data": 1, "model": 4},
          "m2": {"data": 1, "model": 2}, "m2s2": {"data": 1, "model": 2, "seq": 2},
          "m2e2": {"data": 1, "model": 2, "expert": 2},
          "s2e2": {"data": 1, "seq": 2, "expert": 2},
          "m2p2": {"data": 1, "model": 2, "pipe": 2}}
#: The cases held to the port's own run at the same mesh instead of the
#: reference's (its program does not trace there).
PORT_REFERENCE = {"m2p2_gpipe": "m2p2_1f1b"}
#: The cases whose reference runs without the rule: the reference cannot
#: place a (30, 30) kernel over 4 model ranks, so the MLP whose width (90)
#: does not divide them is held to its plain program on the same mesh.
REFERENCE_UNSHARDED = ("m4_mlp",)
#: The dp x tp x pp case whose checkpoint one process resumes, and the case
#: that resumes a one-process checkpoint at dp x tp x pp.
SAVED, RESUMED = "m2p2_1f1b", "m2p2_resumed"

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch import bridge, optim
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.examples.cifar_resnet import cross_entropy
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.models.vit import ViT
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.parallel import sharding

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])
RULES = {"tp": sharding.gpt2_tp_rules,
         "tp_moe": lambda: sharding.combine_rules(sharding.moe_rules(), sharding.gpt2_tp_rules()),
         "moe": sharding.moe_rules,
         "pp_tp": lambda: sharding.pipeline_over(sharding.gpt2_tp_rules())}


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
        self.losses, self.params = [], []

    def launch(self, attrs=None):
        if self.before:
            if not self.params:
                self.params.append(bridge.gather_params(self.prepared, self.rt))
            return
        self.losses.append(float(attrs.step_metrics["loss"]))
        self.params.append(bridge.gather_params(self.prepared, self.rt))


for case in cfg["cases"]:
    for key in ("ROCKET_TPU_OVERLAP", "ROCKET_TPU_OVERLAP_WIRE"):
        os.environ.pop(key, None)
    os.environ.update(case["env"])
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=cfg["mesh"],
                         project_dir=os.path.join(out, f"proj{rank}"))
    flat = dict(np.load(os.path.join(out, case["init"] + ".npz")))
    if case["family"] == "vit":
        model = ViT(**case["model"])
        data = ArrayDataset(np.load(os.path.join(out, "images.npy")),
                            np.load(os.path.join(out, "labels.npy")))
        loss = rt.Loss(cross_entropy)
    else:
        model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
        data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), case["model"]["max_seq_len"])
        loss = rt.Loss(tt.next_token_loss())
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(tree_of(flat))})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [loss, rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"])],
                       param_sharding=RULES[case["rule"]]() if case["rule"] else None)
    grab, before = Grab(prepared, runtime), Grab(prepared, runtime, before=True)
    caps = [rt.Dataset(data, batch_size=cfg["batch"]), before, module, grab]
    steps = cfg["steps"]
    if case.get("save"):
        caps.append(rt.Checkpointer(output_dir=os.path.join(out, "ckpt"), save_every=steps))
    if case.get("resume"):
        steps = 1
        caps.append(rt.Checkpointer(output_dir=case["resume"], save_every=1000,
                                    resume_from="latest", resume_capsules=False))
    coll.reset_stats()
    rt.Launcher([rt.Looper(caps, tag="train", repeats=steps, progress=False)],
                runtime=runtime).launch()
    json.dump({"step": prepared.state["step"], "replicated": coll.STATS["replicated_layers"]},
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


def _port_flat(flat):
    """A reference tree's flat names as the port's (``blocks_stacked``
    unstacked into ``blocks/<i>``)."""
    from rocket_tpu_torch import bridge

    return {k: np.asarray(v) for k, v in _flat(bridge.params_from_jax(_tree(flat)))}


def _tokens():
    return np.random.default_rng(3).integers(0, 64, size=T * BATCH * 6, dtype=np.int32)


def _images():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(BATCH * 3, VIT["image_size"], VIT["image_size"], 3))
            .astype(np.float32), rng.integers(0, 10, BATCH * 3).astype(np.int32))


def _jce(batch):
    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"],
                                                           batch["label"]).mean()


def _jrule(name):
    return {None: None, "tp": js.gpt2_tp_rules,
            "tp_moe": lambda: js.combine_rules(js.moe_rules(), js.gpt2_tp_rules()),
            "moe": js.moe_rules,
            "pp_tp": lambda: js.pipeline_over(js.gpt2_tp_rules())}[name]


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.params = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        self.params.append(_port_flat(dict(_flat(jax.tree.map(np.asarray,
                                                              self.prepared.state["params"])))))


def _model(name):
    family, model_cfg = CASES[name][:2]
    return JViT(**model_cfg) if family == "vit" else jt.TransformerLM(
        jt.TransformerConfig(**model_cfg))


def _init(name):
    """The reference's initial params of ``name`` (flat, numpy)."""
    return dict(_flat(jax.tree.map(np.asarray,
                                   jax.jit(_model(name).init)(jax.random.key(1))["params"])))


#: The reference's runs by configuration (two cases may share one).
_REFERENCES: dict = {}


def _reference(name, tmp, monkeypatch, init):
    """The reference's two steps of ``name`` on its mesh from ``init``:
    (losses, the params after each step), every tree in the port's names;
    a case held to the port's own run has none."""
    family, model_cfg, _, env, mesh, rule = CASES[name]
    if name in PORT_REFERENCE:
        return None, None
    key = json.dumps([family, model_cfg, env, mesh, rule, name in REFERENCE_UNSHARDED],
                     sort_keys=True)
    if key in _REFERENCES:
        return _REFERENCES[key]
    for k in ("ROCKET_TPU_OVERLAP", "ROCKET_TPU_OVERLAP_WIRE"):
        monkeypatch.delenv(k, raising=False)
    for k, value in env.items():
        monkeypatch.setenv(k, value)
    model = _model(name)
    shape = MESHES[mesh]
    runtime = JRuntime(mesh_shape=shape, devices=jax.devices()[:int(np.prod(list(shape.values())))],
                       seed=0, project_dir=str(tmp / f"jax_{name}"))
    params = jax.tree.map(jnp.asarray, _tree(init))
    prepared = JPrepared(model, {"params": params, "model_state": {},
                                 "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    rule_fn = None if name in REFERENCE_UNSHARDED else _jrule(rule)
    if family == "vit":
        loss, data = jrt.Loss(_jce), JArrayDataset(*_images())
    else:
        loss, data = jrt.Loss(jt.next_token_loss()), JTokens(_tokens(), model_cfg["max_seq_len"])
    module = jrt.Module(model, [loss, jrt.Optimizer(joptim.sgd(), learning_rate=LR)],
                        param_sharding=rule_fn() if rule_fn else None)
    grab = _JGrab(prepared)
    jrt.Launcher([jrt.Looper([jrt.Dataset(data, batch_size=BATCH, device_cache=False), module,
                              grab], tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    _REFERENCES[key] = grab.losses, grab.params
    return _REFERENCES[key]


def _one_process(tmp, resume=None):
    """Two SGD steps of ``SAVED``'s model unpipelined on one port process,
    saved (the checkpoint the dp x tp x pp ranks resume); with ``resume``
    one step resumed from that checkpoint instead. Returns the params
    before the first step and after the last, by port path."""
    import rocket_tpu_torch as rt
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import PreparedModule
    from rocket_tpu_torch.data.text import TokenDataset
    from rocket_tpu_torch.models import transformer as tt

    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp / "one"))
    cfg = dict(CASES[SAVED][1], pipeline_axis=None, pipeline_microbatches=None,
               pipeline_schedule="gpipe")
    model = tt.TransformerLM(tt.TransformerConfig(**cfg))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(
        _tree(dict(np.load(tmp / f"{SAVED}.npz"))))})
    runtime.models.add(model, prepared)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(optim.sgd(), learning_rate=LR)])
    seen = {}

    class Before(rt.Capsule):
        def __init__(self):
            super().__init__(priority=2000)

        def launch(self, attrs=None):
            if not seen:
                seen.update(bridge.gather_params(prepared, runtime))
                seen["step"] = prepared.state["step"]

    ckpt = (rt.Checkpointer(output_dir=str(tmp / "one_ckpt"), save_every=STEPS) if resume is None
            else rt.Checkpointer(output_dir=str(resume), save_every=1000, resume_from="latest",
                                 resume_capsules=False))
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(_tokens(), T), batch_size=BATCH), Before(),
                            module, ckpt], tag="train", repeats=STEPS if resume is None else 1,
                           progress=False)], runtime=runtime).launch()
    step = seen.pop("step")
    return step, {k: v.numpy() for k, v in seen.items()}, {
        k: v.numpy() for k, v in bridge.gather_params(prepared, runtime).items()}


_RUNS: dict = {}


def _mesh_run(mesh, tmp_path_factory, monkeypatch_factory):
    """Every case of ``mesh`` on its spawned group, and the reference's runs
    (in this process while the ranks run)."""
    if mesh in _RUNS:
        return _RUNS[mesh]
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp(f"mesh_{mesh}")
    names = [n for n, c in CASES.items() if c[4] == mesh]
    inits = {name: _init(name) for name in names}
    for name in names:
        np.savez(tmp / f"{name}.npz", **inits[name])
    np.save(tmp / "tokens.npy", _tokens())
    images, labels = _images()
    np.save(tmp / "images.npy", images)
    np.save(tmp / "labels.npy", labels)
    cases = []
    for name in names:
        family, model_cfg, extra, env, _, rule = CASES[name]
        cases.append({"name": name, "family": family, "model": dict(model_cfg, **extra),
                      "env": env, "rule": rule, "init": name, "save": name == SAVED})
    extra = {}
    if mesh == "m2p2":
        extra["one"] = _one_process(tmp)
        cases.append(dict(cases[0], name=RESUMED, save=False, resume=str(tmp / "one_ckpt")))
    world = int(np.prod(list(MESHES[mesh].values())))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, tmp, WORKER, world,
                            {"mesh": MESHES[mesh], "cases": cases, "lr": LR, "batch": BATCH,
                             "steps": STEPS}, timeout=400)
        refs = {}
        for name in names:
            with monkeypatch_factory() as mp:
                refs[name] = (*_reference(name, tmp, mp, inits[name]), inits[name])
        ranks.result()
    _RUNS[mesh] = (tmp, refs, world, extra)
    return _RUNS[mesh]


@pytest.fixture(scope="module")
def monkeypatch_factory():
    return pytest.MonkeyPatch.context


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, tmp_path_factory, monkeypatch_factory):
    return request.param, *_mesh_run(request.param, tmp_path_factory, monkeypatch_factory)


def _grad_tol(name):
    return MOE_GRAD_TOL if "e2" in name else GRAD_TOL


def _step1(port, leaf):
    return (port[f"before/{leaf}"] - port[f"step1/{leaf}"]) / LR


def test_losses_and_step1_gradients_match_the_reference(mesh_run):
    """Both losses and every step-1 gradient leaf against the reference's
    run at the same mesh (the port's GPipe against the port's 1F1B)."""
    mesh, tmp, refs, _, _ = mesh_run
    for name in [n for n, c in CASES.items() if c[4] == mesh]:
        port = dict(np.load(tmp / f"{name}_out.npz"))
        if name in PORT_REFERENCE:
            twin = dict(np.load(tmp / f"{PORT_REFERENCE[name]}_out.npz"))
            losses = twin["losses"]
            want_of = {k[7:]: _step1(twin, k[7:]) for k in twin if k.startswith("before/")}
            init = {k[7:]: twin[k] for k in twin if k.startswith("before/")}
        else:
            losses, ref_params, init = refs[name]
            init = _port_flat(init)
            want_of = {leaf: (p0 - ref_params[0][leaf]) / LR for leaf, p0 in init.items()}
        np.testing.assert_allclose(port["losses"], losses, rtol=LOSS_RTOL, err_msg=name)
        assert sorted(want_of) == sorted(k[7:] for k in port if k.startswith("before/")), name
        for leaf, want in want_of.items():
            got = _step1(port, leaf)
            scale = float(np.abs(want).max()) + 1e-12
            err = float(np.abs(got - want).max())
            # A gradient read off two f32 params is exact to their ulp.
            floor = 2 * float(np.spacing(np.abs(init[leaf]).max())) / LR
            assert err <= max(_grad_tol(name) * scale, floor), (name, leaf, err, scale)


def test_replicated_layers_are_counted_where_the_model_axis_runs_replicated(mesh_run):
    """Every case over a model axis whose widths, sequence or model have no
    TP path counts the forwards it ran replicated; the others count none."""
    mesh, tmp, _, world, _ = mesh_run
    for name in [n for n, c in CASES.items() if c[4] == mesh]:
        counts = [json.load(open(tmp / f"{name}_rank{r}.json"))["replicated"]
                  for r in range(world)]
        replicated = name in ("m4_heads6", "m4_mlp", "m4_t14", "vit_m2", "m2s2", "m2p2_1f1b",
                              "m2p2_gpipe")
        assert all(c > 0 for c in counts) if replicated else counts == [0] * world, (name,
                                                                                    counts)


def test_dp_tp_pp_checkpoint_resumes_on_one_process_and_back(tmp_path_factory,
                                                            monkeypatch_factory):
    tmp, _, world, extra = _mesh_run("m2p2", tmp_path_factory, monkeypatch_factory)
    step_dir = tmp / "ckpt" / str(STEPS) / "model_0"
    index = json.load(open(step_dir / "index.json"))
    # One writer per (stage, model shard): every rank wrote a file, and a
    # layer's model-sharded kernel has one chunk per model rank of its stage.
    assert sorted(f for f in os.listdir(step_dir) if f.startswith("shard_")) == [
        f"shard_p{r}.npz" for r in range(world)]
    files = {c["file"] for c in index["params/blocks/1/attn/qkv/w"]["chunks"]}
    assert len(files) == 2, files
    trained = dict(np.load(tmp / f"{SAVED}_out.npz"))
    step, before, _ = _one_process(tmp, resume=tmp / "ckpt")
    assert step == STEPS
    assert sorted(before) == sorted(k[6:] for k in trained if k.startswith(f"step{STEPS}/"))
    for name, value in before.items():
        np.testing.assert_array_equal(value, trained[f"step{STEPS}/{name}"], err_msg=name)
    resumed = dict(np.load(tmp / f"{RESUMED}_out.npz"))
    assert all(json.load(open(tmp / f"{RESUMED}_rank{r}.json"))["step"] == STEPS + 1
               for r in range(world))
    _, _, one_after = extra["one"]
    for name, value in one_after.items():
        np.testing.assert_array_equal(resumed[f"before/{name}"], value, err_msg=name)


# -- the seams -------------------------------------------------------------------------------


@pytest.mark.parametrize("shape,b,h,want", [
    ({"data": 2, "model": 2}, 4, 4, (("data",), "model")),
    ({"data": 2, "model": 4}, 4, 6, (("data",), None)),     # 6 heads over 4: dropped
    ({"data": 4, "model": 2}, 6, 4, (None, "model")),       # 6 rows over 4: dropped
    ({"data": 1, "model": 2}, 4, 4, (None, "model")),       # an axis of size 1: dropped
    ({"data": 8}, 8, 3, (("data",), None)),                 # no model axis
    ({"data": 2, "seq": 2}, 4, 4, (("data",), None)),
])
def test_shardable_axes_drops_as_the_reference(shape, b, h, want):
    from rocket_tpu.ops.flash_attention import shardable_axes as jshardable
    from rocket_tpu_torch.ops.flash_attention import shardable_axes

    n = int(np.prod(list(shape.values())))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))
    assert jshardable(mesh, b, h) == want
    assert shardable_axes(shape, b, h) == want


SEAM = dict(b=4, h=4, h_kv=2, t=128, d=32)
SEAM_MESHES = {"d2m2": {"data": 2, "model": 2}, "d4": {"data": 4}, "m4": {"data": 1, "model": 4}}


def _seam_inputs():
    rng = np.random.default_rng(5)
    s = SEAM
    q = rng.normal(size=(s["b"], s["t"], s["h"] * s["d"])).astype(np.float32)
    kv = rng.normal(size=(2, s["b"], s["t"], s["h_kv"] * s["d"])).astype(np.float32)
    fused = rng.normal(size=(s["b"], s["t"], 3 * s["h"] * s["d"])).astype(np.float32)
    return q, kv[0], kv[1], fused


def _cut(x, mesh, bi, hi, heads, feat_axis=-1):
    """Rank (``bi``, ``hi``)'s shard of ``x``: its stripe of dim 0 and, on a
    usable head axis, its contiguous cut of the features."""
    nb = mesh.get("data", 1)
    x = np.split(x, nb, axis=0)[bi]
    m = mesh.get("model", 1)
    if m > 1 and heads % m == 0:
        x = np.split(x, m, axis=feat_axis)[hi]
    return x


@pytest.mark.parametrize("mesh_name", sorted(SEAM_MESHES))
def test_the_seams_on_local_shards_match_the_reference_sharded_calls(mesh_name):
    """Each rank's local output, concatenated over the batch and head axes,
    against the reference's shard_map seam on the whole operand."""
    from rocket_tpu.ops import flash_attention as jfa
    from rocket_tpu.ops import flash_native as jfn
    from rocket_tpu_torch.ops import flash_attention as fa
    from rocket_tpu_torch.ops import flash_native as fn

    shape = SEAM_MESHES[mesh_name]
    n = int(np.prod(list(shape.values())))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))
    s = SEAM
    q, k, v, fused = _seam_inputs()
    want_bthd = np.asarray(jfn.flash_bthd_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s["h"], s["h_kv"], mesh=mesh,
        interpret=True))
    want_fused = np.asarray(jfn.flash_fused_sharded(jnp.asarray(fused), s["h"], mesh=mesh,
                                                    interpret=True))
    qkv = np.stack([q.reshape(s["b"], s["t"], s["h"], s["d"]).transpose(0, 2, 1, 3)] * 3)
    qkv[1] *= 0.5
    want_qkv = np.asarray(jfa.flash_attention_qkv_sharded(jnp.asarray(qkv), mesh=mesh,
                                                          interpret=True))
    nb, m = shape.get("data", 1), shape.get("model", 1)
    # The head axis is used where it divides Hq (and, for bthd, Hkv too).
    split_bthd = m > 1 and s["h"] % m == 0 and s["h_kv"] % m == 0
    split_heads = m > 1 and s["h"] % m == 0
    got_bthd, got_fused, got_qkv = [], [], []
    for bi in range(nb):
        row_b, row_f, row_q = [], [], []
        for hi in range(m if split_bthd else 1):
            args = [torch.from_numpy(np.ascontiguousarray(
                _cut(x, shape, bi, hi, s["h"] if split_bthd else 1))) for x in (q, k, v)]
            row_b.append(fn.flash_bthd_sharded(*args, s["h"], s["h_kv"], mesh=shape).numpy())
        for hi in range(m if split_heads else 1):
            segs = np.split(fused, 3, axis=-1)
            local = np.concatenate([_cut(seg, shape, bi, hi, s["h"] if split_heads else 1)
                                    for seg in segs], axis=-1)
            row_f.append(fn.flash_fused_sharded(torch.from_numpy(np.ascontiguousarray(local)),
                                                s["h"], mesh=shape).numpy())
            local_qkv = np.split(qkv, nb, axis=1)[bi]
            if split_heads:
                local_qkv = np.split(local_qkv, m, axis=2)[hi]
            row_q.append(fa.flash_attention_qkv_sharded(
                torch.from_numpy(np.ascontiguousarray(local_qkv)), mesh=shape).numpy())
        got_bthd.append(np.concatenate(row_b, axis=-1))
        got_fused.append(np.concatenate(row_f, axis=-1))
        got_qkv.append(np.concatenate(row_q, axis=1))
    np.testing.assert_allclose(np.concatenate(got_bthd, 0), want_bthd, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.concatenate(got_fused, 0), want_fused, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.concatenate(got_qkv, 0), want_qkv, atol=2e-5, rtol=2e-5)


def test_in_manual_axes_is_true_inside_a_manual_axes_block_only():
    from rocket_tpu_torch.ops.flash_attention import in_manual_axes, manual_axes

    assert not in_manual_axes(("pipe",))
    with manual_axes(("pipe",)):
        assert in_manual_axes(("data", "pipe")) and not in_manual_axes(("model",))
    assert not in_manual_axes(("pipe",))


# -- the refusals ------------------------------------------------------------------------------


@pytest.mark.parametrize("pair,words", [
    (("seq", "pipe"), "should match the mesh passed to shard_map"),
    (("pipe", "expert"), "psum is a variant->invariant collective"),
])
def test_the_two_remaining_pairs_refuse_naming_the_reference_failure(pair, words):
    from rocket_tpu_torch.runtime import Runtime

    with pytest.raises(NotImplementedError, match="item 8") as err:
        Runtime(device="cpu", mesh_shape={"data": 1, pair[0]: 2, pair[1]: 2})
    assert words in str(err.value)
