"""Ring attention (``parallel/ring_attention.py``) and the transformer over a
``seq`` mesh axis, against the reference on the virtual CPU mesh.

The port's ranks are spawned gloo processes (``test_torch_grad_sync.
run_ranks``), each holding its block of every sequence; inputs come from
numpy seeds and the weights from the reference's init through ``bridge``.

* ``ring_attention`` over two ranks, causal and not, at B=2, H=4, T=32,
  D=8 (as ``tests/test_attention.py:62``): the output within 2e-5 of the
  reference's ``ring_attention_sharded`` on a 2-device seq mesh and of its
  full attention, and the gradients of q, k and v (the hand-written
  backward ring, dK/dV sent home) within 1e-5 of the largest element of
  the reference's (``jax.grad`` through its ring).
* A 2-layer LM with ``attention_impl="ring"``, GPT-2 style (learned
  positions, the fused chunked loss) and Llama style positions (RoPE,
  RMSNorm, logits in the reference), trained two steps of SGD (lr 0.5) by
  the port's ``Module`` at ``{"data": 1, "seq": 2}`` and by the
  reference's at the same mesh (as ``tests/test_transformer.py:194,204``):
  losses within 1e-5 relative, every step-1 gradient leaf (``(p0 - p1) /
  lr``) within 1e-5 of its largest element (f32 in another order). One
  4-rank case at ``{"data": 2, "seq": 2}``.
* The loss across the shard edge: each rank's share of the step-1 loss
  (before the sum over the sequence group) equals the reference's
  per-position next-token NLL summed over the rank's positions, the last
  one predicting the next rank's first token, over ``B·(T−1)`` of the
  global batch (1e-5 relative).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import rocket_tpu as jrt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokens
from rocket_tpu.models import transformer as jt
from rocket_tpu.nn.attention import dot_product_attention
from rocket_tpu.parallel.ring_attention import ring_attention_sharded
from rocket_tpu.runtime.context import Runtime as JRuntime
from test_torch_grad_sync import run_ranks

T, BATCH, STEPS, LR = 32, 4, 2, 0.5
ATT = dict(b=2, h=4, t=32, d=8)
OUT_TOL, GRAD_TOL, LOSS_RTOL = 2e-5, 1e-5, 1e-5
BASE = dict(vocab_size=64, max_seq_len=T, dim=32, num_layers=2, num_heads=4, dropout=0.0,
            attention_impl="ring")
CASES = {
    "learned": (dict(BASE, loss_chunk=8), {"data": 1, "seq": 2}),
    "rope": (dict(BASE, pos_embedding="rope", norm="rmsnorm"), {"data": 1, "seq": 2}),
    "learned_d2s2": (dict(BASE, loss_chunk=8), {"data": 2, "seq": 2}),
}

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
from rocket_tpu_torch.parallel.ring_attention import ring_attention, seq_spec

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


def flat_of(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            res.update(flat_of(v, name))
        else:
            res[name] = v.detach().numpy().copy()
    return res


if cfg.get("attention"):
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape={"data": 1, "seq": 2})
    spec = seq_spec(runtime)
    data = np.load(os.path.join(out, "att.npz"))
    t = data["q"].shape[2] // 2
    res = {}
    for causal in (True, False):
        q, k, v = (torch.from_numpy(data[n][:, :, rank * t:(rank + 1) * t]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        w = torch.from_numpy(data["w"][:, :, rank * t:(rank + 1) * t])
        o = ring_attention(q, k, v, spec, causal)
        dq, dk, dv = torch.autograd.grad((o * w).sum(), (q, k, v))
        for name, value in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            res[f"{name}{int(causal)}"] = value.detach().numpy()
    np.savez(os.path.join(out, f"att_rank{rank}.npz"), **res)


class Grab(rt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.params = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(attrs.step_metrics["loss"]))
        self.params.append(flat_of(self.prepared.state["params"]))


for case in cfg["cases"]:
    runtime = rt.Runtime(device="cpu", seed=0, mesh_shape=case["mesh"],
                         project_dir=os.path.join(out, f"proj{rank}"))
    model = tt.TransformerLM(tt.TransformerConfig(**case["model"]))
    flat = dict(np.load(os.path.join(out, case["name"] + ".npz")))
    prepared = PreparedModule(model, {"params": bridge.params_from_jax(tree_of(flat))})
    runtime.models.add(model, prepared)
    shares = []
    loss = tt.next_token_loss()

    def objective(batch):
        value = loss(batch)
        shares.append(float(value))  # this rank's share, before the reduction
        return value

    module = rt.Module(model, [rt.Loss(objective),
                               rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"])])
    data = TokenDataset(np.load(os.path.join(out, "tokens.npy")), case["model"]["max_seq_len"])
    grab = Grab(prepared)
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=cfg["batch"]), module, grab],
                           tag="train", repeats=cfg["steps"], progress=False)],
                runtime=runtime).launch()
    snaps = {f"step{s + 1}/{k}": v for s, p in enumerate(grab.params) for k, v in p.items()}
    np.savez(os.path.join(out, f"{case['name']}_rank{rank}.npz"), losses=np.array(grab.losses),
             shares=np.array(shares), seq_index=np.array(runtime.axis_index("seq")),
             data_index=np.array(runtime.data_index), **snaps)
'''


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _tokens():
    return np.random.default_rng(3).integers(0, 64, size=T * BATCH * 4, dtype=np.int32)


def _attention_inputs():
    rng = np.random.default_rng(2)
    shape = (ATT["b"], ATT["h"], ATT["t"], ATT["d"])
    return {n: rng.normal(size=shape).astype(np.float32) for n in ("q", "k", "v", "w")}


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.params = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        self.params.append(dict(_flat(jax.tree.map(np.asarray, self.prepared.state["params"]))))


def _reference(name, tmp):
    model_cfg, mesh = CASES[name]
    model = jt.TransformerLM(jt.TransformerConfig(**model_cfg))
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(1))["params"])
    n = int(np.prod(list(mesh.values())))
    runtime = JRuntime(mesh_shape=mesh, devices=jax.devices()[:n], seed=0,
                       project_dir=str(tmp / f"jax_{name}"))
    prepared = JPrepared(model, {"params": jax.tree.map(jnp.asarray, params), "model_state": {},
                                 "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    module = jrt.Module(model, [jrt.Loss(jt.next_token_loss()),
                                jrt.Optimizer(joptim.sgd(), learning_rate=LR)])
    grab = _JGrab(prepared)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokens(_tokens(), T), batch_size=BATCH,
                                          device_cache=False), module, grab],
                             tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    return {"losses": grab.losses, "params": grab.params, "init": dict(_flat(params))}


def _group(tmp, names, world, attention=False):
    cases = [{"name": n, "model": CASES[n][0], "mesh": CASES[n][1]} for n in names]
    run_ranks(tmp, WORKER, world, {"cases": cases, "lr": LR, "batch": BATCH, "steps": STEPS,
                                   "attention": attention}, timeout=400)
    return {n: [dict(np.load(tmp / f"{n}_rank{r}.npz")) for r in range(world)] for n in names}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    refs = {}
    for name in CASES:
        refs[name] = _reference(name, tmp)
        np.savez(tmp / f"{name}.npz", **refs[name]["init"])
    np.save(tmp / "tokens.npy", _tokens())
    np.savez(tmp / "att.npz", **_attention_inputs())
    port = _group(tmp, ["learned", "rope"], 2, attention=True)
    att = [dict(np.load(tmp / f"att_rank{r}.npz")) for r in range(2)]
    tmp4 = tmp_path_factory.mktemp("ring4")
    np.save(tmp4 / "tokens.npy", _tokens())
    np.savez(tmp4 / "learned_d2s2.npz", **refs["learned_d2s2"]["init"])
    port.update(_group(tmp4, ["learned_d2s2"], 4))
    return port, refs, att


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(runs, causal):
    _, _, att = runs
    x = _attention_inputs()
    q, k, v = (jnp.asarray(x[n]) for n in ("q", "k", "v"))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    spec = NamedSharding(mesh, P(None, None, "seq", None))
    ringed = ring_attention_sharded(*(jax.device_put(a, spec) for a in (q, k, v)), mesh=mesh,
                                    seq_axis="seq", data_axis=None, causal=causal)
    full = dot_product_attention(q, k, v, causal=causal)
    got = np.concatenate([a[f"o{int(causal)}"] for a in att], axis=2)
    np.testing.assert_allclose(got, np.asarray(ringed), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(full), rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_gradients_match_the_reference(runs, causal):
    _, _, att = runs
    x = _attention_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    spec = NamedSharding(mesh, P(None, None, "seq", None))

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh=mesh, seq_axis="seq", data_axis=None,
                                     causal=causal)
        return (out * jnp.asarray(x["w"])).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jax.device_put(jnp.asarray(x[n]), spec)
                                               for n in ("q", "k", "v")))
    for name, w in zip(("dq", "dk", "dv"), want):
        got = np.concatenate([a[f"{name}{int(causal)}"] for a in att], axis=2)
        w = np.asarray(w)
        assert float(np.abs(got - w).max()) <= GRAD_TOL * float(np.abs(w).max()), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_lm_losses_match_the_reference(runs, name):
    port, refs, _ = runs
    for rank in port[name]:
        np.testing.assert_allclose(rank["losses"], refs[name]["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_lm_step1_gradients_of_every_leaf_match_the_reference(runs, name):
    port, refs, _ = runs
    init, ref1 = refs[name]["init"], refs[name]["params"][0]
    for rank in port[name]:
        for leaf, p0 in init.items():
            got = (p0 - rank[f"step1/{leaf}"]) / LR
            want = (p0 - ref1[leaf]) / LR
            floor = 2 * float(np.spacing(np.abs(p0).max())) / LR
            err = float(np.abs(got - want).max())
            assert err <= max(GRAD_TOL * float(np.abs(want).max()), floor), (name, leaf, err)


def test_ring_loss_crosses_the_shard_edge(runs):
    """Each rank's step-1 share is the reference's per-position NLL summed
    over its positions (its last one predicting the next rank's first
    token) over B·(T−1) of the global batch."""
    port, refs, _ = runs
    model_cfg, _ = CASES["learned"]
    model = jt.TransformerLM(jt.TransformerConfig(**dict(model_cfg, attention_impl="xla")))
    params = jax.tree.map(jnp.asarray, refs["learned"]["init"])
    tree: dict = {}
    for name, value in params.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    tokens = jnp.asarray(_tokens()[:BATCH * T].reshape(BATCH, T))
    out, _ = model.apply({"params": tree, "state": {}}, {"tokens": tokens}, mode="eval")
    nll = np.asarray(optax.softmax_cross_entropy_with_integer_labels(
        out["logits"][:, :-1].astype(jnp.float32), tokens[:, 1:]))      # (B, T-1)
    half = T // 2
    want = [nll[:, :half].sum() / nll.size, nll[:, half:].sum() / nll.size]
    for rank in port["learned"]:
        got = float(rank["shares"][0])
        np.testing.assert_allclose(got, want[int(rank["seq_index"])], rtol=LOSS_RTOL)
    # The edge term is in rank 0's share: without it the share is smaller.
    assert want[0] - nll[:, :half - 1].sum() / nll.size > 1e-3


def test_launcher_runs_the_long_context_example(tmp_path):
    """``python -m rocket_tpu_torch.launch -n 2`` on
    ``examples/long_context.py`` (its flags, at a size the CPU runs in
    seconds: 128 tokens over two seq ranks, dim 32, one layer, batch 8)
    on the CPU: the loss falls."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_grad_sync import REPO, _free_port

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "MASTER_PORT": str(_free_port())}
    proc = subprocess.run(
        [sys.executable, "-m", "rocket_tpu_torch.launch", "-n", "2",
         str(Path(REPO) / "rocket_tpu_torch" / "examples" / "long_context.py"),
         "--seq-len", "128", "--dim", "32", "--layers", "1", "--batch", "8", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    losses = [float(x.split("loss=")[1].split(",")[0]) for x in text.replace("\r", "\n").split("\n")
              if "loss=" in x]
    assert losses and losses[-1] < losses[0], losses[:3] + losses[-3:]
