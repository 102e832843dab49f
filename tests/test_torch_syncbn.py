"""Sync-BN: a ResNet with BatchNorm trained by two processes (``{"data":
2}``) against the reference's two-device run on the virtual CPU mesh.

The port's ranks are spawned gloo processes (``test_torch_grad_sync.
run_ranks``); each streams its stripe of every global batch of 8 and its
BatchNorm layers take the statistics of the global batch
(``nn/layers.SyncBnAct``: one (C, 2) all-reduce in the forward and one in
the backward). The model is a two-stage basic-block ResNet with the CIFAR
stem (6 BatchNorm layers), its params and running statistics made by the
reference and carried over by ``bridge``; inputs come from a numpy seed.
Two steps of plain SGD (lr 0.05: at 0.2 this tiny ResNet's loss rises on
its second step, 2.47 to 3.59, which amplifies f32 reassociation past the
bound below in one process already), so the step-1 gradient of every
leaf is ``(p0 - p1) / lr``.

Tolerances, float32: losses within 1e-5 relative; every step-1 gradient
leaf within 1e-4 of its largest element (convolutions and the global
moments summed in another order, the moments over two ranks' partial
sums); the running statistics and params after each step within ``2e-4 *
(1 + |want|)`` (``tests/test_torch_cifar.py``'s bound for a ResNet's
steps); the running statistics bitwise equal across the ranks.
Forcing the fused kernel (``ROCKET_TPU_FUSED_CONV=pallas``) changes
nothing over two ranks: the path is the sync one (no ``fused_bn_act``
call), as the reference's gate keeps multi-device traces off the kernel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import rocket_tpu as jrt
from rocket_tpu import optim as joptim
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.datasets import ArrayDataset as JArrayDataset
from rocket_tpu.models import resnet as jr
from rocket_tpu.runtime.context import Runtime as JRuntime
from test_torch_grad_sync import run_ranks

import optax

STEPS, BATCH, LR = 2, 8, 0.05
LOSS_RTOL, GRAD_TOL, TREE_TOL = 1e-5, 1e-4, 2e-4

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.bridge import variables_from_jax
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.examples import cifar_resnet
from rocket_tpu_torch.models import resnet as tr
from rocket_tpu_torch.nn import layers
from rocket_tpu_torch.ops import fused_conv

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
rank = int(os.environ["RANK"])
data = np.load(os.path.join(out, "data.npz"))
flat = dict(np.load(os.path.join(out, "start.npz")))
calls = [0]
kernel = fused_conv.fused_bn_act


def counted(*args, **kw):
    calls[0] += 1
    return kernel(*args, **kw)


fused_conv.fused_bn_act = counted


def tree_of(flat, prefix):
    tree = {}
    for name, value in flat.items():
        if not name.startswith(prefix + "/"):
            continue
        node = tree
        *parents, last = name[len(prefix) + 1:].split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def flat_of(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_of(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.detach().numpy().copy()
    return out


class Grab(rt.Capsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.losses, self.snaps, self.reduces = module, [], [], []

    def launch(self, attrs=None):
        self.losses.append(float(attrs.step_metrics["loss"]))
        self.reduces.append(layers.SYNC_BN_STATS["all_reduces"])
        state = self.module.state
        self.snaps.append({**flat_of(state["params"], "params"),
                           **flat_of(state["model_state"], "state")})


for case in cfg["cases"]:
    os.environ.pop("ROCKET_TPU_FUSED_CONV", None)
    os.environ.update(case["env"])
    layers.SYNC_BN_STATS["all_reduces"] = 0
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=os.path.join(out, f"p{rank}"))
    model = tr.ResNet("basic", [1, 1], num_classes=10, stem="cifar")
    start = variables_from_jax({"params": tree_of(flat, "params"),
                                "state": tree_of(flat, "state")})
    runtime.models.add(model, PreparedModule(model, {"params": start["params"],
                                                     "model_state": start["state"]}))
    module = rt.Module(model, [rt.Loss(cifar_resnet.cross_entropy),
                               rt.Optimizer(optim.sgd(), learning_rate=cfg["lr"])])
    grab = Grab(module)
    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(data["images"], data["labels"]),
                                       batch_size=cfg["batch"]), module, grab],
                           tag="train", repeats=cfg["steps"], progress=False)],
                runtime=runtime).launch()
    snaps = {f"step{s + 1}/{k}": v for s, snap in enumerate(grab.snaps) for k, v in snap.items()}
    np.savez(os.path.join(out, f"{case['name']}_rank{rank}.npz"), losses=np.array(grab.losses),
             reduces=np.array(grab.reduces), kernel_calls=np.array(calls[0]), **snaps)
'''


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(BATCH * STEPS, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, BATCH * STEPS).astype(np.int32))


def _start():
    """The reference's init, its 1-D leaves (BatchNorm scale, bias and
    statistics) perturbed from a seed so the statistics are not trivial."""
    model = jr.ResNet("basic", [1, 1], num_classes=10, stem="cifar")
    variables = jax.jit(model.init)(jax.random.key(1))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, {"params": variables["params"],
                                     "state": variables["state"]})
    return jax.tree.map(lambda a: a + 0.05 * rng.uniform(size=a.shape).astype(np.float32)
                        if a.ndim == 1 else a, tree)


class _JGrab(jrt.Capsule):
    def __init__(self, prepared):
        super().__init__(priority=10)
        self.prepared, self.losses, self.snaps = prepared, [], []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics.loss)))
        state = jax.tree.map(np.asarray, self.prepared.state)
        self.snaps.append({**_flat(state["params"], "params"),
                           **_flat(state["model_state"], "state")})


def _jce(batch):
    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"],
                                                           batch["label"]).mean()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    images, labels = _data()
    start = _start()
    np.savez(tmp / "data.npz", images=images, labels=labels)
    np.savez(tmp / "start.npz", **_flat(start["params"], "params"),
             **_flat(start["state"], "state"))
    model = jr.ResNet("basic", [1, 1], num_classes=10, stem="cifar")
    runtime = JRuntime(mesh_shape={"data": 2}, devices=jax.devices()[:2], seed=0,
                       project_dir=str(tmp / "jax"))
    prepared = JPrepared(model, {"params": jax.tree.map(jnp.asarray, start["params"]),
                                 "model_state": jax.tree.map(jnp.asarray, start["state"]),
                                 "step": jnp.zeros((), jnp.int32),
                                 "base_key": jax.random.key_data(jax.random.key(0))})
    runtime.models.add(model, prepared)
    module = jrt.Module(model, [jrt.Loss(_jce), jrt.Optimizer(joptim.sgd(), learning_rate=LR)])
    grab = _JGrab(prepared)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JArrayDataset(images, labels), batch_size=BATCH,
                                          device_cache=False), module, grab],
                             tag="train", repeats=STEPS, progress=False)],
                 runtime=runtime).launch()
    run_ranks(tmp, WORKER, 2, {"lr": LR, "batch": BATCH, "steps": STEPS, "cases": [
        {"name": "sync", "env": {}}, {"name": "forced", "env": {"ROCKET_TPU_FUSED_CONV": "pallas"}}
    ]}, timeout=300)
    port = {name: [dict(np.load(tmp / f"{name}_rank{r}.npz")) for r in range(2)]
            for name in ("sync", "forced")}
    ref = {"losses": grab.losses, "snaps": grab.snaps,
           "start": {**_flat(start["params"], "params"), **_flat(start["state"], "state")}}
    return port, ref


def test_syncbn_losses_match_the_reference(runs):
    port, ref = runs
    for r in range(2):
        np.testing.assert_allclose(port["sync"][r]["losses"], ref["losses"], rtol=LOSS_RTOL)


def test_syncbn_step1_gradients_of_every_leaf_match_the_reference(runs):
    port, ref = runs
    got_snap, start = port["sync"][0], ref["start"]
    leaves = [k for k in start if k.startswith("params/")]
    assert len(leaves) > 10
    for leaf in leaves:
        got = (start[leaf] - got_snap[f"step1/{leaf}"]) / LR
        want = (start[leaf] - ref["snaps"][0][leaf]) / LR
        scale = float(np.abs(want).max()) + 1e-12
        floor = 2 * float(np.spacing(np.abs(start[leaf]).max())) / LR
        assert float(np.abs(got - want).max()) <= max(GRAD_TOL * scale, floor), leaf


def test_syncbn_running_statistics_and_params_match_the_reference(runs):
    port, ref = runs
    for step in range(STEPS):
        for name, want in ref["snaps"][step].items():
            for r in range(2):
                got = port["sync"][r][f"step{step + 1}/{name}"]
                assert (np.abs(got - want) - TREE_TOL * (1 + np.abs(want))).max() <= 0, \
                    (step, name, r)
    # The steps moved the statistics, the same bits on both ranks.
    mean = "state/stem/bn/mean"
    assert not np.allclose(port["sync"][0][f"step1/{mean}"], ref["start"][mean])
    for key, value in port["sync"][0].items():
        if "/state/" in f"/{key}":
            np.testing.assert_array_equal(value, port["sync"][1][key], err_msg=key)


def test_syncbn_runs_two_collectives_per_layer_and_never_the_kernel(runs):
    port, ref = runs
    bn_layers = sum(1 for k in ref["start"] if k.startswith("state/") and k.endswith("/mean"))
    assert bn_layers == 6
    for r in range(2):
        reduces = port["sync"][r]["reduces"]
        np.testing.assert_array_equal(np.diff(np.concatenate([[0], reduces])), 2 * bn_layers)
        # Forced, the two-rank path is still the sync path, bitwise.
        assert int(port["forced"][r]["kernel_calls"]) == 0
        for key, value in port["sync"][r].items():
            if key != "kernel_calls":
                np.testing.assert_array_equal(port["forced"][r][key], value, err_msg=key)
