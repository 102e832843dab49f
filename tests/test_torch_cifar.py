"""The CIFAR-10 ResNet slice of the port against the JAX package, on the
CPU: momentum SGD, both packages' Launcher trees, ``Meter(Accuracy)``,
the checkpoint with BatchNorm state in both directions, the on-device
augmentation ops, the Module's model state and ``batch_transform``, and
``examples.cifar_resnet`` at a tiny size (with a bitwise resume).

Tolerances, float32: momentum SGD 1e-6 (the same update in another
order); three Launcher steps of a ResNet, losses 1e-4 and params and
BatchNorm state ``2e-4 * (1 + |want|)`` (a dozen convolutions and batch
statistics over few rows, reordered, then amplified by three updates at lr
0.2); accuracy exactly (counts of argmax hits); checkpoints bitwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.attributes import Attributes as JAttributes
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.datasets import ArrayDataset as JArrayDataset
from rocket_tpu.models import resnet as jr
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu.utils.metrics import Accuracy as JAccuracy
from rocket_tpu.utils.metrics import TopKAccuracy as JTopKAccuracy
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import variables_from_jax
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data import augment
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.examples import cifar_resnet
from rocket_tpu_torch.models import resnet as tr
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.runtime import checkpoint_io as tio
from rocket_tpu_torch.utils.metrics import Accuracy, TopKAccuracy

TREE_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small ops, and the tier-1 run shares the CPU among
    parallel workers: torch's default of one intra-op thread per core then
    oversubscribes it (a tiny-ResNet train step ran ~70x slower with six
    such processes on eight cores). One thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(m):
    """A two-stage basic-block ResNet with the CIFAR stem: the slice's
    layers and state at a size the CPU trains in seconds."""
    return m.ResNet("basic", [1, 1], num_classes=10, stem="cifar")


def _data(seed, n, size=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _numpy_variables(model, seed):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda t: t.numpy(), {"params": model.init(device="cpu"),
                                              "state": model.init_state(device="cpu")})
    return jax.tree.map(lambda a: a + 0.05 * rng.uniform(size=a.shape).astype(np.float32)
                        if a.ndim == 1 else a, tree)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_optax_under_cosine_lr(nesterov):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    schedule, jschedule = toptim.cosine_lr(0.2, 5), joptim.cosine_lr(0.2, 5)
    tx = joptim.momentum(beta=0.9, nesterov=nesterov)(jschedule)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = toptim.resolve(toptim.momentum(beta=0.9, nesterov=nesterov), tp)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)


class _JRecord(JCapsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.losses = module, []

    def launch(self, attrs=None):
        self.losses.append(float(np.asarray(attrs.step_metrics["loss"])))
        self.state = jax.tree.map(np.asarray, {k: self.module.state[k]
                                               for k in ("params", "model_state")})


class _Record(Capsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module, self.losses = module, []

    def launch(self, attrs=None):
        self.losses.append(float(attrs.step_metrics["loss"]))
        self.state = self.module.state


def _jce(batch):
    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"],
                                                           batch["label"]).mean()


def test_launcher_trees_of_both_packages_agree_for_three_steps(tmp_path):
    images, labels = _data(0, 24)
    jmodel, tmodel = _small(jr), _small(tr)
    start = _numpy_variables(tmodel, 1)
    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                        project_dir=str(tmp_path))
    jruntime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, start["params"]),
        "model_state": jax.tree.map(jnp.asarray, start["state"]),
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    jmodule = jrt.Module(jmodel, [jrt.Loss(_jce), jrt.Optimizer(joptim.momentum(beta=0.9)),
                                  jrt.Scheduler(joptim.cosine_lr(0.2, decay_steps=3))])
    jrec = _JRecord(jmodule)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JArrayDataset(images, labels), batch_size=8),
                              jmodule, jrec], progress=False)], runtime=jruntime).launch()

    runtime = rt.Runtime(device="cpu", seed=0)
    bridged = variables_from_jax(start)
    runtime.models.add(tmodel, PreparedModule(tmodel, {"params": bridged["params"],
                                                       "model_state": bridged["state"]}))
    module = rt.Module(tmodel, [rt.Loss(cifar_resnet.cross_entropy),
                                rt.Optimizer(toptim.momentum(beta=0.9)),
                                rt.Scheduler(toptim.cosine_lr(0.2, decay_steps=3))])
    rec = _Record(module)
    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=8), module, rec],
                           progress=False)], runtime=runtime).launch()

    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=1e-4, rtol=1e-4)
    assert rec.state["step"] == 3
    for tree in ("params", "model_state"):
        got = [t.detach().numpy() for t in jax.tree.leaves(rec.state[tree])]
        want = jax.tree.leaves(jrec.state[tree])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (np.abs(g - w) - TREE_TOL * (1 + np.abs(w))).max() <= 0, tree
    # The steps moved the BatchNorm state and the params.
    assert not np.allclose(rec.state["model_state"]["stem"]["bn"]["mean"].numpy(),
                           start["state"]["stem"]["bn"]["mean"])


def _meter_batches(seed):
    """Logits and labels in batches of 8 over 21 samples; the last batch
    is short (5), and the JAX side gets it wrap-padded to 8 as its loader
    pads, with ``batch_info.size`` the real count."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(21, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 21).astype(np.int32)
    labels[:6] = logits[:6].argmax(-1)
    for i in range(0, 21, 8):
        lg, lb = logits[i:i + 8], labels[i:i + 8]
        padded = (np.concatenate([lg, logits[:8 - len(lg)]]),
                  np.concatenate([lb, labels[:8 - len(lb)]]))
        yield (lg, lb), padded, len(lg)


@pytest.mark.parametrize("k", [1, 3])
def test_meter_accuracy_matches_the_jax_meter(k):
    jmetric = JAccuracy() if k == 1 else JTopKAccuracy(k=k)
    jmeter = jrt.Meter(["logits", "label"], [jmetric])
    metrics = [Accuracy() if k == 1 else TopKAccuracy(k=k) for _ in range(2)]
    meters = [rt.Meter(["logits", "label"], [m]) for m in metrics]
    for (lg, lb), (plg, plb), size in _meter_batches(k):
        jattrs = JAttributes(batch={"logits": jnp.asarray(plg), "label": jnp.asarray(plb)},
                             batch_info=JAttributes(size=size))
        jmeter.launch(jattrs)
        # The port's Dataset yields the short batch; a padded batch with
        # its real size gives the same count.
        for meter, (a, b) in zip(meters, ((lg, lb), (plg, plb))):
            meter.launch(Attributes(batch={"logits": torch.from_numpy(a),
                                           "label": torch.from_numpy(b)},
                                    batch_info=Attributes(size=size)))
    attrs = Attributes(tracker=Attributes(scalars=Attributes()), looper=None)
    jmetric.reset(None)
    for m in metrics:
        m.reset(attrs)
        assert m.value == jmetric.value
    assert 0 < metrics[0].value < 1
    assert attrs.tracker.scalars[metrics[0]._tag] == metrics[0].value
    # The host path (a Meter whose metric has no device reduction) agrees.
    host = TopKAccuracy(k=k)
    for (lg, lb), _, size in _meter_batches(k):
        host.launch(Attributes(batch={"logits": torch.from_numpy(lg),
                                      "label": torch.from_numpy(lb)}))
    host.reset(None)
    assert host.value == jmetric.value


def test_meter_errors_propagate_and_missing_keys_raise():
    class Broken(Accuracy):
        def device_reduce(self, batch, real_size):
            raise ZeroDivisionError("inside the metric")

    batch = {"logits": torch.zeros(2, 10), "label": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ZeroDivisionError):
        rt.Meter(["logits", "label"], [Broken()]).launch(Attributes(batch=batch))
    with pytest.raises(KeyError, match="not found"):
        rt.Meter(["logits", "missing"], [Accuracy()]).launch(Attributes(batch=batch))
    with pytest.raises(ValueError):
        rt.Meter(["logits"], gather_on="some")


def test_checkpoint_with_model_state_reads_in_both_packages(tmp_path):
    tmodel, jmodel = _small(tr), _small(jr)
    start = _numpy_variables(tmodel, 2)
    bridged = variables_from_jax(start)
    prepared = PreparedModule(tmodel, {"params": bridged["params"],
                                       "model_state": bridged["state"], "step": 3,
                                       "base_key": 11})
    tio.save_pytree(str(tmp_path / "port"), prepared.checkpoint_state())
    index = json.loads((tmp_path / "port" / "index.json").read_text())
    assert "model_state/stem/bn/mean" in index and "params/stem/conv/w" in index
    template = {"params": jax.tree.map(jnp.asarray, start["params"]),
                "model_state": jax.tree.map(jnp.asarray, start["state"])}
    back = jio.load_pytree(str(tmp_path / "port"), template)
    for tree, src in (("params", "params"), ("model_state", "state")):
        for got, want in zip(jax.tree.leaves(back[tree]), jax.tree.leaves(start[src])):
            np.testing.assert_array_equal(np.asarray(got), want)

    # The reverse: JAX writes params and model_state; the port restores
    # them into a live PreparedModule and evaluates as JAX does.
    jio.save_pytree(str(tmp_path / "jax"), {**template, "step": jnp.asarray(5, jnp.int32),
                                            "base_key": 7})
    fresh = PreparedModule(tmodel, {"params": tmodel.init(device="cpu"),
                                    "model_state": tmodel.init_state(device="cpu")})
    fresh.load_checkpoint_state(tio.unflatten(tio.load_pytree(str(tmp_path / "jax"))))
    assert fresh.state["step"] == 5
    for got, want in zip(jax.tree.leaves(fresh.state["model_state"]),
                         jax.tree.leaves(start["state"])):
        np.testing.assert_array_equal(got.numpy(), want)
    image = _data(3, 2)[0]
    jout, _ = jmodel.apply({"params": template["params"], "state": template["model_state"]},
                           {"image": jnp.asarray(image)}, mode="eval")
    with torch.no_grad():
        out, _ = tmodel.apply(fresh.state["params"], {"image": torch.from_numpy(image)},
                              state=fresh.state["model_state"], mode="eval")
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-4,
                               rtol=1e-4)


# -- augmentation ----------------------------------------------------------


def _images(b=64, h=6, w=7, c=3):
    return torch.arange(b * h * w * c, dtype=torch.float32).reshape(b, h, w, c) + 1.0


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_random_crop_is_a_window_of_the_padded_image(pad_mode):
    images, p = _images(), 2
    out = augment.random_crop(keys.key(1), images, p, pad_mode=pad_mode)
    np_mode = "constant" if pad_mode == "constant" else "reflect"
    padded = np.pad(images.numpy(), ((0, 0), (p, p), (p, p), (0, 0)), mode=np_mode)
    offsets = set()
    for i in range(len(images)):
        found = [(y, x) for y in range(2 * p + 1) for x in range(2 * p + 1)
                 if np.array_equal(padded[i, y:y + 6, x:x + 7], out[i].numpy())]
        assert found, f"sample {i} is no window of its padded image"
        offsets.update(found)
    assert len(offsets) > 10  # offsets spread over [0, 2p]^2
    assert torch.equal(out, augment.random_crop(keys.key(1), images, p, pad_mode=pad_mode))
    with pytest.raises(ValueError):
        augment.random_crop(keys.key(1), images, p, pad_mode="edge")


def test_random_flip_mirrors_exactly_about_half_the_samples():
    images = _images(b=4000, h=2, w=3, c=1)
    out = augment.random_flip(keys.key(2), images)
    flipped = torch.tensor([torch.equal(o, i.flip(1)) for o, i in zip(out, images)])
    kept = torch.tensor([torch.equal(o, i) for o, i in zip(out, images)])
    assert bool((flipped | kept).all()) and not bool((flipped & kept).any())
    assert abs(flipped.float().mean().item() - 0.5) < 0.03
    assert torch.equal(out, augment.random_flip(keys.key(2), images))
    assert not torch.equal(out, augment.random_flip(keys.key(3), images))


def test_cutout_zeroes_one_square_window_per_sample():
    images = _images(b=32, h=12, w=12)
    out = augment.cutout(keys.key(4), images, size=4)
    for o, i in zip(out, images):
        hole = (o == 0).all(-1)
        rows, cols = hole.any(1).nonzero().flatten(), hole.any(0).nonzero().flatten()
        assert len(rows) <= 4 and len(cols) <= 4
        assert int(hole.sum()) == len(rows) * len(cols)
        assert torch.equal(o[~hole], i[~hole])


def test_image_augment_composes_per_op_keys():
    images = _images(b=8)
    batch = {"image": images, "label": torch.arange(8)}
    fn = augment.image_augment(crop_padding=2, flip=True, cutout_size=0)
    out = fn(batch, keys.key(5))
    assert out["label"] is batch["label"] and out["image"].shape == images.shape
    crop = augment.random_crop(keys.fold_in(keys.key(5), 1), images, 2)
    assert torch.equal(out["image"], augment.random_flip(keys.fold_in(keys.key(5), 2), crop))
    assert torch.equal(fn(batch, keys.key(5))["image"], out["image"])


# -- the Module's state and batch_transform ---------------------------------


def test_module_threads_model_state_and_runs_batch_transform_in_train_only():
    images, labels = _data(4, 16)
    model = _small(tr)
    seen = []

    def transform(batch, key):
        seen.append(key)
        return {**batch, "image": batch["image"] * 0.5}

    runtime = rt.Runtime(device="cpu", seed=0)
    module = rt.Module(model, [rt.Loss(cifar_resnet.cross_entropy),
                               rt.Optimizer(toptim.momentum())], batch_transform=transform)
    rec = _Record(module)
    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=8), module, rec],
                           progress=False),
                 rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=8),
                            rt.Module(model)], grad_enabled=False, progress=False)],
                runtime=runtime).launch()
    base = rec.state["base_key"]
    assert seen == [keys.fold_in(keys.fold_in(base, s), 0xA9517) for s in range(2)]
    init = model.init_state(device="cpu")
    assert not torch.equal(rec.state["model_state"]["stem"]["bn"]["var"],
                           init["stem"]["bn"]["var"])
    assert all(not t.requires_grad for t in toptim.param_leaves(rec.state["model_state"]))
    with pytest.raises(RuntimeError, match="batch_transform"):
        rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=8),
                                rt.Module(_small(tr), batch_transform=transform)],
                               progress=False)], runtime=rt.Runtime(device="cpu")).launch()


# -- examples.cifar_resnet at a tiny size ---------------------------------------


def _one_stage(num_classes, stem):
    """``resnet18``'s stand-in for the example's tree on the CPU: one
    basic block on the CIFAR stem."""
    return tr.ResNet("basic", [1], num_classes=num_classes, stem=stem)


def _tiny_cifar(train=True):
    images, labels = _data(5 if train else 6, 220 if train else 10, size=4)
    return ArrayDataset(images, labels)


def _train_lines(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "train/loss" in r], [
        r["val/accuracy"] for r in rows if "val/accuracy" in r]


def test_cifar_main_at_a_tiny_size(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cifar_resnet, "cifar10", _tiny_cifar)
    monkeypatch.setattr(cifar_resnet, "resnet18", _one_stage)
    run = cifar_resnet.main(num_epochs=1, batch_size=20, out_dir="ck", device="cpu")
    losses, accuracy = _train_lines("runs/cifar_resnet18.jsonl")
    assert len(losses) == run["total_steps"] == 11 and all(np.isfinite(losses))
    assert accuracy == [run["accuracy"].value]
    assert run["trained"]["state"]["step"] == 11


def _cifar_run(root, resume_from=None):
    """``cifar_resnet.build``'s tree at batch 2 over 220 tiny images for
    two epochs: 220 steps, a checkpoint at step 200."""
    os.makedirs(root, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        run = cifar_resnet.build(_tiny_cifar(True), _tiny_cifar(False), batch_size=2,
                                 num_epochs=2, out_dir="ck", runtime=rt.Runtime(seed=0,
                                                                                device="cpu"),
                                 resume_from=resume_from)
        run["launcher"].launch()
        return _train_lines("runs/cifar_resnet18.jsonl"), run["trained"]["state"]
    finally:
        os.chdir(cwd)


def test_cifar_resume_from_step_200_is_bitwise(tmp_path, monkeypatch):
    monkeypatch.setattr(cifar_resnet, "resnet18", _one_stage)
    (losses, accuracy), whole = _cifar_run(tmp_path / "b")
    assert sorted(os.listdir(tmp_path / "b" / "ck")) == ["200"]
    os.makedirs(tmp_path / "a" / "ck")
    os.rename(tmp_path / "b" / "ck" / "200", tmp_path / "a" / "ck" / "200")
    (resumed, resumed_accuracy), state = _cifar_run(tmp_path / "a", resume_from="latest")
    assert resumed == losses[200:] and resumed_accuracy == accuracy[1:]
    for tree in ("params", "model_state"):
        for got, want in zip(toptim.param_leaves(state[tree]), toptim.param_leaves(whole[tree])):
            assert torch.equal(got, want), tree
