"""ViT and the ``vit_cifar`` and ``llama_lm`` examples of the port against
the JAX package, on the CPU.

* ViT at depth 2, dim 64, 2 heads over 16x16 images in 4x4 patches (T =
  17 with the CLS token), parameters carried across by ``bridge``: eval
  logits within 1e-5 and, in train mode with dropout 0, the cross-entropy
  within 1e-5 and every gradient within 1e-4 of its largest element
  (float32, the same math in another order).
* Each example's capsule tree at a small size for 2 steps against the same
  tree built from the JAX package, from one bridged start at the same seed:
  the step losses within 1e-4. The comparison runs without dropout and,
  for ViT, without the augmentation (neither draws the same bits in the
  two packages), and in float32 (the Llama configs with
  ``activation_dtype=None``, the ViT trees' Modules without a
  ``compute_dtype``: two bf16 paths round at other places, ~0.4% apart in
  the loss).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.datasets import ArrayDataset as JArrayDataset
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.models.vit import ViT as JViT
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.examples import cifar_resnet, llama_lm, vit_cifar
from rocket_tpu_torch.models.vit import ViT

SMALL = dict(image_size=16, patch_size=4, dim=64, depth=2, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under a tier-1 run that shares the CPU among workers: one
    intra-op thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(n, seed, size=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _jax_params(model, seed=1):
    return jax.tree.map(np.asarray, model.init(jax.random.key(seed))["params"])


def test_vit_logits_match_jax():
    jmodel, model = JViT(**SMALL), ViT(**SMALL)
    assert model.num_patches + 1 == 17
    jparams = _jax_params(jmodel)
    mine = model.init_params(torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, jparams)
    images, _ = _images(3, 0)
    want, _ = jmodel.apply({"params": jparams, "state": {}}, {"image": jnp.asarray(images)},
                           mode="eval")
    got = model.apply(params_from_jax(jparams), {"image": torch.from_numpy(images)}, mode="eval")
    assert got["logits"].shape == (3, 10)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=1e-5, rtol=1e-5)


def _jce(batch):
    return optax.softmax_cross_entropy_with_integer_labels(batch["logits"],
                                                           batch["label"]).mean()


def test_vit_train_loss_and_gradients_match_jax():
    jmodel, model = JViT(**SMALL), ViT(**SMALL)
    jparams = _jax_params(jmodel, 2)
    images, labels = _images(4, 1)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}

    def jloss(p):
        out, _ = jmodel.apply({"params": p, "state": {}}, batch, mode="train",
                              rng=jax.random.key(0))
        return _jce(out)

    want_loss, want_grads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    params = jax.tree.map(lambda t: t.requires_grad_(), params_from_jax(jparams))
    out = model.apply(params, {"image": torch.from_numpy(images),
                               "label": torch.from_numpy(labels)}, mode="train", rng=5)
    loss = cifar_resnet.cross_entropy(out)
    leaves = jax.tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want_leaves = jax.tree.leaves(want_grads)
    assert len(grads) == len(want_leaves) == 2 + 2 + 2 * 12 + 2 + 2
    for g, w in zip(grads, want_leaves):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), w.shape


# -- the examples' trees, 2 steps each -------------------------------------------


class _JLosses(JCapsule):
    def __init__(self):
        super().__init__(priority=10)
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(float(np.asarray(attrs.step_metrics["loss"])))


def _jax_train(tmp_path, jmodel, jparams, dataset, capsules, batch_size, **module_kw):
    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                        project_dir=str(tmp_path))
    jruntime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    rec = _JLosses()
    jrt.Launcher([jrt.Looper([
        jrt.Dataset(dataset, batch_size=batch_size, shuffle=True, drop_last=True),
        jrt.Module(jmodel, capsules, **module_kw), rec], progress=False)],
        runtime=jruntime).launch()
    return rec.rows


def test_vit_cifar_tree_matches_the_jax_example_for_two_steps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(vit_cifar, "image_augment", lambda **kw: lambda batch, key: batch)
    images, labels = _images(8, 3)
    val_images, val_labels = _images(4, 4)
    jmodel, model = JViT(**SMALL), ViT(**SMALL)
    jparams = _jax_params(jmodel, 3)
    steps = 2
    want = _jax_train(tmp_path, jmodel, jparams, JArrayDataset(images, labels), [
        jrt.Loss(_jce), jrt.Optimizer(joptim.adamw(), clip_norm=1.0),
        jrt.Scheduler(joptim.warmup_cosine_lr(3e-3, warmup_steps=1, decay_steps=steps))],
        batch_size=4)

    runtime = rt.Runtime(device="cpu", seed=0)
    run = vit_cifar.build(ArrayDataset(images, labels), ArrayDataset(val_images, val_labels),
                          batch_size=4, num_epochs=1, out_dir="ck", runtime=runtime, model=model,
                          compute_dtype=None)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
    run["launcher"].launch()
    with open("runs/vit_cifar.jsonl") as f:
        rows = [json.loads(line) for line in f]
    got = [r["train/loss"] for r in rows if "train/loss" in r]
    assert run["total_steps"] == steps and len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert [d.device_resident for d in run["datasets"]] == [True, True]
    assert any("val/accuracy" in r for r in rows)


def test_llama_lm_tree_matches_the_jax_example_for_two_steps(tmp_path):
    seq_len, vocab, batch = 16, 24, 4
    tokens = np.random.default_rng(5).integers(0, vocab, 2 * batch * seq_len + 1).astype(np.int32)
    jcfg = jt.TransformerConfig.llama_style(vocab_size=vocab, max_seq_len=seq_len, dim=32,
                                            num_layers=2, num_heads=4, num_kv_heads=2)
    jcfg.loss_chunk, jcfg.activation_dtype = 8, None
    jmodel = jt.TransformerLM(jcfg)
    jparams = _jax_params(jmodel, 4)
    want = _jax_train(tmp_path, jmodel, jparams, JTokenDataset(tokens, seq_len), [
        jrt.Loss(jt.next_token_loss()),
        jrt.Optimizer(joptim.adamw(weight_decay=0.1), clip_norm=1.0),
        jrt.Scheduler(joptim.warmup_cosine_lr(3e-4, warmup_steps=1, decay_steps=2))],
        batch_size=batch)

    cfg = llama_lm.config_for(vocab, seq_len)
    cfg.dim, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads = 32, 2, 4, 2
    cfg.loss_chunk, cfg.activation_dtype = 8, None
    runtime = rt.Runtime(device="cpu", seed=0)
    run = llama_lm.build(TokenDataset(tokens, seq_len), cfg, batch_size=batch, num_epochs=1,
                         out_dir=str(tmp_path / "ck"), runtime=runtime)
    runtime.models.add(run["model"], PreparedModule(run["model"],
                                                    {"params": params_from_jax(jparams)}))
    run["launcher"].launch()
    got = [float(v) for v in run["trained"]["losses"]]
    assert run["total_steps"] == 2 and len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert run["dataset"].device_resident
    sample = llama_lm.sample(run["model"], run["trained"]["params"],
                             _Tok(vocab), "cpu", max_new=6)
    assert sample.shape == (1, 4 + 6) and int(sample.max()) < vocab
    assert toptim.param_leaves(run["trained"]["params"])[0].dtype == torch.float32


class _Tok:
    """A tokenizer stand-in over ``vocab`` ids: "the " is 4 ids."""

    def __init__(self, vocab):
        self.vocab = vocab

    def encode(self, text):
        return np.asarray([ord(c) % self.vocab for c in text], np.int32)
