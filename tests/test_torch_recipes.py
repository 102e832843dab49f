"""The training-recipe pieces of the port against the JAX package's:
Lion, mixup and soft cross-entropy, Perplexity and the Attributes helpers.

* ``optim.lion`` against ``optax.lion`` (the reference's factory) for 5
  steps on a param dict with a matrix and a bias, with and without decay
  and its ndim >= 2 mask: float32, 1e-6 (the same foreach ops in optax's
  order; they agree bitwise on the CPU).
* ``mixup_mix`` fed the lambda and permutation that ``jax.random`` draws
  from the transform's key (recomputed with ``split``/``beta``/
  ``permutation``) against the reference transform's output: images and
  soft labels within 1e-6, the NaN rows of out-of-range labels included;
  the port's own Beta draw against ``scipy.stats.beta`` by a two-sample
  Kolmogorov-Smirnov test (20,000 draws each, p > 1e-3; both in float32,
  where ~2% of Beta(0.2, 0.2) draws round to exactly 1.0).
* ``soft_cross_entropy`` with soft and integer labels: 1e-6.
* ``Perplexity`` over two batches, the second with padding rows past its
  real size, on the device path and the host path: 1e-5 relative.
* ``Attributes.deepcopy`` and ``flat_items`` as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from rocket_tpu import optim as joptim
from rocket_tpu.core.attributes import Attributes as JAttributes
from rocket_tpu.data import augment as jaug
from rocket_tpu.utils.metrics import Perplexity as JPerplexity
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.data import augment as taug
from rocket_tpu_torch.utils.metrics import Perplexity


@pytest.mark.parametrize("weight_decay,mask_1d", [(0.0, True), (0.1, True), (0.1, False)])
def test_lion_matches_optax_for_five_steps(weight_decay, mask_1d):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    lr = 3e-2
    tx = joptim.lion(b1=0.9, b2=0.99, weight_decay=weight_decay, mask_1d=mask_1d)(lr)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = toptim.lion(b1=0.9, b2=0.99, weight_decay=weight_decay, mask_1d=mask_1d)(tp)
    for group in opt.param_groups:
        group["lr"] = lr
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k in tp:
            tp[k].grad = torch.tensor(g[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
    # One moment a param, optax's mu.
    moments = {k: opt.state[tp[k]]["exp_avg"].numpy() for k in tp}
    mu = jstate[0].mu
    for k in tp:
        np.testing.assert_allclose(moments[k], np.asarray(mu[k]), atol=1e-6, rtol=1e-6)
    assert isinstance(opt, toptim.Lion)


def test_lion_masks_the_decay_to_matrices():
    params = {"w": torch.ones(3, 3), "b": torch.ones(3)}
    opt = toptim.lion(weight_decay=0.5)(params)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.5, 0.0]
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1]
    assert [g["weight_decay"] for g in toptim.lion(weight_decay=0.5, mask_1d=False)(params)
            .param_groups] == [0.5]


def _batch(b=8, num_classes=10, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, b).astype(np.int32)
    labels[1], labels[5] = num_classes, -1          # out of range: NaN rows
    return images, labels


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_mixing_matches_the_reference_given_its_draws(alpha):
    images, labels = _batch()
    key = jax.random.key(7)
    want = jaug.mixup(alpha=alpha, num_classes=10)(
        {"image": jnp.asarray(images), "label": jnp.asarray(labels)}, key)
    k_lam, k_perm = jax.random.split(key)
    lam = np.array(jax.random.beta(k_lam, alpha, alpha, (len(labels),)))
    perm = np.array(jax.random.permutation(k_perm, len(labels)))
    mixed, soft = taug.mixup_mix(torch.from_numpy(images), torch.from_numpy(labels),
                                 torch.from_numpy(lam), torch.from_numpy(perm), 10)
    assert mixed.dtype == torch.float32 and soft.shape == (8, 10)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want["image"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(soft.numpy(), np.asarray(want["label"]), atol=1e-6, rtol=1e-6)
    nan_rows = np.isnan(soft.numpy()).any(1)
    assert nan_rows[1] and nan_rows[5]
    assert np.array_equal(nan_rows, np.isnan(np.asarray(want["label"])).any(1))


def test_mixup_transform_draws_on_the_device_and_repeats_from_its_key():
    images, labels = _batch()
    labels = np.clip(labels, 0, 9)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels), "id": 3}
    out = taug.mixup(alpha=0.2, num_classes=10)(batch, 12345)
    again = taug.mixup(alpha=0.2, num_classes=10)(batch, 12345)
    assert torch.equal(out["image"], again["image"]) and torch.equal(out["label"], again["label"])
    assert out["id"] == 3 and out["image"].shape == images.shape
    torch.testing.assert_close(out["label"].sum(1), torch.ones(8))
    lam, perm = taug.mixup_draw(12345, 8, 0.2, "cpu")
    assert sorted(perm.tolist()) == list(range(8)) and ((lam >= 0) & (lam <= 1)).all()


@pytest.mark.parametrize("alpha", [0.2, 1.0, 2.5])
def test_beta_draw_matches_scipy_by_a_two_sample_ks_test(alpha):
    n = 20_000
    got = taug.beta(99, alpha, n, "cpu").numpy()
    want = scipy.stats.beta(alpha, alpha).rvs(n, random_state=np.random.default_rng(1))
    assert not np.isnan(got).any() and got.min() >= 0 and got.max() <= 1
    assert scipy.stats.ks_2samp(got, want.astype(np.float32)).pvalue > 1e-3


def test_soft_cross_entropy_matches_the_reference_with_soft_and_integer_labels():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    soft = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    ints = rng.integers(0, 10, 6).astype(np.int32)
    for labels in (soft, ints):
        want = jaug.soft_cross_entropy()({"logits": jnp.asarray(logits),
                                          "label": jnp.asarray(labels)})
        got = taug.soft_cross_entropy()({"logits": torch.from_numpy(logits),
                                         "label": torch.from_numpy(labels)})
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


def test_perplexity_matches_the_reference_over_padded_batches():
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((3, 9, 17)).astype(np.float32),
                rng.integers(0, 17, (3, 9)).astype(np.int32), real) for real in (3, 2)]
    want = JPerplexity()
    got = Perplexity()
    host = Perplexity()
    for logits, tokens, real in batches:
        want.consume(want.device_reduce({"logits": jnp.asarray(logits),
                                         "tokens": jnp.asarray(tokens)}, real))
        got.consume(got.device_reduce({"logits": torch.from_numpy(logits),
                                       "tokens": torch.from_numpy(tokens)}, real))
        host.launch(Attributes(batch={"logits": torch.from_numpy(logits),
                                      "tokens": torch.from_numpy(tokens)},
                               batch_info=Attributes(size=real)))
    attrs = Attributes(looper=Attributes(state={}))
    want.reset()
    got.reset(attrs)
    host.reset()
    assert np.isfinite(got.value) and got.value > 1.0
    np.testing.assert_allclose(got.value, want.value, rtol=1e-5)
    np.testing.assert_allclose(host.value, want.value, rtol=1e-5)
    assert attrs.looper.state["perplexity"] == got.value
    # The padding row did not count: its logits changed, the value not.
    logits, tokens, _ = batches[1]
    noisy = logits.copy()
    noisy[2] *= 100.0
    again = Perplexity()
    for lg, tk, real in (batches[0], (noisy, tokens, 2)):
        again.consume(again.device_reduce({"logits": torch.from_numpy(lg),
                                           "tokens": torch.from_numpy(tk)}, real))
    again.reset()
    np.testing.assert_allclose(again.value, got.value, rtol=1e-6)


def test_attributes_deepcopy_and_flat_items_match_the_reference():
    def make(cls):
        bag = cls()
        bag.looper = {"state": {"loss": 1.5, "acc": 0.25}, "tag": "train"}
        bag.batch = [1, 2]
        bag.empty = {}
        return bag

    ours, theirs = make(Attributes), make(JAttributes)
    assert list(ours.flat_items()) == list(theirs.flat_items())
    assert list(ours.flat_items(prefix="run.")) == list(theirs.flat_items(prefix="run."))
    copy = ours.deepcopy()
    assert isinstance(copy, Attributes) and copy == ours
    copy.looper.state.loss = 9.0
    copy.batch.append(3)
    assert ours.looper.state.loss == 1.5 and ours.batch == [1, 2]
    tensor = Attributes(x=torch.zeros(2))
    cloned = tensor.deepcopy()
    cloned.x += 1
    assert torch.equal(tensor.x, torch.zeros(2))
