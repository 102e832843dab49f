"""The MNIST slice of the port against the JAX package, on the CPU:
``SyntheticMNIST`` and ``mnist()``, LeNet and the MLP with parameters
carried across by ``bridge``, ``Sequential``/``Lambda`` with the state of
a stateful layer threaded through, and the activation factories.

Tolerances, float32: the synthetic samples bitwise (the same numpy
draws); logits 1e-5 and the activations 1e-6 (the same math in another
order); the threaded BatchNorm state 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu import nn as jnn
from rocket_tpu.data.datasets import SyntheticMNIST as JSyntheticMNIST
from rocket_tpu.models.lenet import LeNet as JLeNet
from rocket_tpu.models.mlp import MLP as JMLP
from rocket_tpu.nn import layers as jl
from rocket_tpu_torch.bridge import params_from_jax, variables_from_jax
from rocket_tpu_torch.data.datasets import SyntheticMNIST, mnist
from rocket_tpu_torch.models.lenet import LeNet
from rocket_tpu_torch.models.mlp import MLP
from rocket_tpu_torch.nn import layers as tl
from rocket_tpu_torch.nn import module as tm
from rocket_tpu_torch.nn.module import Lambda, merge_state

LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under a tier-1 run that shares the CPU among workers: one
    intra-op thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,train", [(0, True), (0, False), (3, True)])
def test_synthetic_mnist_samples_are_the_references_bitwise(seed, train):
    port, ref = SyntheticMNIST(50, seed=seed, train=train), JSyntheticMNIST(50, seed=seed,
                                                                            train=train)
    assert len(port) == len(ref) == 50
    for i in (0, 1, 17, 49):
        got, want = port[i], ref[i]
        assert got["image"].dtype == want["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["label"] == want["label"] and type(got["label"]) is type(want["label"])


def test_mnist_without_a_local_copy_is_the_synthetic_set(tmp_path):
    train, test = mnist(root=str(tmp_path)), mnist(root=str(tmp_path), train=False)
    assert isinstance(train, SyntheticMNIST) and len(train) == 60000
    assert isinstance(test, SyntheticMNIST) and len(test) == 10000
    np.testing.assert_array_equal(test[5]["image"], JSyntheticMNIST(10000, train=False)[5]["image"])


def _images(b, shape, seed=0):
    return np.random.default_rng(seed).normal(size=(b, *shape)).astype(np.float32)


def _jax_variables(model, seed):
    return jax.tree.map(np.asarray, model.init(jax.random.key(seed)))


@pytest.mark.parametrize("shape", [(28, 28), (28, 28, 1)])
def test_lenet_logits_match_jax(shape):
    jmodel, model = JLeNet(10), LeNet(10)
    jvars = _jax_variables(jmodel, 1)
    jparams = jvars["params"]
    shapes = jax.tree.map(np.shape, model.init_params(torch.Generator().manual_seed(0)))
    assert shapes == jax.tree.map(np.shape, jparams)  # the reference's tree, "0" .. "11"
    images = _images(4, shape)
    want, _ = jmodel.apply(jvars, {"image": jnp.asarray(images)}, mode="eval")
    got = model.apply(params_from_jax(jparams), {"image": torch.from_numpy(images)}, mode="eval")
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert torch.equal(got["image"], torch.from_numpy(images))  # the batch passes through


def test_mlp_logits_match_jax():
    jmodel, model = JMLP(28 * 28, 10, hidden=(32, 16)), MLP(28 * 28, 10, hidden=(32, 16))
    jvars = _jax_variables(jmodel, 2)
    jparams = jvars["params"]
    images = _images(5, (28, 28), seed=1)
    want, _ = jmodel.apply(jvars, {"image": jnp.asarray(images)}, mode="train",
                           rng=jax.random.key(0))
    got = model.apply(params_from_jax(jparams), {"image": torch.from_numpy(images)},
                      mode="train", rng=7)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert [repr(layer) for layer in model.trunk.layers] == [
        "Flatten", "Dense(784->32)", "Lambda(relu)", "Dense(32->16)", "Lambda(relu)",
        "Dense(16->10)"]


def test_sequential_threads_the_state_of_a_stateful_layer():
    """Dense -> BatchNorm -> relu -> (Dense -> tanh) in both packages: the
    train output and the BatchNorm's new running statistics, then eval with
    the new state; the chain is stateful because one layer is."""
    def build(nn, layers):
        return nn.Sequential(layers.Dense(4, 6), layers.BatchNorm(6), layers.relu(),
                             nn.Sequential(layers.Dense(6, 3), layers.tanh()))

    jseq, seq = build(jnn, jl), build(tm, tl)
    assert seq.stateful and not seq.layers[3].stateful
    jvars = jax.tree.map(np.asarray, jseq.init(jax.random.key(3)))
    tvars = variables_from_jax(jvars)
    assert set(seq.init_state()) == {"1"} and list(seq.init_params(torch.Generator())) == [
        "0", "1", "2", "3"]
    x = _images(8, (4,), seed=2) * 3.0 + 1.0
    jy, jstate = jseq.apply(jvars, jnp.asarray(x), mode="train")
    y, state = seq.apply(tvars["params"], torch.from_numpy(x), state=tvars["state"],
                         mode="train")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
    for key in ("mean", "var"):
        np.testing.assert_allclose(state["1"][key].numpy(), np.asarray(jstate["1"][key]),
                                   atol=1e-6, rtol=1e-6)
    jvars, tvars = merge_state(jvars, jstate), merge_state(tvars, state)
    jy, _ = jseq.apply(jvars, jnp.asarray(x), mode="eval")
    y, same = seq.apply(tvars["params"], torch.from_numpy(x), state=tvars["state"], mode="eval")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
    assert same["1"] is state["1"]
    with pytest.raises(ValueError, match="needs its state"):
        seq.apply(tvars["params"], torch.from_numpy(x))


@pytest.mark.parametrize("name", ["relu", "gelu", "tanh", "silu", "softmax"])
def test_activation_factories_match_the_reference(name):
    x = _images(6, (33,), seed=4) * 3.0
    layer, ref = getattr(tl, name)(), getattr(jl, name)()
    assert isinstance(layer, Lambda) and repr(layer) == repr(ref) == f"Lambda({name})"
    got = layer({}, torch.from_numpy(x))
    want, _ = ref.apply({"params": {}, "state": {}}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
