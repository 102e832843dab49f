"""The port's conv stack (``nn/layers`` Conv2D, pools, BatchNorm;
``models/resnet.py``) against the JAX package, on the CPU.

* ``Conv2D`` against ``jax.lax.conv_general_dilated`` (NHWC/HWIO) for
  SAME at strides 1 and 2 on even and odd sizes, 1x1/2, 7x7/2, VALID, an
  int and an explicit asymmetric padding — XLA's SAME split pads (0, 1)
  where ``F.conv2d(padding=1)`` would pad (1, 1);
* the pools against the reference layers (max pads with -inf, average
  divides by the full window);
* ``BatchNorm`` train and eval outputs and its running-average state;
* ``resnet18(10, stem="cifar")`` and ``resnet50``: the same param and
  state tree paths and shapes as JAX, the same param counts;
* bridged forward (logits and new state, train and eval) and gradients
  for ResNet-18 with the CIFAR stem and a bottleneck ResNet with the
  ImageNet stem on an odd-sized image.

Tolerances, float32: single layers ``2e-5 * (1 + |want|)`` per element
(the same sums in another order); whole models, logits and state within
``1e-4 * (1 + |want|)`` and each gradient within 1e-4 of its largest
element — a dozen convolutions, and batch statistics over few rows
divide the reordering error by small standard deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.models import resnet as jr
from rocket_tpu.nn import layers as jl
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import variables_from_jax
from rocket_tpu_torch.models import resnet as tr
from rocket_tpu_torch.nn import layers as tl

LAYER_TOL = 2e-5
MODEL_TOL = 1e-4


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


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1 + np.abs(want))
    assert excess.max() <= 0, f"{what}: off by {excess.max()} past {tol} * (1 + |want|)"


def _image(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


CONV_CASES = [  # (size, cin, cout, kernel, stride, padding)
    (8, 3, 8, 3, 1, "SAME"), (8, 4, 8, 3, 2, "SAME"), (9, 4, 8, 3, 2, "SAME"),
    (8, 4, 8, 1, 2, "SAME"), (17, 3, 8, 7, 2, "SAME"), (16, 3, 8, 7, 2, "SAME"),
    (9, 4, 8, 3, 1, "VALID"), (8, 4, 8, 3, 2, 1), (9, 4, 8, 3, 2, [(1, 2), (0, 1)]),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "s{}k{}x{}{}".format(
    c[0], c[3], c[4], c[5] if isinstance(c[5], str) else "pad"))
def test_conv2d_matches_conv_general_dilated(case):
    size, cin, cout, k, s, padding = case
    x = _image(0, (2, size, size, cin))
    w = _image(1, (k, k, cin, cout)) * 0.3
    b = _image(2, (cout,))
    layer = jl.Conv2D(cin, cout, k, stride=s, padding=padding)
    want, _ = layer.apply({"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "state": {}},
                          jnp.asarray(x))
    got = tl.Conv2D(cin, cout, k, stride=s, padding=padding).apply(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    _close(got.numpy(), want, LAYER_TOL, str(case))


def test_same_padding_splits_as_xla():
    assert tl._same_pads(32, 3, 2) == (0, 1)     # CIFAR stage transitions
    assert tl._same_pads(224, 7, 2) == (2, 3)    # ImageNet stem
    assert tl._same_pads(112, 3, 2) == (0, 1)    # the stem's max pool
    assert tl._same_pads(32, 3, 1) == (1, 1)
    assert tl._same_pads(32, 1, 2) == (0, 0)


def test_conv2d_init_is_truncated_he_normal():
    w = tl.Conv2D(64, 128, 3).init_params(torch.Generator().manual_seed(0))["w"]
    assert w.shape == (3, 3, 64, 128)
    std = (2.0 / (9 * 64)) ** 0.5
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / tl._TRUNC_STD + 1e-6


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_pools_match_the_reference(size, padding):
    x = _image(3, (2, size, size, 4))
    for jcls, tcls in ((jl.MaxPool2D, tl.MaxPool2D), (jl.AvgPool2D, tl.AvgPool2D)):
        want, _ = jcls(3, stride=2, padding=padding).apply({"params": {}, "state": {}},
                                                           jnp.asarray(x))
        got = tcls(3, stride=2, padding=padding).apply({}, torch.from_numpy(x))
        _close(got.numpy(), want, LAYER_TOL, f"{jcls.__name__} {padding} {size}")
    want, _ = jl.GlobalAvgPool2D().apply({"params": {}, "state": {}}, jnp.asarray(x))
    _close(tl.GlobalAvgPool2D().apply({}, torch.from_numpy(x)).numpy(), want, LAYER_TOL)


def _bn_variables(seed, c):
    rng = np.random.default_rng(seed)
    return ({"scale": 1 + 0.1 * rng.normal(size=c).astype(np.float32),
             "bias": 0.1 * rng.normal(size=c).astype(np.float32)},
            {"mean": 0.2 * rng.normal(size=c).astype(np.float32),
             "var": 1 + rng.uniform(size=c).astype(np.float32)})


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_batchnorm_outputs_and_state_match_jax(mode):
    params, state = _bn_variables(4, 16)
    x = _image(5, (4, 6, 6, 16)) * 2 + 0.5
    jbn, tbn = jl.BatchNorm(16), tl.BatchNorm(16)
    jv = {"params": jax.tree.map(jnp.asarray, params), "state": jax.tree.map(jnp.asarray, state)}
    tp, ts = (jax.tree.map(torch.from_numpy, t) for t in (params, state))
    for act in (False, True):
        want, want_state = jbn.apply_act(jv, jnp.asarray(x), mode=mode, act=act)
        got, got_state = tbn.apply_act(tp, torch.from_numpy(x), state=ts, mode=mode, act=act)
        _close(got.numpy(), want, LAYER_TOL, f"{mode} act={act}")
        for key in ("mean", "var"):
            _close(got_state[key].numpy(), want_state[key], LAYER_TOL, key)
    # apply_act(act=True) is relu(apply(...)) bitwise on the default path.
    y, _ = tbn.apply(tp, torch.from_numpy(x), state=ts, mode=mode)
    y_act, _ = tbn.apply_act(tp, torch.from_numpy(x), state=ts, mode=mode, act=True)
    assert torch.equal(tl.relu().fn(y), y_act)
    assert jax.tree.map(np.shape, tbn.init_state()) == jax.tree.map(np.shape, jbn.init_state())


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("make,kw", [(tr.resnet18, {"stem": "cifar"}), (tr.resnet50, {})],
                         ids=["resnet18_cifar", "resnet50"])
def test_param_and_state_trees_match_jax(make, kw):
    jmodel = getattr(jr, make.__name__)(10, **kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    tmodel = make(10, **kw)
    with torch.device("meta"):  # shapes only, as eval_shape
        params, state = tmodel.init(device="meta"), tmodel.init_state(device="meta")
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(state) == _paths(shapes["state"])
    count = sum(p.numel() for p in toptim.param_leaves(params))
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    if make is tr.resnet18:
        assert count == 11_173_962  # torchvision's CIFAR-head ResNet-18


def _bridged(tmodel, seed):
    """A numpy variables tree in the JAX layout (the port's init with the
    BatchNorm params and state perturbed from a seed) and its bridge into
    the port."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda t: t.numpy(), {"params": tmodel.init(device="cpu"),
                                              "state": tmodel.init_state(device="cpu")})

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'scale'", "'bias'", "'mean'", "'var'")):
            leaf = leaf + 0.1 * rng.uniform(size=leaf.shape).astype(np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return tree, variables_from_jax(tree)


MODELS = {
    "resnet18_cifar": (lambda m: m.resnet18(10, stem="cifar"), (4, 16, 16, 3)),
    "bottleneck_imagenet": (lambda m: m.ResNet("bottleneck", [1, 1], 10, stem="imagenet"),
                            (2, 17, 17, 3)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_bridged_forward_state_and_gradients_match_jax(name):
    make, shape = MODELS[name]
    jmodel, tmodel = make(jr), make(tr)
    jvars, tvars = _bridged(tmodel, 1)
    image = _image(6, shape)
    labels = np.random.default_rng(7).integers(0, 10, shape[0])

    def jloss(params, state, image):
        out, new_state = jmodel.apply({"params": params, "state": state}, {"image": image},
                                      mode="train")
        logp = jax.nn.log_softmax(out["logits"])
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean(), (
            out["logits"], new_state)

    (_, (jlogits, jstate)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jvars["params"], jvars["state"], image)

    params = jax.tree.map(lambda t: t.requires_grad_(), tvars["params"])
    out, state = tmodel.apply(params, {"image": torch.from_numpy(image)}, state=tvars["state"],
                              mode="train")
    loss = torch.nn.functional.cross_entropy(out["logits"], torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, toptim.param_leaves(params))
    _close(out["logits"].detach().numpy(), jlogits, MODEL_TOL, "train logits")
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(jstate)):
        _close(got.numpy(), want, MODEL_TOL, "train state")
    for (path, _), got, want in zip(_paths(tvars["params"]).items(), grads,
                                    jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= MODEL_TOL, f"grad {path}: {err}"

    jlogits = jax.jit(lambda v, x: jmodel.apply(v, {"image": x}, mode="eval")[0]["logits"])(
        jvars, image)
    with torch.no_grad():
        tout, teval_state = tmodel.apply(tvars["params"], {"image": torch.from_numpy(image)},
                                         state=tvars["state"], mode="eval")
    _close(tout["logits"].numpy(), jlogits, MODEL_TOL, "eval logits")
    for got, want in zip(toptim.param_leaves(teval_state), toptim.param_leaves(tvars["state"])):
        assert got is want  # eval reads the state and leaves it as it was
