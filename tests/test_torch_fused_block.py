"""The port's fused attention half of a block (``ops/fused_block.py``)
against the JAX package's, and the seam in ``Block`` that takes it.

Operands are those of ``tests/test_fused_kernels.py`` (B=4, T=64, D=128,
H=2, from a numpy seed). On the CPU the port's ``block_attn_half`` runs the
kernel's plain version inside its autograd Function (the backward
recomputes through ``reference_block_attn``, as the reference's custom VJP
does); the JAX side runs the Pallas kernel in interpret mode and its plain
reference.

Tolerances:

* float32: value and all seven gradients of ``sum(y**2)`` within 2e-5
  absolute plus 2e-5 relative (the same f32 math in another order);
* bfloat16 x: the forward element by element within 2e-2 * (1 + |want|),
  each gradient within 2e-2 of its own norm. The gradients are large sums
  that carry the bf16 rounding of y, so they are held relative to their
  norm, never element by element (the reference's own red
  ``test_block_attn_half_bf16_parity`` fails on exactly that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.models import transformer as jt
from rocket_tpu.ops import fused_block as jfb
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.ops import fused_block as tfb

B, T, D, H = 4, 64, 128, 2
F32 = dict(atol=2e-5, rtol=2e-5)
_BLOCK_ATTN_HALF = tfb.block_attn_half


def _spy(monkeypatch) -> list:
    """Record the epilogue of every ``block_attn_half`` call the model makes."""
    calls = []
    monkeypatch.setattr(tfb, "block_attn_half",
                        lambda *a, **k: calls.append(k["epilogue"]) or _BLOCK_ATTN_HALF(*a, **k))
    return calls


def _assert_f32(got, want):
    """Values element by element within 2e-5 abs + 2e-5 rel; gradients
    with the absolute part scaled by the leaf's largest element: they are
    sums over B*T rows of terms up to ~40, so an element that cancels to
    near zero carries their f32 rounding in either summation order."""
    np.testing.assert_allclose(got[0], want[0], **F32)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5 * max(np.abs(w).max(), 1.0))


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, D)).astype(np.float32) * 0.5)
    ln_s = 1.0 + 0.1 * rng.normal(size=(D,)).astype(np.float32)
    ln_b = 0.1 * rng.normal(size=(D,)).astype(np.float32)
    wqkv = rng.normal(size=(D, 3 * D)).astype(np.float32) * D ** -0.5
    bqkv = 0.01 * rng.normal(size=(3 * D,)).astype(np.float32)
    wproj = rng.normal(size=(D, D)).astype(np.float32) * D ** -0.5
    bproj = 0.01 * rng.normal(size=(D,)).astype(np.float32)
    return [x, ln_s, ln_b, wqkv, bqkv, wproj, bproj]


def _jax_value_and_grads(fn, args, bf16=False):
    args = [jnp.asarray(a) for a in args]
    if bf16:
        args[0] = args[0].astype(jnp.bfloat16)
    y = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(jnp.square(fn(*a).astype(jnp.float32))),
                     argnums=tuple(range(7)))(*args)
    return [np.asarray(y.astype(jnp.float32))] + [np.asarray(g.astype(jnp.float32))
                                                   for g in grads]


def _torch_value_and_grads(fn, args, bf16=False):
    leaves = [torch.tensor(a) for a in args]
    if bf16:
        leaves[0] = leaves[0].to(torch.bfloat16)
    leaves = [t.requires_grad_() for t in leaves]
    y = fn(*leaves)
    grads = torch.autograd.grad(y.float().square().sum(), leaves, allow_unused=True)
    return [y.detach().float().numpy()] + [
        np.zeros(a.shape, np.float32) if g is None else g.float().numpy()
        for g, a in zip(grads, args)]


@pytest.fixture(scope="module")
def jax_refs():
    """{(epilogue, block_b): value and grads of the interpreted Pallas
    kernel} plus {epilogue: those of the JAX plain reference}."""
    args = _operands()
    out = {}
    for epilogue in tfb.EPILOGUES:
        out[epilogue] = _jax_value_and_grads(
            lambda *a: jfb.reference_block_attn(*a, num_heads=H, epilogue=epilogue), args)
        for block_b in (1, 2, 4):
            out[epilogue, block_b] = _jax_value_and_grads(
                lambda *a: jfb.block_attn_half(*a, num_heads=H, epilogue=epilogue,
                                               block_b=block_b, interpret=True), args)
    return out


@pytest.mark.parametrize("epilogue", tfb.EPILOGUES)
@pytest.mark.parametrize("block_b", [1, 2, 4])
def test_block_attn_half_matches_the_pallas_kernel_f32(jax_refs, epilogue, block_b):
    got = _torch_value_and_grads(
        lambda *a: tfb.block_attn_half(*a, num_heads=H, epilogue=epilogue, block_b=block_b),
        _operands())
    _assert_f32(got, jax_refs[epilogue, block_b])


@pytest.mark.parametrize("epilogue", tfb.EPILOGUES)
def test_reference_block_attn_matches_the_jax_reference_f32(jax_refs, epilogue):
    got = _torch_value_and_grads(
        lambda *a: tfb.reference_block_attn(*a, num_heads=H, epilogue=epilogue), _operands())
    _assert_f32(got, jax_refs[epilogue])


@pytest.mark.parametrize("epilogue", tfb.EPILOGUES)
def test_block_attn_half_bf16(epilogue):
    args = _operands()
    want = _jax_value_and_grads(
        lambda *a: jfb.block_attn_half(*a, num_heads=H, epilogue=epilogue, block_b=2,
                                       interpret=True), args, bf16=True)
    got = _torch_value_and_grads(
        lambda *a: tfb.block_attn_half(*a, num_heads=H, epilogue=epilogue, block_b=2),
        args, bf16=True)
    assert np.all(np.abs(got[0] - want[0]) <= 2e-2 * (1.0 + np.abs(want[0])))
    for g, w in zip(got[1:], want[1:]):
        assert np.linalg.norm(g - w) <= 2e-2 * max(np.linalg.norm(w), 1e-30)


def test_bad_epilogue_and_block_b_raise_as_in_the_reference():
    args = [torch.tensor(a) for a in _operands()]
    jargs = [jnp.asarray(a) for a in _operands()]
    for kw in ({"epilogue": "bogus"}, {"block_b": 3}):
        with pytest.raises(ValueError):
            jfb.block_attn_half(*jargs, num_heads=H, interpret=True, **kw)
        with pytest.raises(ValueError):
            tfb.block_attn_half(*args, num_heads=H, **kw)
    assert tfb.block_attn_supported(B, T, D, H, 2) == jfb.block_attn_supported(B, T, D, H, 2)
    assert not tfb.block_attn_supported(B, T, D, H, 3)


def test_kernel_limits():
    assert tfb.kernel_supported(256, 256, 4) and tfb.kernel_supported(tfb.MAX_T, 64, 1)
    assert not tfb.kernel_supported(tfb.MAX_T + 1, 256, 4)      # K/V past shared memory
    assert not tfb.kernel_supported(256, 128, 4)                 # head dim 32
    assert not tfb.kernel_supported(64, 64 * 9, 9, "fused")      # past one cluster
    assert tfb.kernel_supported(64, 64 * 9, 9, "separate")


# -- the Block seam -----------------------------------------------------------

BLOCK_CFG = dict(vocab_size=64, max_seq_len=64, dim=128, num_layers=2, num_heads=2)


def _blocks(dropout=0.0, **extra):
    """(jax Block, port Block, jax params, port params) from one init."""
    kw = dict(BLOCK_CFG, dropout=dropout, **extra)
    jblock = jt.Block(jt.TransformerConfig(**kw), 1)
    jparams = jax.tree.map(np.asarray, jblock.init_params(jax.random.key(3)))
    return jblock, tt.Block(tt.TransformerConfig(**kw), 1), jparams, params_from_jax(jparams)


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("ROCKET_TPU_BLOCK_ATTN", "fused")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forced_block_matches_the_jax_block(forced, monkeypatch, mode):
    jblock, block, jparams, params = _blocks()
    x = np.random.default_rng(5).normal(size=(2, 32, BLOCK_CFG["dim"])).astype(np.float32)

    def jloss(p, xx):
        y, _ = jblock.apply({"params": p, "state": {}}, xx, mode=mode)
        return jnp.sum(jnp.square(y)), y

    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    leaves = [t.requires_grad_() for t in jax.tree.leaves(params)]
    xt = torch.tensor(x, requires_grad=True)
    before = tfb.fused_block.launches
    calls = _spy(monkeypatch)
    y = block.apply(params, xt, mode=mode)
    assert calls == ["fused"] and tfb.fused_block.launches == before  # CPU: the plain version
    grads = torch.autograd.grad(y.square().sum(), leaves + [xt])
    _assert_f32([y.detach().numpy()] + [g.numpy() for g in grads],
                [np.asarray(w) for w in [jy] + jax.tree.leaves(jg) + [jgx]])


def _run_block(block, params, x, mode, rng, monkeypatch, force):
    if force:
        monkeypatch.setenv("ROCKET_TPU_BLOCK_ATTN", "fused")
    else:
        monkeypatch.delenv("ROCKET_TPU_BLOCK_ATTN", raising=False)
    calls = _spy(monkeypatch)
    leaves = [t.detach().requires_grad_() for t in jax.tree.leaves(params)]
    tree = jax.tree.unflatten(jax.tree.structure(params), leaves)
    y = block.apply(tree, x, mode=mode, rng=rng)
    return y, torch.autograd.grad(y.square().sum(), leaves), calls


def test_forced_train_with_dropout_equals_the_unforced_chain(monkeypatch):
    _, block, _, params = _blocks(dropout=0.1)
    x = torch.tensor(np.random.default_rng(6).normal(size=(2, 32, BLOCK_CFG["dim"]))
                     .astype(np.float32))
    y0, g0, calls0 = _run_block(block, params, x, "train", 1234, monkeypatch, force=False)
    y1, g1, calls1 = _run_block(block, params, x, "train", 1234, monkeypatch, force=True)
    assert calls0 == [] and calls1 == ["separate"]  # dropout forces the separate epilogue
    _assert_f32([y1.detach().numpy()] + [g.numpy() for g in g1],
                [y0.detach().numpy()] + [g.numpy() for g in g0])


def test_unforced_block_and_llama_style_never_take_the_fused_path(monkeypatch):
    _, block, _, params = _blocks()
    x = torch.zeros(2, 16, BLOCK_CFG["dim"])
    assert _run_block(block, params, x, "eval", None, monkeypatch, force=False)[2] == []
    llama = tt.TransformerConfig.llama_style(vocab_size=64, max_seq_len=64, dim=128,
                                             num_layers=2, num_heads=2, num_kv_heads=1)
    lblock = tt.Block(llama, 0)
    lparams = lblock.init_params(torch.Generator().manual_seed(0))
    assert not lblock._block_attn_ok
    assert _run_block(lblock, lparams, x, "eval", None, monkeypatch, force=True)[2] == []


def test_shapes_past_the_kernel_stay_on_the_chain(monkeypatch):
    _, block, _, params = _blocks()
    monkeypatch.setenv("ROCKET_TPU_BLOCK_ATTN", "fused")
    assert block._block_attn_config(torch.zeros(2, tfb.MAX_T, BLOCK_CFG["dim"])) is not None
    assert block._block_attn_config(torch.zeros(2, tfb.MAX_T + 1, BLOCK_CFG["dim"])) is None
    assert block._block_attn_config(torch.zeros(2, 1, BLOCK_CFG["dim"])) is None  # T < 2
