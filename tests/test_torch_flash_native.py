"""Port parity: ``rocket_tpu_torch.ops.flash_native`` against
``rocket_tpu.ops.flash_native`` run in Pallas interpret mode on the CPU.

The port's CPU path is the kernels' plain versions (``_fwd_plain``,
``_bwd_plain``, ``_dq_plain``) behind the same autograd Functions the
card runs. Inputs come from a numpy seed; the JAX kernels run with 128-row
blocks at T=256 (two k-blocks), the port with its own 64-row tiles, so
the dq partials are compared through their sum.

Tolerances: float32 1e-5 on out and lse (the same f32 math, blockwise vs
whole-row softmax) and 1e-4 on gradients (sums over T of products, in
another order); bfloat16 2e-2 (p and ds rounded to bf16 from f32 scores
summed in another order can round one bf16 step apart).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.ops import flash_native as jfn
from rocket_tpu_torch.bridge import tensor_from_numpy
from rocket_tpu_torch.ops import flash_native as tfn

B, T, H, D, BLOCK = 1, 256, 4, 32, 128
TOL_FWD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}
LAYOUTS = {  # name -> (Hkv, fused operand)
    "fused": (H, True),
    "bthd_mha": (H, False),
    "bthd_gqa": (2, False),
}


def _operands(layout, d, dtype, seed):
    """numpy operands (one fused array, or q2/k2/v2) for a layout."""
    h_kv, fused = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32).astype(dtype)  # noqa: E731
    if fused:
        return (mk(B, T, 3 * H * d),)
    return mk(B, T, H * d), mk(B, T, h_kv * d), mk(B, T, h_kv * d)


def _jax_call(layout, arrs, causal, dq_split=None):
    h_kv, fused = LAYOUTS[layout]
    kw = dict(causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True, dq_split=dq_split)
    if fused:
        return jax.jit(lambda a: jfn.flash_fused(a, H, **kw))
    return jax.jit(lambda q, k, v: jfn.flash_bthd(q, k, v, H, h_kv, **kw))


def _port_call(layout, causal, dq_split=None):
    h_kv, fused = LAYOUTS[layout]
    if fused:
        return lambda a: tfn.flash_fused(a, H, causal=causal, dq_split=dq_split)
    return lambda q, k, v: tfn.flash_bthd(q, k, v, H, h_kv, causal=causal, dq_split=dq_split)


def _jax_lse(layout, arrs, d, causal):
    """The JAX forward's lse, reshaped from its (B, H/(kb*g), kb*g, T)
    TPU blocking to the port's (B, H, T)."""
    h_kv, fused = LAYOUTS[layout]
    if fused:
        kb = jfn._fused_kb(H, d)
        q = k = v = arrs[0]
        offs = dict(q_off=0, k_off=H * d, v_off=2 * H * d)
    else:
        kb = jfn._kv_block(h_kv, H // h_kv, d, H * d, h_kv * d)
        q, k, v = arrs
        offs = dict(q_off=0, k_off=0, v_off=0)
    _, lse = jax.jit(lambda q, k, v: jfn._fwd(q, k, v, h=H, h_kv=h_kv, d=d, kb=kb, causal=causal,
                                              block_q=BLOCK, block_k=BLOCK, interpret=True,
                                              **offs))(q, k, v)
    return np.asarray(lse).reshape(B, H, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_out_and_lse_match_jax(layout, causal, dtype):
    d = D
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    arrs = _operands(layout, d, np_dtype, seed=len(layout) + causal)
    jarrs = [jnp.asarray(a) for a in arrs]
    want = np.asarray(_jax_call(layout, arrs, causal)(*jarrs)).astype(np.float32)
    got = _port_call(layout, causal)(*[tensor_from_numpy(a) for a in arrs])
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, T, H * d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_FWD[dtype],
                               rtol=TOL_FWD[dtype])
    if dtype == "float32":
        h_kv, fused = LAYOUTS[layout]
        offsets = (0, H * d, 2 * H * d) if fused else (0, 0, 0)
        targs = [tensor_from_numpy(a) for a in (arrs * 3 if fused else arrs)]
        _, lse = tfn._fwd_plain(*targs, H, h_kv, d, offsets, causal)
        np.testing.assert_allclose(lse.numpy(), _jax_lse(layout, jarrs, d, causal),
                                   atol=TOL_FWD[dtype], rtol=TOL_FWD[dtype])


@pytest.mark.parametrize("dq_split", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["fused", "bthd_gqa"])
def test_backward_matches_jax_vjp(layout, causal, dq_split):
    """Gradients of the port's autograd Function (the plain fused backward
    with the partial sum, or the plain accumulating dq) against jax.vjp of
    the interpreted kernels with the same dq strategy forced. The fused
    layout covers MHA and its [dq | dk | dv] cotangent, bthd_gqa the
    separate-operand Function with a query group per kv head."""
    d = D
    arrs = _operands(layout, d, np.float32, seed=7 + causal)
    cot = np.random.default_rng(11).standard_normal((B, T, H * d)).astype(np.float32)
    jarrs = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(_jax_call(layout, arrs, causal, dq_split), *jarrs)
    want = vjp(jnp.asarray(cot))
    targs = [tensor_from_numpy(a).requires_grad_() for a in arrs]
    out = _port_call(layout, causal, dq_split)(*targs)
    got = torch.autograd.grad(out, targs, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL_GRAD["float32"],
                                   rtol=TOL_GRAD["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_dq_partials_sum_to_the_accumulating_dq(causal):
    """``_bwd_plain``'s f32 partials (one per 64-row k-tile, zero where a
    causal tile is skipped) sum to ``_dq_plain``; dk/dv do not depend on
    the strategy."""
    d, h_kv, t = D, 2, 200  # a ragged last tile
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((B, t, w * d)).astype(np.float32))
                     for w in (H, h_kv, h_kv, H))
    geo = (H, h_kv, d, (0, 0, 0), causal)
    out, lse = tfn._fwd_plain(q, k, v, *geo)
    delta = (dout * out).reshape(B, t, H, d).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, *geo)
    dqp, dk, dv = tfn._bwd_plain(*args, with_dq=True)
    nk = math.ceil(t / tfn.TILE)
    assert tuple(dqp.shape) == (nk, B, t, H * d) and dqp.dtype == torch.float32
    torch.testing.assert_close(dqp.sum(0), tfn._dq_plain(*args), atol=1e-5, rtol=1e-5)
    none, dk2, dv2 = tfn._bwd_plain(*args, with_dq=False)
    assert none is None and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if causal:
        for ik in range(nk):
            assert not dqp[ik, :, :ik * tfn.TILE].any()


def test_strategy_switch_counts_the_ports_tiles(monkeypatch):
    """dq_split=None takes the partials below the byte bound and the
    accumulating dq kernel above it, where nk counts 64-row tiles."""
    d, t = D, 128
    rng = np.random.default_rng(5)
    fused = torch.from_numpy(rng.standard_normal((1, t, 3 * H * d)).astype(np.float32))
    calls = []
    real_dq = tfn._dq_plain
    monkeypatch.setattr(tfn, "_dq_plain", lambda *a: calls.append("dq") or real_dq(*a))
    partial_bytes = (t // tfn.TILE) * 1 * t * H * d * 4
    for bound, split in ((partial_bytes, False), (partial_bytes - 1, True)):
        calls.clear()
        monkeypatch.setattr(tfn, "DQ_PARTIALS_MAX_BYTES", bound)
        x = fused.clone().requires_grad_()
        tfn.flash_fused(x, H).sum().backward()
        assert calls == (["dq"] if split else [])


def test_wrappers_reject_unaligned_causal_tiles():
    with pytest.raises(ValueError, match="block_q == block_k"):
        tfn._check_causal_blocks(64, 128, True, "flash")
    tfn._check_causal_blocks(64, 128, False, "flash")
