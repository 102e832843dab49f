"""Port parity: ``rocket_tpu_torch.ops.flash_native`` against
``rocket_tpu.ops.flash_native`` run in Pallas interpret mode on the CPU.

The port's CPU path is the kernels' plain versions (``_fwd_plain``,
``_bwd_plain``, ``_dq_plain``) behind the same autograd Functions the
card runs. Inputs come from a numpy seed; the JAX kernels run with 128-row
blocks at T=256 (two k-blocks), the port with its own 64-row tiles, so
the dq partials are compared through their sum. Head dims 32, 128, 96
and 80: the card runs 96 and 80 on heads zero-padded to 128, which the
meta route below checks (the launches it declares); the plain versions
take any D.

Tolerances: float32 1e-5 on out and lse (the same f32 math, blockwise vs
whole-row softmax) and 1e-4 on gradients (sums over T of products, in
another order); bfloat16 2e-2 (p and ds rounded to bf16 from f32 scores
summed in another order can round one bf16 step apart).
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.nn import attention as jattn
from rocket_tpu.ops import flash_native as jfn
from rocket_tpu_torch.bridge import tensor_from_numpy
from rocket_tpu_torch.nn.attention import resolve_impl
from rocket_tpu_torch.ops import _launch
from rocket_tpu_torch.ops import flash_attention as tfa
from rocket_tpu_torch.ops import flash_native as tfn

B, T, H, D, BLOCK = 1, 256, 4, 32, 128
#: Head dims of the parity cases: the MoE char-LM example's 32, Llama's 128
#: and Phi-3-mini's 96 and Phi-2's 80 (which the card runs on heads
#: zero-padded to 128).
HEAD_DIMS = (32, 128, 96, 80)
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
    if fused and jfn._fused_kb(H, d) is None:
        # No 128-lane head block at this D: the reference slices the fused
        # operand (its fused-to-sliced fallback).
        fused, arrs = False, [arrs[0][..., i * H * d:(i + 1) * H * d] for i in range(3)]
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


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_forward_out_and_lse_match_jax(layout, causal, dtype, d):
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


#: (layout, causal, dq_split, d): every combination at D = 32 and 128; at
#: the padded D's one MHA case with the partials and one GQA case with the
#: accumulating dq (the plain versions have no D-specific path; the padding
#: itself runs on the card).
BACKWARD_CASES = [(layout, causal, dq_split, d) for d in (32, 128)
                  for layout in ("fused", "bthd_gqa") for causal in (True, False)
                  for dq_split in (False, True)] + [
    ("fused", True, False, 96), ("bthd_gqa", False, True, 96),
    ("fused", False, False, 80), ("bthd_gqa", True, True, 80)]


@pytest.mark.parametrize("layout,causal,dq_split,d", BACKWARD_CASES)
def test_backward_matches_jax_vjp(layout, causal, dq_split, d):
    """Gradients of the port's autograd Function (the plain fused backward
    with the partial sum, or the plain accumulating dq) against jax.vjp of
    the interpreted kernels with the same dq strategy forced. The fused
    layout covers MHA and its [dq | dk | dv] cotangent, bthd_gqa the
    separate-operand Function with a query group per kv head."""
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


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192])
def test_auto_impl_follows_the_references_head_dim_rule(monkeypatch, d):
    """On an accelerator the reference takes its flash kernel for D <= 128
    and the XLA path above (``rocket_tpu/nn/attention.py:97``); on a CUDA
    device the port takes its flash kernels for D <= 128 (their own at 32,
    64 and 128, the padded next one between) and the plain path above.
    The CPU takes the plain path in both."""
    monkeypatch.setattr(jattn.jax, "devices", lambda: [SimpleNamespace(platform="tpu")])
    monkeypatch.setattr(jattn.jax, "device_count", lambda: 1)     # one chip, no mesh seam
    want = jattn.resolve_impl("auto", T, d)
    got = resolve_impl("auto", d, "cuda")
    assert got == {"flash": "flash", "xla": "plain"}[want]
    assert got == ("flash" if d <= 128 else "plain")
    assert resolve_impl("auto", d, "cpu") == "plain"
    assert resolve_impl("flash", d, "cuda") == "flash"   # explicit impls pass through


def test_padded_head_dims_declare_the_next_compiled_kernel():
    """On meta tensors (the launch audit's route) a D that is not compiled
    runs the next compiled D's kernel on zero-padded heads: the launches
    carry the padded D and feature widths, the results the true D."""
    assert [tfn.kernel_dim(d) for d in (8, 32, 40, 64, 80, 96, 128)] == \
        [32, 32, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="head dim 192"):
        tfn.kernel_dim(192)
    b, t, h, h_kv = 2, 100, 4, 2
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    for d in (80, 96, 128):
        kd = tfn.kernel_dim(d)
        q, k, v, dout = meta(b, t, h * d), meta(b, t, h_kv * d), meta(b, t, h_kv * d), \
            meta(b, t, h * d)
        lse = meta(b, h, t)
        with _launch.record_launches() as facts:
            out, lse_out = tfn.flash_fwd(q, k, v, h, h_kv, d, (0, 0, 0), True)
            dqp, dk, dv = tfn.flash_bwd(q, k, v, dout, lse, lse, h, h_kv, d, (0, 0, 0), True)
            dq = tfn.flash_dq(q, k, v, dout, lse, lse, h, h_kv, d, (0, 0, 0), True)
        assert out.shape == dq.shape == (b, t, h * d) and dk.shape == dv.shape == (b, t, h_kv * d)
        assert dqp.shape == (2, b, t, h * d) and lse_out.shape == (b, h, t)
        want = [tfn.flash_launch(kind, b, t, h, h_kv, kd, torch.float32, h * kd, h_kv * kd)
                for kind in ("flash_fwd", "flash_bwd", "flash_dq")]
        assert facts == want
        qkv = torch.empty(3, b, h, 128, d, device="meta")
        with _launch.record_launches() as facts:
            out, _ = tfa.flash_qkv_fwd(qkv, True, 64, 64)
        assert out.shape == (b, h, 128, d)
        assert facts == [tfa.qkv_launch("fwd", b, h, 128, kd, torch.float32, 64, 64)]


def test_pad_heads_round_trips_and_keeps_the_attention():
    """Zero-padding every head to a wider D leaves q.k, the softmax and the
    first D output features unchanged: the plain forward on padded heads
    at the true D's scale (through a scale-neutral rewrite: q scaled by
    sqrt(kd / d)) equals the forward at D."""
    rng = np.random.default_rng(4)
    b, t, h, h_kv, d = 1, 70, 4, 2, 80
    q = torch.from_numpy(rng.standard_normal((b, t, h * d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, h_kv * d)).astype(np.float32))
            for _ in range(2))
    kd = tfn.kernel_dim(d)
    qp, kp, vp = (tfn.pad_heads(x, 0, n, d, kd) for x, n in ((q, h), (k, h_kv), (v, h_kv)))
    assert qp.shape == (b, t, h * kd) and torch.equal(tfn.unpad_heads(qp, h, d), q)
    assert not qp.reshape(b, t, h, kd)[..., d:].any()
    want, lse = tfn._fwd_plain(q, k, v, h, h_kv, d, (0, 0, 0), True)
    got, lse_p = tfn._fwd_plain(qp * math.sqrt(kd / d), kp, vp, h, h_kv, kd, (0, 0, 0), True)
    torch.testing.assert_close(tfn.unpad_heads(got, h, d), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse_p, lse, atol=1e-5, rtol=1e-5)
