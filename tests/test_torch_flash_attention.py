"""Port parity: ``rocket_tpu_torch.ops.flash_attention`` (rows 6-7) against
``rocket_tpu.ops.flash_attention`` run in Pallas interpret mode on the CPU.

The port's CPU path is the kernels' plain versions (``_fwd_plain``,
``_bwd_plain``) behind the same autograd Function the card runs. Inputs
come from a numpy seed (B <= 2, H = 2, T = 256); both packages run
``block_q = block_k = 128`` (two k-blocks, so the dq partials are summed),
plus one non-causal f32 call where the reference pins 256/128 and the port
resolves 128/128 (its largest compiled tile). Head dims 32, 64, 128, 96
and 80; at D = 128 (and the D's the card pads to it) the port runs its one
compiled tile pair, 64 x 64, against the reference at 128 x 128 in f32
and at 64 x 64 in bf16 (where the dq partials round per block). Gradients: ``jax.grad``
against torch autograd of ``sum(out * w)`` for one random ``w``.

Tolerances: float32 1e-5 on the forward (the same f32 math, blockwise vs
whole-row softmax) and 1e-4 on gradients (sums over T in another order);
bfloat16 2e-2 * (1 + |want|) per element (p and ds rounded to bf16 from
f32 scores summed in another order can land one bf16 step apart; the dq
partials round at the same 128-row blocks in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.ops import flash_attention as jfa
from rocket_tpu_torch.ops import flash_attention as tfa

T, H = 256, 2
TOL_FWD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}


def _operands(b, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(3, b, H, T, d)).astype(np.float32)
    w = rng.normal(size=(b, H, T, d)).astype(np.float32)
    return qkv, w


def _jax(qkv, w, dtype, causal, bq, bk):
    q, k, v = (jnp.asarray(x).astype(dtype) for x in qkv)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
        return (out.astype(jnp.float32) * jnp.asarray(w)).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch(qkv, w, dtype, causal, bq, bk):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_() for x in qkv)
    out = tfa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy() for x in (out, q.grad, k.grad, v.grad)]


def _assert_close(got, want, tol, what):
    excess = np.abs(got - want) - tol * (1.0 + np.abs(want))
    assert excess.max() <= 0.0, f"{what}: off by {excess.max()} more than {tol} * (1 + |want|)"


def _compare(b, d, dtype_name, causal, jblocks, tblocks, seed=0):
    qkv, w = _operands(b, d, seed)
    want = _jax(qkv, w, getattr(jnp, dtype_name), causal, *jblocks)
    got = _torch(qkv, w, getattr(torch, dtype_name), causal, *tblocks)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        tol = TOL_FWD[dtype_name] if name == "out" else TOL_GRAD[dtype_name]
        if dtype_name == "float32":
            np.testing.assert_allclose(g, x, atol=tol, rtol=0, err_msg=name)
        else:
            _assert_close(g, x, tol, name)


def _port_blocks(d):
    """The port's tiles at head dim d: 128 x 128 up to D = 64, the one
    compiled 64 x 64 pair at D = 128 (and the D's padded to it)."""
    return (128, 128) if d <= 64 else (64, 64)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 96, 80])
def test_f32_matches_the_jax_kernel(causal, d):
    _compare(2, d, "float32", causal, (128, 128), _port_blocks(d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_the_jax_kernel(causal, d):
    _compare(1, d, "bfloat16", causal, _port_blocks(d), _port_blocks(d), seed=1)


def test_pinned_tpu_blocks_resolve_to_compiled_tiles():
    """The reference pins 256/128 (non-causal); the port gets 128/128."""
    assert tfa.resolve_tuned_blocks(T, 64, H, H, torch.float32, False, 256, 128, None,
                                    None) == (128, 128, 128, 128)
    _compare(2, 64, "float32", False, (256, 128), (256, 128), seed=2)


def test_pick_block_and_default():
    assert tfa.DEFAULT_BLOCK == 128
    assert tfa.pick_block(1024, 512) == 128
    assert tfa.pick_block(1024, 64) == 64
    assert tfa.pick_block(192, 128) == 64
    assert tfa.pick_block(100) is None
    assert tfa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, True, 64, 128, None,
                                    None) == (64, 64, 64, 64)  # causal: square


def test_wrappers_take_the_plain_versions_on_cpu():
    """The CPU wrappers are the plain versions; the dq partials are one per
    block_k rows, zero above the causal diagonal, and sum to the gradient
    the autograd Function returns."""
    qkv = torch.from_numpy(_operands(1, 32, 3)[0]).requires_grad_()
    out, lse = tfa.flash_qkv_fwd(qkv.detach(), True, 64, 64)
    want_out, want_lse = tfa._fwd_plain(qkv.detach(), True, 64, 64)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert lse.shape == (1, H, 1, T)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    delta = (out * dout).sum(-1).unsqueeze(2)
    dqp, dk, dv = tfa.flash_qkv_bwd(qkv.detach(), out, lse, dout, delta, True, 64, 64)
    assert dqp.shape == (T // 64, 1, H, T, 32)
    assert torch.count_nonzero(dqp[3, :, :, :192]) == 0   # k-tile 3 sees q rows >= 192
    tfa.flash_attention_qkv(qkv, True, 64, 64).backward(dout)
    torch.testing.assert_close(qkv.grad, torch.stack([dqp.sum(0), dk, dv]))


def test_entry_errors():
    x = torch.zeros(1, H, T, 64)
    with pytest.raises(ValueError, match="expected stacked"):
        tfa.flash_attention_qkv(torch.zeros(2, 1, H, T, 64))
    with pytest.raises(ValueError, match="causal requires t_q == t_kv"):
        tfa.flash_attention(x, torch.zeros(1, H, 2 * T, 64), torch.zeros(1, H, 2 * T, 64))
    with pytest.raises(ValueError, match="share one shape"):
        tfa.flash_attention(x, x, torch.zeros(1, H, T, 32), causal=False)
    with pytest.raises(ValueError, match="supported block size"):
        tfa.flash_attention(*(torch.zeros(1, H, 200, 64),) * 3)
    with pytest.raises(ValueError, match="supported block size"):
        tfa.flash_attention(*(torch.zeros(1, H, 192, 64),) * 3)  # 64 divides, 128 does not
    with pytest.raises(ValueError, match="block_q == block_k"):
        tfa.flash_qkv_fwd(torch.stack([x, x, x]), True, 64, 128)
    with pytest.raises(ValueError, match="head dim 192"):  # past 128: no kernel
        tfa.flash_attention(*(torch.zeros(1, H, T, 192),) * 3)
