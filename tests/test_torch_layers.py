"""Port parity: the decode-path layers of ``rocket_tpu_torch.nn`` against
``rocket_tpu.nn`` on the same numpy inputs and weights.

Tolerances: float32 to 1e-5 (the same math; only the summation order of
the two CPU backends differs), bfloat16 to 2e-2 (one bf16 rounding, about
4e-3 relative, at a few places where the two frameworks round apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rocket_tpu.nn import attention as jattn
from rocket_tpu.nn import layers as jl
from rocket_tpu_torch.bridge import tensor_from_numpy
from rocket_tpu_torch.nn import attention as tattn
from rocket_tpu_torch.nn import layers as tl

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(x_np, dtype):
    """The same input as a jax array and a torch tensor of ``dtype``."""
    jx = jnp.asarray(x_np).astype(dtype)
    return jx, tensor_from_numpy(np.asarray(jx))


def _close(got: torch.Tensor, ref, dtype, tol=None):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
        atol=tol or TOL[dtype], rtol=tol or TOL[dtype],
    )


def _params(jparams):
    return {k: tensor_from_numpy(np.asarray(v)) for k, v in jparams.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense(dtype, use_bias):
    rng = np.random.default_rng(0)
    layer = jl.Dense(24, 40, use_bias=use_bias)
    p = {"w": rng.normal(size=(24, 40)).astype(np.float32) * 0.2}
    if use_bias:
        p["b"] = rng.normal(size=(40,)).astype(np.float32)
    jx, tx = _pair(rng.normal(size=(3, 5, 24)).astype(np.float32), dtype)
    ref, _ = layer.apply({"params": p, "state": {}}, jx)
    got = tl.Dense(24, 40, use_bias=use_bias)(_params(p), tx)
    assert got.dtype == tx.dtype  # w/b cast to x.dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms(dtype, norm):
    rng = np.random.default_rng(1)
    d = 48
    if norm == "layernorm":
        jlayer, tlayer = jl.LayerNorm(d), tl.LayerNorm(d)
        p = {"scale": rng.normal(size=d).astype(np.float32),
             "bias": rng.normal(size=d).astype(np.float32)}
        assert tlayer.eps == jlayer.eps == 1e-5
    else:
        jlayer, tlayer = jl.RMSNorm(d), tl.RMSNorm(d)
        p = {"scale": rng.normal(size=d).astype(np.float32)}
        assert tlayer.eps == jlayer.eps == 1e-6
    jx, tx = _pair(rng.normal(loc=3.0, size=(4, 7, d)).astype(np.float32), dtype)
    ref, _ = jlayer.apply({"params": p, "state": {}}, jx)
    got = tlayer(_params(p), tx)
    assert got.dtype == tx.dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_embedding_dropout(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(scale=3.0, size=(6, 33)).astype(np.float32), dtype)
    # jax.nn.gelu is the tanh approximation; the exact erf form differs by ~1e-3.
    _close(tl.gelu(tx), jl.gelu().fn(jx), dtype)
    _close(tl.silu(tx), jl.silu().fn(jx), dtype)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    ref, _ = jl.Embedding(50, 16).apply({"params": {"table": table}, "state": {}},
                                        jnp.asarray(ids))
    got = tl.Embedding(50, 16)({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    _close(got, ref, "float32", tol=0.0)
    assert tl.Dropout(0.1)({}, tx) is tx  # eval semantics: the identity


def test_init_layouts_match_jax():
    """Port init draws the same param tree shapes (from a torch.Generator)."""
    gen = torch.Generator().manual_seed(0)
    for jlayer, tlayer in [
        (jl.Dense(8, 12), tl.Dense(8, 12)),
        (jl.LayerNorm(8), tl.LayerNorm(8)),
        (jl.RMSNorm(8), tl.RMSNorm(8)),
        (jl.Embedding(10, 8), tl.Embedding(10, 8)),
        (jattn.MultiHeadAttention(16, 4, num_kv_heads=2),
         tattn.MultiHeadAttention(16, 4, num_kv_heads=2)),
    ]:
        ref = jax.tree.map(np.shape, jlayer.init(jax.random.key(0))["params"])
        got = jax.tree.map(lambda t: tuple(t.shape), tlayer.init_params(gen))
        assert got == ref, (jlayer, got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(tattn.apply_rope(tx, 7, 500.0), jattn.apply_rope(jx, 7, 500.0), dtype)
    offsets = np.asarray([0, 4, 11], np.int32)
    jy, ty = _pair(x.transpose(1, 2, 0, 3), dtype)   # (B=3, T=5, H=2, D)
    _close(tattn.apply_rope_offsets(ty, torch.from_numpy(offsets)),
           jattn.apply_rope_offsets(jy, jnp.asarray(offsets)), dtype)


@pytest.mark.parametrize("rope,h_kv", [(False, 4), (True, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_cached(rope, h_kv, dtype):
    """Prefill (S > 1) then one S = 1 step through the dense KV cache: the
    outputs and the caches match the JAX layer (CPU: the einsum path)."""
    rng = np.random.default_rng(4)
    jlayer = jattn.MultiHeadAttention(32, 4, num_kv_heads=h_kv, rope=rope)
    tlayer = tattn.MultiHeadAttention(32, 4, num_kv_heads=h_kv, rope=rope)
    p = jax.tree.map(np.asarray, jlayer.init(jax.random.key(3))["params"])
    tp = {k: _params(v) for k, v in p.items()}
    b, t_max, plen = 2, 12, 5
    jdt = jnp.dtype(dtype)
    jcache = jlayer.init_cache(b, t_max, jdt)
    tcache = tlayer.init_cache(b, t_max, getattr(torch, dtype))
    x = rng.normal(size=(b, plen + 1, 32)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jstep = jax.jit(jlayer.apply_cached)
    ref, jcache = jstep(p, jx[:, :plen], jcache, 0)
    got, tcache = tlayer.apply_cached(tp, tx[:, :plen], tcache, 0)
    _close(got, ref, dtype)
    ref, jcache = jstep(p, jx[:, plen:], jcache, plen)
    got, tcache = tlayer.apply_cached(tp, tx[:, plen:], tcache, plen)
    _close(got, ref, dtype)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], dtype)
