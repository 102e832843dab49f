"""Port parity: ``rocket_tpu_torch.ops.decode_attention``'s plain version
against ``rocket_tpu.ops.decode_attention`` (the Pallas kernel in
interpret mode) at T = 128, MHA and GQA, f32 and bf16, with the cache row
written in place.

Tolerances: float32 1e-5 (the same math); bfloat16 2e-2 (the inputs are
the same bf16 values; the products round at different points).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rocket_tpu.ops import decode_attention as jda
from rocket_tpu_torch.bridge import tensor_from_numpy
from rocket_tpu_torch.ops import decode_attention as tda

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(hq, h_kv, dtype, seed=0, t_max=128, b=2, d=32):
    rng = np.random.default_rng(seed)
    shapes = {"q": (b, hq, d), "k_new": (b, h_kv, d), "v_new": (b, h_kv, d),
              "k_cache": (b, h_kv, t_max, d), "v_cache": (b, h_kv, t_max, d)}
    return {k: jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)
            for k, s in shapes.items()}


def _torch(jops, device="cpu"):
    return {k: tensor_from_numpy(np.asarray(v), device) for k, v in jops.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,h_kv", [(4, 4), (6, 2)])
@pytest.mark.parametrize("pos", [0, 37, 127])
def test_plain_matches_jax_kernel_interpreted(pos, hq, h_kv, dtype):
    jops = _case(hq, h_kv, dtype, seed=pos)
    t = _torch(jops)
    k_cache, v_cache = t["k_cache"], t["v_cache"]
    ref = jda.decode_attention(jops["q"], jops["k_new"], jops["v_new"], jops["k_cache"],
                               jops["v_cache"], pos, interpret=True)
    got = tda.decode_attention(t["q"], t["k_new"], t["v_new"], k_cache, v_cache, pos)
    assert got[1] is k_cache and got[2] is v_cache  # row written in place
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r.astype(jnp.float32)))


def test_validation_and_cpu_counts_nothing():
    t = _torch(_case(4, 2, "float32"))
    before = tda.decode_attention.launches
    tda.decode_attention(t["q"], t["k_new"], t["v_new"], t["k_cache"], t["v_cache"], 3)
    assert tda.decode_attention.launches == before
    with pytest.raises(ValueError, match="pos"):
        tda.decode_attention(t["q"], t["k_new"], t["v_new"], t["k_cache"], t["v_cache"], 128)
    assert tda.decode_attention_supported(64) and tda.decode_attention_supported(256)
    assert not tda.decode_attention_supported(60) and not tda.decode_attention_supported(264)

