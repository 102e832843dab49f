"""Port parity: ``rocket_tpu_torch.ops.paged_attention`` against
``rocket_tpu.ops.paged_attention`` — its XLA path AND its Pallas kernel in
interpret mode — on the same numpy pools, tables and chunks.

Covered: C = 1 decode and C = chunk prefill, MHA and GQA, padded rows
(valid < C) and table entries pointing at the trash block, f32 and bf16.
Tolerances: float32 1e-5 (same math, another summation order); bfloat16
2e-2 (the attention weights are rounded to bf16 before the PV product on
both sides, but at different points of the flash vs one-shot softmax).
The trash block 0 is excluded from pool comparisons: padded rows collide
there in an unspecified order, in both packages.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and, at the full shapes, ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rocket_tpu.ops import paged_attention as jpa
from rocket_tpu_torch.bridge import tensor_from_numpy
from rocket_tpu_torch.ops import paged_attention as tpa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(c, hq, h_kv, dtype, seed=0):
    """Pools, a table with trash entries, per-slot positions and valid
    counts (slot 2 is half padding; slot 3 starts at 0)."""
    rng = np.random.default_rng(seed)
    s, nb, bl, d, mb = 4, 24, 16, 32, 5
    table = np.zeros((s, mb), np.int32)
    for i in range(s):
        table[i, :4] = 1 + 5 * i + np.arange(4)  # the last entry stays the trash block
    positions = np.asarray([0, 15, 16 * 3 - c, 40], np.int32)[:s]
    positions = np.minimum(positions, 16 * 4 - c)
    valid = np.asarray([c, c, max(1, c // 2), c], np.int32)
    arrays = {
        "q": rng.normal(size=(s, c, hq, d)),
        "k_new": rng.normal(size=(s, c, h_kv, d)),
        "v_new": rng.normal(size=(s, c, h_kv, d)),
        "k_pages": rng.normal(size=(nb, bl, h_kv, d)),
        "v_pages": rng.normal(size=(nb, bl, h_kv, d)),
    }
    jops = {k: jnp.asarray(v.astype(np.float32)).astype(dtype) for k, v in arrays.items()}
    ints = {"block_table": table, "positions": positions, "valid": valid}
    return jops, ints


def _run_jax(jops, ints, **kw):
    out, kp, vp = jpa.paged_attention(
        jops["q"], jops["k_new"], jops["v_new"], jops["k_pages"], jops["v_pages"],
        jnp.asarray(ints["block_table"]), jnp.asarray(ints["positions"]),
        jnp.asarray(ints["valid"]), **kw,
    )
    return [np.asarray(a.astype(jnp.float32)) for a in (out, kp, vp)]


def _run_torch(jops, ints):
    t = {k: tensor_from_numpy(np.asarray(v)) for k, v in jops.items()}
    i = {k: torch.from_numpy(v) for k, v in ints.items()}
    out, kp, vp = tpa.paged_attention(
        t["q"], t["k_new"], t["v_new"], t["k_pages"], t["v_pages"],
        i["block_table"], i["positions"], i["valid"],
    )
    assert kp is t["k_pages"] and vp is t["v_pages"]  # updated in place
    return [a.float().numpy() for a in (out, kp, vp)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,h_kv", [(4, 4), (6, 2)])
@pytest.mark.parametrize("c", [1, 8])
def test_plain_attend_matches_jax_xla_and_pallas(c, hq, h_kv, dtype):
    jops, ints = _case(c, hq, h_kv, dtype)
    got = _run_torch(jops, ints)
    impls = [dict(impl="xla")]
    if c == 1:
        impls.append(dict(impl="pallas", interpret=True))  # the TPU kernel, interpreted
    for kw in impls:
        ref = _run_jax(jops, ints, **kw)
        # Padded query rows are garbage by contract: compare the real rows.
        for s, n in enumerate(ints["valid"]):
            np.testing.assert_allclose(got[0][s, :n], ref[0][s, :n], atol=TOL[dtype],
                                       rtol=TOL[dtype], err_msg=str(kw))
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g[1:], r[1:])


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    jops, ints = _case(1, 6, 2, "float32", seed=3)
    t = {k: tensor_from_numpy(np.asarray(v)) for k, v in jops.items()}
    i = {k: torch.from_numpy(v) for k, v in ints.items()}
    before = tpa.paged_decode.launches
    got = tpa.paged_decode(t["q"][:, 0], t["k_pages"], t["v_pages"],
                           i["block_table"], i["positions"])
    want = tpa.attend_plain(t["q"], t["k_pages"], t["v_pages"],
                            i["block_table"], i["positions"]).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tpa.paged_decode.launches == before


def test_write_kv_pages_routes_padding_to_trash():
    jops, ints = _case(8, 4, 4, "float32", seed=5)
    t = {k: tensor_from_numpy(np.asarray(v)) for k, v in jops.items()}
    before = t["k_pages"].clone()
    i = {k: torch.from_numpy(v) for k, v in ints.items()}
    tpa.write_kv_pages(t["k_pages"], t["v_pages"], i["block_table"], i["positions"],
                       i["valid"], t["k_new"], t["v_new"])
    # Slot 2 wrote only its first valid rows; its padded rows hit block 0 only.
    pos0, n = int(ints["positions"][2]), int(ints["valid"][2])
    table = ints["block_table"][2]
    for r in range(8):
        p = pos0 + r
        row = t["k_pages"][table[p // 16], p % 16]
        if r < n:
            torch.testing.assert_close(row, t["k_new"][2, r])
        else:
            torch.testing.assert_close(row, before[table[p // 16], p % 16])

