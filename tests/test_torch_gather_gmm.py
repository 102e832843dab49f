"""The port's grouped matrix products against the JAX package, on the CPU.

* ``padded_group_layout`` and the expert-per-tile lookup: the same
  integers as the reference, with an empty expert, ``tile_m`` 8 and 16,
  with and without ``sorted_expert``.
* ``gather_gmm`` (the kernel's plain version under the reference
  composition's backward) against JAX ``gather_gmm(..., interpret=True)``
  at the reference test's shapes (``tests/test_fused_kernels.py``), values
  and both gradients.
* ``grouped_matmul`` against JAX ``_grouped_matmul`` (``ragged_dot`` on the
  CPU) with unaligned, empty and full groups and rows past the groups,
  values and grads; ``gmm_reference`` in both modes and ``tgmm_reference``
  against the cotangents of that product.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, float32: rtol = atol = 2e-5, the reference test's own (the
same f32 products summed in another order). The kernels' launch counts
stay 0: on CPU tensors every wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.nn.moe import _grouped_matmul as j_grouped_matmul
from rocket_tpu.ops import gather_gmm as jg
from rocket_tpu_torch.ops import gather_gmm as tg
from rocket_tpu_torch.ops import grouped_matmul as tgm

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under parallel test workers: one intra-op thread each
    (torch's default of one per core oversubscribes the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches():
    before = (tg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches)
    yield
    assert (tg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches) == before


def _routing(pair_expert, e):
    """(sorted_token, counts, sorted_expert) of a stable sort by expert."""
    pair_expert = np.asarray(pair_expert, np.int32)
    order = np.argsort(pair_expert, kind="stable")
    return (order.astype(np.int32), np.bincount(pair_expert, minlength=e).astype(np.int32),
            pair_expert[order])


def _t(a):
    return torch.from_numpy(np.array(a))


ROUTINGS = {
    "random": (np.random.default_rng(1).integers(0, 4, size=50), 4),
    "empty_expert": ([0] * 11 + [3] * 13, 4),
    "one_expert": ([2] * 16, 3),
}


@pytest.mark.parametrize("tile_m", [8, 16])
@pytest.mark.parametrize("with_expert", [False, True])
@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_padded_group_layout_matches_jax(routing, with_expert, tile_m):
    pair_expert, e = ROUTINGS[routing]
    sorted_token, counts, sorted_expert = _routing(pair_expert, e)
    nk = len(sorted_token)
    want = jg.padded_group_layout(jnp.asarray(counts), jnp.asarray(sorted_token), tile_m, nk,
                                  sorted_expert=jnp.asarray(sorted_expert) if with_expert
                                  else None)
    got = tg.padded_group_layout(_t(counts), _t(sorted_token), tile_m, nk,
                                 sorted_expert=_t(sorted_expert) if with_expert else None)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tg.expert_per_tile(got[1], tile_m, got[3]).numpy(),
                                  np.asarray(jg._expert_per_tile(want[1], tile_m, want[3])))


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(cot))))


def _torch_vjp(fn, args, cot):
    leaves = [_t(a).requires_grad_() for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, _t(cot))
    return (out.detach().numpy(), *[g.numpy() for g in grads])


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tile_m,tile_n", [(8, 128), (16, 128), (16, 256)])
def test_gather_gmm_values_and_grads_match_jax(tile_m, tile_n):
    rng = np.random.default_rng(7)
    n_tok, k, n_out, e = 48, 64, 256, 3
    x = (rng.normal(size=(n_tok, k)) * 0.2).astype(np.float32)
    rhs = (rng.normal(size=(e, k, n_out)) * 0.2).astype(np.float32)
    sorted_token, counts, _ = _routing(rng.integers(0, e, size=n_tok), e)
    row_ids, gsz, padded_pos, m = jg.padded_group_layout(
        jnp.asarray(counts), jnp.asarray(sorted_token), tile_m, n_tok)
    cot = rng.normal(size=(n_tok, n_out)).astype(np.float32)
    want = _jax_vjp(lambda a, b: jg.gather_gmm(a, b, row_ids, gsz, tile_m=tile_m, tile_n=tile_n,
                                               interpret=True)[padded_pos], (x, rhs), cot)
    ids, sizes, pos = (_t(np.asarray(v)) for v in (row_ids, gsz, padded_pos))
    got = _torch_vjp(lambda a, b: tg.gather_gmm(a, b, ids, sizes, tile_m=tile_m,
                                                tile_n=tile_n)[pos.long()], (x, rhs), cot)
    _close(got, want)


def test_gather_gmm_plain_version_is_the_explicit_gather():
    """The tile-by-tile plain version equals ``gmm_reference`` over the
    gathered rows (each tile lies in one padded group), rows of an empty
    expert included."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(24, 16)).astype(np.float32))
    rhs = _t(rng.normal(size=(4, 16, 128)).astype(np.float32))
    sorted_token, counts, _ = _routing([0] * 11 + [3] * 13, 4)
    row_ids, gsz, _, _ = tg.padded_group_layout(_t(counts), _t(sorted_token), 8, 24)
    got = tg.gather_gmm_reference(x, rhs, row_ids, gsz, 8)
    torch.testing.assert_close(got, tgm.gmm_reference(x[row_ids.long()], rhs, gsz),
                               rtol=TOL, atol=TOL)


def test_gather_gmm_refuses_shapes_the_reference_refuses():
    x = torch.zeros(8, 12)
    rhs = torch.zeros(2, 12, 128)
    ids, sizes = torch.zeros(16, dtype=torch.int32), torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="does not tile"):
        tg.gather_gmm(x, rhs, ids, sizes, tile_m=8)
    with pytest.raises(ValueError, match="K mismatch"):
        tg.gather_gmm(torch.zeros(8, 16), rhs, ids, sizes, tile_m=8)
    assert tg.gather_gmm_supported(768, 3072, 512) and not tg.gather_gmm_supported(768, 3072, 96)


GROUPS = {
    "unaligned_empty": ([0, 13, 27, 0], 40),
    "full": ([40, 0, 0, 0], 40),
    "past_the_groups": ([5, 10, 15, 7], 40),
    "many_small": ([3, 1, 0, 4], 8),
}


@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_grouped_matmul_values_and_grads_match_jax(groups):
    sizes, m = GROUPS[groups]
    rng = np.random.default_rng(len(groups))
    k, n = 24, 40
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    rhs = rng.normal(size=(4, k, n)).astype(np.float32)
    cot = rng.normal(size=(m, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = _jax_vjp(lambda a, b: j_grouped_matmul(a, b, jnp.asarray(gs)), (lhs, rhs), cot)
    got = _torch_vjp(lambda a, b: tgm.grouped_matmul(a, b, _t(gs)), (lhs, rhs), cot)
    _close(got, want)
    # The kernels' plain versions give the same values and cotangents:
    # gmm forward, gmm with the transposed rhs (dlhs), tgmm (drhs).
    g_out = tgm.gmm_reference(_t(lhs), _t(rhs), _t(gs))
    g_dlhs = tgm.gmm_reference(_t(cot), _t(rhs), _t(gs), transpose_rhs=True)
    g_drhs = tgm.tgmm_reference(_t(lhs), _t(cot), _t(gs))
    # Rows past the groups carry no cotangent into the lhs.
    g_dlhs[int(min(gs.sum(), m)):] = 0
    _close((g_out.numpy(), g_dlhs.numpy(), g_drhs.numpy()), want)
    # The transposed mode reads rhs (E, N, K).
    torch.testing.assert_close(
        tgm.gmm_reference(_t(cot), _t(rhs).transpose(1, 2).contiguous(), _t(gs)),
        tgm.gmm_reference(_t(cot), _t(rhs), _t(gs), transpose_rhs=True), rtol=TOL, atol=TOL)


def test_grouped_matmul_bf16_casts_after_f32_accumulation():
    rng = np.random.default_rng(9)
    lhs = rng.normal(size=(16, 32)).astype(np.float32)
    rhs = rng.normal(size=(2, 32, 16)).astype(np.float32)
    gs = np.asarray([9, 7], np.int32)
    want = j_grouped_matmul(jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16),
                            jnp.asarray(gs))
    got = tgm.grouped_matmul(_t(lhs).bfloat16(), _t(rhs).bfloat16(), _t(gs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
