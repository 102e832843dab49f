"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The module imports neither JAX nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-4 (the same math in another order); bfloat16 2e-2
(the decode plain versions round the attention weights to bf16 before the
PV product where the decode kernels keep them in float32; the flash
kernels and their plain versions both round p and ds to bf16, but from
scores summed in another order, so a rounding can flip by one bf16 step;
the fused-block kernel rounds xn, qkv, the weights and the heads to bf16
where its plain version does, from sums in another order). The paged
decode kernel is also held to two calls bitwise: its splits combine in a
fixed order. The flash and
fused-block checks hold every element to ``tol * (1 + |want|)``, and
every flash kernel to two launches bitwise (no atomics anywhere). The
fused BatchNorm kernels are held to the reference's own bound for them,
f32 ``5e-5 + 5e-5 * |want|`` (the moments are reassociated f32 sums), and
bf16 y to ``2e-2 * (1 + |want|)`` (one bf16 rounding). The MoE grouped
products (``gmm``, ``tgmm``, ``gather_gmm``) hold every element to
``tol * (1 + |want|)``: f32 sums in another order, and in bf16 one
rounding of the f32 accumulator that may flip by one step. Rows 6-7 (the
stacked-qkv flash kernels) hold every element to ``tol * (1 + |want|)``
as the other flash kernels do; their dq partials are compared through
their f32 sum. Rows 3-8 in bf16 run on the tensor cores and are held to
the same bounds, plus two launches bitwise; so do bf16 ``gmm`` and row
11, on wgmma. Rows 3-7 also run at head dim 128 and at D's the wrappers
zero-pad to 128 (96, 80; 40 to 64), against their plain versions at the
true D. The bucketed gradient reduction of ``parallel/grad_sync.py`` runs
on CUDA tensors over a two-rank gloo group and equals the f32 all-reduce
bitwise under ``wire_dtype=None``; over such a group the tensor-parallel
ring (its CUDA chunks staged through host memory) gives the bulk
collectives' forward and gradients.
"""

import pytest
import torch

from rocket_tpu_torch.ops import decode_attention as tda
from rocket_tpu_torch.ops import flash_attention as tfa
from rocket_tpu_torch.ops import flash_native as tfn
from rocket_tpu_torch.ops import fused_block as tfb
from rocket_tpu_torch.ops import fused_conv as tfc
from rocket_tpu_torch.ops import gather_gmm as tgg
from rocket_tpu_torch.ops import grouped_matmul as tgm
from rocket_tpu_torch.ops import paged_attention as tpa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen).to(dtype).cuda()


#: Slot positions per context: a short table (MB * BL = 144, three splits)
#: and a long one (MB * BL = 4096, 64 splits): 0, one row before, at and
#: after a split boundary (64 rows), and the table's last row. Every slot's
#: table points past its live pages at block 0.
PAGED_POSITIONS = {9: [0, 15, 16, 100, 143], 256: [0, 63, 64, 65, 1000, 4095]}


@pytest.mark.cuda
@pytest.mark.parametrize("mb", sorted(PAGED_POSITIONS), ids=lambda mb: f"mb{mb}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,h_kv,d", [(12, 12, 64), (12, 4, 64), (6, 2, 128), (4, 4, 40),
                                       (12, 4, 256)])
def test_paged_decode_matches_plain(cuda, hq, h_kv, d, dtype, mb):
    gen = torch.Generator().manual_seed(hq * 100 + h_kv + d + mb)
    bl = 16
    positions = torch.tensor(PAGED_POSITIONS[mb], dtype=torch.int32)
    s = len(positions)
    nb = 1 + s * mb
    table = torch.zeros((s, mb), dtype=torch.int32)
    for i, p in enumerate(positions.tolist()):
        live = p // bl + 1
        table[i, :live] = 1 + i * mb + torch.randperm(mb, generator=gen)[:live].to(torch.int32)
    q = _randn(gen, dtype, s, hq, d)
    kp, vp = _randn(gen, dtype, nb, bl, h_kv, d), _randn(gen, dtype, nb, bl, h_kv, d)
    args = (q, kp, vp, table.cuda(), positions.cuda())
    before = tpa.paged_decode.launches
    got = tpa.paged_decode(*args)
    again = tpa.paged_decode(*args)
    assert tpa.paged_decode.launches == before + 2
    assert torch.equal(got, again)  # the splits combine in a fixed order
    torch.testing.assert_close(got.float(), tpa.paged_decode_plain(*args).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_paged_decode_rejects_bad_operands(cuda):
    q = torch.zeros(2, 4, 64, device=cuda)
    pages = torch.zeros(3, 16, 4, 64, device=cuda)
    table = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tpa.paged_decode(q.half(), pages.half(), pages.half(), table, pos)
    with pytest.raises(ValueError):
        tpa.paged_decode(q, pages, pages, table.long(), pos)
    with pytest.raises(ValueError):
        tpa.paged_decode(q.transpose(0, 1).contiguous().transpose(0, 1), pages, pages, table, pos)


@pytest.mark.cuda
def test_a_traced_serve_window_parses_to_the_paged_decode_counter(cuda, tmp_path):
    """A ``capture_trace`` window over a small engine's ticks: the
    ``paged_decode`` calls that ``obs/prof.parse_trace`` files under the
    window's ``serve_tick`` steps (joined by correlation id) equal the
    launch counter's change over the window, one per layer per wave."""
    import numpy as np

    from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from rocket_tpu_torch.obs import prof
    from rocket_tpu_torch.serve import ServeConfig, ServeEngine

    model = TransformerLM(TransformerConfig(vocab_size=128, max_seq_len=128, dim=64,
                                            num_layers=2, num_heads=4))
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    engine = ServeEngine(model, params, ServeConfig(max_slots=4, block_len=16, prefill_chunk=16),
                         device=cuda)
    engine.capture_trace((6, 12), str(tmp_path))
    for n in (5, 17, 30, 9):
        engine.submit(np.arange(n, dtype=np.int32) % 128, max_new_tokens=24)
    marks = {}
    while not engine.scheduler.idle:
        if engine._ticks in (6, 12):
            marks[engine._ticks] = (tpa.paged_decode.launches, engine.engine.decode_waves)
        engine.step()
    engine.finish_trace()
    summary = prof.parse_trace(prof.load_trace_events(engine.trace_file))
    launches, waves = (marks[12][i] - marks[6][i] for i in (0, 1))
    assert [s.step for s in summary.steps] == list(range(6, 12))
    assert summary.step_launches("paged_decode") == launches == 2 * waves > 0
    paged = {op.name for op in summary.ops if op.module == "paged_decode"}
    assert paged == {"paged_split_kernel", "paged_combine_kernel"}
    assert all(op.category == "compute" for op in summary.ops if op.module)


#: Row 2's positions: the first row, the rows around the first 64-row split
#: boundary, generate()'s last row at T = 192, and the cache's last row.
DECODE_POSITIONS = (0, 63, 64, 191, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_max", [100, 192, 1024])
@pytest.mark.parametrize("hq,h_kv,d", [(12, 12, 64), (12, 4, 64), (12, 12, 32), (12, 4, 128),
                                       (8, 2, 256), (8, 4, 32)])
def test_decode_attention_matches_plain(cuda, hq, h_kv, d, t_max, dtype):
    """Row 2 (split over 64-row chunks, then a fixed-order combine) against
    its plain version at positions on both sides of a split boundary and at
    the cache's last row, with T not a multiple of 64; the written cache
    rows bitwise, one count per call, and two calls giving the same bits."""
    gen = torch.Generator().manual_seed(hq + h_kv + d + t_max)
    b = 3
    ops = [_randn(gen, dtype, *shape) for shape in
           [(b, hq, d), (b, h_kv, d), (b, h_kv, d), (b, h_kv, t_max, d), (b, h_kv, t_max, d)]]
    twin = [t.clone() for t in ops]
    for pos in sorted({p % t_max for p in DECODE_POSITIONS if p < t_max}):
        before = tda.decode_attention.launches
        got = tda.decode_attention(*ops, pos)
        again = tda.decode_attention(*ops, pos)
        assert tda.decode_attention.launches == before + 2
        assert torch.equal(got[0], again[0])  # the splits combine in a fixed order
        want = tda.decode_attention_plain(*twin, pos)
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_decode_attention_rejects_misaligned_operands(cuda):
    """The split CTAs copy cache rows and the new rows in 16-byte pieces: a
    cache at an odd element offset raises; an aligned one runs."""
    b, h, t, d = 2, 4, 100, 64
    q, new = torch.zeros(b, h, d, device=cuda), torch.zeros(b, h, d, device=cuda)
    buf = torch.zeros(b * h * t * d + 1, device=cuda)
    odd = buf[1:].view(b, h, t, d)
    with pytest.raises(ValueError):
        tda.decode_attention(q, new, new, odd, odd.clone(), 5)
    cache = buf[:-1].view(b, h, t, d)
    tda.decode_attention(q, new, new, cache, cache.clone(), 5)


# -- flash attention: forward, fused backward, accumulating dq ---------------

FLASH_CASES = [  # (B, T, Hq, Hkv, D, causal)
    (2, 256, 4, 4, 64, True),
    (2, 200, 4, 2, 64, True),
    (1, 130, 4, 1, 64, False),
    (2, 96, 2, 2, 64, True),
    (1, 64, 4, 4, 64, False),
    (4, 128, 4, 4, 32, True),   # the MoE char-LM example's head dim
    (2, 100, 4, 2, 32, False),
    (2, 200, 4, 2, 128, True),  # Llama-2/3's head dim
    (1, 130, 4, 4, 128, False),
    (2, 256, 4, 4, 96, True),   # Phi-3-mini's, on heads zero-padded to 128
    (2, 100, 4, 2, 80, False),  # Phi-2's, padded to 128
    (1, 64, 2, 2, 40, True),    # padded to 64
]


def _flash_operands(gen, dtype, b, t, hq, h_kv, d, fused):
    """(q_arr, k_arr, v_arr, offsets): one fused (B, T, 3HD) operand for
    MHA cases with ``fused``, else three bthd operands."""
    if fused:
        arr = _randn(gen, dtype, b, t, 3 * hq * d)
        return arr, arr, arr, (0, hq * d, 2 * hq * d)
    return (_randn(gen, dtype, b, t, hq * d), _randn(gen, dtype, b, t, h_kv * d),
            _randn(gen, dtype, b, t, h_kv * d), (0, 0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "b{}t{}h{}kv{}d{}{}".format(
    *c[:5], "c" if c[5] else "n"))
def test_flash_kernels_match_plain(cuda, case, dtype):
    b, t, hq, h_kv, d, causal = case
    gen = torch.Generator().manual_seed(t + hq + d)
    for fused in ([True, False] if hq == h_kv else [False]):
        q, k, v, offs = _flash_operands(gen, dtype, b, t, hq, h_kv, d, fused)
        geo = (hq, h_kv, d, offs, causal)
        before = tfn.flash_fwd.launches
        out, lse = tfn.flash_fwd(q, k, v, *geo)
        assert tfn.flash_fwd.launches == before + 1
        out_p, lse_p = tfn._fwd_plain(q, k, v, *geo)
        torch.testing.assert_close(out.float(), out_p.float(), atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(lse, lse_p, atol=TOL[dtype], rtol=TOL[dtype])

        dout = _randn(gen, dtype, b, t, hq * d)
        delta = (dout.float() * out.float()).reshape(b, t, hq, d).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous(), *geo)
        dqp, dk, dv = tfn.flash_bwd(*args, with_dq=True)
        dqp_p, dk_p, dv_p = tfn._bwd_plain(*args, with_dq=True)
        torch.testing.assert_close(dqp, dqp_p, atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(dk.float(), dk_p.float(), atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(dv.float(), dv_p.float(), atol=TOL[dtype], rtol=TOL[dtype])
        dqp2, dk2, dv2 = tfn.flash_bwd(*args, with_dq=True)
        assert torch.equal(dqp2, dqp) and torch.equal(dk2, dk) and torch.equal(dv2, dv)
        none, dk2, dv2 = tfn.flash_bwd(*args, with_dq=False)
        none2, dk3, dv3 = tfn.flash_bwd(*args, with_dq=False)
        assert none is None and none2 is None
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
        assert torch.equal(dk3, dk) and torch.equal(dv3, dv)
        dq = tfn.flash_dq(*args)
        assert torch.equal(tfn.flash_dq(*args), dq)
        torch.testing.assert_close(dq.float(), tfn._dq_plain(*args).float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        torch.testing.assert_close(dq.float(), dqp.sum(0), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_rejects_bad_operands(cuda):
    q = torch.zeros(1, 64, 4 * 64, device=cuda)
    with pytest.raises(ValueError):
        tfn.flash_fwd(q.half(), q.half(), q.half(), 4, 4, 64, (0, 0, 0), True)
    wide = torch.zeros(1, 64, 2 * 256, device=cuda)
    for h, d in ((2, 192), (2, 256)):  # past 128: no kernel
        with pytest.raises(ValueError):
            tfn.flash_fwd(wide[..., :h * d], wide[..., :h * d], wide[..., :h * d], h, h, d,
                          (0, 0, 0), True)
    with pytest.raises(ValueError):  # head slices past the operand
        tfn.flash_fwd(q, q, q, 4, 4, 64, (0, 64, 0), True)
    with pytest.raises(ValueError):
        tfn.flash_fwd(q[:, ::2], q[:, ::2], q[:, ::2], 4, 4, 64, (0, 0, 0), True)


# -- rows 3 and 8 in bf16: the tensor-core kernels -----------------------------

TC_FLASH_CASES = [  # (B, T, Hq, Hkv, D, causal): ragged T, GQA, D=32, causal and not
    (2, 1, 4, 4, 64, True), (2, 63, 4, 4, 64, True), (2, 65, 4, 2, 64, False),
    (2, 100, 4, 4, 64, True), (1, 1000, 8, 2, 64, True), (2, 100, 4, 2, 32, False),
    (2, 256, 4, 4, 32, True), (2, 300, 4, 2, 128, True), (1, 257, 4, 4, 128, False),
    (2, 200, 4, 4, 96, True), (1, 100, 4, 2, 80, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("case", TC_FLASH_CASES, ids=lambda c: "b{}t{}h{}kv{}d{}{}".format(
    *c[:5], "c" if c[5] else "n"))
def test_flash_fwd_bf16_matches_plain_and_repeats_bitwise(cuda, case, scale):
    """The bf16 forward on the tensor cores against its plain version, with
    q and k scaled so that the scores reach the masking and max paths, and
    two launches giving the same bits."""
    b, t, hq, h_kv, d, causal = case
    gen = torch.Generator().manual_seed(t + hq + d)
    for fused in ([True, False] if hq == h_kv else [False]):
        q, k, v, offs = _flash_operands(gen, torch.bfloat16, b, t, hq, h_kv, d, fused)
        if fused:
            q = k = v = q * scale
        else:
            q, k = q * scale, k * scale
        geo = (hq, h_kv, d, offs, causal)
        before = tfn.flash_fwd.launches
        out, lse = tfn.flash_fwd(q, k, v, *geo)
        out2, lse2 = tfn.flash_fwd(q, k, v, *geo)
        assert tfn.flash_fwd.launches == before + 2
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        out_p, lse_p = tfn._fwd_plain(q, k, v, *geo)
        _held(out, out_p, torch.bfloat16)
        _held(lse, lse_p, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("case", TC_FLASH_CASES, ids=lambda c: "b{}t{}h{}kv{}d{}{}".format(
    *c[:5], "c" if c[5] else "n"))
def test_flash_bwd_bf16_matches_plain_and_repeats_bitwise(cuda, case, scale):
    """Rows 4 and 5 in bf16 on the tensor cores against their plain
    versions (every dq partial, dk, dv and the dq pass), with q and k scaled
    as in the forward's test; dk and dv equal bitwise with and without the
    partials, and two launches of each kernel giving the same bits.

    dout is divided by ``scale`` (exactly, a power of two). With q and k
    eight times larger the scores are 64 times larger and the gradients
    eight times: then one bf16 rounding of ds that another summation order
    of the scores flips (a ds within 1e-5 of a rounding midpoint) moves a
    dq element by |ds| * |k| / 256, past the bound's absolute part. A probe
    on the card found such a case at T=1000 (dq off by 0.026, exactly that
    flip at one key). Scaling dout back keeps the scores' regime and the
    gradients' scale of the x1 case."""
    b, t, hq, h_kv, d, causal = case
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(t + hq + d)
    for fused in ([True, False] if hq == h_kv else [False]):
        q, k, v, offs = _flash_operands(gen, bf16, b, t, hq, h_kv, d, fused)
        if fused:
            q = k = v = q * scale
        else:
            q, k = q * scale, k * scale
        geo = (hq, h_kv, d, offs, causal)
        out, lse = tfn.flash_fwd(q, k, v, *geo)
        dout = _randn(gen, bf16, b, t, hq * d) / scale
        delta = (dout.float() * out.float()).reshape(b, t, hq, d).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous(), *geo)
        before = (tfn.flash_bwd.launches, tfn.flash_dq.launches)
        dqp, dk, dv = tfn.flash_bwd(*args, with_dq=True)
        dqp2, dk2, dv2 = tfn.flash_bwd(*args, with_dq=True)
        none, dk3, dv3 = tfn.flash_bwd(*args, with_dq=False)
        dq, dq2 = tfn.flash_dq(*args), tfn.flash_dq(*args)
        assert (tfn.flash_bwd.launches, tfn.flash_dq.launches) == (before[0] + 3, before[1] + 2)
        assert none is None and torch.equal(dqp, dqp2) and torch.equal(dq, dq2)
        for got in (dk2, dk3):
            assert torch.equal(got, dk)
        for got in (dv2, dv3):
            assert torch.equal(got, dv)
        dqp_p, dk_p, dv_p = tfn._bwd_plain(*args)
        _held(dqp, dqp_p, bf16)
        _held(dk, dk_p, bf16)
        _held(dv, dv_p, bf16)
        _held(dq, tfn._dq_plain(*args), bf16)


#: Rows 3-4 at the main paths' shapes of the examples: ViT-Ti (B=512, T=65,
#: 3 heads of 64, non-causal, the fused qkv operand) and the Llama char-LM
#: (B=128, T=256, 8 query heads over 4 K/V heads of 32, causal, bthd).
EXAMPLE_FLASH_CASES = {"vit": (512, 65, 3, 3, 64, False, True),
                       "llama": (128, 256, 8, 4, 32, True, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EXAMPLE_FLASH_CASES))
def test_flash_bf16_at_the_example_shapes_matches_plain_and_repeats_bitwise(cuda, name):
    """The forward and the backward with dq partials (T <= 512) in bf16 on
    the tensor cores against their plain versions, two launches of each
    giving the same bits."""
    b, t, hq, h_kv, d, causal, fused = EXAMPLE_FLASH_CASES[name]
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(b + t)
    q, k, v, offs = _flash_operands(gen, bf16, b, t, hq, h_kv, d, fused)
    geo = (hq, h_kv, d, offs, causal)
    out, lse = tfn.flash_fwd(q, k, v, *geo)
    out2, lse2 = tfn.flash_fwd(q, k, v, *geo)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    out_p, lse_p = tfn._fwd_plain(q, k, v, *geo)
    _held(out, out_p, bf16)
    _held(lse, lse_p, bf16)
    dout = _randn(gen, bf16, b, t, hq * d)
    delta = (dout.float() * out.float()).reshape(b, t, hq, d).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta.contiguous(), *geo)
    dqp, dk, dv = tfn.flash_bwd(*args)
    dqp2, dk2, dv2 = tfn.flash_bwd(*args)
    assert torch.equal(dqp, dqp2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    dqp_p, dk_p, dv_p = tfn._bwd_plain(*args)
    _held(dqp, dqp_p, bf16)
    _held(dk, dk_p, bf16)
    _held(dv, dv_p, bf16)


def _held_by_norm(got, want, dtype):
    """The element bound ``TOL * (1 + |want|)`` taken over the whole tensor:
    the error's L2 norm within the bound's L2 norm. One element whose bf16
    rounding flipped cannot fail it; an error spread over the tensor
    would."""
    got, want = got.float(), want.float()
    err = (got - want).norm().item()
    bound = (TOL[dtype] * (1.0 + want.abs())).norm().item()
    assert err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_FLASH_CASES, ids=lambda c: "b{}t{}h{}kv{}d{}{}".format(
    *c[:5], "c" if c[5] else "n"))
def test_flash_bwd_bf16_x8_unscaled_dout_held_by_norm(cuda, case):
    """Rows 4 and 5 in bf16 with q and k eight times larger and dout as
    drawn (not divided by 8, unlike the test above). Scores 64 times larger
    and gradients eight times: one bf16 rounding of ds that another
    summation order of the scores flips moves a dq element by |ds| * |k| /
    256, which can pass the element bound's absolute part (a card probe
    found 0.026 against 0.0204 at T=1000), and dk, built from the same ds
    times q, moves alike. So dq, the dq partials it is summed from, dk and
    dv are held by norm (:func:`_held_by_norm`); every kernel repeats
    bitwise."""
    b, t, hq, h_kv, d, causal = case
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(t + hq + d)
    for fused in ([True, False] if hq == h_kv else [False]):
        q, k, v, offs = _flash_operands(gen, bf16, b, t, hq, h_kv, d, fused)
        if fused:
            q = k = v = q * 8.0
        else:
            q, k = q * 8.0, k * 8.0
        geo = (hq, h_kv, d, offs, causal)
        out, lse = tfn.flash_fwd(q, k, v, *geo)
        dout = _randn(gen, bf16, b, t, hq * d)
        delta = (dout.float() * out.float()).reshape(b, t, hq, d).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous(), *geo)
        dqp, dk, dv = tfn.flash_bwd(*args, with_dq=True)
        dqp2, dk2, dv2 = tfn.flash_bwd(*args, with_dq=True)
        dq, dq2 = tfn.flash_dq(*args), tfn.flash_dq(*args)
        assert torch.equal(dqp, dqp2) and torch.equal(dq, dq2)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        dqp_p, dk_p, dv_p = tfn._bwd_plain(*args)
        for got, want in ((dqp, dqp_p), (dk, dk_p), (dv, dv_p), (dq, tfn._dq_plain(*args))):
            _held_by_norm(got, want, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4])
def test_flash_bthd_gqa_runs_the_bf16_forward(cuda, g):
    gen = torch.Generator().manual_seed(g)
    b, t, hq, d = 2, 200, 8, 64
    q, k, v, offs = _flash_operands(gen, torch.bfloat16, b, t, hq, hq // g, d, False)
    before = tfn.flash_fwd.launches
    out = tfn.flash_bthd(q, k, v, hq, hq // g, causal=True)
    assert tfn.flash_fwd.launches == before + 1
    _held(out, tfn._fwd_plain(q, k, v, hq, hq // g, d, offs, True)[0], torch.bfloat16)


TC_BLOCK_CASES = [  # (B, T, H): ragged T, the longest T, one to four heads, the char-LM width
    (3, 100, 4), (2, 320, 2), (2, 1, 4), (2, 63, 3), (2, 65, 1), (8, 256, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("epilogue", ["fused", "separate"])
@pytest.mark.parametrize("case", TC_BLOCK_CASES, ids=lambda c: "b{}t{}h{}".format(*c))
def test_fused_block_bf16_matches_plain_and_repeats_bitwise(cuda, case, epilogue, causal,
                                                            scale):
    """The bf16 block on the tensor cores against its plain version, two
    launches bitwise. ``scale`` multiplies x, whose LayerNorm statistics it
    moves; the weights stay at the layer's scale: weights eight times larger
    make the scores 64 times larger, where the plain version on the card and
    on the CPU already disagree past the bound (one bf16 rounding of q or k
    moves a score past the next)."""
    b, t, h = case
    x, ln, weights = _block_operands(torch.Generator().manual_seed(t + h), torch.bfloat16, b, t,
                                     h)
    x = x * scale
    kw = dict(num_heads=h, epilogue=epilogue, causal=causal)
    before = tfb.fused_block.launches
    got = tfb.fused_block(x, ln, *weights, **kw)
    again = tfb.fused_block(x, ln, *weights, **kw)
    assert tfb.fused_block.launches == before + 2
    assert torch.equal(got, again)
    want = tfb.fused_block_plain(x, ln, *weights, **kw)
    assert got.shape == want.shape == (b, t, 64 * h)
    _held(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_tensor_core_kernels_reject_misaligned_bf16_operands(cuda):
    """The flash kernels (rows 3-5) and the fused block copy 16-byte
    pieces: a bf16 view at an odd element offset (an operand or dout), or
    head offsets off the 8-element grid, raise."""
    b, t, h, d = 2, 64, 4, 64
    buf = torch.zeros(b * t * 3 * h * d + 1, dtype=torch.bfloat16, device=cuda)
    odd = buf[1:].view(b, t, 3 * h * d)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError):
        tfn.flash_fwd(odd, odd, odd, h, h, d, (0, h * d, 2 * h * d), True)
    even = buf[:-1].view(b, t, 3 * h * d)
    with pytest.raises(ValueError):
        tfn.flash_fwd(even, even, even, h, h, d, (4, h * d + 4, 2 * h * d - 4), True)
    offs = (0, h * d, 2 * h * d)
    out, lse = tfn.flash_fwd(even, even, even, h, h, d, offs, True)  # aligned: runs
    dbuf = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=cuda)
    dout, odd_dout = dbuf[:-1].view(b, t, h * d), dbuf[1:].view(b, t, h * d)
    delta = torch.zeros_like(lse)
    for backward in (tfn.flash_bwd, tfn.flash_dq):
        with pytest.raises(ValueError):
            backward(odd, odd, odd, dout, lse, delta, h, h, d, offs, True)
        with pytest.raises(ValueError):
            backward(even, even, even, odd_dout, lse, delta, h, h, d, offs, True)
        with pytest.raises(ValueError):
            backward(even, even, even, dout, lse, delta, h, h, d,
                     (4, h * d + 4, 2 * h * d - 4), True)
        backward(even, even, even, dout, lse, delta, h, h, d, offs, True)  # aligned: runs
    x, ln, weights = _block_operands(torch.Generator().manual_seed(1), torch.bfloat16, b, t, h)
    xbuf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xbuf[1:] = x.reshape(-1)
    with pytest.raises(ValueError):
        tfb.fused_block(xbuf[1:].view(b, t, h * d), ln, *weights, num_heads=h)


@pytest.mark.cuda
def test_tensor_core_occupancy_is_what_the_declarations_leave_room_for(cuda):
    """Resident CTAs per SM as the card reports them: at least 2 for row 8
    at T=256, 3 for row 3 at D=64, 3 and 4 for rows 4 and 5 (what their
    shared memory leaves room for at D=64, and their launch bounds' floor
    at D=32), 4 and 2 for row 6 at 64 x 64 and 128 x 128 (bf16), 8 for
    rows 1 and 2's splits at the serve shape, and for row 11's persistent
    wgmma kernel one CTA per SM in at most 168 registers a thread (its
    launch bounds')."""
    assert tfn.occupancy(64, torch.bfloat16) >= 3
    assert tfn.occupancy(32, torch.bfloat16) >= 3
    for d in (32, 64):
        assert tfn.occupancy(d, torch.bfloat16, "flash_bwd") >= 3
        assert tfn.occupancy(d, torch.bfloat16, "flash_dq") >= 4
        assert tfa.occupancy("fwd", d, 64, 64, torch.bfloat16) >= 4
        assert tfa.occupancy("fwd", d, 128, 128, torch.bfloat16) >= 2
    # D = 128: two CTAs of rows 3-6 per SM, by shared memory and the
    # launch bounds' registers.
    for kind in ("flash_fwd", "flash_bwd", "flash_dq"):
        assert tfn.occupancy(128, torch.bfloat16, kind) >= 2, kind
    assert tfa.occupancy("fwd", 128, 64, 64, torch.bfloat16) >= 2
    assert tpa.attribute("split", "ctas", 1, 64, torch.bfloat16) >= 8
    assert tda.attribute("split", "ctas", 1, 64, torch.bfloat16) >= 8
    assert tgg.attribute("ctas") == 1 and 0 < tgg.attribute("registers") <= 168
    for epilogue in tfb.EPILOGUES:
        assert tfb.occupancy(256, epilogue, torch.bfloat16) >= 2
        assert tfb.occupancy(tfb.MAX_T, epilogue, torch.bfloat16) >= 1


# -- the fused attention half of a block -------------------------------------

BLOCK_CASES = [  # (B, T, H): the char-LM shape, a ragged T, one head, the longest T
    (8, 256, 4), (3, 100, 4), (2, 64, 1), (2, 320, 2),
]


def _block_operands(gen, dtype, b, t, h):
    d = 64 * h
    mk = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen) * s).cuda()  # noqa: E731
    x = mk(b, t, d, s=0.5).to(dtype)
    ln = torch.stack([1.0 + 0.1 * torch.randn(d, generator=gen),
                      0.1 * torch.randn(d, generator=gen)]).cuda()
    weights = [mk(d, 3 * d, s=d ** -0.5), mk(3 * d, s=0.01), mk(d, d, s=d ** -0.5), mk(d, s=0.01)]
    return x, ln, [w.to(dtype) for w in weights]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", ["fused", "separate"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "b{}t{}h{}".format(*c))
def test_fused_block_matches_plain(cuda, case, epilogue, dtype):
    b, t, h = case
    x, ln, weights = _block_operands(torch.Generator().manual_seed(t + h), dtype, b, t, h)
    before = tfb.fused_block.launches
    got = tfb.fused_block(x, ln, *weights, num_heads=h, epilogue=epilogue)
    assert tfb.fused_block.launches == before + 1
    want = tfb.fused_block_plain(x, ln, *weights, num_heads=h, epilogue=epilogue)
    assert got.shape == want.shape == (b, t, 64 * h)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_fused_block_limits_match_the_build_and_shapes_past_them_raise(cuda):
    assert tfb.kernel_limits() == (tfb.MAX_T, tfb.MAX_FUSED_HEADS)
    gen = torch.Generator().manual_seed(0)
    x, ln, weights = _block_operands(gen, torch.float32, 1, tfb.MAX_T + 1, 1)
    with pytest.raises(ValueError):
        tfb.fused_block(x, ln, *weights, num_heads=1)
    x, ln, weights = _block_operands(gen, torch.float32, 1, 64, 1)
    with pytest.raises(ValueError):  # head dim 32
        tfb.fused_block(x, ln, *weights, num_heads=2)
    with pytest.raises(ValueError):  # weights in another dtype than x
        tfb.fused_block(x, ln, *(w.to(torch.bfloat16) for w in weights), num_heads=1)


@pytest.mark.cuda
def test_block_attn_half_gradients_recompute_through_the_plain_path(cuda):
    gen = torch.Generator().manual_seed(7)
    x, ln, weights = _block_operands(gen, torch.float32, 2, 128, 2)
    args = [x, ln[0].clone(), ln[1].clone(), *weights]
    grads = {}
    for name, fn in (("kernel", tfb.block_attn_half), ("plain", tfb.reference_block_attn)):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves, num_heads=2)
        grads[name] = [y] + list(torch.autograd.grad(y.square().sum(), leaves))
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# -- the fused BatchNorm(+relu) epilogue ---------------------------------------

BN_CASES = [  # (N, C): ResNet-18's four CIFAR train shapes, the widest C, small and ragged ones
    (524288, 64), (131072, 128), (32768, 256), (8192, 512), (1024, 2048), (512, 24), (64, 8),
    (70000, 64),  # 264 slabs of 266 rows, the last 42
    (16900, 64),  # 264 slabs of 65 rows: the last four hold none
]
BN_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


def _bn_operands(gen, dtype, n, c):
    x = (torch.randn(n, c, generator=gen) * 2 + 0.5).to(dtype).cuda()
    sc = torch.stack([1 + 0.1 * torch.randn(c, generator=gen),
                      0.1 * torch.randn(c, generator=gen)]).cuda()
    return x, sc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: "n{}c{}".format(*c))
def test_fused_bn_kernels_match_plain(cuda, case, act, dtype):
    n, c = case
    x, sc = _bn_operands(torch.Generator().manual_seed(n + c), dtype, n, c)
    before = (tfc.bn_twopass.launches, tfc.bn_normalize.launches)
    y, stats = tfc.bn_twopass(x, sc, eps=1e-5, act=act)
    want_y, want_stats = tfc.bn_twopass_plain(x, sc, eps=1e-5, act=act)
    atol, rtol = BN_TOL[dtype]
    torch.testing.assert_close(stats, want_stats, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=rtol)
    mi = tfc.epilogue_rows(want_stats, sc[0], sc[1], 1e-5).contiguous()
    torch.testing.assert_close(tfc.bn_normalize(x, mi, act=act).float(),
                               tfc.bn_normalize_plain(x, mi, act=act).float(),
                               atol=atol, rtol=rtol)
    assert (tfc.bn_twopass.launches, tfc.bn_normalize.launches) == (before[0] + 1,
                                                                    before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: "n{}c{}".format(*c))
def test_fused_bn_twopass_is_deterministic(cuda, case, dtype):
    x, sc = _bn_operands(torch.Generator().manual_seed(1), dtype, *case)
    first = tfc.bn_twopass(x, sc, eps=1e-5, act=True)
    second = tfc.bn_twopass(x, sc, eps=1e-5, act=True)
    assert torch.equal(first[1], second[1]) and torch.equal(first[0], second[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_bn_twopass_grid_is_resident_and_one_launch(cuda, dtype):
    """Row 9's cooperative grid fits the card at once at every ResNet-18
    shape (two CTAs per SM at 264 CTAs on an H100), and a call is one
    launch of the library."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, c in BN_CASES[:4]:
        grid = min(tfc.MOMENT_CTAS, -(-n // tfc.MOMENT_MIN_ROWS))
        assert tfc.resident(n, c, dtype) * sms >= grid, (n, c)
    x, sc = _bn_operands(torch.Generator().manual_seed(6), dtype, 8192, 512)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tfc.bn_twopass(x, sc, eps=1e-5, act=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "twopass_kernel" in e.name
             or "normalize_kernel" in e.name]
    assert len(names) == 1 and "twopass_kernel" in names[0], names


@pytest.mark.cuda
def test_fused_bn_limits_match_the_build_and_bad_operands_raise(cuda):
    """Since the coverage repair the kernels take any C and f16; what still
    raises: float64 (the TPU kernel never ran it), scale/bias not f32, a
    non-contiguous x and rows of the wrong shape."""
    x, sc = _bn_operands(torch.Generator().manual_seed(2), torch.float32, 64, 16)
    with pytest.raises(ValueError, match="float64"):
        tfc.bn_twopass(x.double(), sc, eps=1e-5, act=True)
    with pytest.raises(ValueError):  # scale/bias not f32
        tfc.bn_twopass(x, sc.double(), eps=1e-5, act=True)
    with pytest.raises(ValueError):  # not contiguous
        tfc.bn_normalize(x.t(), torch.zeros(4, 64, device=cuda), act=True)
    with pytest.raises(ValueError):  # mi of the wrong shape
        tfc.bn_normalize(x, torch.zeros(4, 8, device=cuda), act=True)


#: The coverage repair's shapes: (N, C, dtype) — f16 in the vec form, C = 3
#: and bf16 C = 12 in the any form (one element a load, slabs not starting
#: on a vector), C = 4096 in two chunks of the vec form, a C past MAX_C that
#: is no whole vector (chunks ld apart), and an odd C past 256 lanes.
BN_COVERAGE = [(4096, 64, torch.float16), (4096, 3, torch.float32), (4096, 12, torch.bfloat16),
               (2048, 4096, torch.float32), (1024, 2050, torch.float32),
               (70000, 64, torch.float16), (16900, 5, torch.float16),
               (2048, 1001, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("case", BN_COVERAGE,
                         ids=lambda c: "n{}c{}{}".format(c[0], c[1], str(c[2])[6:]))
def test_fused_bn_coverage_matches_plain(cuda, case, act):
    n, c, dtype = case
    x, sc = _bn_operands(torch.Generator().manual_seed(n + c), dtype, n, c)
    before = (tfc.bn_twopass.launches, tfc.bn_normalize.launches)
    y, stats = tfc.bn_twopass(x, sc, eps=1e-5, act=act)
    want_y, want_stats = tfc.bn_twopass_plain(x, sc, eps=1e-5, act=act)
    atol, rtol = (5e-5, 5e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(stats, want_stats, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=rtol)
    mi = tfc.epilogue_rows(want_stats, sc[0], sc[1], 1e-5).contiguous()
    torch.testing.assert_close(tfc.bn_normalize(x, mi, act=act).float(),
                               tfc.bn_normalize_plain(x, mi, act=act).float(),
                               atol=atol, rtol=rtol)
    launches = len(tfc.chunks(c))
    assert (tfc.bn_twopass.launches, tfc.bn_normalize.launches) == (before[0] + launches,
                                                                    before[1] + launches)
    again = tfc.bn_twopass(x, sc, eps=1e-5, act=act)
    assert torch.equal(again[0], y) and torch.equal(again[1], stats)


@pytest.mark.cuda
def test_fused_bn_misaligned_view_runs_the_any_form(cuda):
    """A view one element into its storage is no 16-byte vector stream: the
    wrappers send it to the any form, which matches plain."""
    base, sc = _bn_operands(torch.Generator().manual_seed(9), torch.bfloat16, 4097, 64)
    x = base.view(-1)[1:1 + 4096 * 64].view(4096, 64)
    assert x.data_ptr() % 16
    y, stats = tfc.bn_twopass(x, sc, eps=1e-5, act=True)
    want_y, want_stats = tfc.bn_twopass_plain(x, sc, eps=1e-5, act=True)
    torch.testing.assert_close(stats, want_stats, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BN_COVERAGE[:4],
                         ids=lambda c: "n{}c{}{}".format(c[0], c[1], str(c[2])[6:]))
def test_fused_bn_coverage_launches_match_the_build(cuda, case):
    """Each chunk's declared launch (the meta route) equals the built
    library's own query: grid, threads, dynamic and static shared memory."""
    n, c, dtype = case
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in ("twopass", "normalize"):
        declared = tfc.bn_chunk_launches(kind, n, c, dtype, sms)
        assert len(declared) == len(tfc.chunks(c))
        for width, fact in declared:
            built = tfc.launch_info(fact.name, n, width, fact.grid[0], True, dtype)
            assert fact.geometry == built, (kind, width, fact.name)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["twopass", "stats_xla"])
def test_fused_bn_act_gradients_are_the_plain_backward(cuda, schedule):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 16, 16, 64, generator=gen) + 0.3).cuda()
    scale = (1 + 0.1 * torch.randn(64, generator=gen)).cuda()
    bias = (0.1 * torch.randn(64, generator=gen)).cuda()
    results = {}
    for name, fn in (("kernel", lambda *a: tfc.fused_bn_act(*a, schedule=schedule)),
                     ("plain", lambda *a: tfc.reference_bn_act(*a, 1e-5, True))):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y, stats = fn(*leaves)
        results[name] = [y, stats, *torch.autograd.grad(y.square().sum(), leaves)]
    for got, want in zip(results["kernel"], results["plain"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64"])
def test_forced_seam_raises_on_what_the_kernel_does_not_take(cuda, case, monkeypatch):
    """Forced, a CUDA tensor that passes the reference's shape gate goes to
    the kernel; the one operand type it does not take (float64) raises: no
    plain fallback on the card."""
    import os

    from rocket_tpu_torch.nn import layers as tl

    monkeypatch.setitem(os.environ, "ROCKET_TPU_FUSED_CONV", "pallas")
    x = torch.randn(2, 16, 16, 16, generator=torch.Generator().manual_seed(5)).double().cuda()
    before = tfc.bn_twopass.launches
    with pytest.raises(ValueError, match="float64"):
        tl.bn_act_train(x, torch.ones(16, device=cuda), torch.zeros(16, device=cuda), 1e-5,
                        act=True)
    assert tfc.bn_twopass.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float16", "c3", "c12", "c4096"])
def test_forced_seam_runs_the_kernel_on_the_coverage_shapes(cuda, case, monkeypatch):
    """Forced, f16, C = 3, 12 and 4096 run the hand kernel on the card (its
    count moves) and never the reference path."""
    import os

    from rocket_tpu_torch.nn import layers as tl

    monkeypatch.setitem(os.environ, "ROCKET_TPU_FUSED_CONV", "pallas")
    monkeypatch.setattr(tfc, "reference_bn_act", lambda *a, **k: pytest.fail("plain path"))
    c = {"float16": 64, "c3": 3, "c12": 12, "c4096": 4096}[case]
    dtype = torch.float16 if case == "float16" else torch.float32
    x = torch.randn(2, 16, 16, c, generator=torch.Generator().manual_seed(5)).to(dtype).cuda()
    before = tfc.bn_twopass.launches
    y, _ = tl.bn_act_train(x, torch.ones(c, device=cuda), torch.zeros(c, device=cuda), 1e-5,
                           act=True)
    assert tfc.bn_twopass.launches == before + len(tfc.chunks(c)) and y.dtype == dtype


# -- the MoE grouped products: gmm (both modes), tgmm, gather_gmm -------------

GROUP_CASES = {  # (M, K, N, group sizes)
    "ragged": (300, 128, 256, [0, 131, 0, 169]),  # empty groups, tiles straddling groups
    "past_the_groups": (40, 64, 136, [3, 1, 0, 17]),  # rows past the groups, N % 128 != 0
    "decode": (16, 768, 3072, [5, 0, 11, 0]),  # NK = 16 at the main widths
    "k_tail": (64, 40, 72, [30, 0, 34, 0]),  # K and N past whole tiles and mma slices
    "in_proj": (2048, 768, 3072, [700, 301, 0, 1047]),
    "k_n_200": (300, 200, 200, [0, 131, 0, 100]),  # row 11's edge: K, N off the tiles, rows past
}


def _held(got, want, dtype):
    """Every element within ``TOL * (1 + |want|)``."""
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - TOL[dtype] * (1.0 + want.abs())).max().item()
    assert excess <= 0.0, excess


def _group_operands(gen, dtype, m, k, n, sizes, transpose=False):
    lhs = (torch.randn(m, k, generator=gen) * 0.5).to(dtype).cuda()
    shape = (len(sizes), n, k) if transpose else (len(sizes), k, n)
    rhs = (torch.randn(*shape, generator=gen) * k ** -0.5).to(dtype).cuda()
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_gmm_matches_plain_and_repeats_bitwise(cuda, case, transpose, dtype):
    m, k, n, sizes = GROUP_CASES[case]
    lhs, rhs, gs = _group_operands(torch.Generator().manual_seed(m + n), dtype, m, k, n, sizes,
                                   transpose)
    before = tgm.gmm.launches
    got = tgm.gmm(lhs, rhs, gs, transpose_rhs=transpose)
    assert tgm.gmm.launches == before + 1
    _held(got, tgm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose), dtype)
    assert torch.equal(got, tgm.gmm(lhs, rhs, gs, transpose_rhs=transpose))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_tgmm_matches_plain_and_repeats_bitwise(cuda, case, dtype):
    m, k, n, sizes = GROUP_CASES[case]
    gen = torch.Generator().manual_seed(m + k)
    lhs, _, gs = _group_operands(gen, dtype, m, k, n, sizes)
    dy = (torch.randn(m, n, generator=gen) * 0.5).to(dtype).cuda()
    before = tgm.tgmm.launches
    got = tgm.tgmm(lhs, dy, gs)
    assert tgm.tgmm.launches == before + 1
    want = tgm.tgmm_reference(lhs, dy, gs)
    _held(got, want, dtype)
    for g, size in enumerate(sizes):
        if size == 0:  # an empty group writes zeros
            assert not got[g].any()
    assert torch.equal(got, tgm.tgmm(lhs, dy, gs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768)])
def test_tgmm_at_the_moe_shapes_with_groups_off_the_slices(cuda, k, n, dtype):
    """tgmm at both weight-gradient shapes of the MoE LM (18432 rows, 4
    groups) with group starts and ends off the 64-row slices, so every
    group's last slice runs into the next group's rows (or the rows past
    the groups, which hold data); two launches bitwise."""
    sizes = [4000, 4673, 0, 9701]  # ends at 4000, 8673, 8673, 18374 of 18432
    gen = torch.Generator().manual_seed(k + 7)
    lhs = (torch.randn(18432, k, generator=gen) * 0.5).to(dtype).cuda()
    dy = (torch.randn(18432, n, generator=gen) * 0.5).to(dtype).cuda()
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    got = tgm.tgmm(lhs, dy, gs)
    _held(got, tgm.tgmm_reference(lhs, dy, gs), dtype)
    assert not got[2].any()
    assert torch.equal(got, tgm.tgmm(lhs, dy, gs))


@pytest.mark.cuda
def test_tgmm_bf16_runs_the_wgmma_kernel(cuda):
    """bf16 tgmm on the persistent wgmma + TMA kernel at both compiled
    widths: one CTA per SM in at most 168 registers a thread at launch, the
    declared grid and shared memory; the width rule takes 192 columns at the
    MoE shapes and 256 where 256-wide slots fill one wave (K = N = 1024, 4
    groups) on a 132-SM H100, and both hold against the plain version."""
    for bn in tgm.GMM_BLOCK_NS:
        assert tgm.attribute("ctas", block_n=bn, kind="tgmm") == 1
        assert 0 < tgm.attribute("registers", block_n=bn, kind="tgmm") <= 168
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator().manual_seed(41)
    widths = set()
    for m, k, n, sizes in ((18432, 768, 3072, [4608] * 4), (4096, 1024, 1024, [1000, 77, 0, 3000])):
        lhs, _, gs = _group_operands(gen, torch.bfloat16, m, k, n, sizes)
        dy = (torch.randn(m, n, generator=gen) * 0.5).to(torch.bfloat16).cuda()
        _held(tgm.tgmm(lhs, dy, gs), tgm.tgmm_reference(lhs, dy, gs), torch.bfloat16)
        bn = tgm.tgmm_block_n(k, n, 4, sms)
        assert tgm.launch_info("tgmm", m, k, n, 4, torch.bfloat16) == \
            tgm.tgmm_launch(m, k, n, 4, torch.bfloat16, sms).geometry
        assert tgm.launch_info("tgmm", m, k, n, 4, torch.bfloat16)[2] == tgm.wg_smem(bn)
        widths.add(bn)
    if sms == 132:
        assert widths == set(tgm.GMM_BLOCK_NS)


def _routed(gen, n_tok, k_top, e, tile_m, empty=None):
    """A seeded routing of n_tok tokens x k_top choices over e experts (none
    to expert ``empty``) -> the padded layout."""
    pair_expert = torch.randint(0, e, (n_tok * k_top,), generator=gen)
    if empty is not None:
        pair_expert[pair_expert == empty] = (empty + 1) % e
    order = torch.argsort(pair_expert, stable=True)
    sorted_token = (torch.arange(n_tok).repeat_interleave(k_top))[order]
    counts = torch.bincount(pair_expert, minlength=e).to(torch.int32)
    layout = tgg.padded_group_layout(counts.cuda(), sorted_token.cuda(), tile_m, n_tok * k_top,
                                     sorted_expert=pair_expert[order].cuda())
    return layout


GATHER_CASES = {  # (tokens, K, N, E, tile_m, expert with no rows)
    "decode": (8, 768, 3072, 4, 16, 1),
    "tile_8": (50, 64, 256, 3, 8, None),
    "k_edge": (300, 200, 256, 4, 64, 2),     # K past whole 64-deep slices, an empty group
    "n_edge": (300, 768, 200, 4, 64, None),  # N past whole 128-column tiles
    "main_bf16_only": (8192, 768, 3072, 4, 512, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_gmm_matches_plain_and_repeats_bitwise(cuda, case, dtype):
    n_tok, k, n, e, tile_m, empty = GATHER_CASES[case]
    if case.endswith("bf16_only") and dtype != torch.bfloat16:
        pytest.skip("the main shape is held in the path's dtype, bf16")
    gen = torch.Generator().manual_seed(n_tok + k)
    row_ids, gsz, _, m = _routed(gen, n_tok, 2, e, tile_m, empty)
    x = (torch.randn(n_tok, k, generator=gen) * 0.5).to(dtype).cuda()
    rhs = (torch.randn(e, k, n, generator=gen) * k ** -0.5).to(dtype).cuda()
    before = tgg.gather_gmm_fwd.launches
    got = tgg.gather_gmm_fwd(x, rhs, row_ids, gsz, tile_m)
    assert tgg.gather_gmm_fwd.launches == before + 1
    assert got.shape == (m, n)
    _held(got, tgg.gather_gmm_reference(x, rhs, row_ids, gsz, tile_m), dtype)
    assert torch.equal(got, tgg.gather_gmm_fwd(x, rhs, row_ids, gsz, tile_m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_gmm_zeros_rows_past_the_groups_and_bad_ids(cuda, dtype):
    """Group sizes that stop short of M (rows past the groups come out as
    zeros) and an empty group, with row ids outside [0, N) (zero rows),
    against the grouped product of the explicit gather; K and N off the
    kernels' tiles."""
    gen = torch.Generator().manual_seed(21)
    n_tok, m, k, n = 70, 300, 200, 200
    x = (torch.randn(n_tok, k, generator=gen) * 0.5).to(dtype).cuda()
    rhs = (torch.randn(4, k, n, generator=gen) * k ** -0.5).to(dtype).cuda()
    ids = torch.randint(0, n_tok, (m,), generator=gen, dtype=torch.int32)
    ids[::17], ids[5::23] = -1, n_tok  # outside the source rows
    sizes = torch.tensor([0, 131, 0, 100], dtype=torch.int32, device=cuda)
    ids = ids.cuda()
    got = tgg.gather_gmm_fwd(x, rhs, ids, sizes, 8)
    assert not got[231:].any()  # rows past the groups
    valid = ((ids >= 0) & (ids < n_tok))[:, None]
    gathered = torch.where(valid, x[ids.long().clamp(0, n_tok - 1)], torch.zeros_like(x[:1]))
    _held(got, tgm.gmm_reference(gathered, rhs, sizes), dtype)
    assert torch.equal(got, tgg.gather_gmm_fwd(x, rhs, ids, sizes, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_gmm_bf16_runs_the_wgmma_kernel_and_zeros_rows_past_the_groups(cuda, transpose):
    """bf16 gmm in both modes and both tile widths on the persistent wgmma
    + TMA kernel: one CTA per SM in at most 168 registers a thread at
    launch; work tiles that start off the 128-row grid (raw counts), an
    empty group and rows past the groups (zeros) at K = N = 200, then the
    decode size, then N = 768 at 16384 and 18432 rows, where the width
    rule takes 256 and 192 columns on a 132-SM H100; two launches
    bitwise."""
    for bn in tgm.GMM_BLOCK_NS:
        assert tgm.attribute("ctas", transpose, bn) == 1
        assert 0 < tgm.attribute("registers", transpose, bn) <= 168
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator().manual_seed(31 + transpose)
    widths = set()
    for m, k, n, sizes in ((300, 200, 200, [0, 131, 0, 100]), (16, 3072, 768, [5, 0, 11, 0]),
                           (1000, 3072, 768, [77, 0, 402, 300]),
                           (16384, 768, 768, [4100, 0, 6000, 6184]),
                           (18432, 768, 768, [4608, 4608, 4608, 4480])):
        lhs, rhs, gs = _group_operands(gen, torch.bfloat16, m, k, n, sizes, transpose)
        got = tgm.gmm(lhs, rhs, gs, transpose_rhs=transpose)
        rows = sum(sizes)
        assert not got[rows:].any()
        _held(got, tgm.gmm_reference(lhs, rhs, gs, transpose_rhs=transpose), torch.bfloat16)
        assert torch.equal(got, tgm.gmm(lhs, rhs, gs, transpose_rhs=transpose))
        bn = tgm.gmm_block_n(m, n, sms)
        assert tgm.launch_info("gmm", m, k, n, 4, torch.bfloat16, transpose)[2] == tgm.wg_smem(bn)
        widths.add(bn)
    if sms == 132:
        assert widths == set(tgm.GMM_BLOCK_NS)


@pytest.mark.cuda
def test_grouped_products_gradients_match_the_plain_composition(cuda):
    """The kernels' autograd Functions against autograd through the plain
    versions: ``grouped_matmul`` (gmm forward; gmm transposed + tgmm
    backward) and ``gather_gmm`` (dx through gmm + index_add, drhs through
    tgmm), f32."""
    gen = torch.Generator().manual_seed(11)
    lhs, rhs, gs = _group_operands(gen, torch.float32, 256, 128, 256, [0, 100, 56, 100])
    dy = torch.randn(256, 256, generator=gen).cuda()
    leaves = [lhs.clone().requires_grad_(), rhs.clone().requires_grad_()]
    before = (tgm.gmm.launches, tgm.tgmm.launches)
    out = tgm.grouped_matmul(*leaves, gs)
    grads = torch.autograd.grad(out, leaves, dy)
    assert (tgm.gmm.launches, tgm.tgmm.launches) == (before[0] + 2, before[1] + 1)
    plain = [lhs.clone().requires_grad_(), rhs.clone().requires_grad_()]
    want = tgm.grouped_matmul_plain(*plain, gs)
    want_grads = torch.autograd.grad(want, plain, dy)
    for g, w in zip([out, *grads], [want, *want_grads]):
        _held(g, w, torch.float32)

    row_ids, gsz, pos, m = _routed(gen, 64, 2, 4, 16, empty=2)
    x = torch.randn(64, 128, generator=gen).cuda()
    w = (torch.randn(4, 128, 256, generator=gen) * 0.1).cuda()
    dh = torch.randn(m, 256, generator=gen).cuda()
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    h = tgg.gather_gmm(*leaves, row_ids, gsz, tile_m=16, tile_n=256)
    grads = torch.autograd.grad(h, leaves, dh)
    plain = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    want = tgm.grouped_matmul_plain(plain[0][row_ids.long()], plain[1], gsz)
    want_grads = torch.autograd.grad(want, plain, dh)
    for g, w_ in zip([h, *grads], [want, *want_grads]):
        _held(g, w_, torch.float32)


@pytest.mark.cuda
def test_grouped_products_follow_the_gate_and_raise_past_the_kernels(cuda):
    """A CUDA shape past the reference's gate takes its non-kernel branch;
    one that passes it reaches the kernel, which raises on what it does not
    take: no plain fallback on the card."""
    gen = torch.Generator().manual_seed(12)
    lhs, rhs, gs = _group_operands(gen, torch.float32, 12, 128, 128, [5, 7])
    before = tgm.gmm.launches
    tgm.grouped_matmul(lhs, rhs, gs)  # m % 8 != 0: the reference's ragged_dot branch
    assert tgm.gmm.launches == before
    tgm.grouped_matmul(lhs[:8], rhs, torch.tensor([3, 5], dtype=torch.int32, device=cuda))
    assert tgm.gmm.launches == before + 1
    with pytest.raises(ValueError):  # float16
        tgm.grouped_matmul(lhs[:8].half(), rhs.half(), gs)
    with pytest.raises(ValueError):  # operands of two dtypes
        tgm.gmm(lhs, rhs.bfloat16(), gs)
    with pytest.raises(ValueError):  # group sizes of the wrong length or type
        tgm.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError):  # lhs and dy of other row counts
        tgm.tgmm(lhs, lhs[:4], gs)
    with pytest.raises(ValueError):  # K not a multiple of 8
        tgm.gmm(lhs[:, :12].contiguous(), rhs[:, :12].contiguous(), gs)
    x = torch.randn(8, 64, generator=gen).cuda()
    w = torch.randn(2, 64, 128, generator=gen).cuda()
    ids, sizes = torch.zeros(16, dtype=torch.int32, device=cuda), gs.new_tensor([8, 8])
    with pytest.raises(ValueError):  # row ids not int32
        tgg.gather_gmm_fwd(x, w, ids.long(), sizes, 8)
    with pytest.raises(ValueError):  # row ids on the host
        tgg.gather_gmm_fwd(x, w, ids.cpu(), sizes, 8)
    assert tgm.gmm.launches == before + 1


# -- rows 6-7: flash attention on the stacked (3, B, H, T, D) operand ---------

QKV_CASES = [(2, 4, 256, 64), (2, 4, 256, 32), (8, 12, 1024, 64)]  # (B, H, T, D); GPT-2 last
#: Head dim 128 (64 x 64 only) and two padded to it.
QKV_D128_CASES = [(2, 4, 256, 128), (1, 2, 384, 96), (1, 3, 128, 80)]
QKV_TILES = [(64, 64), (128, 128), (64, 128), (128, 64)]


def _close_per_element(got, want, tol, what):
    excess = ((got.float() - want.float()).abs() - tol * (1.0 + want.float().abs())).max().item()
    assert excess <= 0.0, f"{what}: off by {excess} more than {tol} * (1 + |want|)"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tiles", QKV_TILES, ids=lambda c: "q{}k{}".format(*c))
@pytest.mark.parametrize("case", QKV_CASES, ids=lambda c: "b{}h{}t{}d{}".format(*c))
def test_flash_qkv_kernels_match_plain_and_repeat_bitwise(cuda, case, tiles, dtype):
    """Every compiled tile pair (causal only on square tiles), forward and
    the whole backward against the plain versions, two launches bitwise."""
    b, h, t, d = case
    bq, bk = tiles
    gen = torch.Generator().manual_seed(b * t + d + bq + bk)
    qkv = _randn(gen, dtype, 3, b, h, t, d)
    dout = _randn(gen, dtype, b, h, t, d)
    for causal in ((True, False) if bq == bk else (False,)):
        what = f"{case} {tiles} {dtype} causal={causal}"
        before = (tfa.flash_qkv_fwd.launches, tfa.flash_qkv_bwd.launches)
        out, lse = tfa.flash_qkv_fwd(qkv, causal, bq, bk)
        out2, lse2 = tfa.flash_qkv_fwd(qkv, causal, bq, bk)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        out_p, lse_p = tfa._fwd_plain(qkv, causal, bq, bk)
        _close_per_element(out, out_p, TOL[dtype], what + " out")
        _close_per_element(lse, lse_p, TOL[dtype], what + " lse")
        delta = (out.float() * dout.float()).sum(-1).unsqueeze(2)
        args = (qkv, out, lse, dout, delta, causal, bq, bk)
        dqp, dk, dv = tfa.flash_qkv_bwd(*args)
        again = tfa.flash_qkv_bwd(*args)
        assert all(torch.equal(x, y) for x, y in zip((dqp, dk, dv), again))
        assert tfa.flash_qkv_fwd.launches == before[0] + 2
        assert tfa.flash_qkv_bwd.launches == before[1] + 2
        dqp_p, dk_p, dv_p = tfa._bwd_plain(*args)
        assert dqp.shape == dqp_p.shape == (t // bk, b, h, t, d)
        _close_per_element(dqp.float().sum(0), dqp_p.float().sum(0), TOL[dtype], what + " dq")
        _close_per_element(dk, dk_p, TOL[dtype], what + " dk")
        _close_per_element(dv, dv_p, TOL[dtype], what + " dv")
        if causal:  # the partials a k-tile cannot see are written as zeros
            assert torch.count_nonzero(dqp[-1, :, :, :t - bk]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 256, 1024])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("tiles", QKV_TILES, ids=lambda c: "q{}k{}".format(*c))
def test_flash_qkv_bwd_bf16_tensor_cores_match_plain_and_repeat_bitwise(cuda, tiles, d, t):
    """Row 7's bf16 backward on the tensor cores at every tile pair, both
    head dims and three lengths, causal on square tiles and not: dq through
    its partials' f32 sum, dk and dv per element within ``TOL * (1 +
    |want|)``, the partials a causal k-tile cannot see exactly zero, and two
    launches bitwise."""
    bq, bk = tiles
    dtype = torch.bfloat16
    b, h = 2, 3
    gen = torch.Generator().manual_seed(t + d + 3 * bq + bk)
    qkv = _randn(gen, dtype, 3, b, h, t, d)
    dout = _randn(gen, dtype, b, h, t, d)
    for causal in ((True, False) if bq == bk else (False,)):
        what = f"T={t} D={d} {tiles} causal={causal}"
        out, lse = tfa._fwd_plain(qkv, causal, bq, bk)
        delta = (out.float() * dout.float()).sum(-1).unsqueeze(2)
        args = (qkv, out, lse, dout, delta, causal, bq, bk)
        before = tfa.flash_qkv_bwd.launches
        dqp, dk, dv = tfa.flash_qkv_bwd(*args)
        again = tfa.flash_qkv_bwd(*args)
        assert tfa.flash_qkv_bwd.launches == before + 2
        assert all(torch.equal(x, y) for x, y in zip((dqp, dk, dv), again)), what
        dqp_p, dk_p, dv_p = tfa._bwd_plain(*args)
        _close_per_element(dqp.float().sum(0), dqp_p.float().sum(0), TOL[dtype], what + " dq")
        _close_per_element(dk, dk_p, TOL[dtype], what + " dk")
        _close_per_element(dv, dv_p, TOL[dtype], what + " dv")
        if causal:
            for ik in range(t // bk):
                assert torch.count_nonzero(dqp[ik, :, :, :ik * bk]) == 0, (what, ik)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", QKV_D128_CASES, ids=lambda c: "b{}h{}t{}d{}".format(*c))
def test_flash_qkv_d128_and_padded_match_plain_and_repeat_bitwise(cuda, case, dtype):
    """Rows 6-7 at D = 128 (the one compiled tile pair, 64 x 64) and at
    D = 96 and 80 on heads zero-padded to 128: forward and backward against
    the plain versions at the true D, causal and not, two launches bitwise;
    a 128-row tile at these head dims raises."""
    b, h, t, d = case
    gen = torch.Generator().manual_seed(b * t + d)
    qkv = _randn(gen, dtype, 3, b, h, t, d)
    dout = _randn(gen, dtype, b, h, t, d)
    for causal in (True, False):
        what = f"{case} {dtype} causal={causal}"
        out, lse = tfa.flash_qkv_fwd(qkv, causal, 64, 64)
        out2, lse2 = tfa.flash_qkv_fwd(qkv, causal, 64, 64)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        out_p, lse_p = tfa._fwd_plain(qkv, causal, 64, 64)
        assert out.shape == out_p.shape == (b, h, t, d)
        _close_per_element(out, out_p, TOL[dtype], what + " out")
        _close_per_element(lse, lse_p, TOL[dtype], what + " lse")
        delta = (out.float() * dout.float()).sum(-1).unsqueeze(2)
        args = (qkv, out, lse, dout, delta, causal, 64, 64)
        dqp, dk, dv = tfa.flash_qkv_bwd(*args)
        again = tfa.flash_qkv_bwd(*args)
        assert all(torch.equal(x, y) for x, y in zip((dqp, dk, dv), again)), what
        dqp_p, dk_p, dv_p = tfa._bwd_plain(*args)
        assert dqp.shape == dqp_p.shape == (t // 64, b, h, t, d)
        _close_per_element(dqp.float().sum(0), dqp_p.float().sum(0), TOL[dtype], what + " dq")
        _close_per_element(dk, dk_p, TOL[dtype], what + " dk")
        _close_per_element(dv, dv_p, TOL[dtype], what + " dv")
    with pytest.raises(ValueError):
        tfa.flash_qkv_fwd(qkv, True, 128, 128)


@pytest.mark.cuda
def test_flash_qkv_bwd_bf16_occupancy_and_registers(cuda):
    """Row 7's bf16 backward: at least two resident CTAs of 64 keys per SM
    and one of 128 keys, at every tile pair and head dim, in at most 255
    registers a thread (no spills: the build line prints them)."""
    for d in tfa.HEAD_DIMS:
        for bq, bk in [(bq, bk) for bq, bk in QKV_TILES if {bq, bk} <= set(tfa.tiles_for(d))]:
            ctas = tfa.occupancy("bwd", d, bq, bk, torch.bfloat16)
            regs = tfa.registers("bwd", d, bq, bk, torch.bfloat16)
            assert ctas >= (2 if bk == 64 else 1), (d, bq, bk, ctas)
            assert 0 < regs <= 255, (d, bq, bk, regs)


@pytest.mark.cuda
def test_flash_qkv_autograd_runs_the_kernels_and_raises_past_them(cuda):
    gen = torch.Generator().manual_seed(7)
    qkv = _randn(gen, torch.bfloat16, 3, 2, 4, 256, 64).requires_grad_()
    before = (tfa.flash_qkv_fwd.launches, tfa.flash_qkv_bwd.launches)
    out = tfa.flash_attention_qkv(qkv)
    out.float().square().sum().backward()
    assert (tfa.flash_qkv_fwd.launches, tfa.flash_qkv_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad.float()).all()
    x = torch.zeros(3, 1, 2, 256, 64, device=cuda)
    with pytest.raises(ValueError):  # not a compiled tile
        tfa.flash_qkv_fwd(x, False, 256, 128)
    with pytest.raises(ValueError):  # float16 is not compiled
        tfa.flash_qkv_fwd(x.half(), True, 128, 128)
    with pytest.raises(ValueError):
        tfa.flash_qkv_fwd(x[:, :, :, ::2], True, 128, 128)
    for kind in ("fwd", "bwd"):
        for bq, bk in QKV_TILES:
            assert tfa.occupancy(kind, 64, bq, bk, torch.float32) >= 1


@pytest.mark.cuda
def test_tuner_sweeps_on_the_card_and_rejects_a_seeded_bad_variant(cuda):
    """A real flash sweep: every candidate parity-clean and timed; then a
    wrong-but-fast variant in a test-only TuneSpace is rejected before
    timing."""
    from rocket_tpu_torch.tune.space import TUNE_SPACES, TuneSpace
    from rocket_tpu_torch.tune.tuner import TuneCase, load_cases, sweep_case

    report = sweep_case(load_cases()["flash_bwd/charlm"], device="cuda", iters=3,
                        min_speedup=1.0)
    assert report.default_us > 0 and report.results
    for result in report.results:
        assert result.error is None and result.parity_ok and result.mean_us > 0, result

    space = TuneSpace(kernel="card_fake_variant", axes={"impl": ("reference", "wrongfast")},
                      shape_keys=("n",), default=lambda shape: {"impl": "reference"},
                      structural=("impl",))
    TUNE_SPACES[space.kernel] = space
    try:
        qkv = torch.randn(3, 2, 4, 256, 64, device=cuda).to(torch.bfloat16)

        def build(device):
            def run(config):
                if config["impl"] == "wrongfast":
                    return qkv[0] * 1.5
                return tfa.flash_attention_qkv(qkv)
            return run

        case = TuneCase(name="fake/wrongfast", kernel=space.kernel, shape={"n": 256},
                        dtype="bfloat16", build=build)
        report = sweep_case(case, device="cuda", iters=2, min_speedup=1.0)
        (bad,) = report.results
        assert not bad.parity_ok and bad.mean_us is None and report.winner is None
    finally:
        del TUNE_SPACES[space.kernel]


# -- launch declarations and row 12 ------------------------------------------


def _declared_and_built(kernel, dtype):
    """Pairs of (declared LaunchFact, library query) of ``kernel`` at a few
    shapes, both dtypes where the kernel takes them."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops import badpallas as tbp

    if kernel == "paged_decode":
        lib = tpa._lib()
        pairs = []
        for s, hq, hkv, d, mb, bl in ((8, 12, 12, 64, 64, 16), (3, 12, 4, 128, 9, 16),
                                      (2, 4, 4, 40, 7, 10)):
            assert lib.rkt_paged_decode_workspace(s, hq, hkv, d, mb, bl) == \
                tpa.workspace_floats(s, hq, hkv, d, mb, bl)
            pairs += zip(tpa.paged_decode_launches(s, hq, hkv, d, 1 + s * mb, bl, mb, dtype),
                         tpa.launch_info(s, hq, hkv, d, mb, bl, dtype))
        return pairs
    if kernel == "decode_attention":
        pairs = []
        for b, hq, hkv, t, d in ((4, 12, 12, 192, 64), (2, 6, 2, 100, 128), (8, 12, 4, 1024, 32)):
            assert tda._lib().rkt_decode_attention_workspace(b, hq, hkv, t, d) == \
                tda.workspace_floats(b, hq, hkv, t, d)
            pairs += zip(tda.decode_attention_launches(b, hq, hkv, t, d, dtype),
                         tda.launch_info(b, hq, hkv, t, d, dtype))
        return pairs
    if kernel == "flash_native":
        return [(tfn.flash_launch(kind, 2, t, 4, hkv, d, dtype, 4 * d, hkv * d),
                 tfn.launch_info(kind, 2, t, 4, hkv, d, dtype))
                for kind in ("flash_fwd", "flash_bwd", "flash_dq")
                for t, hkv, d in ((1024, 4, 64), (100, 2, 32))]
    if kernel == "flash_qkv":
        return [(tfa.qkv_launch(kind, 2, 4, 256, d, dtype, bq, bk),
                 tfa.launch_info(kind, 2, 4, 256, d, dtype, bq, bk))
                for kind in ("fwd", "bwd") for d in (32, 64)
                for bq in tfa.TILES for bk in tfa.TILES]
    if kernel == "fused_block":
        return [(tfb.fused_block_launch(b, t, 64 * h, h, dtype, ep),
                 tfb.launch_info(b, t, h, ep, dtype))
                for b, t, h in ((128, 256, 4), (3, 100, 2)) for ep in tfb.EPILOGUES]
    if kernel == "fused_conv":
        pairs = []
        with tune.priced_device_kind(torch.cuda.get_device_name(0)):
            for n, c in ((4096, 64), (1000, 2048), (524288, 64), (8192, 512)):
                grid, norm = tfc._grids(torch.empty((n, c), dtype=dtype, device="meta"))
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                for kind, ctas in (("twopass", grid), ("normalize", norm)):
                    for fact in tfc.bn_launches(kind, n, c, dtype, grid, norm, sms):
                        for act in (True, False):
                            pairs.append((fact, tfc.launch_info(fact.name, n, c, ctas, act,
                                                                dtype)))
        return pairs
    if kernel == "grouped":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        pairs = [(tgm.gmm_launch(m, k, n, e, dtype, trans, sms=sms), tgm.launch_info(
                     "gmm", m, k, n, e, dtype, trans))
                 for m, k, n, e in ((1000, 768, 3072, 4), (16, 128, 256, 2),
                                    (18432, 3072, 768, 4))
                 for trans in (False, True)]
        pairs += [(tgm.tgmm_launch(m, k, n, e, dtype, sms),
                   tgm.launch_info("tgmm", m, k, n, e, dtype))
                  for m, k, n, e in ((1000, 768, 3072, 4), (16, 128, 256, 2),
                                     (18432, 3072, 768, 4), (4096, 1024, 1024, 4))]
        pairs += [(tgg.gather_gmm_launch(m, 768, n, 4, dtype, 500, sms),
                   tgg.launch_info(m, n, 4, dtype)) for m, n in ((18432, 3072), (1024, 3072),
                                                                 (16, 3072), (300, 200))]
        return pairs
    assert kernel == "bad_scale" and dtype == torch.float32
    return [(tbp.bad_scale_launch((4096, 4096), block, grid), tbp.launch_info(block, grid))
            for block, grid in (((7, 100), (4,)), ((8, 128), (512, 32)), ((4096, 4096), ()))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    (kernel, dtype) for kernel in ("paged_decode", "decode_attention", "flash_native",
                                   "flash_qkv", "fused_block", "fused_conv", "grouped")
    for dtype in DTYPES] + [("bad_scale", torch.float32)])
def test_declared_launch_geometry_equals_the_library_query(cuda, kernel, dtype):
    """Every wrapper's declared (grid, threads, dynamic, static shared
    memory) equals what its library reports for the same launch: the grid
    and dynamic part from the helpers its launch calls, the static part
    from ``cudaFuncGetAttributes``."""
    for fact, built in _declared_and_built(kernel, dtype):
        assert fact.geometry == built, (fact.name, fact.geometry, built)


@pytest.mark.cuda
def test_bad_scale_matches_plain_on_the_written_blocks(cuda):
    from rocket_tpu_torch.ops import badpallas as tbp

    gen = torch.Generator().manual_seed(12)
    x = torch.randn(4096, 4096, generator=gen).cuda()
    before = tbp.bad_scale.launches
    for block, grid in (((7, 100), (4,)), ((7, 100), (586, 41)), ((8, 128), (3, 2))):
        rows, cols = tbp.written_blocks(x.shape, block, grid)
        got = tbp.bad_scale(x, block, grid)
        want = tbp.bad_scale_plain(x, block, grid)
        torch.cuda.synchronize()
        assert torch.equal(got[rows, cols], want[rows, cols]), (block, grid)
    assert tbp.bad_scale.launches == before + 3


@pytest.mark.cuda
def test_bad_scale_whole_array_launch_is_refused(cuda):
    """The fixture's one (4096, 4096) f32 block asks for 64 MiB of shared
    memory: the card refuses it, the wrapper raises with CUDA's message and
    counts no launch, and the next launch runs clean."""
    from rocket_tpu_torch.ops import badpallas as tbp

    x = torch.ones(4096, 4096, device=cuda)
    before = tbp.bad_scale.launches
    with pytest.raises(RuntimeError, match="67108864 bytes.*cudaError"):
        tbp.bad_scale(x, x.shape, ())
    assert tbp.bad_scale.launches == before
    y = tbp.bad_scale(x, (8, 128), (512, 32))
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2.0)


@pytest.mark.cuda
def test_a_poisoned_cuda_batch_stays_on_the_card_and_is_all_nan(cuda):
    """The fault injector's poison of a device-resident batch: each floating
    leaf becomes a NaN tensor made on its own card (no upload, so the sync
    guard stays quiet), its integer leaves untouched."""
    from rocket_tpu_torch.resilience.faults import FaultInjector, FaultPlan

    batch = {"image": torch.ones(8, 1, 28, 28, device=cuda),
             "half": torch.ones(4, device=cuda, dtype=torch.bfloat16),
             "label": torch.arange(8, device=cuda)}
    inj = FaultInjector(FaultPlan.parse("poison:step=1"))
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = inj.poison_hook(batch)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    for key in ("image", "half"):
        assert out[key].device == batch[key].device and out[key].dtype == batch[key].dtype
        assert out[key].shape == batch[key].shape and bool(torch.isnan(out[key]).all())
    assert out["label"] is batch["label"] and inj.fired == ("poison@batch[1]",)


_GLOO_CUDA_WORKER = r'''
import os, sys
import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), 2
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=rank,
                        world_size=world)
from rocket_tpu_torch.parallel.grad_sync import GradSync
from rocket_tpu_torch.runtime import Runtime

runtime = Runtime(device="cuda")  # adopts the caller's group
assert (runtime.process_index, runtime.process_count, runtime.backend) == (rank, world, "gloo")
gen = torch.Generator().manual_seed(7)
shapes = [(300, 7), (64,), (5, 3, 2), (1000,)]
leaves = [torch.randn(*s, generator=gen).cuda().requires_grad_(True) for s in shapes]
x = torch.randn(16, generator=gen).cuda() * (rank + 1)
sync = GradSync(shapes, [torch.float32] * 4, [None] * 4, world, bucket_bytes=4096,
                wire_dtype=None)
sync.begin(leaves)
loss = sum((t.sum() * x[i]) ** 2 for i, t in enumerate(leaves))
grads = torch.autograd.grad(loss, leaves)
reduced, _ = sync.finish(grads, loss.detach())
for g, r in zip(grads, reduced):
    want = g / world
    dist.all_reduce(want)
    assert r.is_cuda and torch.equal(r, want), (r - want).abs().max()
dist.destroy_process_group()
'''


@pytest.mark.cuda
def test_gloo_bucketed_reduction_on_cuda_equals_the_f32_all_reduce(cuda, tmp_path):
    """Two ranks on the card over a caller-opened gloo group: under
    ``wire_dtype=None`` the bucketed reduction is the f32 all-reduce."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "worker.py"
    script.write_text(_GLOO_CUDA_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


_TP_CUDA_WORKER = r'''
import sys
import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), 2
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=rank,
                        world_size=world)
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.runtime import Runtime

runtime = Runtime(device="cuda", mesh_shape={"data": 1, "model": world})
gen = torch.Generator().manual_seed(11)
x = torch.randn(2, 64, 32, generator=gen).cuda()
w1 = torch.randn(32, 48, generator=gen).cuda()
w2 = torch.randn(48, 32, generator=gen).cuda()
d = runtime.axis_index("model")
out = {}
for mode in ("bulk", "ring"):
    with coll.tp_overlap(runtime, mode=mode, wire=None) as spec:
        xs = x.chunk(world, 1)[d].clone().requires_grad_(True)
        a, b = w1.chunk(world, 1)[d].clone().requires_grad_(True), w2.chunk(world, 0)[d].clone()
        b.requires_grad_(True)
        (h,) = coll.all_gather_matmul(spec, xs, (a,))
        y = coll.matmul_reduce_scatter(spec, torch.tanh(h), b)
        out[mode] = (y,) + torch.autograd.grad((y ** 2).sum(), (xs, a, b))
for got, want in zip(out["ring"], out["bulk"]):
    assert got.is_cuda and torch.allclose(got, want, rtol=0, atol=1e-4), (got - want).abs().max()
# The ring's hops crossed through host memory: gloo takes no CUDA pointer.
assert coll.STATS["staged"] and coll.STATS["calls"]["all_gather_matmul"]["ring"] == 1
dist.destroy_process_group()
'''


@pytest.mark.cuda
def test_gloo_tp_ring_on_cuda_equals_the_bulk_collectives(cuda, tmp_path):
    """Two ranks on the card over a caller-opened gloo group at
    ``{"data": 1, "model": 2}``: the ring's staged hops give the bulk
    collectives' forward and gradients."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    script = tmp_path / "worker.py"
    script.write_text(_TP_CUDA_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


# -- sync-BN, ring attention and the pipeline over gloo on the card --------------

_PAR_CUDA_WORKER = r'''
import json, os, sys
import torch
import torch.distributed as dist

rank, world, out = int(sys.argv[1]), 2, sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=rank,
                        world_size=world)
from rocket_tpu_torch.nn import layers
from rocket_tpu_torch.nn.attention import dot_product_attention
from rocket_tpu_torch.ops import fused_conv
from rocket_tpu_torch.parallel.ring_attention import STATS, ring_attention, seq_spec
from rocket_tpu_torch.runtime import Runtime

res = {}
gen = torch.Generator().manual_seed(5)
# Sync-BN: the fused kernel forced, two data ranks, each its half of the rows.
os.environ["ROCKET_TPU_FUSED_CONV"] = "pallas"
Runtime(device="cuda")
x = torch.randn(1024, 64, generator=gen).cuda() * 2 + 1
scale, bias = torch.rand(64, generator=gen).cuda() + 0.5, torch.randn(64, generator=gen).cuda()
dy = torch.randn(1024, 64, generator=gen).cuda()
fused_conv.bn_twopass.launches = fused_conv.bn_normalize.launches = 0
xs = x.chunk(world)[rank].clone().requires_grad_(True)
y, stats = layers.bn_act_train(xs, scale, bias, 1e-5, act=True)
(dx,) = torch.autograd.grad(y, xs, dy.chunk(world)[rank])
xw = x.clone().requires_grad_(True)
yw, stats_w = fused_conv.reference_bn_act(xw, scale, bias, 1e-5, True)
(dxw,) = torch.autograd.grad(yw, xw, dy)
res["bn"] = {"launches": fused_conv.bn_twopass.launches + fused_conv.bn_normalize.launches,
             "all_reduces": layers.SYNC_BN_STATS["all_reduces"], "cuda": y.is_cuda,
             "y": float((y - yw.chunk(world)[rank]).abs().max()),
             "stats": float((stats - stats_w).abs().max()),
             "dx": float((dx - dxw.chunk(world)[rank]).abs().max())}
# Ring attention over the seq group, K/V blocks staged through the host.
runtime = Runtime(device="cuda", mesh_shape={"data": 1, "seq": world})
q, k, v, w = (torch.randn(2, 4, 256, 64, generator=gen).cuda() for _ in range(4))
t = 256 // world
for causal in (True, False):
    ql, kl, vl = (a[:, :, rank * t:(rank + 1) * t].clone().requires_grad_(True) for a in (q, k, v))
    o = ring_attention(ql, kl, vl, seq_spec(runtime), causal)
    grads = torch.autograd.grad((o * w[:, :, rank * t:(rank + 1) * t]).sum(), (ql, kl, vl))
    qf, kf, vf = (a.clone().requires_grad_(True) for a in (q, k, v))
    full = dot_product_attention(qf, kf, vf, causal)
    want = torch.autograd.grad((full * w).sum(), (qf, kf, vf))
    sl = slice(rank * t, (rank + 1) * t)
    res[f"ring{int(causal)}"] = {
        "cuda": o.is_cuda, "out": float((o - full[:, :, sl]).abs().max()),
        "grads": [float((g - wg[:, :, sl]).abs().max()) for g, wg in zip(grads, want)]}
res["ring_staged"] = STATS["staged"]
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def par_cuda(tmp_path_factory):
    """The two-rank gloo group on the card running :data:`_PAR_CUDA_WORKER`."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tmp = tmp_path_factory.mktemp("par_cuda")
    script = tmp / "worker.py"
    script.write_text(_PAR_CUDA_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.cuda
def test_gloo_syncbn_on_cuda_never_launches_the_fused_kernels(par_cuda):
    """Two data ranks with ``ROCKET_TPU_FUSED_CONV=pallas``: rows 9-10
    launch no time (the reference's gate keeps multi-device traces on the
    reference path), two all-reduces a forward and backward, and the
    output, statistics and dx those of one BN over the whole batch (f32
    ``1e-4``: sums over two halves)."""
    for r in par_cuda:
        bn = r["bn"]
        assert bn["cuda"] and bn["launches"] == 0 and bn["all_reduces"] == 2, bn
        assert max(bn["y"], bn["stats"], bn["dx"]) <= 1e-4, bn


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_gloo_ring_attention_on_cuda_matches_full_attention(par_cuda, causal):
    """Ring attention over two seq ranks on CUDA tensors (its K/V hops
    staged through host memory): the output and the gradients of q, k and
    v those of full attention, f32 ``1e-4``."""
    for r in par_cuda:
        ring = r[f"ring{int(causal)}"]
        assert ring["cuda"] and r["ring_staged"]
        assert ring["out"] <= 1e-4 and max(ring["grads"]) <= 1e-4, ring


# -- expert parallelism: a rank's local experts ----------------------------------------


def _local_routing(gen, n_tok, e, lo, held, tile_m):
    """A seeded top-2 routing of ``n_tok`` tokens over ``e`` experts, as a
    rank holding experts ``[lo, lo + held)`` sorts it: its pairs first, by
    local expert, its group sizes summing below NK (``nn/moe.py``)."""
    pair_expert = torch.randint(0, e, (n_tok * 2,), generator=gen)
    mine = (pair_expert >= lo) & (pair_expert < lo + held)
    order = torch.argsort(torch.where(mine, pair_expert, pair_expert + e), stable=True)
    ids = torch.clamp(pair_expert - lo, 0, held - 1)
    counts = torch.zeros(held, dtype=torch.int32).scatter_add_(0, ids, mine.to(torch.int32))
    sorted_token = (torch.arange(n_tok).repeat_interleave(2))[order]
    return counts, sorted_token, ids[order], mine[order]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lo", [0, 2])
def test_local_expert_groups_match_plain(cuda, dtype, lo):
    """Rows 11, ``gmm`` and ``tgmm`` on one expert rank's two of four
    experts at the MoE's widths (the group-size sum below M, the rows past
    the groups zeros and no work), against their plain versions: the
    gather-GMM over the layout without the other ranks' rows, ``gmm`` in
    both modes and ``tgmm`` over the raw local counts; two launches
    bitwise."""
    gen = torch.Generator().manual_seed(40 + lo)
    n_tok, d, h = 1024, 768, 3072
    counts, sorted_token, sorted_expert, mine = _local_routing(gen, n_tok, 4, lo, 2, 128)
    nk = n_tok * 2
    assert 0 < int(counts.sum()) < nk
    row_ids, gsz, padded_pos, m = tgg.padded_group_layout(
        counts.cuda(), sorted_token.cuda(), 128, nk, sorted_expert=sorted_expert.cuda(),
        valid=mine.cuda())
    assert int(gsz.sum()) < m and int(padded_pos[~mine.cuda()].min()) == m
    x = (torch.randn(n_tok, d, generator=gen) * 0.5).to(dtype).cuda()
    w_in = (torch.randn(2, d, h, generator=gen) * d ** -0.5).to(dtype).cuda()
    before = (tgg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches)
    got = tgg.gather_gmm_fwd(x, w_in, row_ids, gsz, 128)
    _held(got, tgg.gather_gmm_reference(x, w_in, row_ids, gsz, 128), dtype)
    assert not got[int(gsz.sum()):].any()
    assert torch.equal(got, tgg.gather_gmm_fwd(x, w_in, row_ids, gsz, 128))
    xs = x[sorted_token.cuda()]
    lc = counts.cuda()
    hid = tgm.gmm(xs, w_in, lc)
    _held(hid, tgm.gmm_reference(xs, w_in, lc), dtype)
    assert not hid[int(counts.sum()):].any()
    back = tgm.gmm(hid, w_in, lc, transpose_rhs=True)  # the in-projection's dlhs
    _held(back, tgm.gmm_reference(hid, w_in, lc, transpose_rhs=True), dtype)
    assert not back[int(counts.sum()):].any()
    dy = (torch.randn(nk, h, generator=gen) * 0.5).to(dtype).cuda()
    dw = tgm.tgmm(xs, dy, lc)
    _held(dw, tgm.tgmm_reference(xs, dy, lc), dtype)
    assert torch.equal(dw, tgm.tgmm(xs, dy, lc))
    assert (tgg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)


_EP_CUDA_WORKER = r'''
import json, os, sys
import torch
import torch.distributed as dist

rank, world, out = int(sys.argv[1]), 2, sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=rank,
                        world_size=world)
torch.backends.cuda.matmul.allow_tf32 = False
from rocket_tpu_torch.nn.moe import MoE
from rocket_tpu_torch.ops import gather_gmm as tgg
from rocket_tpu_torch.ops import grouped_matmul as tgm
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.runtime import Runtime

runtime = Runtime(device="cuda", mesh_shape={"data": 1, "expert": world})
res = {}
for dispatch, forced in (("dropless", "fused"), ("einsum", None)):
    os.environ.pop("ROCKET_TPU_MOE_GMM", None)
    if forced:
        os.environ["ROCKET_TPU_MOE_GMM"] = forced
    for dtype in (torch.float32, torch.bfloat16):
        moe = MoE(768, 3072, 4, top_k=2, dispatch=dispatch)
        gen = torch.Generator().manual_seed(7)
        params = moe.init_params(gen)
        x = (torch.randn(2, 512, 768, generator=gen) * 0.5).to(dtype).cuda()
        cot = torch.randn(2, 512, 768, generator=gen).to(dtype).cuda()

        def run(p, ep):
            p = {"router": {"w": p["router"]["w"].cuda().requires_grad_(True)},
                 "experts": {k: v.cuda().requires_grad_(True) for k, v in p["experts"].items()}}
            xx = x.clone().requires_grad_(True)
            launches = (tgg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches)
            inputs = [p["router"]["w"], xx] + list(p["experts"].values())
            if ep:
                with coll.expert_parallel(runtime):
                    y, aux = moe.apply(p, xx)
                    loss = (y.float() * cot.float()).sum() + aux["aux_loss"]
                    grads = torch.autograd.grad(loss, inputs)
            else:
                y, aux = moe.apply(p, xx)
                loss = (y.float() * cot.float()).sum() + aux["aux_loss"]
                grads = torch.autograd.grad(loss, inputs)
            now = (tgg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches)
            return y.detach(), grads[:2], [b - a for a, b in zip(launches, now)]

        y1, g1, n1 = run(params, False)
        local = {"router": params["router"],
                 "experts": {k: v.chunk(world, 0)[rank] for k, v in params["experts"].items()}}
        y2, g2, n2 = run(local, True)
        name = f"{dispatch}_{str(dtype).removeprefix('torch.')}"
        res[name] = {"cuda": y2.is_cuda, "bitwise": bool(torch.equal(y1, y2)),
                     "y": float((y1.float() - y2.float()).abs().max()),
                     "y_scale": float(y1.float().abs().max()),
                     "grads": [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                               for a, b in zip(g2, g1)],
                     "one_rank_launches": n1, "launches": n2}
res["calls"] = coll.STATS["calls"]
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ep_cuda(tmp_path_factory):
    """Two expert ranks on the card over a gloo group, running
    :data:`_EP_CUDA_WORKER`."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tmp = tmp_path_factory.mktemp("ep_cuda")
    script = tmp / "worker.py"
    script.write_text(_EP_CUDA_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dropless_float32", "dropless_bfloat16", "einsum_float32",
                                  "einsum_bfloat16"])
def test_gloo_expert_parallel_moe_on_cuda_matches_one_rank(ep_cuda, case):
    """The MoE layer over two expert ranks on the card (gloo), dropless with
    the fused kernels forced and einsum, against one rank's layer: the
    output within the dtype's tolerance of its scale and bitwise where the
    order of a token's k = 2 adds cannot matter: dropless (the two
    gate-weighted rows add onto zero in either order, on one rank or
    across the two) and einsum in bf16 (its two products of bf16 values are
    exact in the f32 sum, rounded once); einsum in f32 rounds each rank's
    product before the sum, one rank's inside it. The router's and the
    input's gradients
    (all-reduced over the expert group) within it; each rank launching
    rows 11, ``gmm`` and ``tgmm`` as often as the one rank."""
    dtype = torch.float32 if case.endswith("float32") else torch.bfloat16
    for r in ep_cuda:
        rec = r[case]
        assert rec["cuda"] and rec["y"] <= TOL[dtype] * (1.0 + rec["y_scale"]), rec
        assert max(rec["grads"]) <= TOL[dtype], rec
        assert rec["launches"] == rec["one_rank_launches"], rec
        assert rec["bitwise"] or case == "einsum_float32", rec
        if case.startswith("dropless"):
            assert rec["launches"] == [1, 3, 2], rec
    assert ep_cuda[0]["calls"]["ep_combine"]["bulk"] == 4


# -- a non-ring attention on a seq-sharded batch: rows 3-5 on the gathered sequence ----

_SEQ_FLASH_CUDA_WORKER = r'''
import json, os, sys
import torch
import torch.distributed as dist

rank, world, out = int(sys.argv[1]), 2, sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[2]}", rank=rank,
                        world_size=world)
torch.backends.cuda.matmul.allow_tf32 = False
from rocket_tpu_torch.nn.attention import MultiHeadAttention
from rocket_tpu_torch.ops import flash_native as fa
from rocket_tpu_torch.runtime import Runtime

Runtime(device="cuda", mesh_shape={"data": 1, "seq": world})
res = {}
b, t, dim, h = 2, 512, 256, 4
sl = slice(rank * t // world, (rank + 1) * t // world)
for dtype in (torch.float32, torch.bfloat16):
    for rope in (False, True):
        for split in (False, True):
            gen = torch.Generator().manual_seed(7)
            # The dq strategy: row 4's partials, or row 5 past the byte bound.
            fa.DQ_PARTIALS_MAX_BYTES = 0 if split else 1 << 30
            attn = MultiHeadAttention(dim, h, impl="flash", rope=rope)
            params = {k: {kk: vv.cuda() for kk, vv in v.items()}
                      for k, v in attn.init_params(gen).items()}
            leaves = [params[k][kk].requires_grad_(True) for k in ("qkv", "proj")
                      for kk in ("w", "b")]
            x = torch.randn(b, t, dim, generator=gen).cuda().to(dtype)
            w = torch.randn(b, t, dim, generator=gen).cuda().to(dtype)
            xl = x[:, sl].clone().requires_grad_(True)
            for kernel in (fa.flash_fwd, fa.flash_bwd, fa.flash_dq):
                kernel.launches = 0
            y = attn.apply(params, xl, mode="eval")
            got = torch.autograd.grad((y.float() * w[:, sl].float()).sum(), [xl] + leaves)
            launches = [fa.flash_fwd.launches, fa.flash_bwd.launches, fa.flash_dq.launches]
            # Each rank's param gradients are its rows' share: summed over the
            # seq group they are the whole sequence's.
            grads = [g.float().clone() for g in got[1:]]
            for g in grads:
                dist.all_reduce(g)
            # The whole sequence on this rank alone, through the plain path.
            plain = MultiHeadAttention(dim, h, impl="plain", rope=rope)
            xw = x.clone().requires_grad_(True)
            yw = plain._apply_whole(params, xw, "eval", None)
            want = torch.autograd.grad((yw.float() * w.float()).sum(), [xw] + leaves)

            def err(a, b):
                a, b = a.detach().float(), b.detach().float()
                return float(((a - b).abs() / (1 + b.abs())).max())

            res[f"{dtype}/{rope}/{split}"] = {
                "cuda": y.is_cuda, "launches": launches, "out": err(y, yw[:, sl]),
                "dx": err(got[0], want[0][:, sl]),
                "dparams": max(float((g - wg.float()).abs().max() / (1 + wg.float().abs().max()))
                               for g, wg in zip(grads, want[1:]))}
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def seq_flash_cuda(tmp_path_factory):
    """The two-rank gloo group on the card running
    :data:`_SEQ_FLASH_CUDA_WORKER`."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tmp = tmp_path_factory.mktemp("seq_flash_cuda")
    script = tmp / "worker.py"
    script.write_text(_SEQ_FLASH_CUDA_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_gloo_seq_gathered_flash_on_cuda_matches_plain(seq_flash_cuda, dtype, rope, split):
    """A flash attention on a seq-sharded batch over two gloo ranks: each
    gathers the sequence's q, k and v and runs rows 3 and 4 (and row 5
    past the dq byte bound) on it whole; the rank's rows of the output and
    of dx, and the param gradients summed over the ranks, against the
    plain path on the whole sequence (``tol * (1 + |want|)``). Row 3 on
    the fused operand without RoPE, on q/k/v with it."""
    for r in seq_flash_cuda:
        rec = r[f"{dtype}/{rope}/{split}"]
        assert rec["cuda"] and rec["launches"] == [1, 1, int(split)], rec
        assert max(rec["out"], rec["dx"], rec["dparams"]) <= TOL[dtype], rec


# -- the launches' declared work (PERF.md section 6's bound formulas) ---------


def _declared(fn, *args, **kw) -> list:
    """The LaunchFacts ``fn`` declares for these meta operands, on this card
    (its SM count sizes the persistent grids)."""
    from rocket_tpu_torch.ops._launch import record_launches
    from rocket_tpu_torch.tune import priced_device_kind

    with priced_device_kind(torch.cuda.get_device_name(0)), record_launches() as facts:
        fn(*args, **kw)
    return facts


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _work(facts) -> tuple:
    return sum(f.bytes for f in facts), sum(f.flops for f in facts)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hq,hkv,d,dtype", [(8, 1024, 12, 12, 64, torch.bfloat16),
                                                (4, 256, 8, 4, 32, torch.float32)])
def test_flash_launch_facts_declare_the_bound_formulas_work(cuda, b, t, hq, hkv, d, dtype):
    """Rows 3-5: the work each meta launch declares is PERF.md's bound
    formula (each input read once, each output written once, 2*D flops per
    visible pair and product), and a launch on the card counts one."""
    item = torch.empty((), dtype=dtype).element_size()
    q, k, v = _meta(b, t, hq * d, dtype=dtype), _meta(b, t, hkv * d, dtype=dtype), \
        _meta(b, t, hkv * d, dtype=dtype)
    qkv, act, stats = b * t * (hq + 2 * hkv) * d * item, b * t * hq * d * item, b * hq * t * 4
    pairs = b * hq * t * (t + 1) / 2
    dkv = 2 * b * t * hkv * d * item
    fwd = _declared(tfn.flash_fwd, q, k, v, hq, hkv, d, (0, 0, 0), True)
    assert _work(fwd) == (qkv + act + stats, 4 * d * pairs)
    out, lse = _meta(b, t, hq * d, dtype=dtype), _meta(b, hq, t, dtype=torch.float32)
    bwd = _declared(tfn.flash_bwd, q, k, v, out, lse, lse, hq, hkv, d, (0, 0, 0), True)
    assert _work(bwd) == (qkv + 2 * act + 2 * stats + dkv, 10 * d * pairs)
    dq = _declared(tfn.flash_dq, q, k, v, out, lse, lse, hq, hkv, d, (0, 0, 0), True)
    assert _work(dq) == (qkv + 2 * act + 2 * stats, 6 * d * pairs)
    gen = torch.Generator().manual_seed(b + t)
    before = tfn.flash_fwd.launches
    tfn.flash_fwd(_randn(gen, dtype, b, t, hq * d), _randn(gen, dtype, b, t, hkv * d),
                  _randn(gen, dtype, b, t, hkv * d), hq, hkv, d, (0, 0, 0), True)
    torch.cuda.synchronize()
    assert tfn.flash_fwd.launches - before == len(fwd) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 12, 1024, 64, torch.bfloat16, 128),
                                   (2, 4, 512, 32, torch.float32, 64)])
def test_qkv_block_bn_facts_declare_the_bound_formulas_work(cuda, shape):
    """Rows 6-10 at two shapes each."""
    b, h, t, d, dtype, blk = shape
    item = torch.empty((), dtype=dtype).element_size()
    act, stats, pairs = b * h * t * d * item, b * h * t * 4, b * h * t * (t + 1) / 2
    qkv = _meta(3, b, h, t, d, dtype=dtype)
    fwd = _declared(tfa.flash_qkv_fwd, qkv, True, blk, blk)
    assert _work(fwd) == (4 * act + stats, 4 * d * pairs)
    out, lse = _meta(b, h, t, d, dtype=dtype), _meta(b, h, 1, t, dtype=torch.float32)
    bwd = _declared(tfa.flash_qkv_bwd, qkv, out, lse, out, lse, True, blk, blk)
    assert _work(bwd) == (6 * act + 2 * stats + (t // blk) * act, 10 * d * pairs)
    for bb, tt, dd, ep in ((128, 256, 256, "fused"), (3, 100, 256, "separate")):
        w = (dd * 3 * dd + 3 * dd) * item + 2 * dd * 4 + ((dd * dd + dd) * item if ep == "fused"
                                                         else 0)
        flops = 2 * bb * tt * dd * 3 * dd + 4 * 64 * 4 * bb * tt * (tt + 1) / 2 + (
            2 * bb * tt * dd * dd if ep == "fused" else 0)
        fact = tfb.fused_block_launch(bb, tt, dd, 4, dtype, ep)
        assert (fact.bytes, fact.flops) == (2 * bb * tt * dd * item + w, flops)
    for n, c in ((524288, 64), (8192, 512)):
        x, sc = _meta(n, c, dtype=dtype), _meta(2, c, dtype=torch.float32)
        two = _declared(tfc.bn_twopass, x, sc, eps=1e-5, act=True)
        norm = _declared(tfc.bn_normalize, x, _meta(4, c, dtype=torch.float32), act=True)
        assert _work(two) == (2 * n * c * item + 16 * c, 7.0 * n * c)
        assert _work(norm) == (2 * n * c * item + 16 * c, 4.0 * n * c)
        assert all(f.flop_dtype == "float32" for f in two + norm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_and_grouped_facts_declare_the_bound_formulas_work(cuda, dtype):
    """Rows 1-2 at a cache position and full pages, row 11, gmm and tgmm
    with every row grouped (what a meta launch, which sees no data, counts)."""
    item = torch.empty((), dtype=dtype).element_size()
    for b, hq, hkv, d, t, pos in ((4, 12, 12, 64, 192, 191), (1, 8, 4, 32, 68, 67)):
        cache = _meta(b, hkv, t, d, dtype=dtype)
        facts = _declared(tda.decode_attention, _meta(b, hq, d, dtype=dtype),
                          _meta(b, hkv, d, dtype=dtype), _meta(b, hkv, d, dtype=dtype), cache,
                          cache, pos)
        assert _work(facts) == (2 * b * hkv * pos * d * item + 2 * b * hq * d * item
                                + 4 * b * hkv * d * item, 4.0 * b * hq * d * (pos + 1))
    for s, hq, hkv, d, mb, bl in ((8, 12, 12, 64, 64, 16), (8, 12, 4, 64, 9, 16)):
        pool = _meta(1 + s * mb, bl, hkv, d, dtype=dtype)
        facts = _declared(tpa.paged_decode, _meta(s, hq, d, dtype=dtype), pool, pool,
                          _meta(s, mb, dtype=torch.int32), _meta(s, dtype=torch.int32))
        rows = s * mb * bl
        assert _work(facts) == (2 * rows * hkv * d * item + 2 * s * hq * d * item
                                + 4 * s * mb + 4 * s, 4.0 * rows * hq * d)
    for m, k, n, e in ((18432, 768, 3072, 4), (2048, 256, 512, 8)):
        sizes = _meta(e, dtype=torch.int32)
        g = _declared(tgm.gmm, _meta(m, k, dtype=dtype), _meta(e, k, n, dtype=dtype), sizes)
        assert _work(g) == (m * k * item + e * k * n * item + m * n * item + 4 * e,
                            2.0 * m * k * n)
        tg = _declared(tgm.tgmm, _meta(m, k, dtype=dtype), _meta(m, n, dtype=dtype), sizes)
        assert _work(tg) == (m * k * item + m * n * item + e * k * n * item + 4 * e,
                             2.0 * m * k * n)
        gg = _declared(tgg.gather_gmm_fwd, _meta(m // 2, k, dtype=dtype),
                       _meta(e, k, n, dtype=dtype), _meta(m, dtype=torch.int32), sizes, 128)
        assert _work(gg) == ((m // 2) * k * item + 4 * m + e * k * n * item + m * n * item
                             + 4 * e, 2.0 * m * k * n)


@pytest.mark.cuda
def test_small_lm_step_peak_reconciles_with_its_liveness(cuda):
    """The memory audit held to the allocator (RKT805): one AdamW train step
    of a small LM (the audit LM at T=256, flash attention, whole-forward
    remat), its second (the moments exist), measured on the card by
    ``max_memory_allocated`` against the liveness peak of the same step
    traced on meta tensors and priced as this card, within the floor."""
    from rocket_tpu_torch import optim
    from rocket_tpu_torch.analysis.mem_audit import audit_memory, train_state
    from rocket_tpu_torch.analysis.rules.mem_rules import check_reconciliation
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _train_parts
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss

    cfg = _lm_config(max_seq_len=256, attention_impl="auto", dropout=0.1)

    def parts(device):
        tokens = torch.zeros((16, 256), dtype=torch.int32, device=device)
        return _train_parts(TransformerLM(cfg), {"tokens": tokens},
                            make_opt=optim.adamw(weight_decay=0.1), loss_fn=next_token_loss(),
                            device=device)

    step, args = parts("meta")
    record = audit_memory(step, *args, state=lambda: train_state(step), warmup=1,
                          device_kind=torch.cuda.get_device_name(0), slope=False).record
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step, args = parts("cuda")
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert check_reconciliation(record["predicted_peak_bytes"], measured) == []


# -- the declared f32 accumulators at the main paths' longest contractions ----


@pytest.mark.cuda
def test_grouped_kernels_accumulate_in_f32(cuda):
    """gmm over K = 3072 and tgmm over each group's rows of 18,432 routed
    rows, bf16: each kernel's error against the f64 sum is below the same
    sum carried in bf16 one WG_SLICE at a time (``ops/accuracy.py``)."""
    from rocket_tpu_torch.ops import accuracy

    gen = torch.Generator().manual_seed(26)
    sizes = torch.tensor([4608, 4480, 4736, 4608], dtype=torch.int32, device="cuda")
    h = (torch.randn(18432, 3072, generator=gen) * 0.5).to(torch.bfloat16).cuda()
    w_out = (torch.randn(4, 3072, 768, generator=gen) * 3072 ** -0.5).to(torch.bfloat16).cuda()
    x = (torch.randn(18432, 768, generator=gen) * 0.5).to(torch.bfloat16).cuda()
    dy = (torch.randn(18432, 3072, generator=gen) * 0.5).to(torch.bfloat16).cuda()
    for kind, args, out in (("gmm", (h, w_out), tgm.gmm(h, w_out, sizes)),
                            ("tgmm", (x, dy), tgm.tgmm(x, dy, sizes))):
        errs = accuracy.grouped_errors(kind, *args, sizes, out, tgm.WG_SLICE)
        assert errs["kernel"] < errs["bf16_tiles"], (kind, errs)


@pytest.mark.cuda
def test_flash_bwd_accumulates_dk_dv_in_f32(cuda):
    """Row 4's dk and dv over T = 1024 queries (GPT-2's heads, bf16,
    causal): below the bf16 tile-wise sum's error against f64."""
    from rocket_tpu_torch.ops import accuracy

    gen = torch.Generator().manual_seed(27)
    b, t, h, d = 2, 1024, 12, 64
    arr = _randn(gen, torch.bfloat16, b, t, 3 * h * d)
    geo = (h, h, d, (0, h * d, 2 * h * d), True)
    out, lse = tfn.flash_fwd(arr, arr, arr, *geo)
    dout = _randn(gen, torch.bfloat16, b, t, h * d)
    delta = (dout.float() * out.float()).reshape(b, t, h, d).sum(-1).transpose(1, 2).contiguous()
    _, dk, dv = tfn.flash_bwd(arr, arr, arr, dout, lse, delta, *geo, with_dq=False)
    p, ds, q, _k, do = tfn._probs_and_ds(arr, arr, arr, dout, lse, delta, h, h, d, geo[3], True)
    for name, errs in accuracy.flash_bwd_errors(p, ds, q, do, dk, dv, tfn.TILE).items():
        assert errs["kernel"] < errs["bf16_tiles"], (name, errs)
