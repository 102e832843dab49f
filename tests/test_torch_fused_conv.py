"""The port's fused BatchNorm(+relu) epilogue (``ops/fused_conv.py``) and
its call-site seam (``nn/layers.bn_act_train``) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. On the
CPU the port's kernel wrappers run their plain versions; the JAX
``fused_bn_act`` runs its Pallas kernels in interpret mode (as
``tests/test_fused_kernels.py`` runs them). Each case compares y, the
(C, 2) stats and the gradients of ``sum(y^2)`` with respect to x, scale
and bias.

Tolerances: float32 ``|got - want| <= 5e-5 + 5e-5 * |want|`` element by
element — the reference's own parity bound for this kernel
(``rocket_tpu/tune/space.py``: its moments are reassociated f32 sums);
bfloat16 y element by element within ``2e-2 * (1 + |want|)`` (one bf16
rounding of values summed in another order), and the gradients, large
f32 sums over bf16 operands, within 2e-2 of their norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.nn import layers as jl
from rocket_tpu.ops import fused_conv as jfc
from rocket_tpu_torch.nn import layers as tl
from rocket_tpu_torch.ops import fused_conv as tfc

F32_TOL = (5e-5, 5e-5)
BF16_TOL = 2e-2


def _operands(seed, b=8, hw=8, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32) + 0.3
    scale = 1.0 + 0.1 * rng.normal(size=(c,)).astype(np.float32)
    bias = 0.1 * rng.normal(size=(c,)).astype(np.float32)
    return x, scale, bias


def _jax_run(fn, x, scale, bias, dtype=jnp.float32):
    """(y, stats, dx, dscale, dbias) as f32 numpy for L = sum(y^2)."""
    def loss(x, scale, bias):
        y, stats = fn(x, scale, bias)
        return (y.astype(jnp.float32) ** 2).sum(), (y, stats)

    (_, (y, stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x).astype(dtype), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(a, dtype=np.float32) for a in (y, stats, *grads)]


def _torch_run(fn, x, scale, bias, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, stats = fn(xt, st, bt)
    grads = torch.autograd.grad(y.float().square().sum(), (xt, st, bt))
    return [a.detach().float().numpy() for a in (y, stats, *grads)]


def _assert_f32(got, want):
    atol, rtol = F32_TOL
    for name, g, w in zip(("y", "stats", "dx", "dscale", "dbias"), got, want):
        assert g.shape == w.shape, name
        excess = np.abs(g - w) - (atol + rtol * np.abs(w))
        assert excess.max() <= 0, f"{name}: off by {excess.max()} past the bound"


@pytest.mark.parametrize("schedule", ["twopass", "stats_xla"])
@pytest.mark.parametrize("act", [True, False])
def test_fused_bn_act_matches_the_interpreted_kernel_and_the_reference(schedule, act):
    x, scale, bias = _operands(1)
    got = _torch_run(lambda *a: tfc.fused_bn_act(*a, eps=1e-5, act=act, schedule=schedule,
                                                 block_rows=128), x, scale, bias)
    kernel = _jax_run(lambda *a: jfc.fused_bn_act(*a, eps=1e-5, act=act, schedule=schedule,
                                                  block_rows=128, interpret=True),
                      x, scale, bias)
    _assert_f32(got, kernel)
    _assert_f32(got, _jax_run(lambda *a: jfc.reference_bn_act(*a, 1e-5, act), x, scale, bias))


@pytest.mark.parametrize("act", [True, False])
def test_reference_bn_act_matches_jax(act):
    x, scale, bias = _operands(2, b=4, hw=5, c=24)
    got = _torch_run(lambda *a: tfc.reference_bn_act(*a, 1e-5, act), x, scale, bias)
    _assert_f32(got, _jax_run(lambda *a: jfc.reference_bn_act(*a, 1e-5, act), x, scale, bias))


@pytest.mark.parametrize("schedule", ["twopass", "stats_xla"])
def test_fused_bn_act_bf16(schedule):
    x, scale, bias = _operands(3, b=16, hw=8, c=32)
    got = _torch_run(lambda *a: tfc.fused_bn_act(*a, eps=1e-5, act=True, schedule=schedule,
                                                 block_rows=256), x, scale, bias, torch.bfloat16)
    want = _jax_run(lambda *a: jfc.fused_bn_act(*a, eps=1e-5, act=True, schedule=schedule,
                                                block_rows=256, interpret=True),
                    x, scale, bias, jnp.bfloat16)
    y, w = got[0], want[0]
    assert (np.abs(y - w) - BF16_TOL * (1 + np.abs(w))).max() <= 0
    np.testing.assert_allclose(got[1], want[1], atol=F32_TOL[0], rtol=F32_TOL[1])
    for name, g, w in zip(("dx", "dscale", "dbias"), got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= BF16_TOL * np.linalg.norm(w), name


def test_fused_bn_act_rejects_what_the_reference_rejects():
    x, scale, bias = (torch.from_numpy(a) for a in _operands(4))
    with pytest.raises(ValueError, match="tile block_rows"):
        tfc.fused_bn_act(x, scale, bias, block_rows=384)
    with pytest.raises(ValueError, match="unknown schedule"):
        tfc.fused_bn_act(x, scale, bias, schedule="retired", block_rows=128)
    assert tfc.fused_bn_act_supported(512, 128, 4) == jfc.fused_bn_act_supported(512, 128, 4)
    for n, rows, item in ((512, 8, 4), (512, 8, 2), (512, 16, 2), (500, 128, 4), (64, 32, 1)):
        assert tfc.fused_bn_act_supported(n, rows, item) == jfc.fused_bn_act_supported(
            n, rows, item)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    x, scale, bias = (torch.from_numpy(a).reshape(-1, a.shape[-1]) for a in _operands(5))
    sc = torch.stack([scale.reshape(-1), bias.reshape(-1)])
    before = (tfc.bn_twopass.launches, tfc.bn_normalize.launches)
    y, stats = tfc.bn_twopass(x, sc, eps=1e-5, act=True)
    want_y, want_stats = tfc.bn_twopass_plain(x, sc, eps=1e-5, act=True)
    assert torch.equal(y, want_y) and torch.equal(stats, want_stats)
    mi = tfc.epilogue_rows(stats, sc[0], sc[1], 1e-5)
    assert torch.equal(tfc.bn_normalize(x, mi, act=False), tfc.bn_normalize_plain(x, mi, act=False))
    assert (tfc.bn_twopass.launches, tfc.bn_normalize.launches) == before
    assert tfc.kernel_supported(64, torch.float32) and tfc.kernel_supported(2048, torch.bfloat16)
    # The kernels take what the reference's kernel takes: any C (past
    # MAX_C in chunks) and f16 too; only f64 stays out.
    assert tfc.kernel_supported(12, torch.float32) and tfc.kernel_supported(3, torch.float32)
    assert tfc.kernel_supported(4096, torch.float32)
    assert tfc.kernel_supported(64, torch.float16)
    assert not tfc.kernel_supported(64, torch.float64)


def _count_fused(monkeypatch):
    calls = []
    real = tfc.fused_bn_act

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfc, "fused_bn_act", spy)
    return calls


def test_seam_unforced_is_bitwise_bn_train_then_relu(monkeypatch):
    monkeypatch.delenv("ROCKET_TPU_FUSED_CONV", raising=False)
    calls = _count_fused(monkeypatch)
    x, scale, bias = _operands(6)
    seam = _torch_run(lambda *a: tl.bn_act_train(*a, 1e-5, act=True), x, scale, bias)

    def manual(x, scale, bias):
        y, stats = tl._bn_train(x, scale, bias, 1e-5)
        return tl.relu().fn(y), stats

    for got, want in zip(seam, _torch_run(manual, x, scale, bias)):
        np.testing.assert_array_equal(got, want)
    assert calls == []


def test_seam_forced_runs_the_plain_kernel_as_jax_runs_it_interpreted(monkeypatch):
    x, scale, bias = _operands(7)
    monkeypatch.setenv("ROCKET_TPU_FUSED_CONV", "pallas")
    calls = _count_fused(monkeypatch)
    got = _torch_run(lambda *a: tl.bn_act_train(*a, 1e-5, act=True), x, scale, bias)
    assert calls == [dict(eps=1e-5, act=True, schedule="twopass", block_rows=512)]
    want = _jax_run(lambda *a: jl.bn_act_train(*a, 1e-5, act=True), x, scale, bias)
    _assert_f32(got, want)
    # A shape past the reference's gate (N = 8 * 5 * 5 does not tile 512)
    # stays on the reference path.
    x, scale, bias = _operands(8, b=8, hw=5)
    _torch_run(lambda *a: tl.bn_act_train(*a, 1e-5, act=False), x, scale, bias)
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["float16", "c12", "c4096"])
def test_seam_forced_sends_what_the_kernel_does_not_take_to_fused_bn_act(case, monkeypatch):
    """The gate is the reference's shape gate alone: forced, float16, C not
    a multiple of 8 and C past 2048 reach ``fused_bn_act`` (on a CUDA tensor
    the kernel runs them: f16, the any form, channel chunks); on the CPU it
    runs the plain version, equal to the reference path."""
    monkeypatch.setenv("ROCKET_TPU_FUSED_CONV", "pallas")
    calls = _count_fused(monkeypatch)
    c = {"float16": 16, "c12": 12, "c4096": 4096}[case]
    dtype = torch.float16 if case == "float16" else torch.float32
    x, scale, bias = (torch.from_numpy(a) for a in _operands(10, b=2, hw=16, c=c))
    y, stats = tl.bn_act_train(x.to(dtype), scale, bias, 1e-5, act=True)
    assert len(calls) == 1 and y.dtype == dtype
    want_y, want_stats = tfc.reference_bn_act(x.to(dtype), scale, bias, 1e-5, True)
    assert torch.equal(y, want_y) and torch.equal(stats, want_stats)


def test_seam_reads_the_table_entry_it_is_given(monkeypatch):
    """A ``fused_conv`` table entry (the reference's table is empty, so a
    stand-in) picks the schedule and block rows; unforced it engages only
    on CUDA tensors, as the reference's does only off the CPU."""
    monkeypatch.delenv("ROCKET_TPU_FUSED_CONV", raising=False)
    monkeypatch.setattr(tl, "_fused_conv_config", lambda n, c, dtype: {
        "impl": "pallas", "schedule": "stats_xla", "block_rows": 256})
    calls = _count_fused(monkeypatch)
    x, scale, bias = (torch.from_numpy(a) for a in _operands(9))
    tl.bn_act_train(x, scale, bias, 1e-5, act=True)
    assert calls == []
    monkeypatch.setenv("ROCKET_TPU_FUSED_CONV", "pallas")
    tl.bn_act_train(x, scale, bias, 1e-5, act=True)
    assert calls == [dict(eps=1e-5, act=True, schedule="stats_xla", block_rows=256)]


# -- what the CUDA kernels take since the coverage repair: f16, any C, C past
# MAX_C in chunks (the shapes the card holds to plain in chip_smoke).

COVERAGE = {  # case -> (torch dtype, jax dtype, C)
    "f16_c64": (torch.float16, jnp.float16, 64),
    "f32_c3": (torch.float32, jnp.float32, 3),
    "bf16_c12": (torch.bfloat16, jnp.bfloat16, 12),
    "f32_c4096": (torch.float32, jnp.float32, 4096),
}


@pytest.mark.parametrize("case", list(COVERAGE))
def test_coverage_shapes_take_the_kernel_route_and_pass_rkt504(case, monkeypatch):
    """On meta tensors the forced seam sends each shape to the kernel route:
    one row 9 launch a channel chunk (the vec form where the rows are whole
    16-byte vectors, the any form otherwise), and the declared launches
    are RKT504-clean priced as an H100."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.analysis.rules.sched_rules import check_launches
    from rocket_tpu_torch.ops._launch import record_launches
    from rocket_tpu_torch.utils.perf import device_spec

    dtype, _, c = COVERAGE[case]
    monkeypatch.setenv("ROCKET_TPU_FUSED_CONV", "pallas")
    card = "NVIDIA H100 80GB HBM3"
    x = torch.empty(2, 16, 16, c, dtype=dtype, device="meta")
    scale, bias = torch.empty(c, device="meta"), torch.empty(c, device="meta")
    with tune.priced_device_kind(card), record_launches() as facts:
        y, stats = tl.bn_act_train(x, scale, bias, 1e-5, act=True)
        tfc.bn_normalize(x.reshape(-1, c), torch.empty(4, c, device="meta"), act=True)
    assert y.shape == x.shape and y.dtype == dtype and stats.shape == (c, 2)
    names = [f.name for f in facts]
    form = "" if c % (16 // x.element_size()) == 0 else "_any"
    chunks = len(tfc.chunks(c))
    assert names == [f"bn_twopass{form}"] * chunks + [f"bn_normalize{form}"] * chunks
    assert chunks == (2 if c == 4096 else 1)
    assert check_launches(facts, device_spec(card)) == []


@pytest.mark.parametrize("offset", [0, 1])
def test_meta_route_declares_the_form_a_view_launches(offset):
    """A view whose first element is off a 16-byte boundary launches the any
    form on the card; the meta route declares that same form from the
    view's offset into its storage."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops._launch import record_launches

    base = torch.empty(4096 * 64 + 1, dtype=torch.bfloat16, device="meta")
    x = base[offset:offset + 4096 * 64].view(4096, 64)
    sc, mi = torch.empty(2, 64, device="meta"), torch.empty(4, 64, device="meta")
    with tune.priced_device_kind("NVIDIA H100 80GB HBM3"), record_launches() as facts:
        tfc.bn_twopass(x, sc, eps=1e-5, act=True)
        tfc.bn_normalize(x, mi, act=True)
    form = "_any" if offset else ""
    assert [f.name for f in facts] == [f"bn_twopass{form}", f"bn_normalize{form}"]


@pytest.mark.parametrize("schedule", ["twopass", "stats_xla"])
@pytest.mark.parametrize("case", list(COVERAGE))
def test_coverage_shapes_plain_matches_the_interpreted_kernel(case, schedule):
    """The plain versions (what the kernels are held to on the card) against
    the JAX package's kernel in interpret mode at the coverage shapes."""
    tdtype, jdtype, c = COVERAGE[case]
    x, scale, bias = _operands(11, b=2, hw=16, c=c)
    got = _torch_run(lambda *a: tfc.fused_bn_act(*a, eps=1e-5, act=True, schedule=schedule,
                                                 block_rows=512), x, scale, bias, tdtype)
    want = _jax_run(lambda *a: jfc.fused_bn_act(*a, eps=1e-5, act=True, schedule=schedule,
                                                block_rows=512, interpret=True),
                    x, scale, bias, jdtype)
    if tdtype == torch.float32:
        _assert_f32(got, want)
        return
    y, w = got[0], want[0]
    assert (np.abs(y - w) - BF16_TOL * (1 + np.abs(w))).max() <= 0
    np.testing.assert_allclose(got[1], want[1], atol=F32_TOL[0], rtol=F32_TOL[1])
    for name, g, w in zip(("dx", "dscale", "dbias"), got[2:], want[2:]):
        assert np.linalg.norm(g - w) <= BF16_TOL * np.linalg.norm(w), name
