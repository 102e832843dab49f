"""``rocket_tpu_torch.tune`` — table lookup, the parity gate, the table gate
and the CLI, on the CPU (the counterpart of ``tests/test_tune.py`` where
it maps onto the port).

* table round trip, longest-prefix matching on CUDA device names, exact
  bucket and dtype, ``ROCKET_TPU_TUNE=0``, the lookup log, unknown kernels;
* with no table entry every call site runs bitwise what it ran before the
  tables existed (flash rows 6-7, ``bn_act_train``, ``gmm_config``, the
  block-attention gate, paged decode);
* table entries steer the call sites (flash blocks, ``paged_decode``
  impl, ``fused_conv`` and ``moe_gmm`` configs), explicit forward blocks
  suppress the backward table;
* the sweep rejects a wrong candidate before timing and accepts a
  parity-equal one; the parity tolerances; the table gate (missing,
  stale, illegal, unknown device, stale structural winner); the shipped
  tables; the CLI's exit codes and its ``--allow-cpu`` smoke;
* schema parity: a table the port writes loads in the reference's
  ``load_table`` and resolves through the reference's lookup.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rocket_tpu_torch import tune
from rocket_tpu_torch.tune.space import TUNE_SPACES, TuneSpace
from rocket_tpu_torch.tune.tuner import (
    CandidateResult,
    CaseReport,
    TuneCase,
    check_parity,
    run_cases,
    sweep_case,
    update_tables,
)
from rocket_tpu_torch.utils.perf import DeviceSpec, device_spec

H100 = "NVIDIA H100 80GB HBM3"
FLASH_SHAPE = {"t": 256, "d": 64, "h": 2, "h_kv": 2, "causal": True}
PAGED_SHAPE = {"s": 2, "mb": 2, "bl": 16, "hkv": 2, "hq": 2, "d": 16}


@pytest.fixture
def table_dir(tmp_path, monkeypatch):
    """Point the lookup at a scratch table directory."""
    monkeypatch.setenv("ROCKET_TPU_TUNE_DIR", str(tmp_path))
    tune.reset_table_cache()
    tune.reset_lookup_log()
    yield str(tmp_path)
    tune.reset_table_cache()


def _entry(kernel, device_kind, config, shape=FLASH_SHAPE, dtype="float32"):
    return {"device_kind": device_kind, "dtype": dtype, "shape": dict(shape),
            "shape_bucket": TUNE_SPACES[kernel].bucket(shape), "config": dict(config),
            "speedup": 1.1}


def _flash_entry(device_kind, config, **kw):
    return _entry("flash_fwd", device_kind, config, **kw)


# -- table round trip + lookup ------------------------------------------------


def test_table_round_trips(table_dir):
    entry = _flash_entry(H100, {"block_q": 64, "block_k": 64})
    path = tune.write_table("flash_fwd", [entry], configs_dir=table_dir)
    table = json.loads(Path(path).read_text())
    assert table["kernel"] == "flash_fwd" and table["version"] == 1
    assert table["entries"] == [entry]
    assert tune.load_table("flash_fwd", table_dir, use_cache=False)["entries"] == [entry]


def test_lookup_longest_prefix_device_name(table_dir):
    """The exact card name beats the family entry, the family entry serves
    other cards of the family, and other cards and the CPU miss."""
    tune.write_table("flash_fwd", [
        _flash_entry("NVIDIA H100", {"block_q": 128, "block_k": 128}),
        _flash_entry(H100, {"block_q": 64, "block_k": 64}),
    ], configs_dir=table_dir)

    def block_q(kind):
        config = tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32,
                                 device_kind=kind)
        return None if config is None else config["block_q"]

    assert block_q(H100) == 64
    assert block_q("NVIDIA H100 PCIe") == 128
    assert block_q("NVIDIA A100-SXM4-80GB") is None
    assert block_q("cpu") is None


def test_lookup_exact_bucket_and_dtype(table_dir):
    tune.write_table("flash_fwd", [_flash_entry(H100, {"block_q": 64, "block_k": 64})],
                     configs_dir=table_dir)
    assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32,
                           device_kind=H100) == {"block_q": 64, "block_k": 64}
    assert tune.get_config("flash_fwd", shape=dict(FLASH_SHAPE, t=512), dtype=torch.float32,
                           device_kind=H100) is None
    assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.bfloat16,
                           device_kind=H100) is None


def test_lookup_disabled_by_env_and_context(table_dir, monkeypatch):
    tune.write_table("flash_fwd", [_flash_entry(H100, {"block_q": 64, "block_k": 64})],
                     configs_dir=table_dir)
    with tune.tuning_disabled():
        assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32,
                               device_kind=H100) is None
    assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32,
                           device_kind=H100) is not None
    monkeypatch.setenv("ROCKET_TPU_TUNE", "0")
    assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32,
                           device_kind=H100) is None


def test_priced_device_kind_and_lookup_log(table_dir):
    tune.write_table("flash_fwd", [_flash_entry(H100, {"block_q": 64, "block_k": 64})],
                     configs_dir=table_dir)
    assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32) is None  # cpu
    tune.reset_lookup_log()
    with tune.priced_device_kind(H100):
        assert tune.get_config("flash_fwd", shape=FLASH_SHAPE, dtype=torch.float32) == \
            {"block_q": 64, "block_k": 64}
        for _ in range(2):
            tune.get_config("moe_gmm", shape={"m": 1024, "k": 256, "n": 512},
                            dtype=torch.bfloat16)
    summary = tune.lookup_log_summary()
    assert len(summary) == 2  # deduplicated
    by_kernel = {r["kernel"]: r for r in summary}
    assert by_kernel["flash_fwd"]["source"] == "table"
    assert by_kernel["flash_fwd"]["config"] == {"block_q": 64, "block_k": 64}
    assert by_kernel["moe_gmm"]["source"] == "default"
    assert by_kernel["moe_gmm"]["dtype"] == "bfloat16"


def test_unknown_kernel_raises():
    with pytest.raises(KeyError, match="unknown kernel"):
        tune.get_config("nope", shape={}, dtype=torch.float32)


# -- no table: every call site runs what it ran before -----------------------


def test_no_table_is_bitwise_identical_to_explicit_defaults(table_dir):
    from rocket_tpu_torch.nn import layers
    from rocket_tpu_torch.nn.moe import gmm_config
    from rocket_tpu_torch.ops import flash_attention as fa
    from rocket_tpu_torch.ops import fused_conv
    from rocket_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(3, 2, 2, 256, 64)).astype(np.float32))

    def run(**blocks):
        x = qkv.clone().requires_grad_()
        out = fa.flash_attention_qkv(x, causal=True, **blocks)
        out.square().sum().backward()
        return out.detach(), x.grad

    for a, b in zip(run(), run(block_q=128, block_k=128)):
        assert torch.equal(a, b)

    x = torch.from_numpy(rng.normal(size=(4, 8, 8, 16)).astype(np.float32))
    scale, bias = torch.full((16,), 1.5), torch.zeros(16)
    got = layers.bn_act_train(x, scale, bias, 1e-5, act=True)
    want = fused_conv.reference_bn_act(x, scale, bias, 1e-5, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    assert gmm_config(16384, 768, 3072, torch.bfloat16) == \
        {"impl": "gmm", "tile_m": 512, "tile_k": 512, "tile_n": 512}

    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 16)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(2, 1, 2, 16)).astype(np.float32))
    pages = torch.from_numpy(rng.normal(size=(5, 16, 2, 16)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos, valid = torch.tensor([3, 17], dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    out = pa.paged_attention(q, kn, kn * 0.5, pages.clone(), pages * 0.25, table, pos, valid)[0]
    pinned = pa.paged_attention(q, kn, kn * 0.5, pages.clone(), pages * 0.25, table, pos, valid,
                                impl="pallas")[0]
    assert torch.equal(out, pinned)
    sources = {r["kernel"]: r["source"] for r in tune.lookup_log_summary()}
    assert sources == {"flash_fwd": "default", "flash_bwd": "default",
                       "fused_conv": "default", "moe_gmm": "default",
                       "paged_decode": "default"}


def test_block_attn_gate_reads_the_table(table_dir):
    """The block reads ``block_attn`` on every call; an empty table keeps the
    per-op chain, and an entry pinning the kernel still leaves CPU tensors
    on the chain (the kernel engages on the card only, unforced)."""
    from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=32, max_seq_len=16, dim=128, num_layers=1, num_heads=2,
                            dropout=0.0)
    block = TransformerLM(cfg).blocks[0]
    x = torch.zeros(2, 16, 128)
    assert block._block_attn_config(x) is None
    shape = {"b": 2, "t": 16, "d": 128, "h": 2}
    tune.write_table("block_attn", [_entry("block_attn", H100, {
        "impl": "fused", "epilogue": "fused", "block_b": 1}, shape=shape)],
        configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        assert block._block_attn_config(x) is None
    hits = [r for r in tune.lookup_log_summary() if r["kernel"] == "block_attn"]
    assert {r["source"] for r in hits} == {"default", "table"}


# -- entries steer the call sites -------------------------------------------


def test_table_entry_drives_flash_blocks(table_dir):
    from rocket_tpu_torch.ops import flash_attention as fa

    tune.write_table("flash_fwd", [_flash_entry(H100, {"block_q": 64, "block_k": 64})],
                     configs_dir=table_dir)
    tune.write_table("flash_bwd", [_entry("flash_bwd", H100, {"block_q": 128, "block_k": 64},
                                          shape=dict(FLASH_SHAPE, causal=False))],
                     configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        assert fa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, True, None, None, None,
                                       None) == (64, 64, 64, 64)
        # Non-causal: no fwd entry, the bwd entry applies as written.
        assert fa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, False, None, None, None,
                                       None) == (128, 128, 128, 64)


def test_illegal_causal_entry_is_clamped_square(table_dir):
    """A hand-edited causal 128/64 entry reaches the resolver, which clamps
    it to square tiles rather than launch an illegal pair."""
    from rocket_tpu_torch.ops import flash_attention as fa

    tune.write_table("flash_fwd", [_flash_entry(H100, {"block_q": 128, "block_k": 64})],
                     configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        assert fa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, True, None, None, None,
                                       None)[:2] == (64, 64)


def test_explicit_fwd_blocks_suppress_bwd_table(table_dir):
    from rocket_tpu_torch.ops import flash_attention as fa

    tune.write_table("flash_bwd", [_entry("flash_bwd", H100, {"block_q": 64, "block_k": 64})],
                     configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        pinned = fa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, True, 128, 128, None,
                                         None)
        unpinned = fa.resolve_tuned_blocks(256, 64, 2, 2, torch.float32, True, None, None,
                                           None, None)
    assert pinned == (128, 128, 128, 128)
    assert unpinned == (128, 128, 64, 64)


def test_paged_decode_table_and_env_pick_the_gather_path(table_dir, monkeypatch):
    from rocket_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 16)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(2, 1, 2, 16)).astype(np.float32))
    pages = torch.from_numpy(rng.normal(size=(5, 16, 2, 16)).astype(np.float32))
    args = (torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
            torch.tensor([3, 17], dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    calls = []
    kernel_wrapper = pa.paged_decode
    monkeypatch.setattr(pa, "paged_decode",
                        lambda *a: calls.append(1) or kernel_wrapper(*a))

    def route(**kw):
        """Which path served the wave: 'pallas' (the kernel's wrapper) or 'xla'."""
        calls.clear()
        out = pa.paged_attention(q, kn, kn * 0.5, pages.clone(), pages * 0.25, *args, **kw)[0]
        torch.testing.assert_close(out, pa.paged_attention(
            q, kn, kn * 0.5, pages.clone(), pages * 0.25, *args, impl="xla")[0])
        return "pallas" if calls else "xla"

    assert route() == "pallas" and route(impl="xla") == "xla"
    tune.write_table("paged_decode", [_entry("paged_decode", H100, {"impl": "xla"},
                                             shape=PAGED_SHAPE)], configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        assert route() == "xla"
        monkeypatch.setenv("ROCKET_TPU_PAGED_DECODE", "pallas")  # the force wins
        assert route() == "pallas"
    with pytest.raises(ValueError, match="unknown impl"):
        route(impl="triton")


def test_fused_conv_and_moe_gmm_read_their_tables(table_dir):
    from rocket_tpu_torch.nn import layers
    from rocket_tpu_torch.nn.moe import gmm_config

    conv = {"impl": "pallas", "schedule": "stats_xla", "block_rows": 512}
    gmm = {"impl": "fused", "tile_m": 256}
    tune.write_table("fused_conv", [_entry("fused_conv", H100, conv,
                                           shape={"n": 4096, "c": 64})], configs_dir=table_dir)
    tune.write_table("moe_gmm", [_entry("moe_gmm", H100, gmm, dtype="bfloat16",
                                        shape={"m": 16384, "k": 768, "n": 3072})],
                     configs_dir=table_dir)
    with tune.priced_device_kind(H100):
        assert layers._fused_conv_config(4096, 64, torch.float32) == conv
        assert layers._fused_conv_config(4096, 32, torch.float32) == {}
        assert gmm_config(16384, 768, 3072, torch.bfloat16) == \
            {"impl": "fused", "tile_m": 256, "tile_k": 512, "tile_n": 512}


# -- the sweep ----------------------------------------------------------------


def _fake_paged_case(wrong_scale):
    """paged_decode's space, whose 'xla' candidate here returns the output
    times ``wrong_scale``: instant, and wrong unless the scale is 1."""
    x = torch.linspace(0.0, 1.0, 64)

    def build(device):
        def run(config):
            return x if config["impl"] == "pallas" else x * wrong_scale
        return run

    return TuneCase(name="paged/fake", kernel="paged_decode", shape=PAGED_SHAPE,
                    dtype="float32", build=build)


def test_sweep_rejects_wrong_candidate():
    report = sweep_case(_fake_paged_case(1.5), device="cpu", iters=1, min_speedup=1.0)
    (result,) = report.results
    assert result.config == {"impl": "xla"}
    assert not result.parity_ok and result.max_err > 1.0
    assert result.mean_us is None  # rejected before timing
    assert report.winner is None


def test_sweep_accepts_parity_equal_candidate():
    report = sweep_case(_fake_paged_case(1.0), device="cpu", iters=1, min_speedup=1.0)
    (result,) = report.results
    assert result.parity_ok and result.mean_us is not None


def test_sweep_rejects_wrong_fast_structural_variant():
    space = TuneSpace(kernel="test_fake_variant", axes={"impl": ("reference", "wrongfast")},
                      shape_keys=("n",), default=lambda shape: {"impl": "reference"},
                      structural=("impl",))
    TUNE_SPACES[space.kernel] = space
    try:
        x = torch.linspace(0.0, 1.0, 128)

        def build(device):
            return lambda config: x * 1.5 if config["impl"] == "wrongfast" else x

        report = sweep_case(TuneCase(name="fake/wrongfast", kernel=space.kernel,
                                     shape={"n": 128}, dtype="float32", build=build),
                            device="cpu", iters=1, min_speedup=1.0)
        (bad,) = report.results
        assert not bad.parity_ok and bad.mean_us is None and report.winner is None
    finally:
        del TUNE_SPACES[space.kernel]


def test_sweep_baseline_is_explicit_default_and_table_blind(table_dir):
    seen = []

    def build(device):
        def run(config):
            assert tune.get_config("paged_decode", shape=PAGED_SHAPE, dtype=torch.float32,
                                   device_kind=H100) is None
            seen.append(dict(config))
            return torch.zeros(4)
        return run

    tune.write_table("paged_decode", [_entry("paged_decode", H100, {"impl": "xla"},
                                             shape=PAGED_SHAPE)], configs_dir=table_dir)
    sweep_case(TuneCase(name="paged/blind", kernel="paged_decode", shape=PAGED_SHAPE,
                        dtype="float32", build=build), device="cpu", iters=1)
    assert seen[0] == {"impl": "pallas"}


def test_run_cases_needs_an_explicit_device():
    """The library entry never falls back to the CPU: without a card,
    ``device="cuda"`` raises, and only an explicit ``device="cpu"`` runs the
    plain versions (the CLI passes it only under ``--allow-cpu``)."""
    with pytest.raises(TypeError):
        run_cases(names=["flash_fwd/smoke"], smoke_only=True)  # no device given
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        run_cases(names=["flash_fwd/smoke"], device="gpu", smoke_only=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_cases(names=["flash_fwd/smoke"], device="cuda", smoke_only=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep_case(_fake_paged_case(1.0), device="cuda", iters=1)
    (report,) = run_cases(names=["paged/smoke"], device="cpu", iters=1, smoke_only=True)
    assert report.default_us > 0


def test_check_parity_tolerances():
    a = np.ones((8, 8), np.float32)
    ok, err = check_parity(a, torch.from_numpy(a), "float32")
    assert ok and err == 0.0
    assert check_parity(a, a * (1 + 5e-6), "float32")[0]
    ok, err = check_parity(a, a * 1.01, "float32")
    assert not ok and err > 1.0
    assert check_parity(a, a * 1.01, "bfloat16")[0]
    assert not check_parity(a, np.full_like(a, np.nan), "bfloat16")[0]
    assert not check_parity((a, a), (a,), "float32")[0]


@pytest.mark.parametrize("blocks", [(64, 64), (128, 128)])
def test_candidate_blocks_fwd_bwd_parity(blocks):
    """Every flash tile pair matches the default's forward and gradients
    within the f32 tolerance, in the forward or the backward slot."""
    from rocket_tpu_torch.ops import flash_attention as fa

    qkv = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 2, 2, 256, 64))
                           .astype(np.float32))

    def run(**kw):
        x = qkv.clone().requires_grad_()
        out = fa.flash_attention_qkv(x, causal=True, **kw)
        out.square().sum().backward()
        return out.detach(), x.grad

    ref = run()
    bq, bk = blocks
    for kw in ({"block_q": bq, "block_k": bk}, {"bwd_block_q": bq, "bwd_block_k": bk}):
        ok, err = check_parity(ref, run(**kw), "float32")
        assert ok, (kw, err)


def test_update_tables_merges_other_device_kinds(tmp_path):
    keep = _flash_entry("NVIDIA H200", {"block_q": 128, "block_k": 128})
    tune.write_table("flash_fwd", [keep], configs_dir=str(tmp_path))
    case = TuneCase(name="flash_fwd/x", kernel="flash_fwd", shape=FLASH_SHAPE,
                    dtype="float32", build=lambda: None)
    report = CaseReport(case=case, device_kind=H100,
                        default_config={"block_q": 128, "block_k": 128}, default_us=100.0)
    report.winner = CandidateResult(config={"block_q": 64, "block_k": 64}, mean_us=80.0)
    update_tables([report], configs_dir=str(tmp_path))
    entries = tune.load_table("flash_fwd", str(tmp_path), use_cache=False)["entries"]
    assert {e["device_kind"] for e in entries} == {"NVIDIA H200", H100}
    new = [e for e in entries if e["device_kind"] == H100][0]
    assert new["speedup"] == 1.25 and new["config"]["block_q"] == 64
    assert tune.validate_tables(str(tmp_path)) == [
        f"{k}.json: missing — every tunable kernel ships a table (empty entries when nothing "
        "is tuned); run `python -m rocket_tpu_torch.tune --update-table`"
        for k in sorted(TUNE_SPACES) if k != "flash_fwd"]


# -- spaces and the table gate ----------------------------------------------


def test_flash_spaces_enumerate_compiled_tiles_within_the_budget():
    spec = device_spec(H100)
    assert spec.smem_bytes == 232448
    space = TUNE_SPACES["flash_bwd"]
    shape = {"t": 1024, "d": 64, "h": 12, "h_kv": 12, "causal": True}
    assert space.default(shape) == {"block_q": 128, "block_k": 128}
    assert space.candidates(shape, spec, "bfloat16") == [
        {"block_k": 64, "block_q": 64}, {"block_k": 128, "block_q": 128}]
    assert len(space.candidates(dict(shape, causal=False), spec, "float32")) == 4
    small = DeviceSpec("small card", 1e12, 1e12, 1e12, 100 * 1024, 132)
    assert space.candidates(shape, small, "float32") == [{"block_k": 64, "block_q": 64}]
    assert space.violations({"block_q": 256, "block_k": 256}, shape, spec, "bfloat16")
    # D = 128 compiles 64 x 64 only; past 128 there is no kernel.
    assert not space.violations({"block_q": 64, "block_k": 64}, dict(shape, d=128), spec,
                                "bfloat16")
    assert space.violations({"block_q": 128, "block_k": 128}, dict(shape, d=128), spec,
                            "bfloat16")
    assert space.violations({"block_q": 64, "block_k": 64}, dict(shape, d=192), spec,
                            "bfloat16")


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
@pytest.mark.parametrize("d", [128, 96])
def test_flash_candidates_at_head_dim_128_are_the_compiled_tiles(kernel, d):
    """At D = 128 (and a D padded to it) the spaces offer only the one tile
    pair compiled there, 64 x 64, causal and not, in both dtypes; every
    candidate is legal and the default is a candidate."""
    from rocket_tpu_torch.ops import flash_attention as fa

    spec = device_spec(H100)
    space = TUNE_SPACES[kernel]
    for causal in (True, False):
        shape = {"t": 2048, "d": d, "h": 32, "h_kv": 32, "causal": causal}
        for dtype in ("bfloat16", "float32"):
            cands = space.candidates(shape, spec, dtype)
            assert cands == [{"block_k": 64, "block_q": 64}], (causal, dtype, cands)
            assert all(not space.violations(c, shape, spec, dtype) for c in cands)
            assert all({c["block_q"], c["block_k"]} <= set(fa.tiles_for(d)) for c in cands)
        assert space.default(shape) == {"block_q": 64, "block_k": 64}


def test_structural_spaces_pin_inert_axes():
    spec = device_spec(H100)
    conv = TUNE_SPACES["fused_conv"]
    assert conv.candidates({"n": 262144, "c": 64}, spec, "bfloat16") == [
        {"block_rows": 512, "impl": "reference", "schedule": "twopass"},
        {"block_rows": 512, "impl": "pallas", "schedule": "twopass"},
        {"block_rows": 512, "impl": "pallas", "schedule": "stats_xla"}]
    assert conv.violations({"impl": "pallas", "schedule": "twopass", "block_rows": 512},
                           {"n": 1000, "c": 64}, spec, "float32")
    gmm = TUNE_SPACES["moe_gmm"]
    fused = [c for c in gmm.candidates({"m": 16384, "k": 768, "n": 3072}, spec, "bfloat16")
             if c["impl"] == "fused"]
    assert [c["tile_m"] for c in fused] == [128, 256, 512, 1024]
    assert gmm.candidates({"m": 16384, "k": 3072, "n": 768}, spec, "bfloat16") == [
        {"impl": "gmm", "tile_m": 512}]  # 512 does not tile N = 768
    attn = TUNE_SPACES["block_attn"]
    assert [c for c in attn.candidates({"b": 64, "t": 256, "d": 256, "h": 4}, spec, "bfloat16")
            if c["impl"] == "fused"] == [
        {"block_b": 1, "epilogue": "fused", "impl": "fused"},
        {"block_b": 1, "epilogue": "separate", "impl": "fused"}]
    assert TUNE_SPACES["paged_decode"].candidates(PAGED_SHAPE, spec, "float32") == [
        {"impl": "pallas"}, {"impl": "xla"}]


def test_shipped_tables_validate_clean_and_are_empty():
    assert tune.validate_tables(tune.CONFIGS_DIR) == []
    for kernel, table in tune.load_tables(tune.CONFIGS_DIR).items():
        assert table == {"version": 1, "kernel": kernel, "entries": []}


def test_gate_fires_on_a_bad_table(tmp_path):
    for kernel in TUNE_SPACES:
        tune.write_table(kernel, [], configs_dir=str(tmp_path))
    stale = _flash_entry(H100, {"block_q": 64, "block_k": 64})
    stale["shape_bucket"] = "t999"
    tune.write_table("flash_fwd", [
        _flash_entry("TPU v99 imaginary", {"block_q": 64, "block_k": 64}),
        _flash_entry(H100, {"block_q": 128, "block_k": 64}),
        stale,
    ], configs_dir=str(tmp_path))
    problems = "\n".join(tune.validate_tables(str(tmp_path)))
    assert "unknown device kind 'TPU v99 imaginary'" in problems
    assert "causal requires block_q == block_k" in problems
    assert "does not match shape" in problems


def test_gate_flags_missing_and_stale_tables(tmp_path):
    problems = "\n".join(tune.validate_tables(str(tmp_path)))
    for kernel in TUNE_SPACES:
        assert f"{kernel}.json: missing" in problems
    for kernel in TUNE_SPACES:
        tune.write_table(kernel, [], configs_dir=str(tmp_path))
    (tmp_path / "ghost_kernel.json").write_text("{}")
    assert "no TuneSpace named 'ghost_kernel'" in "\n".join(tune.validate_tables(str(tmp_path)))


def test_stale_structural_winner_fails_loudly_and_wins_are_summarised(tmp_path):
    shape = {"b": 64, "t": 256, "d": 256, "h": 4}
    for kernel in TUNE_SPACES:
        tune.write_table(kernel, [], configs_dir=str(tmp_path))
    tune.write_table("block_attn", [_entry("block_attn", H100, {
        "impl": "whole_block_v0", "epilogue": "fused", "block_b": 1}, shape=shape,
        dtype="bfloat16")], configs_dir=str(tmp_path))
    problems = "\n".join(tune.validate_tables(str(tmp_path)))
    assert "stale structural winner" in problems and "whole_block_v0" in problems
    assert "not in candidates" not in problems  # reported once
    tune.write_table("block_attn", [_entry("block_attn", H100, {
        "impl": "fused", "epilogue": "separate", "block_b": 1}, shape=shape,
        dtype="bfloat16")], configs_dir=str(tmp_path))
    assert tune.validate_tables(str(tmp_path)) == []
    (win,) = tune.tables_summary(str(tmp_path))["structural_wins"]
    assert win["variant"] == {"impl": "fused", "epilogue": "separate"}


# -- the CLI --------------------------------------------------------------------


def test_cli_exit_codes(tmp_path, capsys):
    from rocket_tpu_torch.tune.__main__ import main

    assert main(["--check"]) == 0
    assert main(["--check-table", "--table-dir", str(tmp_path)]) == 1  # every table missing
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "impl*=" in out and "structural axes" in out and "flash_fwd/gpt2" in out
    assert main([]) == 1  # no card, no --allow-cpu
    assert main(["--allow-cpu", "--update-table", "--table-dir", str(tmp_path)]) == 2
    assert not list(tmp_path.iterdir())


def test_cli_allow_cpu_runs_the_smoke_cases(capsys):
    from rocket_tpu_torch.tune.__main__ import main

    assert main(["--allow-cpu", "--json", "--case", "flash_fwd/smoke", "--case",
                 "fused_conv/smoke", "--case", "paged/smoke"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device_kind"] == "cpu" and "written" not in summary
    assert sorted(summary["cases"]) == ["flash_fwd/smoke", "fused_conv/smoke", "paged/smoke"]
    for case in summary["cases"].values():
        assert case["default_us"] > 0 and case["candidates"]
        for cand in case["candidates"]:
            assert cand["error"] is None and cand["parity_ok"], cand


# -- schema parity with the reference ---------------------------------------


def test_a_port_table_loads_in_the_reference(tmp_path):
    """A table written by the port reads in the reference's ``load_table``
    with the reference's schema and bucket, and its lookup resolves it."""
    from rocket_tpu.tune import space as jspace
    from rocket_tpu.tune import table as jtable

    shape = {"t": 1024, "d": 64, "h": 12, "h_kv": 12, "causal": True}
    entry = _flash_entry(H100, {"block_q": 64, "block_k": 64}, shape=shape, dtype="bfloat16")
    tune.write_table("flash_fwd", [entry], configs_dir=str(tmp_path))
    table = jtable.load_table("flash_fwd", str(tmp_path), use_cache=False)
    assert table["version"] == jtable.TABLE_VERSION and table["kernel"] == "flash_fwd"
    (loaded,) = table["entries"]
    assert all(key in loaded for key in jtable._ENTRY_REQUIRED)
    assert loaded["shape_bucket"] == jspace.TUNE_SPACES["flash_fwd"].bucket(shape)
    for kernel in TUNE_SPACES:
        assert kernel in jspace.TUNE_SPACES
    import os

    os.environ["ROCKET_TPU_TUNE_DIR"] = str(tmp_path)
    jtable.reset_table_cache()
    try:
        assert jtable.get_config("flash_fwd", shape=shape, dtype="bfloat16",
                                 device_kind=H100) == {"block_q": 64, "block_k": 64}
    finally:
        del os.environ["ROCKET_TPU_TUNE_DIR"]
        jtable.reset_table_cache()
