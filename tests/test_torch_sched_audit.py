"""The port's kernel-launch audit (``rocket_tpu_torch/analysis/sched_audit``,
rule RKT504 for Hopper) and row 12 (``ops/badpallas``) against the JAX
package's schedule audit.

* RKT504 parity: the reference's ``check_pallas`` on ``PallasFact``s built
  by hand from the seeded-bad fixture's two BlockSpecs (its collector does
  not run under this JAX), and the port's ``check_launches`` on the facts
  of the matching ``bad_scale`` launches, report the same rule and the same
  kinds: one block misaligned on both dims, one over the budget.
* Every non-demo target traces at full width on ``meta`` tensors and is
  clean; each launches the kernels it names.
* Rows 6-7's declared shared memory equals ``ops/flash_attention.smem_bytes``;
  rows 6 and 7's bf16 kernels (tensor cores), rows 1 and 2's split and
  combine launches, the persistent wgmma launch of row 11 and of bf16
  ``gmm`` (both modes) and ``tgmm``, and row 9's one launch equal a mirror
  of the sizes in their ``.cu`` sources; rows 1 and 2's split counts
  follow the static shapes alone, and the wgmma grid the card's SMs.
* Rows 3 and 8's bf16 (tensor-core) declarations leave room for 3 and 2
  resident CTAs per SM, the f32 (CUDA-core) ones are unchanged, and the
  targets that trace them stay clean.
* The CLI's exit codes: ``sched`` 0, ``sched --target badpallas`` 1.
* Row 12's plain version against the fixture's two ``pallas_call``s, taken
  from ``jax.make_jaxpr`` of the fixture's own step and rebound with
  ``interpret=True`` (JAX 0.9 rebinds them), on the same numpy input,
  compared exactly over the blocks the fixture writes (it is ``2 * x``; the
  rest of its output is uninitialised).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.analysis.rules.sched_rules import check_pallas
from rocket_tpu.analysis.sched_audit import PallasFact, _badpallas_parts
from rocket_tpu.utils.perf import device_spec as tpu_spec
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis.rules.sched_rules import check_launches
from rocket_tpu_torch.analysis.sched_audit import (
    DEFAULT_DEVICE_KIND,
    SCHED_TARGETS,
    audit_schedule,
    collect_launch_facts,
    run_sched_target,
)
from rocket_tpu_torch.ops import _launch
from rocket_tpu_torch.ops import badpallas as tbp
from rocket_tpu_torch.ops import flash_attention as tfa
from rocket_tpu_torch.ops import flash_native as tfn
from rocket_tpu_torch.ops import fused_block as tfb
from rocket_tpu_torch.utils.perf import device_spec

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4096, 4096)
#: The fixture's two launches: (block, grid).
LAUNCHES = (((7, 100), (4,)), (SHAPE, ()))


def _kind(message: str):
    """A finding's kind, in either package's words: ("budget",) or
    ("misaligned", dims) with dims the misaligned block dims."""
    if "misaligns" not in message:
        return ("budget",)
    dims = []
    if "last dim" in message:
        dims.append("last")
    if "sublane dim" in message or re.search(r"rows \d+ %", message):
        dims.append("rows")
    return ("misaligned", tuple(dims))


def _pallas_fact(block, grid):
    key = (tuple(block), "float32")
    vmem = 2 * 2 * block[0] * block[1] * 4  # in and out, double-buffered
    return PallasFact(name="kernel", grid=tuple(grid), blocks=(key, key),
                      full_shapes={key: SHAPE}, vmem_bytes_est=vmem)


def test_rkt504_matches_the_reference_on_the_fixture():
    ref = check_pallas([_pallas_fact(*launch) for launch in LAUNCHES],
                       tpu_spec("TPU v5 lite").vmem_bytes, label="badpallas")
    port = check_launches([tbp.bad_scale_launch(SHAPE, *launch) for launch in LAUNCHES],
                          device_spec(DEFAULT_DEVICE_KIND), label="badpallas")
    assert {f.rule for f in ref} == {f.rule for f in port} == {"RKT504"}
    assert sorted(_kind(f.message) for f in ref) == sorted(_kind(f.message) for f in port) == [
        ("budget",), ("misaligned", ("last", "rows"))]
    assert [f.path for f in port] == ["<sched:badpallas>"] * 2


def test_rkt504_waives_full_dims_and_one_row_vectors_and_keeps_sector_rows():
    spec = device_spec(DEFAULT_DEVICE_KIND)
    fact = _launch.LaunchFact("k", (1, 1, 1), 128, 0, 0, (
        _launch.tile(7, 100, torch.float32, 7, 100),       # the full plane
        _launch.tile(1, 24, torch.float32, 96, 1024),      # one-row vector, 96 B
        _launch.tile(64, 32, torch.bfloat16, 256, 256),    # 64-byte rows: whole sectors
        _launch.tile(12, 64, torch.bfloat16, 12, 4096),    # rows equal the plane's
    ))
    assert check_launches([fact], spec) == []
    bad = _launch.LaunchFact("k", (1, 1, 1), 128, 0, 0, (
        _launch.tile(8, 12, torch.float32, 64, 64),        # 48-byte rows
        _launch.tile(24, 64, torch.bfloat16, 256, 64),     # 24 rows of a 2-byte type
    ))
    kinds = sorted(_kind(f.message) for f in check_launches([bad], spec))
    assert kinds == [("misaligned", ("last",)), ("misaligned", ("rows",))]
    over = _launch.LaunchFact("k", (1, 1, 1), 128, spec.smem_bytes - 1000, 1001)
    assert [_kind(f.message) for f in check_launches([over], spec)] == [("budget",)]


#: target -> the kernels its step launches.
TARGET_KERNELS = {
    "train_flash": {"flash_fwd", "flash_bwd"},
    "train_flash_long": {"flash_fwd", "flash_bwd", "flash_dq"},
    "train_flash_tp": {"flash_fwd", "flash_bwd"},
    "qkv_flash": {"flash_qkv_fwd", "flash_qkv_bwd"},
    "fused_kernels": {"bn_twopass", "bn_normalize", "fused_block", "gather_gmm", "gmm", "tgmm"},
    "serve": {"paged_decode", "paged_decode_combine", "decode_attention",
              "decode_attention_combine"},
    "vit_flash": {"flash_fwd", "flash_bwd"},
    "llama_flash": {"flash_fwd", "flash_bwd", "decode_attention", "decode_attention_combine"},
    "train_flash_d128": {"flash_fwd", "flash_bwd", "flash_dq", "flash_qkv_fwd", "flash_qkv_bwd"},
}
#: Launches that stage nothing in shared memory.
NO_SMEM = {"paged_decode_combine", "decode_attention_combine"}


@pytest.mark.parametrize("name", sorted(TARGET_KERNELS))
def test_every_real_target_is_clean_at_full_width_on_meta(name):
    assert not SCHED_TARGETS[name].demo
    report = run_sched_target(SCHED_TARGETS[name])
    assert report.clean, [f.render() for f in report.findings]
    assert {f.name for f in report.launches} == TARGET_KERNELS[name]
    spec = device_spec(DEFAULT_DEVICE_KIND)
    assert all(0 < f.smem_bytes <= spec.smem_bytes for f in report.launches
               if f.name not in NO_SMEM)


def _launch_counts() -> dict:
    counts = {}
    for module in ("paged_attention", "decode_attention", "flash_native", "flash_attention",
                   "fused_block", "fused_conv", "gather_gmm", "grouped_matmul", "badpallas"):
        mod = __import__(f"rocket_tpu_torch.ops.{module}", fromlist=["_"])
        counts.update({fn.__qualname__: fn.launches for fn in vars(mod).values()
                       if callable(fn) and hasattr(fn, "launches")})
    return counts


def test_meta_launches_leave_every_launch_count_alone():
    before = _launch_counts()
    assert len(before) == 14
    for name in ("serve", "fused_kernels", "qkv_flash", "badpallas"):
        assert run_sched_target(SCHED_TARGETS[name]).launches
    assert _launch_counts() == before
    # The kernel targets, row 12's demo, and the reference's multi-rank
    # roofline targets and schedule demos (tests/test_torch_sched_roofline.py).
    assert SCHED_TARGETS.keys() == set(TARGET_KERNELS) | {"badpallas"} | {
        "tp_2x4", "tp_1x8", "fsdp_1x8", "tp_2x4_eval", "dp_resnet_1x8", "tp_flash",
        "badsched", "badoverlap"}


def test_train_step_launches_one_forward_and_backward_per_layer():
    # The whole step the train phase takes: under the whole-forward remat
    # each layer's forward runs again in the backward (the phase's 24
    # flash_fwd and 12 flash_bwd launches a step).
    facts = run_sched_target(SCHED_TARGETS["train_flash"]).launches
    assert [f.name for f in facts].count("flash_fwd") == 2 * 12
    assert [f.name for f in facts].count("flash_bwd") == 12
    fwd = next(f for f in facts if f.name == "flash_fwd")
    assert fwd.grid == (16, 12, 8) and fwd.threads == 128
    long = run_sched_target(SCHED_TARGETS["train_flash_long"]).launches
    assert [f.name for f in long].count("flash_dq") == 12


def test_tp_train_step_declares_rows_3_4_at_six_local_heads():
    """One rank at --model-axis 2 runs each layer's attention on 6 of
    GPT-2's 12 heads: half of train_flash's grid in heads."""
    facts = run_sched_target(SCHED_TARGETS["train_flash_tp"]).launches
    assert [f.name for f in facts].count("flash_fwd") == 12
    assert [f.name for f in facts].count("flash_bwd") == 12
    fwd = next(f for f in facts if f.name == "flash_fwd")
    assert fwd.grid == (16, 6, 8) and fwd.threads == 128


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_flash_qkv_declarations_equal_smem_bytes(d):
    for kind in ("fwd", "bwd"):
        for bq in tfa.TILES:
            for bk in tfa.TILES:
                fact = tfa.qkv_launch(kind, 2, 3, 256, d, torch.bfloat16, bq, bk)
                assert fact.dynamic_smem == tfa.smem_bytes(kind, bq, bk, d, torch.bfloat16)
                assert fact.static_smem == 0
    qkv = torch.empty((3, 2, 3, 256, d), dtype=torch.bfloat16, device="meta")
    with _launch.record_launches() as facts:
        tfa.flash_qkv_fwd(qkv, True, 64, 64)
    assert [f.dynamic_smem for f in facts] == [tfa.smem_bytes("fwd", 64, 64, d, torch.bfloat16)]


def _qkv_fwd_mirror(dtype, d, bq, bk):
    """(threads, dynamic smem) of row 6's forward as ``csrc/flash_attention.cu``
    sizes it: bf16 ``Fwd<...>`` on the tensor cores is 2 * BQ threads and
    ``fwd_tc_smem`` = (BQ + 4 BK) (D + 8) bf16; f32 keeps ``fwd_smem``."""
    if dtype == torch.bfloat16:
        return 2 * bq, 2 * (bq + 4 * bk) * (d + 8)
    return 256, 4 * ((bq + 2 * bk) * (d + 1) + bq * (bk + 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("tiles", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=lambda c: "q{}k{}".format(*c))
def test_flash_qkv_fwd_declaration_equals_the_cu_sizes(tiles, d, dtype):
    bq, bk = tiles
    fact = tfa.qkv_launch("fwd", 8, 12, 1024, d, dtype, bq, bk)
    assert (fact.threads, fact.dynamic_smem) == _qkv_fwd_mirror(dtype, d, bq, bk)
    assert fact.grid == (1024 // bq, 12, 8) and fact.static_smem == 0
    assert tfa.threads("fwd", bq, "bfloat16" if dtype == torch.bfloat16 else "float32") == \
        fact.threads
    # The backward: bf16 on the tensor cores, f32 on the CUDA cores.
    bwd = tfa.qkv_launch("bwd", 8, 12, 1024, d, dtype, bq, bk)
    assert (bwd.threads, bwd.dynamic_smem) == _qkv_bwd_mirror(dtype, d, bq, bk)


def _qkv_bwd_mirror(dtype, d, bq, bk):
    """(threads, dynamic smem) of row 7's backward as ``csrc/flash_attention.cu``
    sizes it: bf16 ``Bwd<...>`` on the tensor cores is 2 * BK threads and
    ``bwd_tc_smem`` = K and V (BK rows each) and two stages of 64 rows of Q
    and dO, bf16 at stride D + 8, the bf16 BK x 64 dS^T tile at stride 72,
    and two stages of 64 lse and delta; f32 keeps ``bwd_smem``."""
    if dtype == torch.bfloat16:
        return 2 * bk, 2 * ((2 * bk + 4 * 64) * (d + 8) + bk * 72) + 4 * 4 * 64
    return 256, 4 * (2 * (bq + bk) * (d + 1) + bk * (bq + 1) + 2 * bq)


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("tiles", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=lambda c: "q{}k{}".format(*c))
def test_flash_qkv_bf16_backward_declaration_equals_threads_and_smem_bytes(tiles, d):
    """Row 7's bf16 backward declares one warp per 16 key rows and the .cu
    file's shared memory at every tile pair: block_q sets neither (the
    sweep streams 64-query steps), and every tile it names is clean."""
    bq, bk = tiles
    bf16 = torch.bfloat16
    fact = tfa.qkv_launch("bwd", 8, 12, 1024, d, bf16, bq, bk)
    assert fact.threads == tfa.threads("bwd", bq, bf16, bk) == 2 * bk
    assert fact.dynamic_smem == tfa.smem_bytes("bwd", bq, bk, d, bf16)
    assert (fact.threads, fact.dynamic_smem) == _qkv_bwd_mirror(bf16, d, bq, bk)
    assert fact.grid == (1024 // bk, 12, 8) and fact.static_smem == 0
    assert fact.dynamic_smem == tfa.qkv_launch("bwd", 8, 12, 1024, d, bf16, bk, bk).dynamic_smem
    assert {rc for rc, _, _ in fact.tiles} == {(bk, d), (64, d), (1, 64)}
    assert check_launches([fact], device_spec(DEFAULT_DEVICE_KIND)) == []
    # At D = 64: three CTAs of 64 keys fit an SM by shared memory, two of 128.
    if d == 64:
        ctas = 3 if bk == 64 else 2
        assert ctas * (fact.dynamic_smem + CTA_RESERVED) <= SM_SMEM


def test_d128_target_declares_the_compiled_head_dim_for_every_launch():
    """Head dim 128: the Llama-3-8B GQA step (rows 3, 4 without dq, 5), the
    Phi-3-mini D = 96 step on heads padded to 128 (rows 3, 4 with dq) and
    the stacked operand at 64 x 64 (rows 6-7), every launch declared at
    D = 128 with the .cu files' shared memory, two CTAs of rows 3-6 by
    shared memory, clean on an H100."""
    facts = run_sched_target(SCHED_TARGETS["train_flash_d128"]).launches
    names = [f.name for f in facts]
    assert names.count("flash_fwd") == 2 and names.count("flash_bwd") == 2
    assert names.count("flash_dq") == 1
    assert names.count("flash_qkv_fwd") == names.count("flash_qkv_bwd") == 1
    bf16 = torch.bfloat16
    llama = [f for f in facts if f.name.startswith("flash_") and f.grid[-1] == 2
             and not f.name.startswith("flash_qkv")]
    assert {f.name for f in llama} == {"flash_fwd", "flash_bwd", "flash_dq"}
    for f in llama:
        want = tfn.flash_launch(f.name, 2, 2048, 32, 8, 128, bf16, 32 * 128, 8 * 128,
                                with_dq=False)
        assert f == want, f.name
    phi3 = [f for f in facts if f.grid[-1] == 1]
    assert [f.name for f in phi3] == ["flash_fwd", "flash_bwd"]
    for f in phi3:   # padded: the kernel's D and the padded feature widths
        assert f == tfn.flash_launch(f.name, 1, 2048, 32, 32, 128, bf16, 32 * 128, 32 * 128)
    assert tfn._smem_bytes("flash_fwd", 128, bf16) == 2 * 5 * 64 * 136 == 87_040
    assert tfn._smem_bytes("flash_bwd", 128, bf16) == 114_688
    assert tfn._smem_bytes("flash_dq", 128, bf16) == 2 * 6 * 64 * 136 == 104_448
    for kind in ("flash_fwd", "flash_bwd", "flash_dq"):
        assert 2 * (tfn._smem_bytes(kind, 128, bf16) + CTA_RESERVED) <= SM_SMEM
    qkv = {f.name: f for f in facts if f.name.startswith("flash_qkv")}
    for kind in ("fwd", "bwd"):
        assert qkv[f"flash_qkv_{kind}"] == tfa.qkv_launch(kind, 2, 32, 2048, 128, bf16, 64, 64)
    assert check_launches(facts, device_spec(DEFAULT_DEVICE_KIND)) == []


def test_flash_qkv_bf16_forward_leaves_room_for_resident_ctas():
    """By shared memory: four CTAs of 64 x 64 and two of 128 x 128 per SM."""
    for block, ctas in ((64, 4), (128, 2)):
        fact = tfa.qkv_launch("fwd", 8, 12, 1024, 64, torch.bfloat16, block, block)
        assert ctas * (fact.dynamic_smem + CTA_RESERVED) <= SM_SMEM
        assert (ctas + 1) * (fact.dynamic_smem + CTA_RESERVED) > SM_SMEM


def _paged_mirror(s, hq, h_kv, d, mb, bl, itemsize):
    """Row 1's two launches as ``csrc/paged_decode.cu`` sizes them: split
    grid (S, Hkv, ceil(MB * BL / 64)), 128 threads, ``split_smem``; combine
    grid (S, Hkv, 1), no shared memory; the workspace record g * (D + 2)
    floats per (slot, kv head, split)."""
    g, n_split = hq // h_kv, -(-mb * bl // 64)
    smem = 2 * 64 * (d * itemsize + 16) + 4 * (g * d + g * 64 + 128 + 2 * g) + 4 * 68
    return (((s, h_kv, n_split), 128, smem, 0), ((s, h_kv, 1), 128, 0, 0),
            s * h_kv * n_split * g * (d + 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hq,h_kv,d,mb,bl", [
    (8, 12, 12, 64, 64, 16),    # the serve wave
    (8, 12, 12, 64, 256, 16),   # the long-context case
    (5, 12, 4, 256, 9, 16),     # GQA g = 3, the widest head
    (3, 4, 4, 40, 7, 10),       # a chunk that straddles pages
])
def test_paged_decode_declarations_equal_the_cu_sizes(s, hq, h_kv, d, mb, bl, dtype):
    from rocket_tpu_torch.ops import paged_attention as tpa

    split, combine = tpa.paged_decode_launches(s, hq, h_kv, d, 1 + s * mb, bl, mb, dtype)
    want_split, want_combine, work = _paged_mirror(s, hq, h_kv, d, mb, bl,
                                                   2 if dtype == torch.bfloat16 else 4)
    assert (split.name, combine.name) == ("paged_decode", "paged_decode_combine")
    assert split.geometry == want_split and combine.geometry == want_combine
    assert tpa.workspace_floats(s, hq, h_kv, d, mb, bl) == work
    spec = device_spec(DEFAULT_DEVICE_KIND)
    assert check_launches([split, combine], spec) == []


def test_paged_decode_split_count_follows_the_table_shape_alone():
    from rocket_tpu_torch.ops import paged_attention as tpa

    assert [tpa.num_splits(mb, bl) for mb, bl in (
        (64, 16), (256, 16), (1, 16), (4, 16), (5, 16), (3, 100), (64, 1), (1, 1))] == [
        16, 64, 1, 1, 2, 5, 1, 1]
    for mb, bl in ((64, 16), (7, 10), (256, 16)):
        # positions never enter: a meta call records the same grid for any.
        args = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in (
            ((8, 12, 64), torch.bfloat16), ((1 + 8 * mb, bl, 12, 64), torch.bfloat16),
            ((1 + 8 * mb, bl, 12, 64), torch.bfloat16), ((8, mb), torch.int32),
            ((8,), torch.int32))]
        with _launch.record_launches() as facts:
            tpa.paged_decode(*args)
        assert [f.grid for f in facts] == [(8, 12, tpa.num_splits(mb, bl)), (8, 12, 1)]


def test_serve_target_declares_the_split_and_the_combine():
    facts = run_sched_target(SCHED_TARGETS["serve"]).launches
    names = [f.name for f in facts]
    assert names == ["paged_decode", "paged_decode_combine", "decode_attention",
                     "decode_attention_combine"]
    assert facts[0].grid == (8, 12, 16) and facts[0].dynamic_smem == 19_736
    # generate()'s step: B=4 against a 192-row cache, three splits.
    assert facts[2].grid == (4, 12, 3) and facts[2].dynamic_smem == 19_736 - 4 * 68
    assert facts[3].grid == (4, 12, 1) and facts[3].smem_bytes == 0


def _decode_mirror(b, hq, h_kv, t_max, d, itemsize):
    """Row 2's two launches as ``csrc/decode_attention.cu`` sizes them:
    split grid (B, Hkv, ceil(T / 64)), 128 threads, ``split_smem`` of
    ``decode_common.cuh`` (row 1's without its page ids); combine grid (B,
    Hkv, 1), no shared memory; the workspace record g * (D + 2) floats per
    (row, kv head, split)."""
    g, n_split = hq // h_kv, -(-t_max // 64)
    smem = 2 * 64 * (d * itemsize + 16) + 4 * (g * d + g * 64 + 128 + 2 * g)
    return (((b, h_kv, n_split), 128, smem, 0), ((b, h_kv, 1), 128, 0, 0),
            b * h_kv * n_split * g * (d + 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,h_kv,t_max,d", [
    (4, 12, 12, 192, 64),     # generate()'s step
    (8, 12, 12, 1024, 64),    # a long prompt
    (3, 12, 4, 100, 128),     # GQA g = 3, T not a multiple of 64
    (2, 8, 2, 64, 256),       # the widest head, one split
    (1, 4, 4, 1, 32),         # a one-row cache
])
def test_decode_attention_declarations_equal_the_cu_sizes(b, hq, h_kv, t_max, d, dtype):
    from rocket_tpu_torch.ops import decode_attention as tda

    split, combine = tda.decode_attention_launches(b, hq, h_kv, t_max, d, dtype)
    want_split, want_combine, work = _decode_mirror(b, hq, h_kv, t_max, d,
                                                    2 if dtype == torch.bfloat16 else 4)
    assert (split.name, combine.name) == ("decode_attention", "decode_attention_combine")
    assert split.geometry == want_split and combine.geometry == want_combine
    assert tda.workspace_floats(b, hq, h_kv, t_max, d) == work
    assert tda.num_splits(t_max) == -(-t_max // 64)
    assert check_launches([split, combine], device_spec(DEFAULT_DEVICE_KIND)) == []


def test_decode_attention_grid_follows_the_cache_length_not_pos():
    """The split grid is (B, Hkv, ceil(T / 64)) whatever the position, so
    it does not change from token to token."""
    from rocket_tpu_torch.ops import decode_attention as tda

    ops = [torch.empty(shape, dtype=torch.bfloat16, device="meta") for shape in (
        (4, 12, 64), (4, 12, 64), (4, 12, 64), (4, 12, 192, 64), (4, 12, 192, 64))]
    grids = set()
    for pos in (0, 63, 64, 128, 191):
        with _launch.record_launches() as facts:
            tda.decode_attention(*ops, pos)
        grids.add(tuple(f.grid for f in facts))
    assert grids == {((4, 12, 3), (4, 12, 1))}


def _gather_gmm_mirror(m, n, e, sms):
    """Row 11's bf16 launch as ``csrc/gather_gmm.cu`` sizes it: a persistent
    grid of min(SMs, (M / 128 + E + 1) * ceil(N / 256)) CTAs of 384 threads
    (two consumer warpgroups and a producer), and ``kWgSmem``: 1 KB of
    alignment slack, four slices of a 128 x 64 bf16 A tile and four 64 x 64
    bf16 TMA boxes, and eight 8-byte mbarriers."""
    slots = (m // 128 + e + 1) * -(-n // 256)
    return ((min(sms, slots), 1, 1), 384, 1024 + 4 * (16_384 + 32_768) + 64, 0)


@pytest.mark.parametrize("m,k,n,e,sms", [
    (18432, 768, 3072, 4, 132),   # the MoE in-projection on an H100
    (18432, 768, 3072, 4, 114),   # a card of fewer SMs
    (80, 768, 3072, 4, 132),      # the decode layout: fewer tiles than SMs
    (300, 200, 200, 4, 132),      # K and N past whole tiles
])
def test_gather_gmm_bf16_declaration_equals_the_cu_sizes(m, k, n, e, sms):
    from rocket_tpu_torch.ops import gather_gmm as tgg
    from rocket_tpu_torch.ops import grouped_matmul as tgm

    fact = tgg.gather_gmm_launch(m, k, n, e, torch.bfloat16, 8192, sms)
    assert fact.name == "gather_gmm"
    assert fact.geometry == _gather_gmm_mirror(m, n, e, sms)
    assert check_launches([fact], device_spec(DEFAULT_DEVICE_KIND)) == []
    # f32 keeps the grouped products' CUDA-core launch.
    f32 = tgg.gather_gmm_launch(m, k, n, e, torch.float32, 8192, sms)
    assert f32 == tgm.gmm_launch(m, k, n, e, torch.float32, name="gather_gmm", src_rows=8192)


def test_gather_gmm_meta_grid_is_the_priced_cards():
    """The meta route sizes the persistent grid by the SMs of the card being
    priced, and refuses to guess without one."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops import gather_gmm as tgg

    x = torch.empty((8192, 768), dtype=torch.bfloat16, device="meta")
    rhs = torch.empty((4, 768, 3072), dtype=torch.bfloat16, device="meta")
    ids = torch.empty((18432,), dtype=torch.int32, device="meta")
    sizes = torch.empty((4,), dtype=torch.int32, device="meta")
    with tune.priced_device_kind(DEFAULT_DEVICE_KIND), _launch.record_launches() as facts:
        tgg.gather_gmm_fwd(x, rhs, ids, sizes, 512)
    assert [f.grid for f in facts] == [(device_spec(DEFAULT_DEVICE_KIND).sms, 1, 1)]
    with tune.priced_device_kind("TPU v5 lite"), pytest.raises(ValueError, match="SM count"):
        tgg.gather_gmm_fwd(x, rhs, ids, sizes, 512)


def _gmm_wgmma_mirror(m, n, e, sms, bn):
    """The bf16 gmm launch as ``csrc/grouped_gemm.cu`` sizes it on
    ``csrc/wgmma_gemm.cuh``'s kernel (row 11's) at ``bn`` output columns: a
    persistent grid of min(SMs, (M / 128 + E + 1) * ceil(N / bn)) CTAs of
    384 threads, and ``kWgSmem<bn>``: 1 KB of alignment slack, four slices
    of a 128 x 64 bf16 A tile and a 64 x bn bf16 B block, and eight 8-byte
    mbarriers."""
    slots = (m // 128 + e + 1) * -(-n // bn)
    return ((min(sms, slots), 1, 1), 384, 1024 + 4 * (16_384 + 128 * bn) + 64, 0)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,k,n,e,sms,bn", [
    (18432, 3072, 768, 4, 132, 192),   # the out-projection and the in-projection's dlhs
    (18432, 768, 3072, 4, 132, 192),   # the out-projection's dlhs, the padded in-projection
    (16384, 768, 3072, 4, 132, 256),   # the in-projection at raw counts (impl="gmm")
    (16384, 3072, 768, 4, 132, 256),   # the out-projection at raw counts
    (18432, 3072, 768, 4, 114, 256),   # a card of fewer SMs
    (80, 3072, 768, 4, 132, 192),      # decode: fewer tiles than SMs
    (300, 200, 200, 4, 132, 192),      # K and N past whole tiles
])
def test_gmm_bf16_declaration_is_the_persistent_wgmma_grid(m, k, n, e, sms, bn, transpose):
    """bf16 gmm declares the persistent wgmma grid at the tile width its
    rule picks for the card (both modes): the width whose waves, ceil(ceil(M
    / 128) * ceil(N / width) / SMs) * width, cost least, 256 on a tie."""
    from rocket_tpu_torch.ops import grouped_matmul as tgm

    assert tgm.gmm_block_n(m, n, sms) == bn
    fact = tgm.gmm_launch(m, k, n, e, torch.bfloat16, transpose, sms=sms)
    assert fact.name == "gmm"
    assert fact.geometry == _gmm_wgmma_mirror(m, n, e, sms, bn)
    assert check_launches([fact], device_spec(DEFAULT_DEVICE_KIND)) == []
    b_box = (bn, 64) if transpose else (64, 64)
    assert {rc for rc, _, _ in fact.tiles} == {(1, e), (128, 64), b_box, (128, bn)}
    with pytest.raises(ValueError, match="SM count"):
        tgm.gmm_launch(m, k, n, e, torch.bfloat16, transpose)
    # f32 keeps the CUDA-core tiles: one CTA per (work tile, 128 columns).
    f32 = tgm.gmm_launch(m, k, n, e, torch.float32, transpose, sms=sms)
    assert f32.geometry[:2] == ((m // 128 + e + 1, -(-n // 128), 1), 256)
    assert f32.dynamic_smem == 0


def test_gmm_meta_route_records_the_priced_cards_grid_in_both_modes():
    """The autograd seam on meta tensors priced as an H100: the forward gmm,
    the backward's transposed gmm and tgmm declare the persistent grid of
    the card's SMs at the width the rule picks (192 columns at 18432 rows,
    256 at the raw counts' 16384; tgmm's 192 over its K tiles); a meta
    trace needs a card to price."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops import grouped_matmul as tgm

    lhs = torch.empty((18432, 3072), dtype=torch.bfloat16, device="meta", requires_grad=True)
    rhs = torch.empty((4, 3072, 768), dtype=torch.bfloat16, device="meta", requires_grad=True)
    sizes = torch.empty((4,), dtype=torch.int32, device="meta")
    sms = device_spec(DEFAULT_DEVICE_KIND).sms
    with tune.priced_device_kind(DEFAULT_DEVICE_KIND), _launch.record_launches() as facts:
        out = tgm.grouped_matmul(lhs, rhs, sizes)
        out.backward(torch.empty_like(out))
    assert [f.name for f in facts] == ["gmm", "gmm", "tgmm"]
    assert [f.geometry for f in facts[:2]] == [_gmm_wgmma_mirror(18432, 768, 4, sms, 192),
                                              _gmm_wgmma_mirror(18432, 3072, 4, sms, 192)]
    assert facts[2].geometry == _tgmm_wgmma_mirror(3072, 768, 4, sms, 192)
    with tune.priced_device_kind("TPU v5 lite"), pytest.raises(ValueError, match="SM count"):
        tgm.gmm(lhs.detach(), rhs.detach(), sizes)
    raw = torch.empty((16384, 3072), dtype=torch.bfloat16, device="meta")
    with tune.priced_device_kind(DEFAULT_DEVICE_KIND), _launch.record_launches() as wide:
        tgm.gmm(raw, rhs.detach(), sizes)
    assert [f.geometry for f in wide] == [_gmm_wgmma_mirror(16384, 768, 4, sms, 256)]


def _tgmm_wgmma_mirror(k, n, e, sms, bn):
    """The bf16 tgmm launch as ``csrc/grouped_gemm.cu`` sizes it on
    ``csrc/wgmma_gemm.cuh``'s kernel at ``bn`` output columns: a persistent
    grid of min(SMs, ceil(K / 128) * E * ceil(N / bn)) CTAs of 384 threads
    over (K tile, N tile, group) slots, and ``kWgSmem<bn>`` as gmm's: per
    slice two 64 x 64 bf16 boxes of lhs (16 KB, gmm's A tile) and bn / 64
    boxes of dy."""
    slots = -(-k // 128) * e * -(-n // bn)
    return ((min(sms, slots), 1, 1), 384, 1024 + 4 * (16_384 + 128 * bn) + 64, 0)


@pytest.mark.parametrize("m,k,n,e,sms,bn", [
    (18432, 768, 3072, 4, 132, 192),   # the in-projection's drhs: 384 slots, 3 waves at 97%
    (18432, 3072, 768, 4, 132, 192),   # the out-projection's drhs
    (4096, 1024, 1024, 4, 132, 256),   # 128 slots of 256 fill one wave, 192's need two
    (18432, 3072, 768, 4, 114, 256),   # a card of fewer SMs: four waves either way, a tie
    (300, 200, 200, 2, 132, 192),      # K and N past whole tiles, fewer slots than SMs
])
def test_tgmm_bf16_declaration_is_the_persistent_wgmma_grid(m, k, n, e, sms, bn):
    """bf16 tgmm declares the persistent wgmma grid at the width gmm's one
    rule picks over its row tiles, ceil(K / 128) per group, with the
    ``.cu``'s shared memory; the grid does not depend on M; f32 keeps its
    CUDA-core grid of one CTA per (K tile, 128 columns, group)."""
    from rocket_tpu_torch.ops import grouped_matmul as tgm

    assert tgm.tgmm_block_n(k, n, e, sms) == bn
    assert tgm.tgmm_block_n(k, n, e, sms) == tgm.wave_block_n(-(-k // 128) * e, n, sms)
    fact = tgm.tgmm_launch(m, k, n, e, torch.bfloat16, sms)
    assert fact.name == "tgmm"
    assert fact.geometry == _tgmm_wgmma_mirror(k, n, e, sms, bn)
    assert tgm.tgmm_launch(2 * m, k, n, e, torch.bfloat16, sms).geometry == fact.geometry
    assert check_launches([fact], device_spec(DEFAULT_DEVICE_KIND)) == []
    assert {rc for rc, _, _ in fact.tiles} == {(1, e), (64, 128), (64, 64), (128, bn)}
    with pytest.raises(ValueError, match="SM count"):
        tgm.tgmm_launch(m, k, n, e, torch.bfloat16)
    f32 = tgm.tgmm_launch(m, k, n, e, torch.float32, sms)
    assert f32.geometry == ((-(-k // 128), -(-n // 128), e), 256, 0,
                            4 * 16 * (128 + 128) + 8 * 4 * 16)


#: ResNet-18's four CIFAR train shapes at B=512 (f32) and the tuner's two
#: bf16 ones, and an N whose last slab is short (264 CTAs of 266 rows: the
#: last holds 42) at the stem's width.
BN_DECL_SHAPES = [(524288, 64, torch.float32), (131072, 128, torch.float32),
                  (32768, 256, torch.float32), (8192, 512, torch.float32),
                  (262144, 64, torch.bfloat16), (401408, 64, torch.bfloat16),
                  (70000, 64, torch.float32)]


def _bn_twopass_mirror(n, c, item, sms):
    """Row 9's launch as ``csrc/fused_conv.cu`` sizes it: one cooperative
    launch of G = min(264, ceil(N / 64)) CTAs of 256 threads; static
    ``buf[3 * kMaxC]`` f32 (24 KB) and dynamic shared memory for the whole
    rows of a CTA's ceil(N / G)-row slab before its last step of 16
    vectors a thread (kept in registers) that fit in its share of the SM's
    228 KB with ceil(G / SMs) CTAs resident (1 KB reserved for each, at most
    the 227 KB a CTA may opt into)."""
    grid = min(264, -(-n // 64))
    share = min(SM_SMEM // -(-grid // sms) - CTA_RESERVED, 232_448) - 3 * 4 * 2048
    vecs = c * item // 16  # 16-byte vectors a row, at most 256 a step (one a thread)
    step = 16 // -(-vecs // 256) * (256 // min(vecs, 256))  # a step's rows, kept in registers
    rows = min(max(-(-n // grid) - step, 0), share // (c * item))
    return ((grid, 1, 1), 256, rows * c * item, 3 * 4 * 2048)


@pytest.mark.parametrize("n,c,dtype", BN_DECL_SHAPES, ids=lambda v: str(v))
def test_bn_twopass_declaration_is_one_launch(n, c, dtype):
    """Row 9 declares one launch whose grid, threads and shared memory are
    the ``.cu``'s; the CTAs that must share an SM of an H100 (two at 264
    CTAs, one at 128) fit by shared memory; row 10 keeps its own launch.
    At (8192, 512) f32 (128 CTAs of 64 rows) the slab stays on the SM
    whole: its last 32 rows in registers, the first 32 in shared memory."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops import fused_conv as tfc

    item = torch.empty((), dtype=dtype).element_size()
    sms = device_spec(DEFAULT_DEVICE_KIND).sms
    with tune.priced_device_kind(DEFAULT_DEVICE_KIND):
        grid, norm = tfc._grids(torch.empty((n, c), dtype=dtype, device="meta"))
    facts = tfc.bn_launches("twopass", n, c, dtype, grid, norm, sms)
    assert [f.name for f in facts] == ["bn_twopass"]
    assert facts[0].geometry == _bn_twopass_mirror(n, c, item, sms)
    assert -(-grid // sms) * (facts[0].smem_bytes + CTA_RESERVED) <= SM_SMEM
    assert check_launches(facts, device_spec(DEFAULT_DEVICE_KIND)) == []
    normalize = tfc.bn_launches("normalize", n, c, dtype, grid, norm)
    assert [f.geometry for f in normalize] == [((norm, 1, 1), 256, 0, 3 * 4 * 2048)]
    with pytest.raises(ValueError, match="SM count"):
        tfc.bn_launches("twopass", n, c, dtype, grid, norm)
    if (n, c, dtype) == (8192, 512, torch.float32):
        assert (grid, facts[0].dynamic_smem) == (128, 32 * c * item)


def test_bn_twopass_meta_route_records_one_launch():
    """Under ``fused_bn_act`` on meta tensors priced as an H100, the
    twopass schedule records one launch of row 9 and the stats_xla one one
    of row 10; neither counts a launch."""
    from rocket_tpu_torch import tune
    from rocket_tpu_torch.ops import fused_conv as tfc

    x = torch.empty((512, 16, 16, 64), device="meta")
    scale = torch.empty((64,), device="meta")
    before = (tfc.bn_twopass.launches, tfc.bn_normalize.launches)
    for schedule, name in (("twopass", "bn_twopass"), ("stats_xla", "bn_normalize")):
        with tune.priced_device_kind(DEFAULT_DEVICE_KIND), _launch.record_launches() as facts:
            tfc.fused_bn_act(x, scale, scale, schedule=schedule)
        assert [f.name for f in facts] == [name]
    assert (tfc.bn_twopass.launches, tfc.bn_normalize.launches) == before


#: Shared memory an SM holds for resident CTAs (228 KB), each CTA also
#: taking 1 KB the card reserves for it.
SM_SMEM, CTA_RESERVED = 233_472, 1024


@pytest.mark.parametrize("kernel,fact,ctas", [
    ("flash_fwd D=64", tfn.flash_launch("flash_fwd", 8, 1024, 12, 12, 64, torch.bfloat16, 2304,
                                        2304), 3),
    ("flash_fwd D=32", tfn.flash_launch("flash_fwd", 64, 128, 4, 4, 32, torch.bfloat16, 384,
                                        384), 3),
    ("flash_bwd D=64", tfn.flash_launch("flash_bwd", 8, 1024, 12, 12, 64, torch.bfloat16, 2304,
                                        2304), 3),
    ("flash_dq D=64", tfn.flash_launch("flash_dq", 8, 2048, 12, 12, 64, torch.bfloat16, 2304,
                                       2304), 4),
    ("fused_block separate", tfb.fused_block_launch(128, 256, 256, 4, torch.bfloat16,
                                                    "separate"), 2),
    ("fused_block fused", tfb.fused_block_launch(128, 256, 256, 4, torch.bfloat16, "fused"), 2),
])
def test_bf16_declarations_leave_room_for_resident_ctas(kernel, fact, ctas):
    """The tensor-core kernels at their main shapes (rows 3-5 and 8): bf16
    tiles leave room for ``ctas`` resident CTAs per SM by shared memory."""
    assert ctas * (fact.dynamic_smem + fact.static_smem + CTA_RESERVED) <= SM_SMEM, kernel
    assert fact.threads == 128


#: (kind, D) -> dynamic shared memory of the f32 flash kernels, and T ->
#: that of the f32 fused block: the CUDA-core kernels, not redesigned.
F32_FLASH_SMEM = {("flash_fwd", 64): 66_560, ("flash_fwd", 32): 41_984,
                  ("flash_bwd", 64): 100_352, ("flash_dq", 64): 83_712}
F32_BLOCK_SMEM = {256: 166_912, 320: 200_192, 100: 100_352}


def test_f32_declarations_are_unchanged():
    for (kind, d), smem in F32_FLASH_SMEM.items():
        fact = tfn.flash_launch(kind, 8, 1024, 12, 12, d, torch.float32, 36 * d, 36 * d)
        assert (fact.dynamic_smem, fact.static_smem, fact.threads) == (smem, 0, 128), kind
        assert fact.grid == (16, 12, 8)
        assert not tfn.tensor_cores(kind, torch.float32)
    for t, smem in F32_BLOCK_SMEM.items():
        for epilogue in tfb.EPILOGUES:
            fact = tfb.fused_block_launch(128, t, 256, 4, torch.float32, epilogue)
            assert (fact.dynamic_smem, fact.threads, fact.grid) == (smem, 128, (4, 128, 1))
    fused = tfb.fused_block_launch(128, 256, 256, 4, torch.float32, "fused")
    assert {rc for rc, _, _ in fused.tiles} >= {(32, 64), (64, 64)}
    assert (32, 128) not in {rc for rc, _, _ in fused.tiles}


def _tc_backward_smem(kind, d):
    """``launch_smem`` of the bf16 ``csrc/flash_bwd.cu`` and
    ``csrc/flash_dq.cu``: six bf16 64 x (D + 8) row tiles (K, V and two
    stages of Q and dout; Q, dout and two stages of K and V), and for the
    backward the bf16 64 x 72 dS^T tile and two stages of lse and delta
    (64 f32 each)."""
    tiles = 2 * 6 * 64 * (d + 8)
    return tiles + 2 * 64 * 72 + 4 * 2 * 2 * 64 if kind == "flash_bwd" else tiles


@pytest.mark.parametrize("d,bwd,dq", [(64, 65_536, 55_296), (32, 40_960, 30_720)])
@pytest.mark.parametrize("with_dq", [True, False])
def test_bf16_backward_declarations_mirror_the_cu_sizes(d, bwd, dq, with_dq):
    """Rows 4 and 5 in bf16 run on the tensor cores: their declarations
    are the .cu files' bf16 sizes, with or without the dq partials (one
    kernel either way), and not the f32 kernels'."""
    for kind, smem in (("flash_bwd", bwd), ("flash_dq", dq)):
        fact = tfn.flash_launch(kind, 8, 1024, 12, 12, d, torch.bfloat16, 36 * d, 36 * d,
                                with_dq)
        assert tfn.tensor_cores(kind, torch.bfloat16)
        assert (fact.dynamic_smem, fact.static_smem, fact.threads) == (
            _tc_backward_smem(kind, d), 0, 128) == (smem, 0, 128), kind
        assert fact.grid == (16, 12, 8)
        f32 = tfn.flash_launch(kind, 8, 1024, 12, 12, d, torch.float32, 36 * d, 36 * d, with_dq)
        assert f32.dynamic_smem > smem


@pytest.mark.parametrize("name", ["train_flash", "train_flash_long", "fused_kernels"])
def test_targets_trace_the_tensor_core_declarations_and_stay_clean(name):
    """The bf16 targets of rows 3-5 and 8 declare the tensor-core kernels'
    shared memory (bf16 tiles at padded strides) and RKT504 finds nothing."""
    report = run_sched_target(SCHED_TARGETS[name])
    assert report.clean, [f.render() for f in report.findings]
    smem = {f.name: f.dynamic_smem for f in report.launches}
    if name.startswith("train_flash"):
        assert smem["flash_fwd"] == 2 * 5 * 64 * (64 + 8) == 46_080
        assert smem["flash_bwd"] == _tc_backward_smem("flash_bwd", 64) == 65_536
        assert ("flash_dq" in smem) == (name == "train_flash_long")
        if name == "train_flash_long":
            assert smem["flash_dq"] == _tc_backward_smem("flash_dq", 64) == 55_296
    else:
        assert smem["fused_block"] == 110_080
        fused = [f for f in report.launches if f.name == "fused_block"]
        assert {(32, 128) in {rc for rc, _, _ in f.tiles} for f in fused} == {True, False}


def test_bf16_block_smem_follows_t_and_the_out_columns_follow_d():
    assert [tfb._smem_bytes(t, torch.bfloat16) for t in (1, 64, 65, 256, 320)] == [
        54_784, 54_784, 73_216, 110_080, 128_512]
    assert tfb._out_cols(256, torch.bfloat16) == (128, 128)
    assert tfb._out_cols(192, torch.bfloat16) == (128, 64)
    assert tfb._out_cols(64, torch.bfloat16) == (64,)
    assert tfb._out_cols(256, torch.float32) == (64,)


def test_audit_schedule_prices_any_step_and_rejects_an_unknown_card():
    x = torch.empty(SHAPE, device="meta")
    report = audit_schedule(lambda x: tbp.bad_scale(x, (8, 128), (512, 32)), x, label="ok")
    assert report.clean and [f.name for f in report.launches] == ["bad_scale"]
    with pytest.raises(ValueError, match="unknown device kind"):
        collect_launch_facts(lambda: None, device_kind="TPU v5 lite")


def test_cli_exit_codes(capsys):
    assert cli.main(["sched"]) == 0
    assert cli.main(["sched", "--target", "badpallas", "--format", "json"]) == 1
    findings = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in findings] == ["RKT504", "RKT504"]
    messages = " | ".join(f["message"] for f in findings)
    assert "[7, 100] float32" in messages and "last dim" in messages and "rows 7" in messages
    assert "67,108,864 B" in messages and "232,448 B" in messages
    assert cli.main(["sched", "--list-targets"]) == 0
    assert "[demo]" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["sched", "--target", "nope"])
    assert exit_info.value.code == 2
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["sched", "--device-kind", "TPU v5 lite"])
    assert exit_info.value.code == 2


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "rocket_tpu_torch.analysis", "sched",
                           "--target", "badpallas"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.count("RKT504") == 2


# -- row 12 against the fixture ------------------------------------------------


@pytest.fixture(scope="module")
def fixture_outputs():
    """x and the fixture's two pallas_call outputs on it, evaluated once: the
    calls are taken from the jaxpr of the fixture's own step and rebound
    with interpret=True."""
    step, variables, batch, _, _ = _badpallas_parts()
    concrete = lambda tree: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)  # noqa: E731
    closed = jax.make_jaxpr(step)(concrete(variables), concrete(batch))
    calls = [e for e in closed.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 2
    x = np.random.default_rng(12).standard_normal(SHAPE).astype(np.float32)
    outs = [np.asarray(e.primitive.bind(jnp.asarray(x), **dict(e.params, interpret=True))[0])
            for e in calls]
    return x, outs


@pytest.mark.parametrize("which", [0, 1], ids=["blocks_7x100_grid4", "whole_array"])
def test_bad_scale_plain_matches_the_fixture_on_written_blocks(fixture_outputs, which):
    x, outs = fixture_outputs
    block, grid = LAUNCHES[which]
    rows, cols = tbp.written_blocks(SHAPE, block, grid)
    got = tbp.bad_scale(torch.from_numpy(x), block, grid).numpy()
    np.testing.assert_array_equal(got[rows, cols], outs[which][rows, cols])
    assert got[rows, cols].size == (28 * 100 if which == 0 else x.size)


def test_bad_scale_meta_records_both_launches_and_counts_none():
    x = torch.empty(SHAPE, device="meta")
    before = tbp.bad_scale.launches
    with _launch.record_launches() as facts:
        y = tbp.bad_scale(x, (7, 100), (4,))
        tbp.bad_scale(x, SHAPE, ())
    assert y.device.type == "meta" and y.shape == x.shape
    assert [(f.grid, f.dynamic_smem) for f in facts] == [((4, 1, 1), 2800),
                                                         ((1, 1, 1), 67108864)]
    assert tbp.bad_scale.launches == before
    with pytest.raises(ValueError, match="block"):
        tbp.bad_scale(x, (7,), (4,))
    with pytest.raises(ValueError, match="float32"):
        tbp.bad_scale(x.to(torch.bfloat16), (8, 128), (1,))
