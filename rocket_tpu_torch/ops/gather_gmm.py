"""Gather-GMM — the grouped matrix product whose lhs rows are read by index
from the unsorted token rows (counterpart of ``rocket_tpu/ops/gather_gmm.py``,
row 11 of the kernel table): ``out[r] = x[row_ids[r]] @ rhs[expert of r]``,
so the sorted (M, K) copy of the routed rows never exists.

Group layout contract (:func:`padded_group_layout` builds it, with the
same integers as the reference): rows are sorted by expert and each
expert's segment is padded up to a multiple of ``tile_m``, the last group
taking the unused tail, so every ``tile_m`` tile belongs to one expert
(:func:`expert_per_tile`). Pad rows carry row id 0, a real row; their
outputs are never gathered back. The padded row count is the static
worst case ``(ceil(NK / tile_m) + E) * tile_m``; the group sizes stay
device values, so nothing synchronises with the host.

* :func:`gather_gmm` is the differentiable entry point, a
  ``torch.autograd.Function``: the forward is the kernel
  (:func:`gather_gmm_fwd`, ``csrc/gather_gmm.cu``), the backward the
  reference's composition — the vjp of ``grouped_matmul(x[row_ids], rhs,
  group_sizes)``: ``dx = index_add(row_ids, gmm(dy, rhs,
  transpose_rhs=True))`` and ``drhs = tgmm(x[row_ids], dy)``
  (``ops/grouped_matmul.py``'s kernels on the card).
* :func:`gather_gmm_fwd` takes its plain version
  (:func:`gather_gmm_reference`, tile by tile as the TPU kernel computes)
  for CPU tensors, the counterpart of the reference's interpret mode; for
  CUDA tensors it launches the kernel or raises, and counts its launches
  in ``gather_gmm_fwd.launches``.

``tile_m``/``tile_n`` are the TPU grid's tiles: they are checked as the
reference checks them and set the layout; the CUDA kernel chooses its own
tiles, and a ``tile_m`` smaller than its 128 rows is fine (it finds each
row's group from the group sizes). In bf16 the kernel is a persistent
wgmma + TMA kernel (one CTA per SM, three warpgroups); in f32 it keeps the
grouped products' CUDA-core tiles (:func:`gather_gmm_launch`).
"""

from __future__ import annotations

import ctypes

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import (
    DTYPE_CODES,
    LaunchFact,
    itemsize,
    query_launch,
    record,
    sm_count,
    stream_of,
    tile,
    with_work,
)
from rocket_tpu_torch.ops.grouped_matmul import (
    BLOCK_M,
    WG_SLICE,
    check_grouped,
    gmm,
    gmm_launch,
    gmm_work,
    tgmm,
    wgmma_launch,
)

__all__ = [
    "gather_gmm", "gather_gmm_supported", "padded_group_layout", "expert_per_tile",
    "gather_gmm_fwd", "gather_gmm_reference", "GatherGmm", "gather_gmm_launch", "launch_info",
    "attribute",
]

def gather_gmm_supported(k: int, n: int, tile_n: int) -> bool:
    """The reference's shape gate: K a sublane multiple, the output tiled
    by a lane-multiple ``tile_n``."""
    return k % 8 == 0 and n % tile_n == 0 and tile_n % 128 == 0


def _exclusive_cumsum(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v, 0, dtype=torch.int32) - v


def padded_group_layout(counts, sorted_token, tile_m: int, nk: int, sorted_expert=None,
                        valid=None):
    """Tile-aligned padded layout for :func:`gather_gmm`.

    ``counts`` (E,) int per-expert row counts summing to ``nk``;
    ``sorted_token`` (NK,) the source row of each sorted row;
    ``sorted_expert`` (NK,) each sorted row's expert when the caller has
    it, else derived with a searchsorted. Returns ``(row_ids (M,) int32,
    group_sizes (E,) int32, padded_pos (NK,) int32, M)``: every group
    padded to a ``tile_m`` multiple (the last one inflated to cover the
    tail, so the groups sum to M) and ``padded_pos`` mapping a sorted row
    to its padded row.

    ``valid`` (NK,) bool, for a rank that holds only some experts (expert
    parallelism): the sorted rows of its experts come first and ``counts``
    cover them only; the other rows get no padded row (``padded_pos`` M)
    and the last group is not inflated, so the groups sum below M and the
    rows past them belong to none (the kernels give them no work)."""
    e = counts.shape[0]
    m = ((nk + tile_m - 1) // tile_m + e) * tile_m  # static worst case
    counts = counts.to(torch.int32)
    padded = (counts + tile_m - 1) // tile_m * tile_m
    pofs = _exclusive_cumsum(padded)
    ofs = _exclusive_cumsum(counts)
    rows = torch.arange(nk, dtype=torch.int32, device=counts.device)
    if sorted_expert is None:
        sorted_expert = torch.searchsorted(torch.cumsum(counts, 0, dtype=torch.int32), rows,
                                           right=True)
    sorted_expert = sorted_expert.long()
    padded_pos = pofs[sorted_expert] + (rows - ofs[sorted_expert])
    group_sizes = padded.clone()
    if valid is not None:
        padded_pos = torch.where(valid, padded_pos, m)
        row_ids = torch.zeros((m + 1,), dtype=torch.int32, device=counts.device)
        row_ids[padded_pos.long()] = sorted_token.to(torch.int32)
        return row_ids[:m].contiguous(), group_sizes, padded_pos, m
    row_ids = torch.zeros((m,), dtype=torch.int32, device=counts.device)
    row_ids[padded_pos.long()] = sorted_token.to(torch.int32)
    group_sizes[e - 1] += m - padded.sum(dtype=torch.int32)
    return row_ids, group_sizes, padded_pos, m


def expert_per_tile(group_sizes, tile_m: int, m: int):
    """(m // tile_m,) int32: the expert each ``tile_m`` tile computes (the
    group its first row falls in, clipped to the last)."""
    e = group_sizes.shape[0]
    starts = torch.arange(m // tile_m, dtype=torch.int32, device=group_sizes.device) * tile_m
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    return torch.clamp(torch.searchsorted(ends, starts, right=True), 0, e - 1).to(torch.int32)


# -- the forward: plain version and kernel -----------------------------------


def gather_gmm_reference(x, rhs, row_ids, group_sizes, tile_m: int):
    """Plain version of the TPU kernel: tile ``i`` of ``tile_m`` rows is
    ``x[row_ids[tile]] @ rhs[expert_per_tile[i]]``, in f32, cast to
    ``x.dtype``. Rows past the groups (group sizes summing below M, as
    :func:`padded_group_layout` lays them out for some of the experts)
    come out as zeros, as from the kernel."""
    m = row_ids.shape[0]
    expert = expert_per_tile(group_sizes, tile_m, m).repeat_interleave(tile_m)
    past = torch.arange(m, device=x.device) >= group_sizes.sum()
    expert = torch.where(past, -1, expert)
    xs = x[row_ids.long()].float()
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32, device=x.device)
    for g in range(rhs.shape[0]):
        rows = (expert == g).nonzero()[:, 0]
        if rows.numel():
            out[rows] = xs[rows] @ rhs[g].float()
    return out.to(x.dtype)


def gather_gmm_launch(m: int, k: int, n: int, e: int, dtype, src_rows: int,
                      sms: int, rows: int = -1) -> LaunchFact:
    """The launch of :func:`gather_gmm_fwd` on a card of ``sms`` SMs. bf16:
    the persistent wgmma grid it shares with gmm
    (``grouped_matmul.wgmma_launch``), the producer gathering a (BLOCK_M,
    WG_SLICE) tile of source rows through its row ids per slice and TMA
    loading four (WG_SLICE, 64) boxes of the group's rhs, and reading a
    (1, BLOCK_M) tile of row ids per work tile. f32: the grouped
    products' CUDA-core launch (``grouped_matmul.gmm_launch``). Its work is
    ``grouped_matmul.gmm_work``'s over ``rows`` grouped rows."""
    if dtype != torch.bfloat16:
        return gmm_launch(m, k, n, e, dtype, name="gather_gmm", src_rows=src_rows, rows=rows)
    fact = wgmma_launch("gather_gmm", m, k, n, e, sms,
                        tile(BLOCK_M, WG_SLICE, dtype, src_rows, k),
                        tile(WG_SLICE, 64, dtype, k, n),
                        extra_tiles=(tile(1, BLOCK_M, torch.int32, 1, m),))
    return with_work(fact, *gmm_work("gather_gmm", m, k, n, e, dtype, rows, src_rows), dtype,
                     acc=torch.float32)


def _lib():
    lib = _build.load("gather_gmm")
    if lib.rkt_gather_gmm.argtypes is None:
        lib.rkt_gather_gmm.restype = ctypes.c_int
        lib.rkt_gather_gmm.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.rkt_gather_gmm_launch_info.restype = ctypes.c_int
        lib.rkt_gather_gmm_launch_info.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rkt_gather_gmm_attribute.restype = ctypes.c_int
        lib.rkt_gather_gmm_attribute.argtypes = [ctypes.c_int]
    return lib


def launch_info(m: int, n: int, e: int, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the launch on the
    current card as the built library reports it (needs the card); the
    declaration is :func:`gather_gmm_launch`."""
    return query_launch(_lib().rkt_gather_gmm_launch_info, m, n, e, DTYPE_CODES[dtype])


def attribute(what: str) -> int:
    """``"ctas"`` (resident CTAs per SM) or ``"registers"`` (per thread) of
    the bf16 kernel, as the card reports them; -1 when it refuses. Needs the
    card."""
    return _lib().rkt_gather_gmm_attribute(("ctas", "registers").index(what))


def gather_gmm_fwd(x, rhs, row_ids, group_sizes, tile_m: int):
    """Row 11: ``x`` (N, K) unsorted rows, ``rhs`` (E, K, N_out), ``row_ids``
    (M,) int32, ``group_sizes`` (E,) int32 -> (M, N_out) in x's dtype.
    CPU tensors: :func:`gather_gmm_reference`; CUDA tensors:
    ``rkt_gather_gmm`` or raise (a row id outside ``[0, N)`` reads as a zero
    row there); meta tensors record the launch."""
    if x.device.type == "cpu":
        return gather_gmm_reference(x, rhs, row_ids, group_sizes, tile_m)
    e, k, n_out = rhs.shape
    m = row_ids.shape[0]
    check_grouped("gather_gmm", group_sizes, e, x=x, rhs=rhs)
    if row_ids.dtype != torch.int32 or row_ids.dim() != 1 or not row_ids.is_contiguous():
        raise ValueError(f"gather_gmm: row_ids must be contiguous 1-D int32, got {row_ids.dtype} "
                         f"{tuple(row_ids.shape)}")
    if row_ids.device != x.device:
        raise ValueError(f"gather_gmm: row_ids is on {row_ids.device}, x on {x.device}")
    if k % 8 or n_out % 8:
        raise ValueError(f"gather_gmm: the kernel takes K and N multiples of 8, got K={k} "
                         f"N={n_out}")
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        record([gather_gmm_launch(m, k, n_out, e, x.dtype, x.shape[0],
                                  sm_count(x, "gather_gmm"))], (x, rhs, row_ids, group_sizes),
               (out,))
        return out
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or rhs.data_ptr() % 16):
        raise ValueError("gather_gmm: bf16 x and rhs must be 16-byte aligned (the kernel copies "
                         "rows in 16-byte pieces and TMA reads rhs)")
    err = _lib().rkt_gather_gmm(x.data_ptr(), x.shape[0], row_ids.data_ptr(), rhs.data_ptr(),
                                group_sizes.data_ptr(), out.data_ptr(), m, k, n_out, e,
                                DTYPE_CODES[x.dtype], stream_of(x))
    if err:
        raise RuntimeError(f"gather_gmm: kernel launch failed with cudaError {err}")
    gather_gmm_fwd.launches += 1
    return out


gather_gmm_fwd.launches = 0


# -- autograd (the reference composition's backward) -------------------------


class GatherGmm(torch.autograd.Function):
    """``apply(x, rhs, row_ids, group_sizes, tile_m)``: the forward is
    :func:`gather_gmm_fwd`; the backward is the vjp of the explicit gather
    + grouped matmul, through the ``gmm``/``tgmm`` kernels on the card. The
    ``dx`` scatter-add lands each routed row's cotangent on its token; pad
    rows (id 0) carry zero cotangents, since their outputs are never
    gathered back."""

    @staticmethod
    def forward(ctx, x, rhs, row_ids, group_sizes, tile_m):
        ctx.save_for_backward(x, rhs, row_ids, group_sizes)
        return gather_gmm_fwd(x, rhs, row_ids, group_sizes, tile_m)

    @staticmethod
    def backward(ctx, dy):
        x, rhs, row_ids, group_sizes = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        ids = row_ids.long()
        dx = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(dy, rhs, group_sizes, transpose_rhs=True)
            dx = torch.zeros_like(x).index_add_(0, ids, dlhs)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(x[ids], dy, group_sizes)
        return dx, drhs, None, None, None


def gather_gmm(x, rhs, row_ids, group_sizes, *, tile_m: int = 512, tile_n: int = 512):
    """``out[r] = x[row_ids[r]] @ rhs[expert_of(r)]``: ``x`` (N, K) the
    unsorted token rows, ``rhs`` (E, K, N_out), ``row_ids`` (M,) int32 in
    group-sorted, tile-aligned order, ``group_sizes`` (E,) int32 padded
    per-expert counts summing to M (:func:`padded_group_layout`). Returns
    (M, N_out) in the operand dtype with f32 accumulation."""
    m = int(row_ids.shape[0])
    k = x.shape[1]
    _, k2, n_out = rhs.shape
    if k != k2:
        raise ValueError(f"gather_gmm: K mismatch {k} != {k2}")
    tile_m = min(int(tile_m), m)
    tile_n = min(int(tile_n), n_out)
    if m % tile_m or not gather_gmm_supported(k, n_out, tile_n):
        raise ValueError(f"gather_gmm: shape (M={m}, K={k}, N={n_out}) does not tile "
                         f"(tile_m={tile_m}, tile_n={tile_n})")
    return GatherGmm.apply(x.contiguous(), rhs.contiguous(), row_ids.to(torch.int32).contiguous(),
                           group_sizes.to(torch.int32).contiguous(), tile_m)
