"""Grouped matrix products of the dropless MoE FFN (counterpart of
``rocket_tpu/nn/moe._grouped_matmul`` and of the megablox ``gmm``/``tgmm``
kernels it reaches on the TPU).

``lhs`` (M, K) rows are grouped by ``group_sizes`` (E,) int32 — group g is
the next ``group_sizes[g]`` rows, an empty group has none, and rows past
the last group belong to none and come out as zeros (``ragged_dot``'s
semantics) — and each group multiplies its own ``rhs[g]``.

* :func:`grouped_matmul` is the reference's seam: its gate (``k % 128 ==
  0 and n % 128 == 0 and m % 8 == 0``, with ``lhs.is_cuda`` in place of
  "on a TPU") sends a shape to :class:`GroupedMatmul`, whose forward is
  the ``gmm`` kernel and whose backward is megablox's — ``dlhs = gmm(dy,
  rhs, transpose_rhs=True)``, ``drhs = tgmm(lhs, dy)``; any other shape
  takes the reference's non-kernel branch (``ragged_dot`` on widened f32
  operands, then a cast), here :func:`grouped_matmul_plain`.
* :func:`gmm` and :func:`tgmm` are the kernel wrappers
  (``csrc/grouped_gemm.cu``): CPU tensors take their plain versions
  :func:`gmm_reference` / :func:`tgmm_reference`, CUDA tensors launch the
  kernel or raise; each counts its launches in ``<wrapper>.launches``;
  meta tensors record the launch (:func:`gmm_launch`, :func:`tgmm_launch`).
  In bf16, ``gmm`` and ``tgmm`` are the persistent wgmma + TMA kernel
  they share with the gather-GMM (``csrc/wgmma_gemm.cuh``: one CTA per
  SM, three warpgroups; ``tgmm`` over (K tile, N tile, group) slots with
  lhs^T as an M-major operand); in f32 both keep CUDA-core tiles.

All accumulate in f32 and return the operand dtype. The group sizes stay
on the device: the kernels read them there, so the hot path never
synchronises with the host. The plain versions loop over the groups on
the host.
"""

from __future__ import annotations

import ctypes

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import (
    DTYPE_CODES,
    LaunchFact,
    check_cuda_operands,
    itemsize,
    query_launch,
    record,
    sm_count,
    stream_of,
    tile,
    with_work,
)

__all__ = [
    "grouped_matmul", "grouped_matmul_supported", "grouped_matmul_plain", "GroupedMatmul",
    "gmm", "tgmm", "gmm_reference", "tgmm_reference", "group_bounds", "gmm_launch",
    "tgmm_launch", "wgmma_launch", "wave_block_n", "gmm_block_n", "tgmm_block_n",
    "launch_info", "attribute",
]

#: Threads per CTA and the output tile of the f32 grouped kernels
#: (``kThreads``, ``kBM`` x ``kBN`` in ``csrc/grouped_gemm.cuh``), and the
#: reduction slice each stage loads (``kBK``).
THREADS, BLOCK_M, BLOCK_N, SLICE = 256, 128, 128, 16
#: The bf16 wgmma kernel of gmm, tgmm and the gather-GMM
#: (``csrc/wgmma_gemm.cuh``): threads per CTA (two consumer warpgroups and a
#: producer), output columns per tile (the gather-GMM's; gmm's and tgmm's
#: are one of GMM_BLOCK_NS, see :func:`wave_block_n`), reduction rows per
#: slice and slices in the ring.
WG_THREADS, WG_BLOCK_N, WG_SLICE, WG_STAGES = 384, 256, 64, 4
GMM_BLOCK_NS = (256, 192)


def wg_smem(block_n: int) -> int:
    """Dynamic shared memory of the wgmma kernel at ``block_n`` columns: 1
    KB of alignment slack, per slice a (BLOCK_M, WG_SLICE) tile of A rows
    and a (WG_SLICE, block_n) block of rhs, then a full and an empty
    mbarrier per slice."""
    return 1024 + WG_STAGES * (BLOCK_M + block_n) * WG_SLICE * 2 + 2 * WG_STAGES * 8


def wave_block_n(row_tiles: int, n: int, sms: int) -> int:
    """The output tile width the bf16 wgmma products pick on a card of
    ``sms`` SMs over ``row_tiles`` tiles of BLOCK_M output rows
    (``gmm_block_n`` in ``csrc/grouped_gemm.cu``): the one of GMM_BLOCK_NS
    whose waves, ``ceil(row_tiles * N tiles / sms) * width``, cost least,
    256 on a tie."""
    def cost(width):
        slots = row_tiles * -(-n // width)
        return -(-slots // sms) * width
    return min(GMM_BLOCK_NS, key=cost)


def gmm_block_n(m: int, n: int, sms: int) -> int:
    """``rkt_gmm``'s bf16 tile width: :func:`wave_block_n` over
    ``ceil(m / BLOCK_M)`` work tiles (the count when every group fills whole
    tiles)."""
    return wave_block_n(-(-m // BLOCK_M), n, sms)


def tgmm_block_n(k: int, n: int, e: int, sms: int) -> int:
    """``rkt_tgmm``'s bf16 tile width: :func:`wave_block_n` over
    ``ceil(k / BLOCK_M)`` K tiles of each of the ``e`` groups."""
    return wave_block_n(-(-k // BLOCK_M) * e, n, sms)


def _static_smem(kind: str, transpose: bool = False) -> int:
    """The static shared memory of the f32 kernels: one slice of their
    operand tiles and the row-pointer arrays of gmm (A rows, B rows) and
    tgmm (two stages of A and B rows)."""
    tiles = 4 * SLICE * (BLOCK_M + BLOCK_N)
    if kind == "tgmm":
        return tiles + 8 * 4 * SLICE
    return tiles + 8 * (BLOCK_M + (BLOCK_N if transpose else SLICE))


def gmm_work(kind: str, m: int, k: int, n: int, e: int, dtype, rows: int = -1,
             src_rows: int = 0) -> tuple:
    """``(bytes, flops)`` of one grouped product as a function: its inputs
    read once and its output written once (the int32 group sizes, and for
    the gather-GMM the row ids and the ``src_rows`` unsorted token rows),
    and 2*K*N flops per row that lies in a group (``rows``; default all M:
    the most a meta launch, which sees no group sizes, can count)."""
    item = itemsize(dtype)
    rows = m if rows < 0 else rows
    if kind == "gather_gmm":
        nbytes = src_rows * k * item + m * 4 + e * k * n * item + m * n * item
    elif kind == "gmm":
        nbytes = m * k * item + e * k * n * item + m * n * item
    else:  # tgmm: lhs (m, k), dy (m, n) -> (e, k, n)
        nbytes = m * k * item + m * n * item + e * k * n * item
    return nbytes + e * 4, 2.0 * rows * k * n


def wgmma_launch(name: str, m: int, k: int, n: int, e: int, sms: int, a_tile, b_tile,
                 block_n: int = WG_BLOCK_N, extra_tiles: tuple = (),
                 tgmm: bool = False) -> LaunchFact:
    """The bf16 wgmma launch of gmm, the gather-GMM or (``tgmm``) tgmm on a
    card of ``sms`` SMs: a persistent grid of ``min(sms, slots)`` CTAs of
    WG_THREADS, each walking slots of (BLOCK_M output rows, ``block_n``
    columns): for gmm and the gather-GMM (work tile of at most BLOCK_M rows
    of one group, N tile) over the M rows, for tgmm (K tile, N tile,
    group), its output (E, K, N). Per WG_SLICE-deep slice of the reduction
    a CTA loads ``a_tile`` of A and ``b_tile`` boxes of B; it reads the E
    group sizes and ``extra_tiles`` and writes (BLOCK_M, ``block_n``)
    output tiles."""
    row_tiles, out_rows = (-(-k // BLOCK_M) * e, k) if tgmm else (m // BLOCK_M + e + 1, m)
    slots = row_tiles * -(-n // block_n)
    tiles = (tile(1, e, torch.int32, 1, e), a_tile, b_tile,
             tile(BLOCK_M, block_n, torch.bfloat16, out_rows, n), *extra_tiles)
    return LaunchFact(name, (min(sms, slots), 1, 1), WG_THREADS, wg_smem(block_n), 0, tiles)


def gmm_launch(m: int, k: int, n: int, e: int, dtype, transpose_rhs: bool = False,
               name: str = "gmm", src_rows: int = 0, sms: int = 0,
               rows: int = -1) -> LaunchFact:
    """The launch of :func:`gmm` with its work (:func:`gmm_work` over
    ``rows`` grouped rows); :func:`_gmm_geometry` describes it."""
    fact = _gmm_geometry(m, k, n, e, dtype, transpose_rhs, name, src_rows, sms)
    # wgmma (bf16) or FMA (f32) into f32 accumulators, K in slice order.
    return with_work(fact, *gmm_work(name, m, k, n, e, dtype, rows, src_rows), dtype,
                     acc=torch.float32)


def _gmm_geometry(m: int, k: int, n: int, e: int, dtype, transpose_rhs: bool = False,
                  name: str = "gmm", src_rows: int = 0, sms: int = 0) -> LaunchFact:
    """The launch of :func:`gmm` (or, in f32 with ``name="gather_gmm"`` and
    the source's ``src_rows``, of the gather-GMM). bf16: the persistent
    wgmma grid (:func:`wgmma_launch`) on a card of ``sms`` SMs, the
    :func:`gmm_block_n` columns a tile, A by TMA in (BLOCK_M, WG_SLICE)
    boxes, rhs as (WG_SLICE, 64) boxes, or one (block_n, WG_SLICE) box
    read transposed. f32: one CTA per (work tile of at most
    BLOCK_M rows of one group, BLOCK_N columns), over the static
    ``work_tiles`` grid; it reads the E group sizes, loads SLICE-deep slices
    of its A rows and of the group's B block, and writes its output
    tile."""
    if dtype == torch.bfloat16 and name == "gmm":
        if sms <= 0:
            raise ValueError("gmm_launch: the bf16 kernel's grid needs the card's SM count")
        block_n = gmm_block_n(m, n, sms)
        a = tile(BLOCK_M, WG_SLICE, dtype, m, k)
        b = (tile(block_n, WG_SLICE, dtype, n, k) if transpose_rhs
             else tile(WG_SLICE, 64, dtype, k, n))
        return wgmma_launch("gmm", m, k, n, e, sms, a, b, block_n)
    a = tile(BLOCK_M, SLICE, dtype, src_rows or m, k)
    b = tile(BLOCK_N, SLICE, dtype, n, k) if transpose_rhs else tile(SLICE, BLOCK_N, dtype, k, n)
    tiles = (tile(1, e, torch.int32, 1, e), a, b, tile(BLOCK_M, BLOCK_N, dtype, m, n))
    if name == "gather_gmm":
        tiles += (tile(1, BLOCK_M, torch.int32, 1, m),)
    grid = (m // BLOCK_M + e + 1, -(-n // BLOCK_N), 1)
    return LaunchFact(name, grid, THREADS, 0, _static_smem("gmm", transpose_rhs), tiles)


def tgmm_launch(m: int, k: int, n: int, e: int, dtype, sms: int = 0,
                rows: int = -1) -> LaunchFact:
    """The launch of :func:`tgmm` with its work (:func:`gmm_work` over
    ``rows`` grouped rows); :func:`_tgmm_geometry` describes it."""
    return with_work(_tgmm_geometry(m, k, n, e, dtype, sms),
                     *gmm_work("tgmm", m, k, n, e, dtype, rows), dtype, acc=torch.float32)


def _tgmm_geometry(m: int, k: int, n: int, e: int, dtype, sms: int = 0) -> LaunchFact:
    """The launch of :func:`tgmm`. bf16: the persistent wgmma grid
    (:func:`wgmma_launch`) on a card of ``sms`` SMs over (BLOCK_M rows of K,
    :func:`tgmm_block_n` columns, group) slots; per WG_SLICE-row slice of
    its group it loads two (WG_SLICE, 64) boxes of lhs by TMA, one per
    consumer half of the K rows, and ``block_n / 64`` (WG_SLICE, 64) boxes
    of dy. f32: one CTA per (BLOCK_M of K, BLOCK_N of N, group); it walks
    its group's rows in SLICE-row slices of lhs and dy. Either writes
    (BLOCK_M, width) tiles of the group's output."""
    if dtype == torch.bfloat16:
        if sms <= 0:
            raise ValueError("tgmm_launch: the bf16 kernel's grid needs the card's SM count")
        return wgmma_launch("tgmm", m, k, n, e, sms, tile(WG_SLICE, BLOCK_M, dtype, m, k),
                            tile(WG_SLICE, 64, dtype, m, n), tgmm_block_n(k, n, e, sms),
                            tgmm=True)
    tiles = (tile(1, e, torch.int32, 1, e), tile(SLICE, BLOCK_M, dtype, m, k),
             tile(SLICE, BLOCK_N, dtype, m, n), tile(BLOCK_M, BLOCK_N, dtype, k, n))
    grid = (-(-k // BLOCK_M), -(-n // BLOCK_N), e)
    return LaunchFact("tgmm", grid, THREADS, 0, _static_smem("tgmm"), tiles)


def launch_info(kind: str, m: int, k: int, n: int, e: int, dtype,
                transpose_rhs: bool = False) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the ``"gmm"`` or
    ``"tgmm"`` launch as the built library reports it on this card (needs
    the card)."""
    lib = _lib()
    if kind == "tgmm":
        return query_launch(lib.rkt_tgmm_launch_info, k, n, e, DTYPE_CODES[dtype])
    return query_launch(lib.rkt_gmm_launch_info, m, n, e, int(transpose_rhs), DTYPE_CODES[dtype])


def attribute(what: str, transpose_rhs: bool = False, block_n: int = WG_BLOCK_N,
              kind: str = "gmm") -> int:
    """``"ctas"`` (resident CTAs per SM) or ``"registers"`` (per thread, at
    launch) of the bf16 ``kind`` kernel (``"gmm"`` of one mode, or
    ``"tgmm"``) at a compiled tile width (GMM_BLOCK_NS), as the card
    reports them; -1 when it refuses. Needs the card."""
    which = ("ctas", "registers").index(what)
    if kind == "tgmm":
        return _lib().rkt_tgmm_attribute(which, block_n)
    return _lib().rkt_gmm_attribute(which, int(transpose_rhs), block_n)


def grouped_matmul_supported(m: int, k: int, n: int) -> bool:
    """The reference's kernel gate (``nn/moe.py:84``)."""
    return k % 128 == 0 and n % 128 == 0 and m % 8 == 0


def group_bounds(group_sizes: torch.Tensor, m: int) -> list:
    """Host ``[(start, end)]`` per group, clamped to the ``m`` rows (a host
    sync: for the plain versions only)."""
    bounds, start = [], 0
    for size in group_sizes.tolist():
        end = min(start + max(int(size), 0), m)
        bounds.append((start, end))
        start = end
    return bounds


# -- plain versions -----------------------------------------------------------


def gmm_reference(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """``out[rows of g] = lhs[rows of g] @ rhs[g]`` (``rhs[g].T`` with
    ``transpose_rhs``) in f32, cast to ``lhs.dtype``; rows past the groups
    are zeros."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    for g, (s, e) in enumerate(group_bounds(group_sizes, m)):
        if e > s:
            w = rhs[g].float()
            out[s:e] = lhs[s:e].float() @ (w.T if transpose_rhs else w)
    return out.to(lhs.dtype)


def tgmm_reference(lhs, dy, group_sizes):
    """``out[g] = lhs[rows of g].T @ dy[rows of g]`` (E, K, N) in f32, cast
    to ``lhs.dtype``; an empty group's slice is zeros."""
    m, k = lhs.shape
    n = dy.shape[1]
    e_groups = group_sizes.shape[0]
    out = torch.zeros((e_groups, k, n), dtype=torch.float32, device=lhs.device)
    for g, (s, e) in enumerate(group_bounds(group_sizes, m)):
        if e > s:
            out[g] = lhs[s:e].float().T @ dy[s:e].float()
    return out.to(lhs.dtype)


def grouped_matmul_plain(lhs, rhs, group_sizes):
    """The reference's non-kernel branch, differentiable: ``ragged_dot`` on
    f32-widened operands, the result cast back to ``lhs.dtype`` (the
    widening is the reference's way to an f32 accumulator there)."""
    m = lhs.shape[0]
    n = rhs.shape[2]
    lf, rf = lhs.float(), rhs.float()
    parts, covered = [], 0
    for g, (s, e) in enumerate(group_bounds(group_sizes, m)):
        if e > s:
            parts.append(lf[s:e] @ rf[g])
        covered = e
    if covered < m:
        parts.append(lf.new_zeros((m - covered, n)))
    out = torch.cat(parts) if parts else lf.new_zeros((m, n))
    return out.to(lhs.dtype)


# -- kernels ------------------------------------------------------------------


def _lib():
    lib = _build.load("grouped_gemm")
    if lib.rkt_gmm.argtypes is None:
        lib.rkt_gmm.restype = ctypes.c_int
        lib.rkt_gmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.rkt_tgmm.restype = ctypes.c_int
        lib.rkt_tgmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        info = ctypes.POINTER(ctypes.c_longlong)
        lib.rkt_gmm_launch_info.restype = ctypes.c_int
        lib.rkt_gmm_launch_info.argtypes = [ctypes.c_int] * 5 + [info]
        lib.rkt_tgmm_launch_info.restype = ctypes.c_int
        lib.rkt_tgmm_launch_info.argtypes = [ctypes.c_int] * 4 + [info]
        lib.rkt_gmm_attribute.restype = ctypes.c_int
        lib.rkt_gmm_attribute.argtypes = [ctypes.c_int] * 3
        lib.rkt_tgmm_attribute.restype = ctypes.c_int
        lib.rkt_tgmm_attribute.argtypes = [ctypes.c_int] * 2
    return lib


def check_grouped(what: str, group_sizes: torch.Tensor, num_groups: int, **tensors) -> None:
    """What the grouped kernels take: f32 or bf16 operands of one dtype,
    contiguous on one CUDA device and 16-byte aligned, int32 group sizes
    of length E there too; raise otherwise."""
    check_cuda_operands(what, group_sizes=group_sizes, **tensors)
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise ValueError(f"{what}: operands must share a dtype, float32 or bfloat16, got "
                         f"{ {k: t.dtype for k, t in tensors.items()} }")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (num_groups,):
        raise ValueError(f"{what}: group_sizes must be int32 of shape ({num_groups},), got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    for name, t in tensors.items():
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def _check_widths(what: str, k: int, n: int) -> None:
    if k % 8 or n % 8:
        raise ValueError(f"{what}: the kernel takes K and N multiples of 8, got K={k} N={n}")


def gmm(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """``lhs`` (M, K) grouped by ``group_sizes`` times ``rhs`` (E, K, N) —
    or (E, N, K) read transposed — -> (M, N) in ``lhs.dtype``. CPU tensors:
    :func:`gmm_reference`; CUDA tensors: ``rkt_gmm`` or raise; meta tensors
    record the launch."""
    if lhs.device.type == "cpu":
        return gmm_reference(lhs, rhs, group_sizes, transpose_rhs)
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"gmm: lhs must be 2-D and rhs 3-D, got {tuple(lhs.shape)} "
                         f"{tuple(rhs.shape)}")
    m, k = lhs.shape
    e, rk, n = rhs.shape
    if transpose_rhs:
        n, rk = rk, n
    if rk != k:
        raise ValueError(f"gmm: K mismatch {k} != {rk}")
    check_grouped("gmm", group_sizes, e, lhs=lhs, rhs=rhs)
    _check_widths("gmm", k, n)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    if lhs.device.type == "meta":
        sms = sm_count(lhs, "gmm") if lhs.dtype == torch.bfloat16 else 0
        record([gmm_launch(m, k, n, e, lhs.dtype, transpose_rhs, sms=sms)],
               (lhs, rhs, group_sizes), (out,))
        return out
    err = _lib().rkt_gmm(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
                         m, k, n, e, int(transpose_rhs), DTYPE_CODES[lhs.dtype], stream_of(lhs))
    if err:
        raise RuntimeError(f"gmm: kernel launch failed with cudaError {err}")
    gmm.launches += 1
    return out


gmm.launches = 0


def tgmm(lhs, dy, group_sizes):
    """``out[g] = lhs_g.T @ dy_g`` for ``lhs`` (M, K), ``dy`` (M, N) ->
    (E, K, N) in ``lhs.dtype``, zeros for an empty group. CPU tensors:
    :func:`tgmm_reference`; CUDA tensors: ``rkt_tgmm`` or raise; meta
    tensors record the launch."""
    if lhs.device.type == "cpu":
        return tgmm_reference(lhs, dy, group_sizes)
    if lhs.dim() != 2 or dy.dim() != 2 or lhs.shape[0] != dy.shape[0]:
        raise ValueError(f"tgmm: lhs (M, K) and dy (M, N) must share M, got "
                         f"{tuple(lhs.shape)} {tuple(dy.shape)}")
    m, k = lhs.shape
    n = dy.shape[1]
    e = group_sizes.shape[0] if group_sizes.dim() == 1 else -1
    check_grouped("tgmm", group_sizes, e, lhs=lhs, dy=dy)
    _check_widths("tgmm", k, n)
    out = torch.empty((e, k, n), dtype=lhs.dtype, device=lhs.device)
    if lhs.device.type == "meta":
        sms = sm_count(lhs, "tgmm") if lhs.dtype == torch.bfloat16 else 0
        record([tgmm_launch(m, k, n, e, lhs.dtype, sms)], (lhs, dy, group_sizes), (out,))
        return out
    err = _lib().rkt_tgmm(lhs.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
                          m, k, n, e, DTYPE_CODES[lhs.dtype], stream_of(lhs))
    if err:
        raise RuntimeError(f"tgmm: kernel launch failed with cudaError {err}")
    tgmm.launches += 1
    return out


tgmm.launches = 0


# -- autograd -----------------------------------------------------------------


class GroupedMatmul(torch.autograd.Function):
    """``apply(lhs, rhs, group_sizes)``: the forward is :func:`gmm`, the
    backward megablox's — ``dlhs = gmm(dy, rhs, transpose_rhs=True)``,
    ``drhs = tgmm(lhs, dy)``."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dy = dy.to(lhs.dtype).contiguous()
        dlhs = gmm(dy, rhs, group_sizes, transpose_rhs=True) if ctx.needs_input_grad[0] else None
        drhs = tgmm(lhs, dy, group_sizes) if ctx.needs_input_grad[1] else None
        return dlhs, drhs, None


def grouped_matmul(lhs, rhs, group_sizes):
    """``lhs`` (M, K) rows grouped by ``group_sizes`` (E,) int32 times
    per-group ``rhs[g]`` (E, K, N) -> (M, N) in ``lhs.dtype`` with f32
    accumulation. A CUDA tensor that passes the reference's gate
    (:func:`grouped_matmul_supported`) goes through the kernels (or
    raises; meta tensors record the launches); everything else takes the
    reference's non-kernel branch."""
    m, k = lhs.shape
    n = rhs.shape[2]
    if lhs.device.type in ("cuda", "meta") and grouped_matmul_supported(m, k, n):
        return GroupedMatmul.apply(lhs.contiguous(), rhs.contiguous(),
                                   group_sizes.to(torch.int32).contiguous())
    return grouped_matmul_plain(lhs, rhs, group_sizes)
