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
  kernel or raise; each counts its launches in ``<wrapper>.launches``.

All accumulate in f32 and return the operand dtype. The group sizes stay
on the device: the kernels read them there, so the hot path never
synchronises with the host. The plain versions loop over the groups on
the host.
"""

from __future__ import annotations

import ctypes

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_operands, stream_of

__all__ = [
    "grouped_matmul", "grouped_matmul_supported", "grouped_matmul_plain", "GroupedMatmul",
    "gmm", "tgmm", "gmm_reference", "tgmm_reference", "group_bounds",
]


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
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def _check_widths(what: str, k: int, n: int) -> None:
    if k % 8 or n % 8:
        raise ValueError(f"{what}: the kernel takes K and N multiples of 8, got K={k} N={n}")


def gmm(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """``lhs`` (M, K) grouped by ``group_sizes`` times ``rhs`` (E, K, N) —
    or (E, N, K) read transposed — -> (M, N) in ``lhs.dtype``. CPU tensors:
    :func:`gmm_reference`; CUDA tensors: ``rkt_gmm`` or raise."""
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
    :func:`tgmm_reference`; CUDA tensors: ``rkt_tgmm`` or raise."""
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
    raises); everything else takes the reference's non-kernel branch."""
    m, k = lhs.shape
    n = rhs.shape[2]
    if lhs.is_cuda and grouped_matmul_supported(m, k, n):
        return GroupedMatmul.apply(lhs.contiguous(), rhs.contiguous(),
                                   group_sizes.to(torch.int32).contiguous())
    return grouped_matmul_plain(lhs, rhs, group_sizes)
