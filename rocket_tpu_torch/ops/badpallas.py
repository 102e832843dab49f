"""Row 12: the seeded-bad kernel of the schedule audit (counterpart of the
``pallas_call``s in ``rocket_tpu/analysis/sched_audit.py``'s
``_badpallas_parts``).

:func:`bad_scale` computes ``y = 2 * x`` block by block over an f32
``(rows, cols)`` array: block ``(i, j)`` of the caller's ``block`` shape for
every point of ``grid`` (0, 1 or 2 ints; the fixture's index map ``(i, 0)``
is a 1-D grid). Blocks the grid does not reach are never written, and are
unspecified, as in the fixture; :func:`written_blocks` names the region
that is. The audit's demo target launches it twice, as the fixture does:

* ``bad_scale(x, block=(7, 100), grid=(4,))``: 400-byte rows, 7 of them —
  a tile misfit on both dims (RKT504);
* ``bad_scale(x, block=x.shape, grid=())``: one block of 64 MiB of shared
  memory for a (4096, 4096) array, past the card's 227 KB opt-in. On the
  card ``cudaFuncSetAttribute`` refuses it and the wrapper raises with
  CUDA's message, with no retry and no fallback.

On CPU tensors the wrapper runs :func:`bad_scale_plain`; on CUDA tensors it
launches ``csrc/badpallas.cu`` (counted in ``bad_scale.launches``) or
raises; on ``meta`` tensors it records the launch's
:class:`~rocket_tpu_torch.ops._launch.LaunchFact` and launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import (
    LaunchFact,
    check_cuda_operands,
    itemsize,
    query_launch,
    record,
    stream_of,
    tile,
    with_work,
)

__all__ = ["THREADS", "bad_scale", "bad_scale_plain", "bad_scale_launch", "written_blocks",
           "launch_info"]

#: Threads per CTA (``kThreads`` in ``csrc/badpallas.cu``).
THREADS = 256


def _grid2(grid) -> tuple:
    grid = tuple(int(g) for g in grid)
    if len(grid) > 2 or any(g < 1 for g in grid):
        raise ValueError(f"bad_scale: grid must be 0, 1 or 2 positive ints, got {grid}")
    return (grid + (1, 1))[:2]


def _block2(block) -> tuple:
    block = tuple(int(b) for b in block)
    if len(block) != 2 or min(block) < 1:
        raise ValueError(f"bad_scale: block must be 2 positive ints, got {block}")
    return block


def written_blocks(shape, block, grid) -> tuple:
    """``(rows, cols)`` slices of the region the launch writes: the blocks
    the grid reaches, clipped to the array. Grids start at block (0, 0), so
    the region is one rectangle."""
    (br, bc), (gr, gc) = _block2(block), _grid2(grid)
    return slice(0, min(shape[0], gr * br)), slice(0, min(shape[1], gc * bc))


def bad_scale_plain(x: torch.Tensor, block, grid=()) -> torch.Tensor:
    """The plain version: ``2 * x`` over :func:`written_blocks`; the rest
    of ``y`` is left unwritten (``torch.empty_like``)."""
    rows, cols = written_blocks(x.shape, block, grid)
    y = torch.empty_like(x)
    y[rows, cols] = x[rows, cols] * 2.0
    return y


def bad_scale_launch(shape, block, grid) -> LaunchFact:
    """The launch of :func:`bad_scale` at these shapes: one CTA per grid
    point, its whole block of x staged in dynamic shared memory, the same
    block of y written."""
    (br, bc), (gr, gc) = _block2(block), _grid2(grid)
    rows, cols = shape
    blk = tile(br, bc, torch.float32, rows, cols)
    fact = LaunchFact("bad_scale", (gr, gc, 1), THREADS, 4 * br * bc, 0, (blk, blk))
    # Work: the elements its grid covers, each read and written once (4
    # bytes each way) and multiplied once.
    covered = min(gr * br, rows) * min(gc * bc, cols)
    # Numerics: one f32 product an element, nothing summed.
    return with_work(fact, 8 * covered, covered, torch.float32, acc=torch.float32)


def _lib():
    lib = _build.load("badpallas")
    if lib.rkt_bad_scale.argtypes is None:
        lib.rkt_bad_scale.restype = ctypes.c_int
        lib.rkt_bad_scale.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.rkt_bad_scale_launch_info.restype = ctypes.c_int
        lib.rkt_bad_scale_launch_info.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rkt_cuda_error_string.restype = ctypes.c_char_p
        lib.rkt_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def launch_info(block, grid) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the launch as the
    built library reports it (needs the card)."""
    (br, bc), (gr, gc) = _block2(block), _grid2(grid)
    return query_launch(_lib().rkt_bad_scale_launch_info, br, bc, gr, gc)


def bad_scale(x: torch.Tensor, block, grid=()) -> torch.Tensor:
    """``y = 2 * x`` over the blocks of ``block`` shape at the points of
    ``grid``, for an f32 ``(rows, cols)`` ``x``; the rest of ``y`` is
    unspecified. CPU tensors: :func:`bad_scale_plain`; CUDA tensors:
    ``rkt_bad_scale`` or raise (a block past the card's shared memory is
    refused at launch)."""
    if x.device.type == "cpu":
        return bad_scale_plain(x, block, grid)
    check_cuda_operands("bad_scale", x=x)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"bad_scale: x must be 2-D float32, got {x.dtype} {tuple(x.shape)}")
    fact = bad_scale_launch(tuple(x.shape), block, grid)
    y = torch.empty_like(x)
    if x.device.type == "meta":
        record([fact], (x,), (y,))
        return y
    (br, bc), (gr, gc) = _block2(block), _grid2(grid)
    lib = _lib()
    err = lib.rkt_bad_scale(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], br, bc, gr, gc,
                            stream_of(x))
    if err:
        raise RuntimeError(f"bad_scale: launch of {fact.dynamic_smem} bytes of shared memory "
                           f"per CTA refused: {lib.rkt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    bad_scale.launches += 1
    return y


bad_scale.launches = 0
