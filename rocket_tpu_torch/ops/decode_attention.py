"""Fused single-token decode attention for ``generate()``'s cached loop
(counterpart of ``rocket_tpu/ops/decode_attention.py``).

One call per layer per decoded token: the new K/V row is written IN PLACE
at row ``pos`` of the ``(B, Hkv, T, D)`` caches, then each query head
attends over cache rows ``< pos`` plus the token's own K/V (the self
term), grouped-query native, softmax in f32. On CUDA tensors this is the
hand-written kernel ``csrc/decode_attention.cu``; on CPU tensors its plain
version; on ``meta`` tensors it records its launch (:func:`attend_launch`)
and launches nothing. Inference only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import (
    DTYPE_CODES,
    LaunchFact,
    check_cuda_operands,
    query_launch,
    record,
    stream_of,
    tile,
)

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_supported",
           "attend_launch", "attend_smem_bytes", "decode_attention_launch", "launch_info"]

_NEG_INF = -1e30
#: Threads per CTA and key rows per online-softmax step of the kernel
#: (``kThreads`` and ``kTile`` in ``csrc/decode_common.cuh``).
THREADS, KEY_TILE = 128, 64


def attend_smem_bytes(g: int, d: int) -> int:
    """Dynamic shared memory of one decode CTA serving g query rows of
    width d (``attend_smem_bytes`` in ``csrc/decode_common.cuh``): a tile's
    row offsets, q and the accumulator in f32, a tile of scores per query
    row and three statistics per query row."""
    return 8 * KEY_TILE + 4 * (2 * g * d + g * KEY_TILE + 3 * g)


def attend_launch(name: str, grid: tuple, g: int, d: int, dtype, kv_rows: int,
                  extra_tiles: tuple = ()) -> LaunchFact:
    """The launch of a kernel built on ``attend_rows``: one CTA per (row,
    kv head) stages the g query rows of its kv head (the whole (g, D)
    group) and streams K and V in :data:`KEY_TILE`-row tiles out of a
    ``kv_rows``-row plane, writing g output rows."""
    group = tile(g, d, dtype, g, d)
    kv = tile(KEY_TILE, d, dtype, kv_rows, d)
    return LaunchFact(name, (*grid, 1), THREADS, attend_smem_bytes(g, d), 0,
                      (group, kv, kv, group) + tuple(extra_tiles))


def decode_attention_launch(b: int, hq: int, h_kv: int, t_max: int, d: int, dtype) -> LaunchFact:
    """The launch of :func:`decode_attention`: CTA (b, h) also copies the
    token's new K and V rows into row ``pos`` of its (T, D) cache planes."""
    new = tile(1, d, dtype, b * h_kv, d)
    written = tile(1, d, dtype, t_max, d)
    return attend_launch("decode_attention", (b, h_kv), hq // h_kv, d, dtype, t_max,
                         (new, new, written, written))


def launch_info(b: int, hq: int, h_kv: int, d: int, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the launch as the
    built library reports it (needs the card)."""
    lib = _build.load("decode_attention")
    fn = lib.rkt_decode_attention_launch_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    return query_launch(fn, b, hq, h_kv, d, DTYPE_CODES[dtype])


def decode_attention_supported(head_dim: int) -> bool:
    """What the CUDA kernel needs: D a multiple of 8 and at most 256 (a
    warp holds a key row in registers, 8 features per lane). Any T."""
    return head_dim % 8 == 0 and 8 <= head_dim <= 256


def _check_pos(pos: int, t_max: int) -> int:
    pos = int(pos)
    if not 0 <= pos < t_max:
        raise ValueError(f"decode_attention: pos {pos} outside the cache [0, {t_max})")
    return pos


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos: int):
    """The plain version, with the JAX kernel's math: cache rows ``< pos``
    masked to -1e30, the self term from ``k_new``/``v_new`` kept apart, the
    cache-side probabilities cast to the cache dtype before the PV
    product. Writes row ``pos`` of the caches in place; returns
    ``(out (B, Hq, D), k_cache, v_cache)``."""
    b, hq, d = q.shape
    h_kv, t_max = k_cache.shape[1], k_cache.shape[2]
    pos = _check_pos(pos, t_max)
    g = hq // h_kv
    scale = 1.0 / math.sqrt(d)
    q5 = q.reshape(b, h_kv, g, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", q5, k_cache.float()) * scale
    s = s.masked_fill(torch.arange(t_max, device=q.device) >= pos, _NEG_INF)
    s_self = (q5 * k_new.float()[:, :, None, :]).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_self)
    p = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    denom = p.sum(-1, keepdim=True) + p_self
    out = torch.einsum("bkgt,bktd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = out + p_self * v_new.float()[:, :, None, :]
    k_cache[:, :, pos] = k_new.to(k_cache.dtype)
    v_cache[:, :, pos] = v_new.to(v_cache.dtype)
    return (out / denom).reshape(b, hq, d).to(q.dtype), k_cache, v_cache


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.rkt_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos: int):
    """One fused decode-attention step.

    ``q`` ``(B, Hq, D)``; ``k_new``/``v_new`` ``(B, Hkv, D)`` (already
    rotated under RoPE, in the cache dtype); ``k_cache``/``v_cache``
    ``(B, Hkv, T, D)`` with valid rows ``[0, pos)``; ``pos`` a host int.
    Returns ``(out (B, Hq, D), k_cache, v_cache)`` with row ``pos``
    written in place (the JAX kernel aliases its caches the same way).

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (counted in ``decode_attention.launches``)
    or raise — there is no fallback; meta tensors record the launch."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos)
    check_cuda_operands(
        "decode_attention", q=q, k_new=k_new, v_new=v_new, k_cache=k_cache, v_cache=v_cache,
    )
    b, hq, d = q.shape
    _, h_kv, t_max, d_cache = k_cache.shape
    pos = _check_pos(pos, t_max)
    dtypes = {t.dtype for t in (q, k_new, v_new, k_cache, v_cache)}
    if len(dtypes) != 1 or q.dtype not in DTYPE_CODES:
        raise ValueError(
            f"decode_attention: operands must share a dtype in {list(DTYPE_CODES)}, "
            f"got {sorted(map(str, dtypes))}"
        )
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b or d_cache != d
            or hq % h_kv or k_new.shape != (b, h_kv, d) or v_new.shape != (b, h_kv, d)):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, new {tuple(k_new.shape)}/"
            f"{tuple(v_new.shape)}, caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)}"
        )
    if not decode_attention_supported(d):
        raise ValueError(f"decode_attention: head dim {d} must be a multiple of 8 and <= 256")
    out = torch.empty_like(q)
    if q.device.type == "meta":
        record([decode_attention_launch(b, hq, h_kv, t_max, d, q.dtype)])
        return out, k_cache, v_cache
    err = _lib()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), b, hq, h_kv, t_max, d, pos,
        1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], stream_of(q),
    )
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with cudaError {err}")
    decode_attention.launches += 1
    return out, k_cache, v_cache


decode_attention.launches = 0
