"""Fused single-token decode attention for ``generate()``'s cached loop
(counterpart of ``rocket_tpu/ops/decode_attention.py``).

One call per layer per decoded token: the new K/V row is written IN PLACE
at row ``pos`` of the ``(B, Hkv, T, D)`` caches, then each query head
attends over cache rows ``< pos`` plus the token's own K/V (the self
term), grouped-query native, softmax in f32. On CUDA tensors this is the
hand-written kernel ``csrc/decode_attention.cu``, split over 64-row chunks
of the context and folded in a second, fixed-order launch; on CPU tensors
its plain version; on ``meta`` tensors it records both launches
(:func:`decode_attention_launches`) and launches nothing. Inference only.
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
    itemsize,
    query_launch,
    record,
    stream_of,
    tile,
    with_work,
)

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_supported",
           "decode_attention_launches", "num_splits", "workspace_floats", "launch_info",
           "attribute"]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
#: Threads per CTA, key rows per split and bytes of padding per staged row
#: (``kThreads``, ``kChunk`` and ``kRowPad`` in ``csrc/decode_common.cuh``).
THREADS, CHUNK, _ROW_PAD = 128, 64, 16


def num_splits(t_max: int) -> int:
    """Splits per (row, kv head): ``ceil(T / CHUNK)``, from the cache's
    static length alone (never from ``pos``)."""
    return -(-t_max // CHUNK)


def workspace_floats(b: int, hq: int, h_kv: int, t_max: int, d: int) -> int:
    """f32 workspace of one call: per (row, kv head, split) the g
    unnormalised accumulator rows of D, then g maxima and g sums."""
    return b * h_kv * num_splits(t_max) * (hq // h_kv) * (d + 2)


def _split_smem_bytes(g: int, d: int, dtype) -> int:
    """Dynamic shared memory of one split CTA (``split_smem`` in
    ``csrc/decode_common.cuh``): the chunk's K and V rows at a row stride of
    ``D * itemsize + 16`` bytes, q in f32, a score per (query head, row),
    the P.V row-group partials, and m and l per query head."""
    item = torch.empty((), dtype=dtype).element_size()
    return 2 * CHUNK * (d * item + _ROW_PAD) + 4 * (g * d + g * CHUNK + THREADS + 2 * g)


def decode_attention_work(b: int, hq: int, h_kv: int, d: int, dtype, pos: int) -> tuple:
    """``(split, combine)`` ``(bytes, flops)`` of one decode step at
    position ``pos`` as a function: cache rows [0, pos) of K and V read,
    q, k_new and v_new read and the written K/V row once each; 4*D flops
    per visible row and query head. The split carries those, the combine
    the output's write (the workspace records are the kernels' design)."""
    item = itemsize(dtype)
    split = 2 * b * h_kv * pos * d * item + b * hq * d * item + 4 * b * h_kv * d * item
    return (split, 4.0 * b * hq * d * (pos + 1)), (b * hq * d * item, 0.0)


def decode_attention_launches(b: int, hq: int, h_kv: int, t_max: int, d: int, dtype,
                              pos: int = -1) -> tuple:
    """The two launches of :func:`decode_attention`. Split: CTA (row, kv
    head, split) stages the g query rows of its kv head (the whole (g, D)
    group) and the chunk's :data:`CHUNK` K and V rows out of its (T, D)
    cache plane; the split holding row ``pos`` also reads the token's new
    K and V rows and writes them into the caches; each writes one workspace
    record. Combine: CTA (row, kv head) streams the records of its live
    splits and writes the g output rows."""
    g, n_split = hq // h_kv, num_splits(t_max)
    group = tile(g, d, dtype, g, d)
    kv = tile(CHUNK, d, dtype, t_max, d)
    new = tile(1, d, dtype, b * h_kv, d)
    written = tile(1, d, dtype, t_max, d)
    record_f = g * (d + 2)
    rec = tile(1, record_f, torch.float32, b * h_kv * n_split, record_f)
    split, combine = decode_attention_work(b, hq, h_kv, d, dtype, t_max - 1 if pos < 0 else pos)
    return (
        with_work(LaunchFact("decode_attention", (b, h_kv, n_split), THREADS,
                             _split_smem_bytes(g, d, dtype), 0,
                             (group, kv, kv, new, new, written, written, rec)), *split, dtype,
                  acc=torch.float32),
        with_work(LaunchFact("decode_attention_combine", (b, h_kv, 1), THREADS, 0, 0,
                             (rec, group)), *combine, dtype, acc=torch.float32),
    )


def _lib():
    lib = _build.load("decode_attention")
    if lib.rkt_decode_attention.argtypes is None:
        lib.rkt_decode_attention.restype = ctypes.c_int
        lib.rkt_decode_attention.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rkt_decode_attention_workspace.restype = ctypes.c_longlong
        lib.rkt_decode_attention_workspace.argtypes = [ctypes.c_int] * 5
        lib.rkt_decode_attention_launch_info.restype = ctypes.c_int
        lib.rkt_decode_attention_launch_info.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rkt_decode_attention_attribute.restype = ctypes.c_int
        lib.rkt_decode_attention_attribute.argtypes = [ctypes.c_int] * 5
    return lib


def launch_info(b: int, hq: int, h_kv: int, t_max: int, d: int, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the split and the
    combine launch, as the built library reports them (needs the card)."""
    fn = _lib().rkt_decode_attention_launch_info
    return tuple(query_launch(fn, which, b, hq, h_kv, t_max, d, DTYPE_CODES[dtype])
                 for which in (0, 1))


def attribute(which: str, what: str, g: int, d: int, dtype) -> int:
    """``"ctas"`` (resident CTAs per SM) or ``"registers"`` (per thread) of
    the ``"split"`` or ``"combine"`` kernel for g query heads per kv head at
    head dim d, as the card reports it; -1 when it refuses. Needs the card."""
    return _lib().rkt_decode_attention_attribute(("split", "combine").index(which),
                                                 ("ctas", "registers").index(what), g, d,
                                                 DTYPE_CODES[dtype])


def decode_attention_supported(head_dim: int) -> bool:
    """What the CUDA kernel needs: D a multiple of 8 (rows copied in 16-byte
    pieces) and at most 256 (the split CTA's shared memory). Any T."""
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


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos: int):
    """One fused decode-attention step.

    ``q`` ``(B, Hq, D)``; ``k_new``/``v_new`` ``(B, Hkv, D)`` (already
    rotated under RoPE, in the cache dtype); ``k_cache``/``v_cache``
    ``(B, Hkv, T, D)`` with valid rows ``[0, pos)``; ``pos`` a host int.
    Returns ``(out (B, Hq, D), k_cache, v_cache)`` with row ``pos``
    written in place (the JAX kernel aliases its caches the same way).

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu``'s split and combine kernels (one call
    counted in ``decode_attention.launches``) or raise — there is no
    fallback; meta tensors record both launches."""
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
        record(decode_attention_launches(b, hq, h_kv, t_max, d, q.dtype,
                                         pos if isinstance(pos, int) else -1),
               (q, k_new, v_new, k_cache, v_cache), (out, k_cache, v_cache))
        return out, k_cache, v_cache
    if any(t.data_ptr() % 16 for t in (k_new, v_new, k_cache, v_cache)):
        raise ValueError("decode_attention: k_new, v_new and the caches must be 16-byte "
                         "aligned (the kernel copies their rows in 16-byte pieces)")
    work = torch.empty(workspace_floats(b, hq, h_kv, t_max, d), dtype=torch.float32,
                       device=q.device)
    err = _lib().rkt_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), work.data_ptr(), b, hq, h_kv, t_max, d, pos,
        _LOG2E / math.sqrt(d), DTYPE_CODES[q.dtype], stream_of(q),
    )
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with cudaError {err}")
    decode_attention.launches += 1
    return out, k_cache, v_cache


decode_attention.launches = 0
