"""Fused single-token decode attention for ``generate()``'s cached loop
(counterpart of ``rocket_tpu/ops/decode_attention.py``).

One call per layer per decoded token: the new K/V row is written IN PLACE
at row ``pos`` of the ``(B, Hkv, T, D)`` caches, then each query head
attends over cache rows ``< pos`` plus the token's own K/V (the self
term), grouped-query native, softmax in f32. On CUDA tensors this is the
hand-written kernel ``csrc/decode_attention.cu``; on CPU tensors its plain
version. Inference only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_operands, stream_of

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_supported"]

_NEG_INF = -1e30


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
    or raise — there is no fallback."""
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
