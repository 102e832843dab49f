"""Paged KV-cache attention over a shared block pool — the serving
engine's attention (counterpart of ``rocket_tpu/ops/paged_attention.py``).

``k_pages``/``v_pages`` are ``(NB, BL, Hkv, D)`` tensors shared by every
live request; a per-slot ``block_table`` ``(S, MB)`` int32 maps a
sequence's logical positions onto pool blocks, and block 0 is the
reserved trash sink (padded rows land there, unmapped table entries
point at it and are masked off by position).

* :func:`write_kv_pages` scatters a chunk's new K/V rows into the pool IN
  PLACE (``index_copy_`` on the flattened pool) — the JAX package returns
  a new pool and donates the old one; here the update is the donation.
* C = 1 decode waves run :func:`paged_decode`, the hand-written CUDA
  kernel ``csrc/paged_decode.cu`` on CUDA tensors (its plain version on
  CPU tensors). It walks only the slot's live pages.
* Prefill chunks (C > 1) run :func:`attend_plain`, the gather + masked
  einsum attention, as the JAX package runs plain XLA there.

Inference only: nothing here has a backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_operands, stream_of

__all__ = [
    "write_kv_pages",
    "paged_gather",
    "attend_plain",
    "paged_decode",
    "paged_decode_plain",
    "paged_attention",
]


def write_kv_pages(k_pages, v_pages, block_table, positions, valid, k_new, v_new):
    """Scatter one chunk's K/V rows into the pool, in place.

    ``block_table`` ``(S, MB)`` int32; slot ``s``'s chunk ``k_new``/``v_new``
    ``(S, C, Hkv, D)`` sits at global positions ``[positions[s],
    positions[s] + C)`` and only its first ``valid[s]`` rows are real.
    Padded rows, and rows whose table slot is clipped, collapse onto trash
    row 0 (block 0 is never allocated, so collisions there are harmless).
    Returns ``(k_pages, v_pages)``."""
    nb, bl = k_pages.shape[0], k_pages.shape[1]
    s, c = k_new.shape[0], k_new.shape[1]
    steps = torch.arange(c, device=positions.device, dtype=torch.int64)
    pos = positions.long()[:, None] + steps[None, :]                 # (S, C)
    slot = (pos // bl).clamp(0, block_table.shape[1] - 1)
    block = torch.gather(block_table.long(), 1, slot)                 # (S, C)
    ok = steps[None, :] < valid.long()[:, None]
    flat = torch.where(ok, block * bl + pos % bl, torch.zeros_like(pos)).reshape(-1)
    tail = k_pages.shape[2:]
    k_pages.view(nb * bl, *tail).index_copy_(0, flat, k_new.reshape(s * c, *tail).to(k_pages.dtype))
    v_pages.view(nb * bl, *tail).index_copy_(0, flat, v_new.reshape(s * c, *tail).to(v_pages.dtype))
    return k_pages, v_pages


def paged_gather(pages, block_table):
    """``(NB, BL, Hkv, D)`` pages + ``(S, MB)`` table -> the contiguous
    ``(S, MB*BL, Hkv, D)`` context; row ``t`` is global position ``t``."""
    s, mb = block_table.shape
    ctx = pages[block_table.long()]                    # (S, MB, BL, Hkv, D)
    return ctx.reshape(s, mb * pages.shape[1], *pages.shape[2:])


def attend_plain(q, k_pages, v_pages, block_table, positions):
    """The plain gather + attend (``_attend_xla`` of the JAX package):
    ``q`` ``(S, C, Hq, D)``, query row ``i`` of slot ``s`` at global
    position ``positions[s] + i`` sees key positions ``<=`` it; f32
    logits and softmax, ``-inf`` mask (position 0 is always visible, so
    no row is all-masked). Returns ``(S, C, Hq*D)``."""
    s, c, hq, d = q.shape
    h_kv = k_pages.shape[2]
    g = hq // h_kv
    k_ctx = paged_gather(k_pages, block_table)         # (S, T, Hkv, D)
    v_ctx = paged_gather(v_pages, block_table)
    t = k_ctx.shape[1]
    q5 = q.reshape(s, c, h_kv, g, d)
    logits = torch.einsum("sckgd,stkd->skgct", q5.float(), k_ctx.float()) / math.sqrt(d)
    key_pos = torch.arange(t, device=q.device)
    q_pos = positions.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    mask = key_pos[None, None, :] <= q_pos[:, :, None]                  # (S, C, T)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v_ctx.dtype)
    out = torch.einsum("skgct,stkd->sckgd", weights, v_ctx)
    return out.reshape(s, c, hq * d)


def paged_decode_plain(q, k_pages, v_pages, block_table, positions):
    """The plain version of :func:`paged_decode`: ``q`` ``(S, Hq, D)`` ->
    ``(S, Hq, D)`` through :func:`attend_plain` at C = 1."""
    return attend_plain(q[:, None], k_pages, v_pages, block_table, positions).reshape(q.shape)


def _lib():
    lib = _build.load("paged_decode")
    fn = lib.rkt_paged_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def paged_decode(q, k_pages, v_pages, block_table, positions):
    """C = 1 paged decode attention: ``q`` ``(S, Hq, D)`` for slot ``s`` at
    position ``positions[s]`` over its pool pages (new rows already
    written). Returns ``(S, Hq, D)``.

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch
    ``csrc/paged_decode.cu`` (counted in ``paged_decode.launches``) or
    raise — there is no fallback."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, positions)
    check_cuda_operands(
        "paged_decode", q=q, k_pages=k_pages, v_pages=v_pages,
        block_table=block_table, positions=positions,
    )
    s, hq, d = q.shape
    nb, bl, h_kv, d_pool = k_pages.shape
    mb = block_table.shape[1]
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_decode: q/k_pages/v_pages must share a dtype in "
            f"{list(DTYPE_CODES)}, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("paged_decode: block_table and positions must be int32")
    if v_pages.shape != k_pages.shape or d_pool != d or hq % h_kv:
        raise ValueError(
            f"paged_decode: shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)} (need equal pools, matching D, Hkv | Hq)"
        )
    if block_table.shape != (s, mb) or positions.shape != (s,):
        raise ValueError(
            f"paged_decode: block_table {tuple(block_table.shape)} / positions "
            f"{tuple(positions.shape)} do not match {s} slots"
        )
    if d % 8 or d > 256:
        raise ValueError(f"paged_decode: head dim {d} must be a multiple of 8 and <= 256")
    out = torch.empty_like(q)
    err = _lib()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), s, hq, h_kv, d, nb, bl, mb,
        1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], stream_of(q),
    )
    if err:
        raise RuntimeError(f"paged_decode: kernel launch failed with cudaError {err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_attention(q, k_new, v_new, k_pages, v_pages, block_table, positions, valid):
    """One chunk of causal GQA attention against the paged pool.

    ``q`` ``(S, C, Hq, D)``; ``k_new``/``v_new`` ``(S, C, Hkv, D)`` (RoPE
    already applied); the chunk's rows are written into the pool FIRST,
    then query row ``i`` attends over key positions ``<= positions[s] +
    i``. Returns ``(out (S, C, Hq*D), k_pages, v_pages)`` — the pools are
    the same tensors, updated in place. Padded query rows produce
    well-defined garbage that callers ignore."""
    s, c, hq, d = q.shape
    if hq % k_pages.shape[2]:
        raise ValueError(f"paged_attention: Hq {hq} not a multiple of Hkv {k_pages.shape[2]}")
    write_kv_pages(k_pages, v_pages, block_table, positions, valid, k_new, v_new)
    if c == 1:
        out = paged_decode(q[:, 0].contiguous(), k_pages, v_pages, block_table, positions)
        return out.reshape(s, 1, hq * d), k_pages, v_pages
    return attend_plain(q, k_pages, v_pages, block_table, positions), k_pages, v_pages
