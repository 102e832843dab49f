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
  kernels ``csrc/paged_decode.cu`` on CUDA tensors (its plain version on
  CPU tensors): a split launch, one CTA per (slot, kv head, chunk of
  :data:`CHUNK` key rows) that stages the chunk's live pages in shared
  memory and writes partial softmax statistics into an f32 workspace, then
  a combine launch that folds the live chunks in a fixed order. The
  ``paged_decode`` tune table (or ``ROCKET_TPU_PAGED_DECODE``) may pin
  ``impl="xla"``, the gather path, instead; an empty table keeps the
  kernel.
* Prefill chunks (C > 1) run :func:`attend_plain`, the gather + masked
  einsum attention, as the JAX package runs plain XLA there.

Inference only: nothing here has a backward.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

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

__all__ = [
    "paged_decode_supported",
    "write_kv_pages",
    "paged_gather",
    "attend_plain",
    "paged_decode",
    "paged_decode_plain",
    "paged_decode_launches",
    "num_splits",
    "workspace_floats",
    "launch_info",
    "attribute",
    "paged_attention",
]

#: Threads per CTA of both launches, and key rows per split (``kThreads``
#: and ``kChunk`` in ``csrc/paged_decode.cu``).
THREADS, CHUNK = 128, 64
#: Bytes of padding per staged K/V row in shared memory (``kRowPad``).
_ROW_PAD = 16
_LOG2E = math.log2(math.e)


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rkt_paged_decode_workspace.restype = ctypes.c_longlong
        lib.rkt_paged_decode_workspace.argtypes = [ctypes.c_int] * 6
        lib.rkt_paged_decode_launch_info.restype = ctypes.c_int
        lib.rkt_paged_decode_launch_info.argtypes = [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rkt_paged_decode_attribute.restype = ctypes.c_int
        lib.rkt_paged_decode_attribute.argtypes = [ctypes.c_int] * 5
    return lib


def num_splits(mb: int, bl: int) -> int:
    """Splits per (slot, kv head): ``ceil(MB * BL / CHUNK)``, from the
    table's static shape alone (no read of the positions)."""
    return -(-mb * bl // CHUNK)


def workspace_floats(s: int, hq: int, h_kv: int, d: int, mb: int, bl: int) -> int:
    """f32 workspace of one call: per (slot, kv head, split) the g
    unnormalised accumulator rows of D, then g maxima and g sums."""
    return s * h_kv * num_splits(mb, bl) * (hq // h_kv) * (d + 2)


def _split_smem_bytes(g: int, d: int, dtype) -> int:
    """Dynamic shared memory of one split CTA (``split_smem`` in
    ``csrc/paged_decode.cu``): the chunk's K and V rows at a row stride of
    ``D * itemsize + 16`` bytes, q in f32, a score per (query head, row),
    the P.V row-group partials, m and l per query head, and the chunk's
    page ids."""
    item = torch.empty((), dtype=dtype).element_size()
    return 2 * CHUNK * (d * item + _ROW_PAD) + 4 * (g * d + g * CHUNK + THREADS + 2 * g) \
        + 4 * (CHUNK + 4)


def paged_decode_work(s: int, hq: int, h_kv: int, d: int, bl: int, mb: int, dtype,
                      live_rows: int = -1, live_pages: int = -1) -> tuple:
    """``(split, combine)`` ``(bytes, flops)`` of one decode wave as a
    function: the live K and V rows read once, q read and out written once,
    the live table entries and the positions; 4*D flops per live row and
    query head. ``live_rows`` (the slots' positions + 1, summed) and
    ``live_pages`` (their pages) default to every row of every slot's
    ``mb`` pages: the most a meta launch, which sees no positions, can
    count. The split carries the reads and the operations, the combine the
    output's write (the workspace records are the kernels' design, not the
    function's)."""
    item = itemsize(dtype)
    live_rows = s * mb * bl if live_rows < 0 else live_rows
    live_pages = s * mb if live_pages < 0 else live_pages
    split = 2 * live_rows * h_kv * d * item + s * hq * d * item + 4 * live_pages + 4 * s
    return (split, 4.0 * live_rows * hq * d), (s * hq * d * item, 0.0)


def paged_decode_launches(s: int, hq: int, h_kv: int, d: int, nb: int, bl: int, mb: int,
                          dtype, live_rows: int = -1, live_pages: int = -1) -> tuple:
    """The two launches of :func:`paged_decode`. Split: CTA (slot, kv head,
    split) reads its slot's block-table row, stages the g query rows of its
    kv head (the whole (g, D) group) and the chunk's :data:`CHUNK` K and V
    rows out of the (NB*BL*Hkv, D) pool, and writes one workspace record.
    Combine: CTA (slot, kv head) streams the records of its live splits and
    writes the g output rows."""
    g, n_split = hq // h_kv, num_splits(mb, bl)
    group = tile(g, d, dtype, g, d)
    kv = tile(CHUNK, d, dtype, nb * bl * h_kv, d)
    record_f = g * (d + 2)
    rec = tile(1, record_f, torch.float32, s * h_kv * n_split, record_f)
    table_row = tile(1, mb, torch.int32, s, mb)
    split, combine = paged_decode_work(s, hq, h_kv, d, bl, mb, dtype, live_rows, live_pages)
    return (
        with_work(LaunchFact("paged_decode", (s, h_kv, n_split), THREADS,
                             _split_smem_bytes(g, d, dtype), 0, (group, kv, kv, table_row, rec)),
                  *split, dtype, acc=torch.float32),
        with_work(LaunchFact("paged_decode_combine", (s, h_kv, 1), THREADS, 0, 0, (rec, group)),
                  *combine, dtype, acc=torch.float32),
    )


def launch_info(s: int, hq: int, h_kv: int, d: int, mb: int, bl: int, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the split and the
    combine launch, as the built library reports them (needs the card)."""
    fn = _lib().rkt_paged_decode_launch_info
    return tuple(query_launch(fn, which, s, hq, h_kv, d, mb, bl, DTYPE_CODES[dtype])
                 for which in (0, 1))


def attribute(which: str, what: str, g: int, d: int, dtype) -> int:
    """``"ctas"`` (resident CTAs per SM) or ``"registers"`` (per thread) of
    the ``"split"`` or ``"combine"`` kernel for g query heads per kv head at
    head dim d, as the card reports it; -1 when it refuses. Needs the card."""
    return _lib().rkt_paged_decode_attribute(("split", "combine").index(which),
                                             ("ctas", "registers").index(what), g, d,
                                             DTYPE_CODES[dtype])


def paged_decode_supported(block_len: int, head_dim: int, itemsize: int = 4) -> bool:
    """Whether :func:`paged_decode`'s CUDA kernels take pages of
    ``block_len`` rows of head dim ``head_dim`` at ``itemsize`` bytes (the
    reference's signature). The kernels stage whole pages in 16-byte copies
    of any length, so the answer is theirs, not the TPU's (8, 128) tiling:
    D a multiple of 8 up to 256, f32 or a 2-byte type (bf16)."""
    return block_len >= 1 and head_dim % 8 == 0 and 8 <= head_dim <= 256 and itemsize in (2, 4)


def paged_decode(q, k_pages, v_pages, block_table, positions):
    """C = 1 paged decode attention: ``q`` ``(S, Hq, D)`` for slot ``s`` at
    position ``positions[s]`` over its pool pages (new rows already
    written). Returns ``(S, Hq, D)``.

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch
    ``csrc/paged_decode.cu``'s split and combine kernels (one call counted
    in ``paged_decode.launches``) or raise — there is no fallback; meta
    tensors record both launches."""
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
    if q.device.type == "meta":
        record(paged_decode_launches(s, hq, h_kv, d, nb, bl, mb, q.dtype),
               (q, k_pages, v_pages, block_table, positions), (out,))
        return out
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: k_pages and v_pages must be 16-byte aligned (the "
                         "kernel stages them in 16-byte copies)")
    work = torch.empty(workspace_floats(s, hq, h_kv, d, mb, bl), dtype=torch.float32,
                       device=q.device)
    err = _lib().rkt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), work.data_ptr(), s, hq, h_kv, d, nb, bl, mb,
        _LOG2E / math.sqrt(d), DTYPE_CODES[q.dtype], stream_of(q),
    )
    if err:
        raise RuntimeError(f"paged_decode: kernel launch failed with cudaError {err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_attention(q, k_new, v_new, k_pages, v_pages, block_table, positions, valid,
                    impl: Optional[str] = None):
    """One chunk of causal GQA attention against the paged pool.

    ``q`` ``(S, C, Hq, D)``; ``k_new``/``v_new`` ``(S, C, Hkv, D)`` (RoPE
    already applied); the chunk's rows are written into the pool FIRST,
    then query row ``i`` attends over key positions ``<= positions[s] +
    i``. Returns ``(out (S, C, Hq*D), k_pages, v_pages)`` — the pools are
    the same tensors, updated in place. Padded query rows produce
    well-defined garbage that callers ignore.

    ``impl`` (C = 1 only): ``"pallas"`` runs :func:`paged_decode` (the
    CUDA kernel), ``"xla"`` the gather path :func:`attend_plain`. None
    reads ``ROCKET_TPU_PAGED_DECODE``, then the ``paged_decode`` tune
    table, then ``"pallas"`` (the reference's order, ``:304-325``).
    Prefill chunks (C > 1) always take the gather path and read no
    table."""
    s, c, hq, d = q.shape
    _, bl, h_kv, _ = k_pages.shape
    if hq % h_kv:
        raise ValueError(f"paged_attention: Hq {hq} not a multiple of Hkv {h_kv}")
    write_kv_pages(k_pages, v_pages, block_table, positions, valid, k_new, v_new)
    if c == 1:
        if impl is None:
            from rocket_tpu_torch.tune import get_config

            config = get_config("paged_decode", shape={
                "s": s, "mb": block_table.shape[1], "bl": bl, "hkv": h_kv, "hq": hq, "d": d,
            }, dtype=k_pages.dtype) or {}
            impl = os.environ.get("ROCKET_TPU_PAGED_DECODE") or config.get("impl", "pallas")
        if impl not in ("pallas", "xla"):
            raise ValueError(f"paged_attention: unknown impl {impl!r} — the table is ahead of "
                             "the implementation (expected 'pallas' or 'xla')")
        if impl == "pallas":
            out = paged_decode(q[:, 0].contiguous(), k_pages, v_pages, block_table, positions)
            return out.reshape(s, 1, hq * d), k_pages, v_pages
    return attend_plain(q, k_pages, v_pages, block_table, positions), k_pages, v_pages
