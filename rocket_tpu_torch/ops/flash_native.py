"""Flash attention on feature-major operands (counterpart of
``rocket_tpu/ops/flash_native.py``): the training attention of the
transformer, forward and backward.

Operands keep the JAX layouts, so no transpose exists on the path:

* :func:`flash_fused` reads the fused ``(B, T, 3*H*D)`` QKV projection
  output at feature offsets ``0 / H*D / 2*H*D`` (the MHA path) and its
  gradient is the fused ``[dq | dk | dv]`` cotangent;
* :func:`flash_bthd` takes ``q2`` ``(B, T, Hq*D)`` and ``k2``/``v2``
  ``(B, T, Hkv*D)``, grouped-query attention native (the RoPE/GQA path).

Both are ``torch.autograd.Function``s over three kernels, each a
hand-written CUDA kernel (``csrc/flash_{fwd,bwd,dq}.cu``) with a plain
PyTorch version of the same signature beside it:

* :func:`flash_fwd` / :func:`_fwd_plain` -> ``(out (B, T, Hq*D), lse (B,
  Hq, T) f32)``: f32 scores times ``log2(e)/sqrt(D)``, ``exp2``, lse in
  base 2, causal masking to -1e30, ``l = 0`` rows read as ``l = 1``;
* :func:`flash_bwd` / :func:`_bwd_plain` -> ``(dq partials (nk, B, T,
  Hq*D) f32 or None, dk, dv)``: dk/dv summed over the kv head's query
  group in f32, one f32 dq partial per k-tile of :data:`TILE` rows;
* :func:`flash_dq` / :func:`_dq_plain` -> ``dq``: the accumulating dq
  pass, the strategy past the partial buffer's byte bound.

The bf16 instantiations of all three kernels run on the tensor cores
(``mma.sync``, bf16 tiles filled by ``cp.async``; their operands, dout
included, must be 16-byte aligned with feature widths and head offsets in
multiples of 8, which the wrappers check); the f32 instantiations run f32
FMA on the CUDA cores.

Numerics follow the JAX kernels: probabilities are rounded to the operand
dtype before the PV and dV products, ``ds`` before the dK and dQ
products; every accumulator is f32. ``delta = rowsum(dout * out)`` is
computed in f32 outside the kernels, as the reference does.

The TPU's lse layout ``(B, H/(kb*g), kb*g, T)`` and its 128-lane head
blocking (``_kv_block``, ``_fused_kb`` and the fused-to-sliced fallback)
are TPU artefacts and are not ported: the lse is ``(B, H, T)`` and the
kernels read the fused operand at its offsets for any H. The tuned block
lookup is not ported either; the kernels use fixed ``TILE`` x ``TILE``
tiles.

Head dims: the kernels compile D = 32, 64 and 128 (:data:`HEAD_DIMS`).
Every other D <= 128 — the reference's flash rule — runs the kernel of the
next compiled D on heads the wrapper zero-pads along D (q, k, v, and dout
in the backward), with the scale of the true D; out, dq, dk and dv are
sliced back. Zero features add nothing to q.k and the padded output
columns are p.0 = 0, so the result is the D-wide one. Past 128 there is
no kernel, and the wrappers raise.

On CPU tensors every wrapper takes its plain version; on CUDA tensors it
launches its kernel (counted in ``<wrapper>.launches``) or raises; on
``meta`` tensors it records its launch (:func:`flash_launch`) and launches
nothing.
"""

from __future__ import annotations

import ctypes
import math
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
    "TILE", "flash_supported", "kernel_dim", "pad_heads", "unpad_heads", "flash_fused",
    "flash_bthd", "flash_fused_sharded", "flash_bthd_sharded",
    "flash_fwd", "flash_bwd", "flash_dq", "flash_launch", "launch_info", "occupancy",
    "registers", "tensor_cores",
]

#: Query and key rows per tile of the CUDA kernels (block_q == block_k).
TILE = 64
#: Threads per CTA of the three kernels (``kThreads`` in ``csrc/flash_common.cuh``).
THREADS = 128
#: Head dims the CUDA kernels are compiled for: 64 (GPT-2, ViT), 32 (the
#: MoE char-LM example's 128-wide, 4-head model) and 128 (Llama-2/3,
#: Mistral); any T. Every other D <= 128 runs the kernel of the next
#: compiled D on zero-padded heads (:func:`kernel_dim`).
HEAD_DIMS = (32, 64, 128)
#: f32 dq-partial buffer bound past which the backward switches to the
#: accumulating dq kernel (``flash_native.py:415`` of the reference).
DQ_PARTIALS_MAX_BYTES = 1 << 30

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)


def flash_supported(head_dim: int) -> bool:
    """What the flash path takes: any D <= 128 (the reference's rule,
    ``rocket_tpu/nn/attention.py:97``), any T."""
    return 0 < head_dim <= HEAD_DIMS[-1]


def kernel_dim(head_dim: int) -> int:
    """The compiled head dim whose kernel runs D: the smallest in
    :data:`HEAD_DIMS` that is at least D. A D between two compiled ones runs
    on heads zero-padded to it (zero features add nothing to q.k, and the
    padded output columns are P.0 = 0), with the scale of the true D.
    Raises past 128."""
    for kd in HEAD_DIMS:
        if head_dim <= kd:
            return kd
    raise ValueError(f"flash: head dim {head_dim} has no kernel (D <= {HEAD_DIMS[-1]})")


def pad_heads(arr: torch.Tensor, off: int, n: int, d: int, kd: int) -> torch.Tensor:
    """The ``n`` D-wide heads at feature offset ``off`` of a (..., F)
    array -> (..., n * kd), each head zero-padded to ``kd`` features."""
    heads = arr[..., off:off + n * d].reshape(*arr.shape[:-1], n, d)
    return torch.nn.functional.pad(heads, (0, kd - d)).reshape(*arr.shape[:-1], n * kd)


def unpad_heads(arr: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * kd) padded heads -> (..., n * d): the first D features of
    each head."""
    kd = arr.shape[-1] // n
    return arr.reshape(*arr.shape[:-1], n, kd)[..., :d].reshape(*arr.shape[:-1], n * d)


def _padded(q_arr, k_arr, v_arr, h, h_kv, d, offsets, dout=None):
    """The operands of a head dim that is not compiled, each head
    zero-padded to :func:`kernel_dim` -> (q, k, v, dout or None, kd,
    offsets (0, 0, 0))."""
    kd = kernel_dim(d)
    q_off, k_off, v_off = offsets
    return (pad_heads(q_arr, q_off, h, d, kd), pad_heads(k_arr, k_off, h_kv, d, kd),
            pad_heads(v_arr, v_off, h_kv, d, kd),
            None if dout is None else pad_heads(dout, 0, h, d, kd), kd, (0, 0, 0))


def _check_causal_blocks(block_q: int, block_k: int, causal: bool, where: str) -> None:
    """Causal masking runs only on diagonal tiles, which is right only for
    aligned square tiles (``block_q == block_k``); raise on anything else
    (copied from ``rocket_tpu/ops/flash_attention.py:168``)."""
    if causal and block_q != block_k:
        raise ValueError(
            f"{where}: causal diagonal-block masking requires block_q == block_k "
            f"(got block_q={block_q}, block_k={block_k}). Use equal blocks, or "
            "causal=False for asymmetric blocking."
        )


def _num_tiles(t: int) -> int:
    return -(-t // TILE)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round f32 ``x`` to ``dtype`` and back: the kernels' cast of p and ds."""
    return x if dtype == torch.float32 else x.to(dtype).float()


# -- plain versions ---------------------------------------------------------


def _heads(arr, off, n, d):
    """(B, T, F) -> f32 (B, T, n, D) of the n heads at feature offset off."""
    b, t, _ = arr.shape
    return arr[..., off:off + n * d].float().reshape(b, t, n, d)


def _scores(q_arr, k_arr, h, h_kv, d, offsets, causal):
    """Grouped f32 q (B, T, Hkv, g, D), k (B, T, Hkv, D) and the masked
    base-2 scores (B, Hkv, g, Tq, Tk)."""
    b, t, _ = q_arr.shape
    q = _heads(q_arr, offsets[0], h, d).reshape(b, t, h_kv, h // h_kv, d)
    k = _heads(k_arr, offsets[1], h_kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k) * (_LOG2E / math.sqrt(d))
    if causal:
        above = torch.ones(t, t, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    return q, k, s


def _fwd_plain(q_arr, k_arr, v_arr, h, h_kv, d, offsets, causal):
    """Plain forward, the kernel's signature -> (out (B, T, Hq*D), lse (B, Hq, T))."""
    b, t, _ = q_arr.shape
    _, _, s = _scores(q_arr, k_arr, h, h_kv, d, offsets, causal)
    v = _heads(v_arr, offsets[2], h_kv, d)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bskd->bkgqd", _round(p, q_arr.dtype), v) / safe_l
    out = o.permute(0, 3, 1, 2, 4).reshape(b, t, h * d).to(q_arr.dtype)
    lse = (m + torch.log2(safe_l)).reshape(b, h, t)
    return out, lse


def _probs_and_ds(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal):
    """Recomputed p and ds (B, Hkv, g, Tq, Tk), both rounded to the operand
    dtype, plus the grouped f32 q, k and dout."""
    b, t, _ = q_arr.shape
    g = h // h_kv
    q, k, s = _scores(q_arr, k_arr, h, h_kv, d, offsets, causal)
    v = _heads(v_arr, offsets[2], h_kv, d)
    do = dout.float().reshape(b, t, h_kv, g, d)
    p = torch.exp2(s - lse.reshape(b, h_kv, g, t, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v)
    ds = p * (dp - delta.reshape(b, h_kv, g, t, 1)) / math.sqrt(d)
    return _round(p, q_arr.dtype), _round(ds, q_arr.dtype), q, k, do


def _bwd_plain(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal,
               with_dq=True):
    """Plain fused backward, the kernel's signature -> (dq partials (nk, B,
    T, Hq*D) f32 or None without ``with_dq``, dk, dv (B, T, Hkv*D)). Partial
    ``ik`` is the dq contribution of key rows ``[ik*TILE, (ik+1)*TILE)``."""
    b, t, _ = q_arr.shape
    p, ds, q, k, do = _probs_and_ds(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d,
                                    offsets, causal)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do).reshape(b, t, h_kv * d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q).reshape(b, t, h_kv * d)
    dqp = None
    if with_dq:
        nk = _num_tiles(t)
        pad = nk * TILE - t
        ds_t = torch.nn.functional.pad(ds, (0, pad)).reshape(*ds.shape[:-1], nk, TILE)
        k_t = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, nk, TILE, h_kv, d)
        dqp = torch.einsum("bkgqnc,bnckd->nbqkgd", ds_t, k_t).reshape(nk, b, t, h * d)
    return dqp, dk.to(q_arr.dtype), dv.to(q_arr.dtype)


def _dq_plain(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal):
    """Plain accumulating dq, the kernel's signature -> dq (B, T, Hq*D)."""
    b, t, _ = q_arr.shape
    _, ds, _, k, _ = _probs_and_ds(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d,
                                   offsets, causal)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k).reshape(b, t, h * d)
    return dq.to(q_arr.dtype)


# -- kernel wrappers ----------------------------------------------------------


def _check(where, q_arr, k_arr, v_arr, h, h_kv, d, offsets, **extra):
    """Device, dtype, layout and shape checks shared by the three wrappers."""
    check_cuda_operands(where, q_arr=q_arr, k_arr=k_arr, v_arr=v_arr, **extra)
    dtypes = {t.dtype for t in (q_arr, k_arr, v_arr)}
    if len(dtypes) != 1 or q_arr.dtype not in DTYPE_CODES:
        raise ValueError(f"{where}: q/k/v must share a dtype in {list(DTYPE_CODES)}, "
                         f"got {sorted(map(str, dtypes))}")
    if q_arr.dim() != 3 or k_arr.dim() != 3 or k_arr.shape != v_arr.shape:
        raise ValueError(f"{where}: operands must be (B, T, F), got {tuple(q_arr.shape)}, "
                         f"{tuple(k_arr.shape)}, {tuple(v_arr.shape)}")
    if k_arr.shape[:2] != q_arr.shape[:2]:
        raise ValueError(f"{where}: q {tuple(q_arr.shape)} and k {tuple(k_arr.shape)} "
                         "differ in (B, T)")
    if h_kv < 1 or h % h_kv:
        raise ValueError(f"{where}: num_kv_heads {h_kv} must divide num_heads {h}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{where}: head dim {d} not in {HEAD_DIMS}")
    q_off, k_off, v_off = offsets
    if (min(offsets) < 0 or q_off + h * d > q_arr.shape[2] or k_off + h_kv * d > k_arr.shape[2]
            or v_off + h_kv * d > v_arr.shape[2]):
        raise ValueError(f"{where}: head slices at offsets {offsets} exceed the operands")
    for name, t in extra.items():
        if t.dtype != (torch.float32 if name in ("lse", "delta") else q_arr.dtype):
            raise ValueError(f"{where}: {name} has dtype {t.dtype}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> (pointer operands, argument types between the ten
#: geometry ints and the stream).
_ABI = {
    "flash_fwd": (5, [_F, _I, _I]),            # scale2, causal, dtype
    "flash_bwd": (9, [_F, _F, _I, _I, _I]),    # scale, scale2, causal, with_dq, dtype
    "flash_dq": (7, [_F, _F, _I, _I]),         # scale, scale2, causal, dtype
}


def _fn(name: str):
    fn = getattr(_build.load(name), f"rkt_{name}")
    if fn.argtypes is None:
        n_ptr, tail = _ABI[name]
        fn.restype = _I
        fn.argtypes = [_P] * n_ptr + [_I] * 10 + tail + [_P]
    return fn


#: kernel -> (D-wide row tiles, score tiles, statistic rows) in the dynamic
#: shared memory of its f32 (CUDA-core) instantiation (``launch_smem`` of
#: each ``csrc/flash_*.cu``).
_SMEM_PARTS = {"flash_fwd": (3, 1, 0), "flash_bwd": (4, 2, 2), "flash_dq": (4, 1, 2)}
#: Row padding, in elements, of the bf16 tiles of the tensor-core kernels
#: (``kPad`` in ``csrc/mma_common.cuh``).
TC_PAD = 8
#: kernel -> bf16 D-wide row tiles of its tensor-core instantiation: the
#: forward's Q and two stages of K and V; the backward's K, V and two
#: stages of Q and dout; the dq pass's Q, dout and two stages of K and V.
_TC_TILES = {"flash_fwd": 5, "flash_bwd": 6, "flash_dq": 6}


def tensor_cores(kind: str, dtype) -> bool:
    """Whether ``kind``'s ``dtype`` instantiation runs on the tensor cores:
    every bf16 one (the three kernels redesigned); the f32 instantiations
    run f32 FMA on the CUDA cores."""
    return kind in _TC_TILES and dtype == torch.bfloat16


def _smem_bytes(kind: str, d: int, dtype) -> int:
    """Dynamic shared memory of ``kind``'s ``dtype`` launch. bf16: its
    64 x D row tiles at row stride D + 8 (:data:`_TC_TILES`), and for the
    backward also the bf16 64 x 64 dS^T tile at stride 72 and two stages of
    the tile's lse and delta (f32). f32: ``smem_bytes`` of
    ``csrc/flash_common.cuh``, f32 tiles with a padded row stride D + 1,
    padded score tiles and statistic rows."""
    if tensor_cores(kind, dtype):
        smem = 2 * _TC_TILES[kind] * TILE * (d + TC_PAD)
        if kind == "flash_bwd":
            smem += 2 * TILE * (TILE + TC_PAD) + 4 * 4 * TILE
        return smem
    tiles, scores, stats = _SMEM_PARTS[kind]
    return 4 * (tiles * TILE * (d + 1) + scores * TILE * (TILE + 1) + stats * TILE)


def flash_work(kind: str, b: int, t: int, h: int, h_kv: int, d: int, dtype, causal: bool,
               with_dq: bool = True) -> tuple:
    """``(bytes, flops)`` of ``kind`` as a function: each input read once
    and each output written once — the forward reads q, k, v and writes out
    and lse; the backward reads q, k, v, dout, lse and delta and writes dq
    (``with_dq``), dk and dv; the dq pass reads the same and writes dq — and
    2*D flops per visible (query, key) pair and product: 2 products
    forward, 5 in the fused backward (s, dp, dv, dk, dq), 4 without dq, 3 in
    the dq pass. The f32 dq partials are the kernel's design, not the
    function's, so they are left out."""
    item = itemsize(dtype)
    qkv = b * t * (h + 2 * h_kv) * d * item
    act = b * t * h * d * item                   # out, dout or dq
    stats = b * h * t * 4                        # lse or delta (f32)
    pairs = b * h * (t * (t + 1) / 2 if causal else t * t)
    dkv = 2 * b * t * h_kv * d * item
    if kind == "flash_fwd":
        return qkv + act + stats, 4 * d * pairs
    if kind == "flash_bwd" and with_dq:
        return qkv + 2 * act + 2 * stats + dkv, 10 * d * pairs
    if kind == "flash_bwd":
        return qkv + act + 2 * stats + dkv, 8 * d * pairs
    return qkv + 2 * act + 2 * stats, 6 * d * pairs


def flash_launch(kind: str, b: int, t: int, h: int, h_kv: int, d: int, dtype, fq: int,
                 fk: int, with_dq: bool = True, causal: bool = True) -> LaunchFact:
    """The launch of ``kind`` ("flash_fwd", "flash_bwd" or "flash_dq") on
    (B, T, F) operands of feature widths ``fq`` (q) and ``fk`` (k, v). A CTA
    owns one TILE-row tile (query rows; key rows for the backward) of one
    head of one batch row: it stages its own tile of each operand it owns
    and streams TILE-row tiles of the others, every tile the D-wide head
    slice of a (T, F) plane; lse and delta are TILE-long rows of a (B*H, T)
    f32 plane. Its work is :func:`flash_work`'s (a launch on heads padded
    to a compiled D does the padded work)."""
    f32 = torch.float32
    heads = h_kv if kind == "flash_bwd" else h
    q_t, kv_t = tile(TILE, d, dtype, t, fq), tile(TILE, d, dtype, t, fk)
    o_t = tile(TILE, d, dtype, t, h * d)                      # out, dout, dq
    stat = tile(1, TILE, f32, b * h, t)
    if kind == "flash_fwd":
        tiles = (q_t, kv_t, kv_t, o_t, stat)
    elif kind == "flash_bwd":
        dkv = tile(TILE, d, dtype, t, h_kv * d)
        tiles = (kv_t, kv_t, q_t, o_t, stat, stat, dkv, dkv)
        if with_dq:
            tiles += (tile(TILE, d, f32, t, h * d),)
    else:
        tiles = (q_t, o_t, kv_t, kv_t, stat, stat, o_t)
    fact = LaunchFact(kind, (_num_tiles(t), heads, b), THREADS, _smem_bytes(kind, d, dtype), 0,
                      tiles)
    # mma.sync with f32 accumulators, f32 row statistics; dq's partials
    # are summed in a fixed order (flash_dq.cu, or the wrapper's sum).
    return with_work(fact, *flash_work(kind, b, t, h, h_kv, d, dtype, causal, with_dq),
                     dtype, acc=torch.float32)


def launch_info(kind: str, b: int, t: int, h: int, h_kv: int, d: int, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of ``kind``'s launch
    as the built library reports it (needs the card)."""
    fn = getattr(_build.load(kind), f"rkt_{kind}_launch_info")
    fn.restype = _I
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    return query_launch(fn, b, t, h, h_kv, d, DTYPE_CODES[dtype])


def _attribute(kind: str, what: str, d: int, dtype) -> int:
    fn = getattr(_build.load(kind), f"rkt_{kind}_{what}")
    fn.restype = _I
    fn.argtypes = [_I, _I]
    return fn(d, DTYPE_CODES[dtype])


def occupancy(d: int, dtype, kind: str = "flash_fwd") -> int:
    """Resident CTAs per SM of ``kind``'s (D, dtype) kernel at its shared
    memory, as the card reports it (-1 when it refuses). Needs the card."""
    return _attribute(kind, "occupancy", d, dtype)


def registers(d: int, dtype, kind: str) -> int:
    """Registers per thread of the backward's (``"flash_bwd"``) or the dq
    pass's (``"flash_dq"``) (D, dtype) kernel, as the built library reports
    them (-1 when the card refuses it). Needs the card."""
    return _attribute(kind, "registers", d, dtype)


def _check_aligned(where, arrays, offsets) -> None:
    """The tensor-core kernels copy each head's D-wide slice in 16-byte
    pieces: every operand 16-byte aligned, its feature width and the head
    offsets whole multiples of 8 elements. Raise otherwise."""
    for name, arr in arrays.items():
        if arr.data_ptr() % 16 or arr.shape[2] % 8:
            raise ValueError(f"{where}: bf16 {name} must start 16-byte aligned with a feature "
                             f"width that is a multiple of 8 (address {arr.data_ptr():#x}, "
                             f"width {arr.shape[2]})")
    if any(off % 8 for off in offsets):
        raise ValueError(f"{where}: bf16 head offsets {offsets} must be multiples of 8")


def _raise_on(err: int, where: str) -> None:
    if err:
        raise RuntimeError(f"{where}: kernel launch failed with cudaError {err}")


def _geometry_args(q_arr, k_arr, h, h_kv, d, offsets):
    b, t, fq = q_arr.shape
    return [b, t, h, h_kv, d, fq, k_arr.shape[2], *offsets]


def flash_fwd(q_arr, k_arr, v_arr, h: int, h_kv: int, d: int, offsets, causal: bool):
    """Flash forward over the head slices at ``offsets = (q_off, k_off,
    v_off)`` of (B, T, F) operands -> ``(out (B, T, h*d), lse (B, h, T)
    f32)``. CPU tensors: :func:`_fwd_plain`; CUDA tensors:
    ``csrc/flash_fwd.cu`` or raise, at a D that is not compiled on heads
    zero-padded to :func:`kernel_dim` (out sliced back to D)."""
    _check_causal_blocks(TILE, TILE, causal, "flash_fwd")
    if q_arr.device.type == "cpu":
        return _fwd_plain(q_arr, k_arr, v_arr, h, h_kv, d, offsets, causal)
    if flash_supported(d) and d not in HEAD_DIMS:
        q_p, k_p, v_p, _, kd, offs = _padded(q_arr, k_arr, v_arr, h, h_kv, d, offsets)
        out, lse = _fwd_launch(q_p, k_p, v_p, h, h_kv, kd, offs, causal, d)
        return unpad_heads(out, h, d), lse
    return _fwd_launch(q_arr, k_arr, v_arr, h, h_kv, d, offsets, causal, d)


def _fwd_launch(q_arr, k_arr, v_arr, h, h_kv, d, offsets, causal, true_d):
    """Launch (or, on meta tensors, record) ``csrc/flash_fwd.cu`` at the
    compiled head dim ``d`` with the scale of ``true_d``."""
    _check("flash_fwd", q_arr, k_arr, v_arr, h, h_kv, d, offsets)
    if tensor_cores("flash_fwd", q_arr.dtype):
        _check_aligned("flash_fwd", {"q_arr": q_arr, "k_arr": k_arr, "v_arr": v_arr}, offsets)
    b, t, fq = q_arr.shape
    out = torch.empty((b, t, h * d), dtype=q_arr.dtype, device=q_arr.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q_arr.device)
    if q_arr.device.type == "meta":
        record([flash_launch("flash_fwd", b, t, h, h_kv, d, q_arr.dtype, fq, k_arr.shape[2],
                             causal=causal)], (q_arr, k_arr, v_arr), (out, lse))
        return out, lse
    err = _fn("flash_fwd")(
        q_arr.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_geometry_args(q_arr, k_arr, h, h_kv, d, offsets),
        _LOG2E / math.sqrt(true_d), int(causal), DTYPE_CODES[q_arr.dtype], stream_of(q_arr),
    )
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd(q_arr, k_arr, v_arr, dout, lse, delta, h: int, h_kv: int, d: int, offsets,
              causal: bool, with_dq: bool = True):
    """Fused backward -> ``(dq partials (nk, B, T, h*d) f32 or None, dk,
    dv (B, T, h_kv*d))`` with ``nk = ceil(T / TILE)``. CPU tensors:
    :func:`_bwd_plain`; CUDA tensors: ``csrc/flash_bwd.cu`` or raise, at a D
    that is not compiled on zero-padded heads (the results sliced back)."""
    _check_causal_blocks(TILE, TILE, causal, "flash_bwd")
    if q_arr.device.type == "cpu":
        return _bwd_plain(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal,
                          with_dq)
    if flash_supported(d) and d not in HEAD_DIMS:
        q_p, k_p, v_p, do_p, kd, offs = _padded(q_arr, k_arr, v_arr, h, h_kv, d, offsets, dout)
        dqp, dk, dv = _bwd_launch(q_p, k_p, v_p, do_p, lse, delta, h, h_kv, kd, offs, causal,
                                  with_dq, d)
        return (None if dqp is None else unpad_heads(dqp, h, d), unpad_heads(dk, h_kv, d),
                unpad_heads(dv, h_kv, d))
    return _bwd_launch(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal,
                       with_dq, d)


def _bwd_launch(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal, with_dq,
                true_d):
    """Launch (or record) ``csrc/flash_bwd.cu`` at the compiled head dim
    ``d`` with the scales of ``true_d``."""
    _check("flash_bwd", q_arr, k_arr, v_arr, h, h_kv, d, offsets, dout=dout, lse=lse,
           delta=delta)
    if tensor_cores("flash_bwd", q_arr.dtype):
        _check_aligned("flash_bwd", {"q_arr": q_arr, "k_arr": k_arr, "v_arr": v_arr,
                                     "dout": dout}, offsets)
    b, t, _ = q_arr.shape
    if dout.shape != (b, t, h * d) or lse.shape != (b, h, t) or delta.shape != (b, h, t):
        raise ValueError(f"flash_bwd: dout {tuple(dout.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} for (B, T, H, D) = ({b}, {t}, {h}, {d})")
    dev = q_arr.device
    # Every partial is written by the kernel (zeros where causal skips a
    # tile), so the buffer needs no clearing.
    dqp = (torch.empty((_num_tiles(t), b, t, h * d), dtype=torch.float32, device=dev)
           if with_dq else None)
    dk = torch.empty((b, t, h_kv * d), dtype=q_arr.dtype, device=dev)
    dv = torch.empty_like(dk)
    if dev.type == "meta":
        record([flash_launch("flash_bwd", b, t, h, h_kv, d, q_arr.dtype, q_arr.shape[2],
                             k_arr.shape[2], with_dq, causal=causal)],
               (q_arr, k_arr, v_arr, dout, lse, delta), (dqp, dk, dv))
        return dqp, dk, dv
    err = _fn("flash_bwd")(
        q_arr.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqp.data_ptr() if with_dq else None, dk.data_ptr(), dv.data_ptr(),
        *_geometry_args(q_arr, k_arr, h, h_kv, d, offsets),
        1.0 / math.sqrt(true_d), _LOG2E / math.sqrt(true_d), int(causal), int(with_dq),
        DTYPE_CODES[q_arr.dtype], stream_of(q_arr),
    )
    _raise_on(err, "flash_bwd")
    flash_bwd.launches += 1
    return dqp, dk, dv


def flash_dq(q_arr, k_arr, v_arr, dout, lse, delta, h: int, h_kv: int, d: int, offsets,
             causal: bool):
    """Accumulating dq -> ``dq (B, T, h*d)`` in the operands' dtype. CPU
    tensors: :func:`_dq_plain`; CUDA tensors: ``csrc/flash_dq.cu`` or raise,
    at a D that is not compiled on zero-padded heads (dq sliced back)."""
    _check_causal_blocks(TILE, TILE, causal, "flash_dq")
    if q_arr.device.type == "cpu":
        return _dq_plain(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal)
    if flash_supported(d) and d not in HEAD_DIMS:
        q_p, k_p, v_p, do_p, kd, offs = _padded(q_arr, k_arr, v_arr, h, h_kv, d, offsets, dout)
        return unpad_heads(_dq_launch(q_p, k_p, v_p, do_p, lse, delta, h, h_kv, kd, offs,
                                      causal, d), h, d)
    return _dq_launch(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal, d)


def _dq_launch(q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal, true_d):
    """Launch (or record) ``csrc/flash_dq.cu`` at the compiled head dim
    ``d`` with the scales of ``true_d``."""
    _check("flash_dq", q_arr, k_arr, v_arr, h, h_kv, d, offsets, dout=dout, lse=lse,
           delta=delta)
    if tensor_cores("flash_dq", q_arr.dtype):
        _check_aligned("flash_dq", {"q_arr": q_arr, "k_arr": k_arr, "v_arr": v_arr,
                                    "dout": dout}, offsets)
    b, t, _ = q_arr.shape
    if dout.shape != (b, t, h * d) or lse.shape != (b, h, t) or delta.shape != (b, h, t):
        raise ValueError(f"flash_dq: dout {tuple(dout.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} for (B, T, H, D) = ({b}, {t}, {h}, {d})")
    dq = torch.empty((b, t, h * d), dtype=q_arr.dtype, device=q_arr.device)
    if q_arr.device.type == "meta":
        record([flash_launch("flash_dq", b, t, h, h_kv, d, q_arr.dtype, q_arr.shape[2],
                             k_arr.shape[2], causal=causal)],
               (q_arr, k_arr, v_arr, dout, lse, delta), (dq,))
        return dq
    err = _fn("flash_dq")(
        q_arr.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_geometry_args(q_arr, k_arr, h, h_kv, d, offsets),
        1.0 / math.sqrt(true_d), _LOG2E / math.sqrt(true_d), int(causal),
        DTYPE_CODES[q_arr.dtype], stream_of(q_arr),
    )
    _raise_on(err, "flash_dq")
    flash_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd.launches = 0
flash_dq.launches = 0


# -- autograd ---------------------------------------------------------------


def _backward(q_arr, k_arr, v_arr, out, lse, dout, h, h_kv, d, offsets, causal, dq_split):
    """-> (dq (B, T, h*d), dk, dv (B, T, h_kv*d)) by the chosen strategy."""
    b, t, _ = q_arr.shape
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).reshape(b, t, h, d).sum(-1).transpose(1, 2).contiguous()
    if dq_split is None:
        # The switch point moves with the tile size: nk counts this port's
        # TILE-row k-tiles, not the reference's 512-row blocks.
        dq_split = _num_tiles(t) * b * t * h * d * 4 > DQ_PARTIALS_MAX_BYTES
    args = (q_arr, k_arr, v_arr, dout, lse, delta, h, h_kv, d, offsets, causal)
    if dq_split:
        _, dk, dv = flash_bwd(*args, with_dq=False)
        return flash_dq(*args), dk, dv
    dqp, dk, dv = flash_bwd(*args, with_dq=True)
    # One f32 sum over the partials, cast once (never round a partial).
    return dqp.sum(0).to(q_arr.dtype), dk, dv


class _FlashFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fused, h, causal, dq_split):
        d = fused.shape[-1] // (3 * h)
        offsets = (0, h * d, 2 * h * d)
        out, lse = flash_fwd(fused, fused, fused, h, h, d, offsets, causal)
        ctx.save_for_backward(fused, out, lse)
        ctx.cfg = (h, d, offsets, causal, dq_split)
        return out

    @staticmethod
    def backward(ctx, dout):
        fused, out, lse = ctx.saved_tensors
        h, d, offsets, causal, dq_split = ctx.cfg
        dq, dk, dv = _backward(fused, fused, fused, out, lse, dout, h, h, d, offsets, causal,
                               dq_split)
        return torch.cat([dq, dk, dv], dim=-1), None, None, None


class _FlashBTHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q2, k2, v2, h, h_kv, causal, dq_split):
        d = q2.shape[-1] // h
        out, lse = flash_fwd(q2, k2, v2, h, h_kv, d, (0, 0, 0), causal)
        ctx.save_for_backward(q2, k2, v2, out, lse)
        ctx.cfg = (h, h_kv, d, causal, dq_split)
        return out

    @staticmethod
    def backward(ctx, dout):
        q2, k2, v2, out, lse = ctx.saved_tensors
        h, h_kv, d, causal, dq_split = ctx.cfg
        dq, dk, dv = _backward(q2, k2, v2, out, lse, dout, h, h_kv, d, (0, 0, 0), causal,
                               dq_split)
        return dq, dk, dv, None, None, None, None


def flash_fused(fused: torch.Tensor, num_heads: int, causal: bool = True,
                dq_split: Optional[bool] = None) -> torch.Tensor:
    """Flash attention on the fused ``(B, T, 3*H*D)`` projection output
    (``[q | k | v]`` along features, each head-major) -> ``(B, T, H*D)``.
    Differentiable; the gradient is the fused ``[dq | dk | dv]`` cotangent.

    ``dq_split``: backward dq strategy. None picks by the f32 partial
    buffer's size (``nk*B*T*H*D*4 > DQ_PARTIALS_MAX_BYTES``); False forces
    the fused pass with dq partials; True the separate accumulating dq
    kernel."""
    b, t, f = fused.shape
    if f % (3 * num_heads):
        raise ValueError(f"flash_fused: feature dim {f} is not 3*H*D for H={num_heads}")
    return _FlashFused.apply(fused.contiguous(), num_heads, causal, dq_split)


def flash_bthd(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, num_heads: int,
               num_kv_heads: Optional[int] = None, causal: bool = True,
               dq_split: Optional[bool] = None) -> torch.Tensor:
    """Flash attention on ``q2`` ``(B, T, Hq*D)`` against ``k2``/``v2``
    ``(B, T, Hkv*D)`` with Hkv | Hq (grouped-query native: each kv head
    serves its query group, K/V are never repeated) -> ``(B, T, Hq*D)``.
    ``dq_split`` as in :func:`flash_fused`."""
    if num_kv_heads is None:
        num_kv_heads = num_heads
    b, t, f = q2.shape
    if f % num_heads or k2.shape != (b, t, (f // num_heads) * num_kv_heads):
        raise ValueError(f"flash_bthd: q {tuple(q2.shape)} / k {tuple(k2.shape)} "
                         f"inconsistent with H={num_heads}, Hkv={num_kv_heads}")
    if num_heads % num_kv_heads:
        raise ValueError("flash_bthd: num_kv_heads must divide num_heads")
    if v2.shape != k2.shape:
        raise ValueError("flash_bthd: k and v must share one shape")
    return _FlashBTHD.apply(q2.contiguous(), k2.contiguous(), v2.contiguous(), num_heads,
                            num_kv_heads, causal, dq_split)


# -- the mesh seams ----------------------------------------------------------------------------


def _local_heads(mesh, b: int, num_heads: int, num_kv_heads: int, batch_axes, head_axis):
    """The seam's head split: ``(tp, heads, kv heads)`` of this rank's
    shard, the head axis dropped where Hq or Hkv does not divide it (the
    reference's rule)."""
    from rocket_tpu_torch.ops.flash_attention import _mesh_shape, shardable_axes

    _, haxis = shardable_axes(mesh, b, num_heads, batch_axes, head_axis)
    tp = int(_mesh_shape(mesh)[haxis]) if haxis is not None else 1
    if num_kv_heads % tp:
        tp = 1  # the kv heads must split evenly too
    return tp, num_heads // tp, num_kv_heads // tp


def flash_fused_sharded(fused: torch.Tensor, num_heads: int, causal: bool = True, *, mesh,
                        batch_axes=("data",), head_axis: Optional[str] = "model",
                        dq_split: Optional[bool] = None) -> torch.Tensor:
    """:func:`flash_fused` on this rank's shard -> its shard of ``(B, T,
    H*D)``. ``num_heads`` is the whole model's H. The batch is the rank's
    stripe; with a usable ``head_axis`` (H divides it) ``fused`` is ``(B,
    T, 3*(H/n)*D)``, the rank's heads of each of q, k and v laid end to end
    (the reference slices the three segments and shards each on its
    features), and the output holds the rank's heads. No communication."""
    b, t, f = fused.shape
    tp, heads, _ = _local_heads(mesh, b, num_heads, num_heads, batch_axes, head_axis)
    if f % (3 * heads):
        raise ValueError(f"flash_fused_sharded: feature dim {f} is not 3*H*D for the "
                         f"{heads} heads of this rank (H={num_heads} over {tp})")
    return flash_fused(fused, heads, causal=causal, dq_split=dq_split)


def flash_bthd_sharded(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, num_heads: int,
                       num_kv_heads: Optional[int] = None, causal: bool = True, *, mesh,
                       batch_axes=("data",), head_axis: Optional[str] = "model",
                       dq_split: Optional[bool] = None) -> torch.Tensor:
    """:func:`flash_bthd` on this rank's shard -> its shard of ``(B, T,
    Hq*D)``. ``num_heads``/``num_kv_heads`` are the whole model's. The
    batch is the rank's stripe; the features are the rank's contiguous
    cut of ``Hq*D`` and ``Hkv*D`` (the Megatron activation layout: a cut at
    ``H/n`` boundaries is a head split) where ``head_axis`` is usable, Hq
    and Hkv both dividing it, and whole otherwise. No communication."""
    if num_kv_heads is None:
        num_kv_heads = num_heads
    _, heads, kv_heads = _local_heads(mesh, q2.shape[0], num_heads, num_kv_heads, batch_axes,
                                      head_axis)
    return flash_bthd(q2, k2, v2, heads, kv_heads, causal=causal, dq_split=dq_split)
