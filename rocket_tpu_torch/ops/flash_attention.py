"""Flash attention on one stacked ``(3, B, H, T, D)`` q/k/v operand
(counterpart of ``rocket_tpu/ops/flash_attention.py``).

Two kernels, each hand-written CUDA (``csrc/flash_attention.cu``) with a
plain PyTorch version of the same signature beside it (in bf16 both run on
the tensor cores, the forward one warp per 16 query rows, the backward
one warp per 16 key rows; in f32 both are register-tiled f32 FMA):

* :func:`flash_qkv_fwd` / :func:`_fwd_plain` -> ``(out (B, H, T, D), lse
  (B, H, 1, T) f32)``: f32 scores times ``log2(e)/sqrt(D)``, ``exp2``, lse
  in base 2, causal masking to -1e30, ``l = 0`` rows read as ``l = 1``,
  probabilities rounded to the operand dtype before the PV product;
* :func:`flash_qkv_bwd` / :func:`_bwd_plain` -> ``(dq partials (nk, B, H,
  T, D), dk, dv)`` in the operand dtype: dk/dv summed in f32, ``ds``
  rounded to the operand dtype before the dK and dQ products, one dq
  partial per ``block_k`` key rows, summed in f32 and rounded — the
  reference's rounding (the native-layout row 4 of ``flash_native`` keeps
  its partials in f32 instead).

:func:`flash_attention_qkv` wraps both in one ``torch.autograd.Function``
(the reference's ``custom_vjp``); ``delta = rowsum(O * dO)`` is computed
in f32 outside the kernel and the partials are summed in f32 outside it,
``dq_part[0]`` taken as is when there is one k-tile, as the reference does.
:func:`flash_attention` stacks separate q, k, v.

Blocks are the kernel's compiled tiles: 64 and 128 at D <= 64
(:data:`TILES`), 64 at D = 128 (:data:`TILES_BY_D`); causal needs equal
blocks, non-causal runs any compiled pair. A D <= 128 that is not compiled
runs the kernel of the next compiled D on zero-padded heads, with the scale
of the true D. :func:`resolve_tuned_blocks`
reads the ``flash_fwd`` / ``flash_bwd`` tune tables
(``rocket_tpu_torch.tune``) with the reference's precedence: explicit
arguments win, pinned forward blocks suppress the backward table, and
:data:`DEFAULT_BLOCK` is the fallback. T must be a multiple of 128, the
reference's entry contract. Head dims: :data:`HEAD_DIMS`.

The mesh seams (the reference's ``shard_map`` wrappers): in the port a
rank already holds its stripe of the batch (and, under tensor
parallelism, its heads), so :func:`flash_attention_qkv_sharded` takes the
rank's local shard, the counterpart of the reference's in-spec, runs the
kernel on it and returns the local shard of the out-spec, with no
communication, as there. :func:`shardable_axes` is the reference's drop
rule; :func:`in_manual_axes` is True inside a :func:`manual_axes` block,
the counterpart of the reference's ``shard_map`` body. The port's own
layers call the kernels directly on the rank's operands, which is what
the seams would run.

On CPU tensors every kernel wrapper takes its plain version; on CUDA
tensors it launches its kernel (counted in ``<wrapper>.launches``) or
raises; on ``meta`` tensors it records its launch (:func:`qkv_launch`) and
launches nothing.
"""

from __future__ import annotations

import contextlib
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
from rocket_tpu_torch.ops.flash_native import flash_supported, kernel_dim

__all__ = [
    "DEFAULT_BLOCK", "HEAD_DIMS", "TILES", "TILES_BY_D", "default_block", "flash_supported",
    "kernel_dim", "tiles_for",
    "flash_attention", "flash_attention_qkv", "flash_attention_qkv_sharded", "in_manual_axes",
    "manual_axes", "shardable_axes",
    "flash_qkv_bwd", "flash_qkv_fwd", "pick_block", "resolve_tuned_blocks", "smem_bytes",
    "threads", "qkv_launch", "launch_info", "occupancy", "registers",
]

#: Tile sizes the CUDA kernels are compiled for at D <= 64 (block_q and
#: block_k each).
TILES = (128, 64)
#: Head dims the CUDA kernels are compiled for (those of the port's other
#: flash kernels); every other D <= 128 runs on heads zero-padded to the
#: next one (``flash_native.kernel_dim``).
HEAD_DIMS = (32, 64, 128)
#: Compiled head dim -> the tiles compiled at it: at D = 128 only 64 x 64
#: (the f32 forward's 128-row tiles outgrow shared memory, the bf16
#: backward's 128 keys the registers).
TILES_BY_D = {32: TILES, 64: TILES, 128: (64,)}
#: The fallback block when no tune table entry matches: the larger compiled
#: tile. The reference's 512 was a TPU measurement and does not carry over.
DEFAULT_BLOCK = 128
#: The reference's entry contract: T a multiple of its smallest block.
_T_MULTIPLE = 128
#: Threads per CTA of the CUDA-core kernels (``kThreads`` in
#: ``csrc/flash_attention.cu``); the bf16 kernels take :func:`threads`.
THREADS = 256
#: Row padding of the bf16 kernels' shared-memory tiles, in elements
#: (``rkt_mma::kPad``), and the queries of one step of the bf16 backward's
#: sweep (``rkt_mma::kKeys``).
_PAD, _STEP = 8, 64

_NEG_INF = -1e30
_LOG2E = math.log2(math.e)


def tiles_for(d: int) -> tuple:
    """The tiles compiled for the kernel that runs head dim ``d`` (raises
    past 128)."""
    return TILES_BY_D[kernel_dim(d)]


def default_block(d: int) -> int:
    """The fallback block at head dim ``d``: the largest tile compiled
    there (:data:`DEFAULT_BLOCK` at D <= 64)."""
    return tiles_for(d)[0]


def pick_block(t: int, preferred: int = DEFAULT_BLOCK, d: int = 64) -> Optional[int]:
    """Largest tile compiled at head dim ``d`` (<= ``preferred``) that
    divides ``t``, or None. A caller pinning a TPU size (256, 512) gets the
    largest compiled tile."""
    for block in tiles_for(d):
        if block <= preferred and t % block == 0 and block <= t:
            return block
    return None


def _tensor_cores(kind: str, dtype) -> bool:
    """Both bf16 kernels (``kind`` ``"fwd"`` or ``"bwd"``) run on the tensor
    cores, the f32 ones on the CUDA cores. ``dtype`` is a torch dtype or its
    name."""
    return kind in ("fwd", "bwd") and str(dtype).removeprefix("torch.") == "bfloat16"


def threads(kind: str, block_q: int, dtype, block_k: Optional[int] = None) -> int:
    """Threads per CTA of the ``"fwd"`` or ``"bwd"`` kernel: in bf16 one warp
    per 16 query rows forward (``2 * block_q``) and per 16 key rows backward
    (``2 * block_k``), else :data:`THREADS`."""
    if not _tensor_cores(kind, dtype):
        return THREADS
    return 2 * (block_q if kind == "fwd" else block_k)


def smem_bytes(kind: str, block_q: int, block_k: int, d: int, dtype) -> int:
    """Dynamic shared memory of one CTA of the ``"fwd"`` or ``"bwd"`` kernel
    (``fwd_tc_smem`` / ``bwd_tc_smem`` / ``fwd_smem`` / ``bwd_smem`` in
    ``csrc/flash_attention.cu``). The bf16 forward: the Q tile and two
    stages of K and V, bf16 at row stride D + 8. The bf16 backward: K and
    V, two stages of a 64-query step of Q and dO at the same stride, the
    bf16 (block_k, 64) dS^T tile at stride 72 and two stages of the step's
    lse and delta (f32). f32: tiles with a padded row stride D + 1 and one
    padded score tile."""
    if _tensor_cores(kind, dtype) and kind == "bwd":
        return (2 * ((2 * block_k + 4 * _STEP) * (d + _PAD) + block_k * (_STEP + _PAD))
                + 4 * 4 * _STEP)
    if _tensor_cores(kind, dtype):
        return 2 * (block_q + 4 * block_k) * (d + _PAD)
    if kind == "fwd":
        return 4 * ((block_q + 2 * block_k) * (d + 1) + block_q * (block_k + 1))
    return 4 * (2 * (block_q + block_k) * (d + 1) + block_k * (block_q + 1) + 2 * block_q)


def qkv_work(kind: str, b: int, h: int, t: int, d: int, dtype, causal: bool,
             block_k: int) -> tuple:
    """``(bytes, flops)`` of rows 6-7 as the kernels define them: the
    forward reads the stacked qkv and writes out and lse, 2 products per
    visible (query, key) pair; the backward reads qkv, dout, lse and delta
    and writes its dq partials (one (B, H, T, D) copy per ``block_k`` key
    rows in the operand dtype, the reference's output), dk and dv, 5
    products per visible pair; 2*D flops a pair and product."""
    item = itemsize(dtype)
    act = b * h * t * d * item
    stats = b * h * t * 4
    pairs = b * h * (t * (t + 1) / 2 if causal else t * t)
    if kind == "fwd":
        return 4 * act + stats, 4 * d * pairs
    partials = (t // block_k) * act
    return 4 * act + 2 * stats + partials + 2 * act, 10 * d * pairs


def qkv_launch(kind: str, b: int, h: int, t: int, d: int, dtype, block_q: int,
               block_k: int, causal: bool = True) -> LaunchFact:
    """The launch of the ``"fwd"`` or ``"bwd"`` kernel on the stacked (3, B,
    H, T, D) operand: one CTA per (q tile forward, k tile backward; head;
    batch row) of :func:`threads` threads, every tile a run of rows of one
    (T, D) head plane, lse and delta runs of a (B*H, T) f32 plane (the bf16
    backward streams queries, lse and delta in 64-row steps whatever
    ``block_q`` is); the dynamic shared memory is :func:`smem_bytes`. Its
    work is :func:`qkv_work`'s."""
    q_t, k_t = tile(block_q, d, dtype, t, d), tile(block_k, d, dtype, t, d)
    stat = tile(1, block_q, torch.float32, b * h, t)
    if kind == "fwd":
        grid, tiles = t // block_q, (q_t, k_t, k_t, q_t, stat)
    else:                      # k, v staged; q, dout streamed; dq partial, dk, dv
        if _tensor_cores(kind, dtype):
            q_t, stat = tile(_STEP, d, dtype, t, d), tile(1, _STEP, torch.float32, b * h, t)
        grid, tiles = t // block_k, (k_t, k_t, q_t, q_t, stat, stat, q_t, k_t, k_t)
    fact = LaunchFact(f"flash_qkv_{kind}", (grid, h, b), threads(kind, block_q, dtype, block_k),
                      smem_bytes(kind, block_q, block_k, d, dtype), 0, tiles)
    # Scores, softmax statistics and P.V (dk, dv, dq) in f32 registers.
    return with_work(fact, *qkv_work(kind, b, h, t, d, dtype, causal, block_k), dtype,
                     acc=torch.float32)


def _check_causal_blocks(block_q: int, block_k: int, causal: bool, where: str) -> None:
    """Causal masking runs only on diagonal tiles, which is right only for
    aligned square tiles (``block_q == block_k``); raise on anything else
    (the reference's ``_check_causal_blocks``, ``:168``)."""
    if causal and block_q != block_k:
        raise ValueError(
            f"{where}: causal diagonal-block masking requires block_q == block_k "
            f"(got block_q={block_q}, block_k={block_k}). Use equal blocks, or "
            "causal=False for asymmetric blocking."
        )


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round f32 ``x`` to ``dtype`` and back: the kernels' cast of p and ds."""
    return x if dtype == torch.float32 else x.to(dtype).float()


# -- plain versions ---------------------------------------------------------


def _probs(q, k, causal):
    """Base-2 scores (B, H, Tq, Tk) of f32 q, k, masked to -1e30 above the
    diagonal when causal."""
    t, d = q.shape[-2:]
    s2 = torch.einsum("bhqd,bhkd->bhqk", q, k) * (_LOG2E / math.sqrt(d))
    if causal:
        above = torch.ones(t, t, dtype=torch.bool, device=s2.device).triu(1)
        s2 = s2.masked_fill(above, _NEG_INF)
    return s2


def _fwd_plain(qkv, causal: bool, block_q: int, block_k: int):
    """Plain forward, the kernel's signature -> (out (B, H, T, D), lse (B,
    H, 1, T) f32)."""
    _check_causal_blocks(block_q, block_k, causal, "flash_qkv_fwd")
    q, k, v = qkv.float().unbind(0)
    s2 = _probs(q, k, causal)
    m = s2.amax(-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", _round(p, qkv.dtype), v) / safe_l
    lse = (m + torch.log2(safe_l)).transpose(-1, -2)
    return out.to(qkv.dtype), lse.contiguous()


def _bwd_plain(qkv, out, lse, dout, delta, causal: bool, block_q: int, block_k: int):
    """Plain fused backward, the kernel's signature -> (dq partials (nk, B,
    H, T, D), dk, dv (B, H, T, D)), all in the operand dtype. Partial ``ik``
    is the dq contribution of key rows ``[ik*block_k, (ik+1)*block_k)``,
    summed in f32 and rounded; ``block_q`` does not change the result."""
    _check_causal_blocks(block_q, block_k, causal, "flash_qkv_bwd")
    del out
    dtype = qkv.dtype
    b, h, t, d = qkv.shape[1:]
    q, k, v = qkv.float().unbind(0)
    do = dout.float()
    p = torch.exp2(_probs(q, k, causal) - lse.transpose(-1, -2))
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = _round(p * (dp - delta.transpose(-1, -2)) * (1.0 / math.sqrt(d)), dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", _round(p, dtype), do)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    nk = t // block_k
    dqp = torch.einsum("bhqnc,bhncd->nbhqd", ds.reshape(b, h, t, nk, block_k),
                       k.reshape(b, h, nk, block_k, d))
    return dqp.to(dtype), dk.to(dtype), dv.to(dtype)


# -- kernel wrappers ----------------------------------------------------------


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("flash_attention")
    if lib.rkt_flash_qkv_fwd.argtypes is None:
        lib.rkt_flash_qkv_fwd.restype = _I
        lib.rkt_flash_qkv_fwd.argtypes = [_P] * 3 + [_I] * 6 + [_F, _I, _I, _P]
        lib.rkt_flash_qkv_bwd.restype = _I
        lib.rkt_flash_qkv_bwd.argtypes = [_P] * 7 + [_I] * 6 + [_F, _F, _I, _I, _P]
        lib.rkt_flash_qkv_occupancy.restype = _I
        lib.rkt_flash_qkv_occupancy.argtypes = [_I] * 5
        lib.rkt_flash_qkv_registers.restype = _I
        lib.rkt_flash_qkv_registers.argtypes = [_I] * 5
        lib.rkt_flash_qkv_launch_info.restype = _I
        lib.rkt_flash_qkv_launch_info.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def launch_info(kind: str, b: int, h: int, t: int, d: int, dtype, block_q: int,
                block_k: int) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the ``"fwd"`` or
    ``"bwd"`` launch as the built library reports it (needs the card)."""
    return query_launch(_lib().rkt_flash_qkv_launch_info, 0 if kind == "fwd" else 1, b, h, t,
                        d, block_q, block_k, DTYPE_CODES[dtype])


def occupancy(kind: str, d: int, block_q: int, block_k: int, dtype: torch.dtype) -> int:
    """Resident CTAs per SM of one instantiation of the ``"fwd"`` or
    ``"bwd"`` kernel at its shared memory, as the card reports it (-1 when
    it refuses the instantiation). Needs the card."""
    return _lib().rkt_flash_qkv_occupancy(0 if kind == "fwd" else 1, d, block_q, block_k,
                                          DTYPE_CODES[dtype])


def registers(kind: str, d: int, block_q: int, block_k: int, dtype: torch.dtype) -> int:
    """Registers per thread of one instantiation of the ``"fwd"`` or
    ``"bwd"`` kernel, as the built library reports them. Needs the card."""
    return _lib().rkt_flash_qkv_registers(0 if kind == "fwd" else 1, d, block_q, block_k,
                                          DTYPE_CODES[dtype])


def _check(where, qkv, block_q, block_k, **extra):
    check_cuda_operands(where, qkv=qkv, **extra)
    if qkv.dtype not in DTYPE_CODES:
        raise ValueError(f"{where}: dtype {qkv.dtype} not in {list(DTYPE_CODES)}")
    _, b, h, t, d = qkv.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{where}: head dim {d} not in {HEAD_DIMS}")
    tiles = TILES_BY_D[d]
    if block_q not in tiles or block_k not in tiles or t % block_q or t % block_k:
        raise ValueError(f"{where}: blocks ({block_q}, {block_k}) must be tiles {tiles} "
                         f"compiled at head dim {d}, dividing T={t}")
    for name, x in extra.items():
        want = (b, h, 1, t) if name in ("lse", "delta") else (b, h, t, d)
        if tuple(x.shape) != want:
            raise ValueError(f"{where}: {name} is {tuple(x.shape)}, expected {want}")
        if x.dtype != (torch.float32 if name in ("lse", "delta") else qkv.dtype):
            raise ValueError(f"{where}: {name} has dtype {x.dtype}")


def _check_aligned(where, **tensors):
    """The bf16 kernels copy 16-byte pieces: raise on a bf16 CUDA operand
    that does not start on a 16-byte boundary."""
    for name, x in tensors.items():
        if x.dtype == torch.bfloat16 and x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{where}: the bf16 kernel copies 16-byte pieces; {name} must be "
                             "16-byte aligned")


def _raise_on(err: int, where: str) -> None:
    if err:
        raise RuntimeError(f"{where}: kernel launch failed with cudaError {err}")


def _pad_d(x: torch.Tensor, kd: int) -> torch.Tensor:
    """Zero-pad the trailing head dim of ``x`` to ``kd``."""
    return torch.nn.functional.pad(x, (0, kd - x.shape[-1]))


def flash_qkv_fwd(qkv, causal: bool, block_q: int, block_k: int):
    """Flash forward of the stacked ``(3, B, H, T, D)`` operand -> ``(out
    (B, H, T, D), lse (B, H, 1, T) f32)``. CPU tensors: :func:`_fwd_plain`;
    CUDA tensors: ``rkt_flash_qkv_fwd`` or raise, at a D that is not
    compiled on heads zero-padded to ``kernel_dim(D)`` (out sliced back)."""
    _check_causal_blocks(block_q, block_k, causal, "flash_qkv_fwd")
    if qkv.device.type == "cpu":
        return _fwd_plain(qkv, causal, block_q, block_k)
    d = qkv.shape[-1]
    if flash_supported(d) and d not in HEAD_DIMS:
        out, lse = _fwd_launch(_pad_d(qkv, kernel_dim(d)), causal, block_q, block_k, d)
        return out[..., :d].contiguous(), lse
    return _fwd_launch(qkv, causal, block_q, block_k, d)


def _fwd_launch(qkv, causal, block_q, block_k, true_d):
    """Launch (or, on meta tensors, record) ``rkt_flash_qkv_fwd`` at the
    compiled head dim of ``qkv`` with the scale of ``true_d``."""
    _check("flash_qkv_fwd", qkv, block_q, block_k)
    _check_aligned("flash_qkv_fwd", qkv=qkv)
    _, b, h, t, d = qkv.shape
    out = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, 1, t), dtype=torch.float32, device=qkv.device)
    if qkv.device.type == "meta":
        record([qkv_launch("fwd", b, h, t, d, qkv.dtype, block_q, block_k, causal)],
               (qkv,), (out, lse))
        return out, lse
    err = _lib().rkt_flash_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, t, d, block_q, block_k,
        _LOG2E / math.sqrt(true_d), int(causal), DTYPE_CODES[qkv.dtype], stream_of(qkv),
    )
    _raise_on(err, "flash_qkv_fwd")
    flash_qkv_fwd.launches += 1
    return out, lse


def flash_qkv_bwd(qkv, out, lse, dout, delta, causal: bool, block_q: int, block_k: int):
    """Fused backward -> ``(dq partials (T / block_k, B, H, T, D), dk, dv
    (B, H, T, D))`` in the operand dtype. CPU tensors: :func:`_bwd_plain`;
    CUDA tensors: ``rkt_flash_qkv_bwd`` or raise, at a D that is not
    compiled on zero-padded heads (the results sliced back)."""
    _check_causal_blocks(block_q, block_k, causal, "flash_qkv_bwd")
    if qkv.device.type == "cpu":
        return _bwd_plain(qkv, out, lse, dout, delta, causal, block_q, block_k)
    d = qkv.shape[-1]
    if flash_supported(d) and d not in HEAD_DIMS:
        kd = kernel_dim(d)
        grads = _bwd_launch(_pad_d(qkv, kd), _pad_d(dout, kd), lse, delta, causal, block_q,
                            block_k, d)
        return tuple(g[..., :d].contiguous() for g in grads)
    return _bwd_launch(qkv, dout, lse, delta, causal, block_q, block_k, d)


def _bwd_launch(qkv, dout, lse, delta, causal, block_q, block_k, true_d):
    """Launch (or record) ``rkt_flash_qkv_bwd`` at the compiled head dim of
    ``qkv`` with the scales of ``true_d``."""
    _check("flash_qkv_bwd", qkv, block_q, block_k, dout=dout, lse=lse, delta=delta)
    _check_aligned("flash_qkv_bwd", qkv=qkv, dout=dout)
    _, b, h, t, d = qkv.shape
    # Every partial is written by the kernel (zeros where causal skips a
    # tile), so the buffer needs no clearing.
    dqp = torch.empty((t // block_k, b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    dk = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    dv = torch.empty_like(dk)
    if qkv.device.type == "meta":
        record([qkv_launch("bwd", b, h, t, d, qkv.dtype, block_q, block_k, causal)],
               (qkv, dout, lse, delta), (dqp, dk, dv))
        return dqp, dk, dv
    err = _lib().rkt_flash_qkv_bwd(
        qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqp.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, t, d, block_q, block_k, 1.0 / math.sqrt(true_d),
        _LOG2E / math.sqrt(true_d), int(causal), DTYPE_CODES[qkv.dtype], stream_of(qkv),
    )
    _raise_on(err, "flash_qkv_bwd")
    flash_qkv_bwd.launches += 1
    return dqp, dk, dv


flash_qkv_fwd.launches = 0
flash_qkv_bwd.launches = 0


# -- autograd ---------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The reference's ``custom_vjp``: the backward is delta in f32, the
    backward kernel, and its dq partials summed in f32 (``_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, causal, blocks):
        out, lse = flash_qkv_fwd(qkv, causal, blocks[0], blocks[1])
        ctx.save_for_backward(qkv, out, lse)
        ctx.cfg = (causal, blocks[2], blocks[3])
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        causal, bq, bk = ctx.cfg
        dout = dout.contiguous()
        delta = (out.float() * dout.float()).sum(-1).unsqueeze(2)
        dqp, dk, dv = flash_qkv_bwd(qkv, out, lse, dout, delta, causal, bq, bk)
        dq = dqp[0] if dqp.shape[0] == 1 else dqp.float().sum(0).to(qkv.dtype)
        return torch.stack([dq, dk, dv]), None, None


def _resolve_blocks(t: int, d: int, causal: bool, block_q: int, block_k: int):
    tiles = tiles_for(d)
    for block in (block_q, block_k):
        if block in TILES and block not in tiles:
            raise ValueError(
                f"flash_attention: tile {block} is not compiled at head dim {kernel_dim(d)} "
                f"(compiled there: {tiles})"
            )
    bq = pick_block(t, min(block_q, t), d)
    bk = pick_block(t, min(block_k, t), d)
    if t % _T_MULTIPLE or bq is None or bk is None:
        raise ValueError(
            f"flash_attention: seq len {t} must be a multiple of a supported block size "
            f"({_T_MULTIPLE}); use the plain attention path for ragged shapes."
        )
    if causal:
        # Diagonal-tile masking needs aligned square tiles.
        bq = bk = min(bq, bk)
    return bq, bk


def resolve_tuned_blocks(t: int, d: int, h: int, h_kv: int, dtype, causal: bool,
                         block_q, block_k, bwd_block_q, bwd_block_k) -> tuple:
    """(block_q, block_k, bwd_block_q, bwd_block_k) with ``None`` arguments
    resolved through the ``flash_fwd`` / ``flash_bwd`` tune tables and
    :func:`default_block` as the fallback: the backward falls back to the
    resolved forward blocks. Explicit arguments win, and a caller that
    pinned both forward blocks gets those blocks in the backward too, with
    no table read (pinned A/Bs run exactly the blocks they name). All four
    are then clamped to tiles compiled at D dividing T; a pinned or tuned
    tile that the library compiles at another D only raises."""
    from rocket_tpu_torch.tune import get_config

    shape = {"t": t, "d": d, "h": h, "h_kv": h_kv, "causal": causal}
    fallback = default_block(d)
    fwd_pinned = block_q is not None and block_k is not None
    if not fwd_pinned:
        config = get_config("flash_fwd", shape=shape, dtype=dtype) or {}
        if block_q is None:
            block_q = config.get("block_q", fallback)
        if block_k is None:
            block_k = config.get("block_k", fallback)
    bq, bk = _resolve_blocks(t, d, causal, block_q, block_k)
    if bwd_block_q is None or bwd_block_k is None:
        config = {} if fwd_pinned else (get_config("flash_bwd", shape=shape, dtype=dtype) or {})
        if bwd_block_q is None:
            bwd_block_q = config.get("block_q", bq)
        if bwd_block_k is None:
            bwd_block_k = config.get("block_k", bk)
    bbq, bbk = _resolve_blocks(t, d, causal, bwd_block_q, bwd_block_k)
    return bq, bk, bbq, bbk


def flash_attention_qkv(qkv: torch.Tensor, causal: bool = True,
                        block_q: Optional[int] = None, block_k: Optional[int] = None,
                        bwd_block_q: Optional[int] = None,
                        bwd_block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention on a stacked ``(3, B, H, T, D)`` q/k/v tensor ->
    ``(B, H, T, D)``. Differentiable: the gradient is the stacked ``(3, B,
    H, T, D)`` cotangent, from the fused one-pass backward kernel. Blocks
    come from the tune tables for this card / shape / dtype unless given
    (:func:`resolve_tuned_blocks`)."""
    if qkv.dim() != 5 or qkv.shape[0] != 3:
        raise ValueError(
            f"flash_attention_qkv: expected stacked (3, B, H, T, D), got {tuple(qkv.shape)}; "
            "for separate q/k/v use flash_attention()."
        )
    _, _, h, t, d = qkv.shape
    if not flash_supported(d):
        raise ValueError(f"flash_attention_qkv: head dim {d} has no kernel (D <= "
                         f"{HEAD_DIMS[-1]}; compiled: {HEAD_DIMS})")
    blocks = resolve_tuned_blocks(t, d, h, h, qkv.dtype, causal, block_q, block_k,
                                  bwd_block_q, bwd_block_k)
    return _Flash.apply(qkv.contiguous(), causal, blocks)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise (flash) attention for ``(B, H, T, D)`` operands, through
    :func:`flash_attention_qkv` on their stack. T must be a multiple of 128;
    causal requires ``t_q == t_kv``. Softmax statistics and accumulators are
    f32 whatever the input dtype."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("flash_attention: causal requires t_q == t_kv.")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention: q, k, v must share one shape (cross-attention with "
            "t_q != t_kv goes through the plain attention path)."
        )
    return flash_attention_qkv(torch.stack([q, k, v]), causal=causal, block_q=block_q,
                               block_k=block_k)


# -- the mesh seams ----------------------------------------------------------------------------

#: The mesh axes bound by the stage bodies being run (process-wide, as the
#: tensor-parallel context: a CUDA backward runs on autograd's thread).
_MANUAL: list = []


@contextlib.contextmanager
def manual_axes(axis_names):
    """Mark ``axis_names`` bound for the block, whose operands are then
    the rank's own (the reference's ``shard_map`` body)."""
    _MANUAL.append(tuple(axis_names))
    try:
        yield
    finally:
        _MANUAL.pop()


def in_manual_axes(axis_names) -> bool:
    """True inside a :func:`manual_axes` block that binds any of
    ``axis_names``: there the operands are already the rank's own local
    tensors and the kernel is called directly."""
    bound = {name for names in _MANUAL for name in names}
    return any(name in bound for name in axis_names)


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of ``mesh``: a dict, a Runtime (``.mesh``) or a
    mesh with a ``shape`` dict."""
    if isinstance(mesh, dict):
        return mesh
    shape = getattr(mesh, "mesh", None)
    if isinstance(shape, dict):
        return shape
    return dict(getattr(mesh, "shape", {}))


def shardable_axes(mesh, b: int, h: int, batch_axes=("data",), head_axis: Optional[str] = "model"):
    """``(batch axes tuple | None, head axis | None)`` usable by the seam,
    the reference's drop rule: axes of ``mesh`` larger than 1 that divide
    the global batch ``b`` (all of them together) and the head count ``h``.
    An absent axis, an axis of size 1 or one that does not divide is
    dropped."""
    shape = _mesh_shape(mesh)
    baxes = tuple(a for a in batch_axes if int(shape.get(a, 1)) > 1)
    bsize = 1
    for a in baxes:
        bsize *= int(shape[a])
    if not baxes or b % bsize:
        baxes = None
    haxis = head_axis if head_axis is not None and int(shape.get(head_axis, 1)) > 1 else None
    if haxis is not None and h % int(shape[haxis]):
        haxis = None
    return baxes, haxis


def flash_attention_qkv_sharded(qkv: torch.Tensor, causal: bool = True, *, mesh,
                                batch_axes=("data",), head_axis: Optional[str] = "model",
                                block_q: Optional[int] = None,
                                block_k: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_qkv` on this rank's shard of the stacked
    ``(3, B, H, T, D)`` operand -> its shard of ``(B, H, T, D)``: the batch
    is the rank's stripe, and where ``head_axis`` is usable (the heads
    ``H · size`` of the whole operand divide it) the heads are the rank's
    own. Each ``(b, h)`` pair is an independent softmax, so the kernel runs
    on the local shard with no communication; the sequence stays whole
    (sequence parallelism is ring attention's job)."""
    if qkv.dim() != 5 or qkv.shape[0] != 3:
        raise ValueError(f"flash_attention_qkv_sharded: expected stacked (3, B, H, T, D), "
                         f"got {tuple(qkv.shape)}")
    return flash_attention_qkv(qkv, causal=causal, block_q=block_q, block_k=block_k)
