"""The attention half of a transformer block in one kernel (counterpart of
``rocket_tpu/ops/fused_block.py``)::

    ln1(x) -> qkv projection -> per-head causal softmax attention
           [-> output projection + bias]                  (the epilogue)

``epilogue="fused"`` folds the output projection into the launch;
``"separate"`` stops at the attention output ``(B, T, H*64)`` — the shape
train-mode attention dropout needs, since dropout sits between the
attention core and the projection (``models/transformer.Block`` forces it
there).

* :func:`reference_block_attn` is the plain PyTorch composition, op for op
  the reference's (``LayerNorm`` + fused-QKV attention on the plain path).
* :func:`fused_block` is the kernel wrapper: CPU tensors take
  :func:`fused_block_plain`; CUDA tensors launch ``csrc/fused_block.cu``
  (counted in ``fused_block.launches``) or raise; meta tensors record the
  launch (:func:`fused_block_launch`). Its operands are already in the
  compute dtype: ``ln`` (2, D) f32, weights and biases in x's dtype.
* :func:`block_attn_half` is the differentiable entry point, a
  ``torch.autograd.Function``: its forward casts the layer's f32 masters
  and runs :func:`fused_block`; its backward recomputes through
  :func:`reference_block_attn` under autograd from the saved inputs,
  exactly as the reference's custom VJP does. That backward is the
  reference's own design, not a fallback: the JAX package has no backward
  kernel for this function, so gradients are the plain path's by
  construction and the fusion buys the forward its single launch.

bf16 operands run on the tensor cores (``mma.sync``; every operand must
start 16-byte aligned, which the wrapper checks), f32 operands on the CUDA
cores. The CUDA kernel takes head dim 64 only (every preset's) and T up to
:data:`MAX_T` (its K and V stay in shared memory); the fused epilogue
runs the heads of one batch row as a thread-block cluster, so it takes at
most :data:`MAX_FUSED_HEADS` heads. :func:`kernel_supported` states these
limits, and the model's gate checks them beside
:func:`block_attn_supported`. ``block_b`` is the TPU grid's batch tile: it
is checked as the reference checks it, and the CUDA kernel's result does
not depend on it (one CTA per head and batch row).
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

__all__ = [
    "EPILOGUES", "MAX_T", "MAX_FUSED_HEADS", "block_attn_half", "block_attn_supported",
    "kernel_supported", "fused_block", "fused_block_plain", "reference_block_attn",
    "fused_block_launch", "launch_info", "occupancy",
]

EPILOGUES = ("fused", "separate")
#: Head dim the kernel is compiled for.
HEAD_DIM = 64
#: Largest T whose K and V fit in one CTA's shared memory
#: (``kMaxT`` in ``csrc/fused_block.cu``).
MAX_T = 320
#: Most heads of the fused epilogue: one portable thread-block cluster
#: per batch row (``kMaxClusterHeads``).
MAX_FUSED_HEADS = 8
#: Threads per CTA, rows per tile and the reduction depth of one projection
#: step (``kThreads``, ``kTile`` and ``kChunk`` of the kernel).
THREADS, ROW_TILE, CHUNK = 128, 64, 32


def block_attn_supported(b: int, t: int, d: int, num_heads: int, block_b: int) -> bool:
    """The reference's shape gate: batch tiles exactly, heads split the
    width, the head dim is a multiple of 8 and T >= 2."""
    if num_heads <= 0 or d % num_heads:
        return False
    return b % block_b == 0 and (d // num_heads) % 8 == 0 and t >= 2


def kernel_supported(t: int, d: int, num_heads: int, epilogue: str = "fused") -> bool:
    """What the CUDA kernel takes: head dim :data:`HEAD_DIM`, ``T <=
    MAX_T`` and, fused, at most :data:`MAX_FUSED_HEADS` heads."""
    if num_heads <= 0 or d != num_heads * HEAD_DIM or not 1 <= t <= MAX_T:
        return False
    return epilogue != "fused" or num_heads <= MAX_FUSED_HEADS


def reference_block_attn(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, *, num_heads: int,
                         eps: float = 1e-5, causal: bool = True, epilogue: str = "fused"):
    """The per-op composition the kernel is held to, and the backward's
    recompute: ``LayerNorm`` then fused-QKV attention, minus dropout (the
    call site keeps it outside). Weights may be f32 masters; they are cast
    to x's dtype at use."""
    b, t, d = x.shape
    hd = d // num_heads
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * ln_scale
    if ln_bias is not None:
        xn = xn + ln_bias
    xn = xn.to(x.dtype)
    qkv = xn @ wqkv.to(x.dtype)
    if bqkv is not None:
        qkv = qkv + bqkv.to(x.dtype)
    hw = num_heads * hd
    q, k, v = (qkv[..., i * hw:(i + 1) * hw].reshape(b, t, num_heads, hd).transpose(1, 2)
               for i in range(3))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)
    out = out.transpose(1, 2).reshape(b, t, hw)
    if epilogue == "separate":
        return out
    y = out @ wproj.to(x.dtype)
    if bproj is not None:
        y = y + bproj.to(x.dtype)
    return y


def fused_block_plain(x, ln, wqkv, bqkv, wproj, bproj, *, num_heads: int, eps: float = 1e-5,
                      causal: bool = True, epilogue: str = "fused"):
    """Plain version with the kernel's signature (``ln`` stacked (2, D))."""
    return reference_block_attn(x, ln[0], ln[1], wqkv, bqkv, wproj, bproj, num_heads=num_heads,
                                eps=eps, causal=causal, epilogue=epilogue)


#: The bf16 (tensor-core) kernel's row padding of its bf16 tiles, the
#: widest product's columns (q | k | v of one head) and the output columns
#: of one fused-epilogue product (``kPad``, ``kMaxCols`` and ``kOutCols``).
TC_PAD, TC_COLS, TC_OUT_COLS = 8, 3 * HEAD_DIM, 128


def _smem_bytes(t: int, dtype) -> int:
    """Dynamic shared memory of the ``dtype`` kernel at sequence length t.
    bf16 (``tc::smem_bytes``): K and V of every row (rounded up to whole
    tiles) as bf16 at row stride 72, two (64, 32) A stages and two (32,
    192) weight stages (the q tile reuses them) at padded strides, and two
    f32 per-row statistics. f32 (``block_smem_bytes``): K, V, the q tile
    and the work tile as f32 with row stride 65, and the statistics."""
    rows = -(-t // ROW_TILE) * ROW_TILE
    if dtype == torch.bfloat16:
        return 2 * (2 * rows * (HEAD_DIM + TC_PAD) + 2 * ROW_TILE * (CHUNK + TC_PAD)
                    + 2 * CHUNK * (TC_COLS + TC_PAD)) + 4 * 2 * ROW_TILE
    ld = HEAD_DIM + 1
    return 4 * (2 * rows * ld + 2 * ROW_TILE * ld + 2 * ROW_TILE)


def _out_cols(d: int, dtype) -> tuple:
    """Column widths of the fused epilogue's products: (64,) for f32; for
    bf16 128-column blocks and a 64-column rest."""
    if dtype != torch.bfloat16:
        return (HEAD_DIM,)
    return (TC_OUT_COLS,) * (d // TC_OUT_COLS) + (HEAD_DIM,) * (d % TC_OUT_COLS // HEAD_DIM)


def fused_block_work(b: int, t: int, d: int, num_heads: int, dtype,
                     epilogue: str = "fused") -> tuple:
    """``(bytes, flops)`` of the fused block as a function: x read and the
    output written once, the weights it uses read once (the LayerNorm's in
    f32); 2 flops per multiply-add of the QKV projection, the causal QK^T
    and PV products and, fused, the output projection."""
    item = itemsize(dtype)
    weights = (d * 3 * d + 3 * d) * item + 2 * d * 4
    flops = 2 * b * t * d * 3 * d + 2 * 2 * HEAD_DIM * num_heads * b * t * (t + 1) / 2
    if epilogue == "fused":
        weights += (d * d + d) * item
        flops += 2 * b * t * d * d
    return 2 * b * t * d * item + weights, flops


def fused_block_launch(b: int, t: int, d: int, num_heads: int, dtype,
                       epilogue: str = "fused") -> LaunchFact:
    """The launch of :func:`fused_block`: one CTA per (head, batch row). It
    reads whole (64, D) row tiles of x for the LayerNorm statistics and
    (64, 32) chunks of them beside (32, 64) chunks of its head's Wqkv
    columns for the projections, and writes (64, 64) tiles of its head's
    output; the fused epilogue then reads (64, 32) chunks of all heads
    beside (32, n) chunks of Wproj and writes (64, n) tiles of the output,
    n as :func:`_out_cols`."""
    hw = num_heads * HEAD_DIM
    tiles = (
        tile(ROW_TILE, d, dtype, t, d), tile(ROW_TILE, CHUNK, dtype, t, d),
        tile(2, CHUNK, torch.float32, 2, d), tile(CHUNK, HEAD_DIM, dtype, d, 3 * hw),
        tile(1, HEAD_DIM, dtype, 1, 3 * hw), tile(ROW_TILE, HEAD_DIM, dtype, t, hw),
    )
    if epilogue == "fused":
        tiles += (tile(ROW_TILE, CHUNK, dtype, t, hw),)
        for n in sorted(set(_out_cols(d, dtype)), reverse=True):
            tiles += (tile(CHUNK, n, dtype, hw, d), tile(1, n, dtype, 1, d),
                      tile(ROW_TILE, n, dtype, t, d))
    fact = LaunchFact("fused_block", (num_heads, b, 1), THREADS, _smem_bytes(t, dtype), 0, tiles)
    # LayerNorm moments, the products and the softmax in f32.
    return with_work(fact, *fused_block_work(b, t, d, num_heads, dtype, epilogue), dtype,
                     acc=torch.float32)


def launch_info(b: int, t: int, num_heads: int, epilogue: str, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of the launch as the
    built library reports it (needs the card)."""
    fn = _build.load("fused_block").rkt_fused_block_launch_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    return query_launch(fn, b, t, num_heads, int(epilogue == "fused"), DTYPE_CODES[dtype])


def _lib():
    lib = _build.load("fused_block")
    fn = lib.rkt_fused_block
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return fn


def occupancy(t: int, epilogue: str, dtype) -> int:
    """Resident CTAs per SM of the (dtype, epilogue) kernel at sequence
    length t, as the card reports it (-1 when it refuses). Needs the card."""
    fn = _build.load("fused_block").rkt_fused_block_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(t, int(epilogue == "fused"), DTYPE_CODES[dtype])


def kernel_limits() -> tuple:
    """``(MAX_T, MAX_FUSED_HEADS)`` as the built kernel reports them."""
    lib = _build.load("fused_block")
    return lib.rkt_fused_block_max_t(), lib.rkt_fused_block_max_fused_heads()


def fused_block(x, ln, wqkv, bqkv, wproj, bproj, *, num_heads: int, eps: float = 1e-5,
                causal: bool = True, epilogue: str = "fused"):
    """The kernel: ``x`` (B, T, D), ``ln`` (2, D) f32 (scale, bias),
    ``wqkv`` (D, 3*H*64), ``bqkv`` (3*H*64,), ``wproj`` (H*64, D), ``bproj``
    (D,), all but ``ln`` in x's dtype -> (B, T, D) fused or (B, T, H*64)
    separate. CPU tensors: :func:`fused_block_plain`; CUDA tensors:
    ``csrc/fused_block.cu`` or raise; meta tensors record the launch."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"fused_block: unknown epilogue {epilogue!r}")
    if x.device.type == "cpu":
        return fused_block_plain(x, ln, wqkv, bqkv, wproj, bproj, num_heads=num_heads, eps=eps,
                                 causal=causal, epilogue=epilogue)
    check_cuda_operands("fused_block", x=x, ln=ln, wqkv=wqkv, bqkv=bqkv, wproj=wproj,
                        bproj=bproj)
    b, t, d = x.shape
    hw = d
    if x.dtype not in DTYPE_CODES or ln.dtype != torch.float32 or any(
            w.dtype != x.dtype for w in (wqkv, bqkv, wproj, bproj)):
        raise ValueError(f"fused_block: x in {list(DTYPE_CODES)}, ln float32 and the weights "
                         f"in x's dtype, got x {x.dtype}, ln {ln.dtype}, weights "
                         f"{[str(w.dtype) for w in (wqkv, bqkv, wproj, bproj)]}")
    if (ln.shape != (2, d) or wqkv.shape != (d, 3 * hw) or bqkv.shape != (3 * hw,)
            or wproj.shape != (hw, d) or bproj.shape != (d,)):
        raise ValueError(f"fused_block: operand shapes for D={d}: ln {tuple(ln.shape)}, wqkv "
                         f"{tuple(wqkv.shape)}, bqkv {tuple(bqkv.shape)}, wproj "
                         f"{tuple(wproj.shape)}, bproj {tuple(bproj.shape)}")
    if not kernel_supported(t, d, num_heads, epilogue):
        raise ValueError(f"fused_block: the kernel takes head dim {HEAD_DIM}, T <= {MAX_T} and, "
                         f"fused, at most {MAX_FUSED_HEADS} heads; got T={t} D={d} "
                         f"H={num_heads} {epilogue}")
    if x.dtype == torch.bfloat16 and any(
            op.data_ptr() % 16 for op in (x, ln, wqkv, bqkv, wproj, bproj)):
        raise ValueError("fused_block: the bf16 kernel copies 16-byte pieces; every operand "
                         "must start 16-byte aligned")
    fused = epilogue == "fused"
    heads = torch.empty((b, t, hw), dtype=x.dtype, device=x.device)
    out = torch.empty((b, t, d), dtype=x.dtype, device=x.device) if fused else heads
    if x.device.type == "meta":
        record([fused_block_launch(b, t, d, num_heads, x.dtype, epilogue)],
               (x, ln, wqkv, bqkv, wproj, bproj), (out,))
        return out
    err = _lib()(
        x.data_ptr(), ln.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), heads.data_ptr(), out.data_ptr(), b, t, d, num_heads, eps,
        1.0 / math.sqrt(d // num_heads), int(causal), int(fused), DTYPE_CODES[x.dtype],
        stream_of(x),
    )
    if err:
        raise RuntimeError(f"fused_block: kernel launch failed with cudaError {err}")
    fused_block.launches += 1
    return out


fused_block.launches = 0


class _BlockAttnHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, cfg):
        dt = x.dtype
        ln = torch.stack([ln_s.float(), ln_b.float()])
        y = fused_block(x.contiguous(), ln, *(w.to(dt).contiguous()
                                               for w in (wqkv, bqkv, wproj, bproj)), **cfg)
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
        ctx.cfg = cfg
        return y

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            y = reference_block_attn(*inputs, **ctx.cfg)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy, allow_unused=True))
        return (*(next(grads) if n else None for n in needs), None)


def block_attn_half(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, *, num_heads: int,
                    eps: float = 1e-5, causal: bool = True, epilogue: str = "fused",
                    block_b: int = 1):
    """Fused ln1 + QKV + attention (+ projection) for ``x`` (B, T, D), with
    the layer's own parameters (f32 masters are cast to x's dtype here, as
    ``Dense`` does): ``wqkv`` (D, 3*H*Dh) in its fused ``[q | k | v]``
    column layout, ``wproj`` (H*Dh, D); biases required. Returns (B, T, D)
    with ``epilogue="fused"`` or the pre-projection (B, T, H*Dh) attention
    output with ``"separate"``. Differentiable (see the module docstring)."""
    if epilogue not in EPILOGUES:
        raise ValueError(
            f"block_attn_half: unknown epilogue {epilogue!r} — the table is ahead of the "
            f"implementation (expected one of {EPILOGUES})"
        )
    b, t, d = x.shape
    if not block_attn_supported(b, t, d, num_heads, block_b):
        raise ValueError(
            f"block_attn_half: unsupported shape B={b} T={t} D={d} H={num_heads} "
            f"block_b={block_b}"
        )
    cfg = {"num_heads": num_heads, "eps": eps, "causal": causal, "epilogue": epilogue}
    return _BlockAttnHalf.apply(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, cfg)
