"""Fused train-mode BatchNorm + activation — the conv stack's epilogue
(counterpart of ``rocket_tpu/ops/fused_conv.py``).

One program computes the per-channel moments of the flattened activation
``x2`` (N, C) and the normalise + scale + bias [+ relu] epilogue, with
``stats`` (C, 2) f32 = [mean, E[x^2]] for the running averages. Two
schedules, the reference's:

* ``"twopass"``: the moments and the epilogue both in the kernel
  (:func:`bn_twopass`, ``csrc/fused_conv.cu``'s ``rkt_bn_twopass``: one
  cooperative launch, its phases split by grid barriers);
* ``"stats_xla"``: the moments are the plain stacked reduction outside the
  kernel (:func:`moments`) and the kernel only normalises
  (:func:`bn_normalize`, ``rkt_bn_normalize``).

Each kernel wrapper takes its plain version for CPU tensors (the
counterpart of the reference's interpret mode) and, for CUDA tensors,
launches the kernel or raises; each counts its launches in
``<wrapper>.launches``. On ``meta`` tensors a wrapper records its launches
(:func:`bn_launches`) and launches nothing.

:func:`fused_bn_act` is the differentiable entry point, a
``torch.autograd.Function``: the forward is the kernel, the backward the
reference's plain fused BN backward (``_bn_act_bwd``, ``:240-258``: one
stacked (C, 2) reduction gives d_bias, d_scale and dx, with the relu mask
taken from ``x̂·scale + bias > 0``). That backward is the reference's own
design, not a fallback: the JAX package has no backward kernel for this
function. The stats output carries no gradient (callers detach it for the
running averages, as the reference stops its gradient).

The CUDA kernels take what the reference's kernel takes: any C and f32,
bf16 or f16 (:func:`kernel_supported`). Rows of whole 16-byte vectors (C,
and the chunk's offset, a multiple of 16 bytes' elements) run the vec form,
anything else the any form (``csrc/fused_conv.cu``); an activation wider
than :data:`MAX_C` runs as channel chunks of at most ``MAX_C``, one launch
each, rows ``C`` apart (:func:`chunks`). Only float64 raises on a CUDA
tensor: the TPU kernel never ran it. The call-site gate
(``nn/layers.bn_act_train``) is the reference's shape gate
:func:`fused_bn_act_supported` alone. ``block_rows`` is the TPU
grid's row tile: it is checked as the reference checks it, and the CUDA
kernels' result does not depend on it. The same :class:`BnAct` Function
with ``schedule="plain"`` is ``nn/layers._bn_train``, the seam's default.
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
    sm_count,
    stream_of,
    tile,
    with_work,
)

__all__ = [
    "SCHEDULES", "MAX_C", "BnAct", "fused_bn_act", "fused_bn_act_supported",
    "kernel_supported", "reference_bn_act", "moments", "epilogue_rows", "bn_backward",
    "bn_twopass", "bn_twopass_plain", "bn_normalize", "bn_normalize_plain", "bn_launches",
    "slab_smem", "launch_info", "resident", "chunks", "vec_form", "BN_DTYPE_CODES",
    "bn_chunk_launches",
]

#: Sublane minimum per itemsize — the reference's ``_SUBLANE``.
_SUBLANE = {4: 8, 2: 16, 1: 32}

SCHEDULES = ("twopass", "stats_xla")
#: Widest channel count of one launch (``kMaxC`` in ``csrc/fused_conv.cu``);
#: a wider activation runs as chunks of at most this many channels.
MAX_C = 2048
#: Operand types of these kernels and their code in their C ABI (f16 beside
#: the shared f32 and bf16 codes).
BN_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Launch geometry of both kernels, all chosen here (:func:`_grids`). Row 9
#: runs at most MOMENT_CTAS CTAs (two per SM of an H100, all resident at
#: once) of at least MOMENT_MIN_ROWS rows each. It is a constant, not read
#: from the card: the grid fixes the slabs and so the order in which the
#: partial sums add, so the same input gives the same bits on any card.
#: Row 10 is a grid-stride loop of THREADS-thread CTAs (``kThreads``), up to
#: NORM_CTAS_PER_SM per SM.
MOMENT_CTAS, MOMENT_MIN_ROWS = 264, 64
THREADS, NORM_CTAS_PER_SM = 256, 8
#: The loads each thread of row 9 keeps in flight: vectors of its moments
#: pass, whose last step stays in registers, and of its normalise pass
#: (``kInFlight``, ``kNormUnroll``).
IN_FLIGHT, NORM_UNROLL = 16, 4
#: Hopper's shared memory (``kSmemPerSm``, ``kSmemReserved``,
#: ``kSmemOptIn``): what an SM holds for its resident CTAs, what the card
#: reserves of it per CTA, and the most one CTA may opt into.
SM_SMEM, CTA_RESERVED, SMEM_OPT_IN = 233_472, 1024, 232_448


def fused_bn_act_supported(n: int, block_rows: int, itemsize: int) -> bool:
    """The reference's shape gate: the flattened activation tiles
    ``block_rows`` exactly."""
    sub = _SUBLANE.get(itemsize, 8)
    return block_rows % sub == 0 and n % block_rows == 0


def kernel_supported(c: int, dtype: torch.dtype) -> bool:
    """What the CUDA kernels take: f32, bf16 or f16, any C >= 1 (past
    :data:`MAX_C` in chunks)."""
    return dtype in BN_DTYPE_CODES and c >= 1


def chunks(c: int) -> list:
    """``(first channel, width)`` of each launch over C channels: one for C
    <= :data:`MAX_C`, else runs of ``MAX_C`` and the rest."""
    return [(k, min(MAX_C, c - k)) for k in range(0, c, MAX_C)]


def vec_form(width: int, ld: int, offset: int, dtype, ptr: int = 0) -> bool:
    """Whether a launch over ``width`` channels of rows ``ld`` apart,
    starting ``offset`` channels in, takes the vec form (whole 16-byte
    vectors: ``width``, ``ld`` and the start a multiple of 16 bytes'
    elements; ``ptr`` the operand's address on the card, 0 on meta)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    item = 16 // vec
    return width % vec == 0 and ld % vec == 0 and (ptr + offset * item) % 16 == 0


def reference_bn_act(x, scale, bias, eps: float, act: bool):
    """The composition the fused kernel is measured against:
    ``nn/layers._bn_train`` followed by relu. Bitwise the seam's default
    path."""
    from rocket_tpu_torch.nn.layers import _bn_train, relu_fn

    y, stats = _bn_train(x, scale, bias, eps)
    if act:
        y = relu_fn(y)
    return y, stats


# -- plain versions -----------------------------------------------------------


def moments(x2: torch.Tensor) -> torch.Tensor:
    """(C, 2) f32 [mean, E[x^2]] over the rows of ``x2``, one mean per
    moment: the two means the reference's moment reduction computes (its
    ``"separate"`` form; the ``"stacked"`` default takes both in one
    reduction over a stacked (N, C, 2) array)."""
    xf = x2.float()
    return torch.stack([xf.mean(0), xf.square().mean(0)], dim=-1)


def epilogue_rows(stats, scale, bias, eps: float) -> torch.Tensor:
    """The (4, C) f32 rows the epilogue reads from the stats: mean, inv =
    rsqrt(max(E[x^2] - mean^2, 0) + eps), inv*scale, bias."""
    mean = stats[:, 0]
    var = torch.clamp(stats[:, 1] - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    return torch.stack([mean, inv, inv * scale.float(), bias.float()])


def bn_normalize_plain(x2, mi, *, act: bool):
    """``(x - mean) * (inv*scale) + bias`` [+ max(., 0)], the reference's
    ``_emit`` association, in f32, written in x's dtype."""
    y = (x2.float() - mi[0]) * mi[2] + mi[3]
    if act:
        y = torch.clamp(y, min=0.0)
    return y.to(x2.dtype)


def bn_twopass_plain(x2, sc, *, eps: float, act: bool):
    """Plain version of the two-pass kernel: ``sc`` (2, C) f32 = [scale,
    bias] -> (y, stats)."""
    stats = moments(x2)
    return bn_normalize_plain(x2, epilogue_rows(stats, sc[0], sc[1], eps), act=act), stats


# -- kernels ------------------------------------------------------------------


def _lib():
    lib = _build.load("fused_conv")
    if lib.rkt_bn_twopass.argtypes is None:
        lib.rkt_bn_twopass.restype = ctypes.c_int
        lib.rkt_bn_twopass.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rkt_bn_normalize.restype = ctypes.c_int
        lib.rkt_bn_normalize.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rkt_bn_launch_info.restype = ctypes.c_int
        lib.rkt_bn_launch_info.argtypes = [ctypes.c_int, ctypes.c_longlong] + [
            ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.rkt_bn_twopass_resident.restype = ctypes.c_int
        lib.rkt_bn_twopass_resident.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    return lib


def _grids(x2: torch.Tensor, width: int = 0) -> tuple:
    """(row 9's CTAs, row 10's CTAs) for ``width`` channels (default all)
    of ``x2`` (N, C) on its card."""
    n, c = x2.shape
    vectors = n * (width or c) * x2.element_size() // 16
    norm_ctas = sm_count(x2, "fused_conv") * NORM_CTAS_PER_SM
    return _twopass_ctas(n), max(1, min(norm_ctas, -(-vectors // THREADS)))


def _twopass_ctas(n: int) -> int:
    """Row 9's CTAs over N rows: at most MOMENT_CTAS, of at least
    MOMENT_MIN_ROWS rows each."""
    return max(1, min(MOMENT_CTAS, -(-n // MOMENT_MIN_ROWS)))


#: Static shared memory of every kernel: f32 rows of MAX_C channels (row
#: 9's ``buf[3 * kMaxC]``, row 10's ``row[3][kMaxC]``).
_STATIC_SMEM = 3 * 4 * MAX_C


def _step_rows(c: int, dtype) -> int:
    """Rows a row 9 CTA loads per step: IN_FLIGHT vectors a thread over its
    row groups (one vector a thread a row, two for f32 past 1024
    channels)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = min(c // vec, THREADS)
    return IN_FLIGHT // -(-(c // vec) // THREADS) * (THREADS // lanes)


def slab_smem(n: int, c: int, dtype, grid: int, sms: int) -> int:
    """Row 9's dynamic shared memory over ``grid`` CTAs on a card of
    ``sms`` SMs: of a CTA's ``ceil(n / grid)``-row slab before its last
    step (kept in registers), the whole rows that fit in its share of an
    SM beside its static rows, once ``ceil(grid / sms)`` CTAs are resident
    on each."""
    row = c * torch.empty((), dtype=dtype).element_size()
    rows = -(-n // grid)
    share = min(SM_SMEM // -(-grid // sms) - CTA_RESERVED, SMEM_OPT_IN) - _STATIC_SMEM
    return min(max(rows - _step_rows(c, dtype), 0), max(share, 0) // row) * row


def _stream(rows: int, cols: int, dtype, n: int, c: int) -> tuple:
    """A tile a CTA streams through 16-byte vectors or single elements
    (these kernels fill no tensor-core fragment): fewer rows than a
    fragment's are declared as the one-row vector read they are."""
    item = torch.empty((), dtype=dtype).element_size()
    if rows < {4: 8, 2: 16}.get(item, 8) and rows != n:
        rows = 1
    return tile(rows, cols, dtype, n, c)


def bn_work(kind: str, n: int, width: int, dtype) -> tuple:
    """``(bytes, flops)`` of one launch over ``width`` channels of N rows:
    x read once and y written once, plus scale/bias and stats
    (``"twopass"``) or the (4, C) rows (``"normalize"``), all bytes; 3
    flops per element for the moments (add, multiply, add), 3 for the
    epilogue (subtract, multiply, add) and 1 for the relu, at the f32 rate
    (the arithmetic is f32 for either operand type)."""
    xy = 2 * n * width * itemsize(dtype)
    if kind == "normalize":
        return xy + 4 * width * 4, 4.0 * n * width
    return xy + 2 * width * 4 + 2 * width * 4, 7.0 * n * width


def _launch_fact(kind: str, n: int, c: int, width: int, vec: bool, dtype, grid: int,
                 norm_grid: int, sms: int) -> LaunchFact:
    """One launch over ``width`` channels of an (N, C) activation, with its
    work (:func:`bn_work`)."""
    return with_work(_launch_geometry(kind, n, c, width, vec, dtype, grid, norm_grid, sms),
                     *bn_work(kind, n, width, dtype), torch.float32, acc=torch.float32,
                     # The moments' partials are combined in slab order; the
                     # kernel's atomicAdd is the grid barrier's integer
                     # arrival counter, not a float sum.
                     order="fixed")


def _launch_geometry(kind: str, n: int, c: int, width: int, vec: bool, dtype, grid: int,
                     norm_grid: int, sms: int) -> LaunchFact:
    f32 = torch.float32
    mi_rows = tile(4, width, f32, 4, width)
    if not vec:  # the any form: one element a load, a row's elements across the lanes
        x_row = _stream(1, width, dtype, n, c)
        if kind == "normalize":
            return LaunchFact("bn_normalize_any", (norm_grid, 1, 1), THREADS, 0, _STATIC_SMEM,
                              (mi_rows, x_row, x_row))
        cols = min(width, 32)
        return LaunchFact("bn_twopass_any", (grid, 1, 1), THREADS, 0, _STATIC_SMEM,
                          (x_row, tile(2 * grid, cols, f32, 2 * grid, width),
                           tile(cols, 2, f32, width, 2), tile(4, cols, f32, 4, width), mi_rows,
                           x_row, x_row))
    vec_elems = 16 // torch.empty((), dtype=dtype).element_size()
    step = THREADS * vec_elems
    if kind == "normalize":
        x_norm = _stream(max(1, step // width), min(width, step), dtype, n, c)
        return LaunchFact("bn_normalize", (norm_grid, 1, 1), THREADS, 0, _STATIC_SMEM,
                          (mi_rows, x_norm, x_norm))
    if sms <= 0:
        raise ValueError("bn_launches: row 9's shared memory needs the card's SM count")
    chunk = NORM_UNROLL * step
    x_out = _stream(max(1, min(n, chunk // width)), min(width, chunk), dtype, n, c)
    cols = min(width, 32)
    return LaunchFact("bn_twopass", (grid, 1, 1), THREADS,
                      slab_smem(n, width, dtype, grid, sms), _STATIC_SMEM,
                      (_stream(min(n, _step_rows(width, dtype)), width, dtype, n, c),
                       tile(2, width, f32, 2, width), tile(2 * grid, cols, f32, 2 * grid, width),
                       tile(cols, 2, f32, width, 2), tile(4, cols, f32, 4, width), mi_rows,
                       x_out, x_out))


def bn_chunk_launches(kind: str, n: int, c: int, dtype, sms: int, ptr: int = 0) -> list:
    """``(width, LaunchFact)`` of every launch of ``kind`` on an (N, C)
    activation at address ``ptr``, chunk by chunk (:func:`chunks`), on a
    card of ``sms`` SMs. The vec or any form follows ``ptr`` as the launch
    does: the meta route passes the view's byte offset into its storage
    (:func:`_address`), the caching allocator's blocks being 16-byte
    aligned."""
    item = torch.empty((), dtype=dtype).element_size()
    out = []
    for first, width in chunks(c):
        vectors = n * width * item // 16
        norm_grid = max(1, min(sms * NORM_CTAS_PER_SM, -(-vectors // THREADS)))
        vec = vec_form(width, c, first, dtype, ptr)
        out.append((width, _launch_fact(kind, n, c, width, vec, dtype, _twopass_ctas(n),
                                        norm_grid, sms)))
    return out


def bn_launches(kind: str, n: int, c: int, dtype, grid: int, norm_grid: int,
                sms: int = 0) -> list:
    """The launches of ``kind`` on ``x2`` (N, C) (packed, 16-byte aligned):
    ``"twopass"`` is row 9's one launch of ``grid`` CTAs a chunk on a card
    of ``sms`` SMs, ``"normalize"`` row 10's of ``norm_grid`` (over the
    whole C; a chunk of a wider C takes its own share).
    A row 9 CTA (vec form) splits each row of its slab among up to THREADS
    lanes, 16 bytes a lane, loads it in steps of IN_FLIGHT vectors a thread
    (:func:`_step_rows`) and writes a (2, C) partial; after a grid barrier it
    reads the partials of up to 32 channels and writes their stats and
    (4, C) rows; after another it stages mean, inv*scale and bias and
    streams its slab of x and y in chunks of NORM_UNROLL vectors of 16
    bytes a thread, the slab's first rows from shared memory
    (:func:`slab_smem`). Row 10 stages those rows and streams x and y one
    vector a thread a step. The any form (:func:`vec_form` false) does the
    same one element at a time, with no slab in shared memory."""
    if len(chunks(c)) > 1:
        if kind == "twopass" and sms <= 0:
            raise ValueError("bn_launches: row 9's shared memory needs the card's SM count")
        return [fact for _, fact in bn_chunk_launches(kind, n, c, dtype, sms)]
    return [_launch_fact(kind, n, c, c, vec_form(c, c, 0, dtype), dtype, grid, norm_grid, sms)]


_WHICH = {"bn_twopass": 0, "bn_normalize": 1, "bn_twopass_any": 2, "bn_normalize_any": 3}


def launch_info(name: str, n: int, c: int, grid: int, act: bool, dtype) -> tuple:
    """``(grid, threads, dynamic_smem, static_smem)`` of one kernel
    (``name`` a :func:`bn_launches` fact name) over ``grid`` CTAs on ``x2``
    (N, C) — for a chunk, C is its width — as the built library reports
    it (needs the card)."""
    return query_launch(_lib().rkt_bn_launch_info, _WHICH[name], n, c, grid, int(act),
                        BN_DTYPE_CODES[dtype])


def resident(n: int, c: int, dtype) -> int:
    """Row 9's resident CTAs per SM (vec form) on ``x2`` (N, C) over its
    grid, as the card reports them (its cooperative launch needs all of the
    grid resident at once); -1 when the card refuses it. Needs the card."""
    return _lib().rkt_bn_twopass_resident(n, c, _twopass_ctas(n), BN_DTYPE_CODES[dtype])


def _address(x2: torch.Tensor) -> int:
    """Where ``x2``'s first element lies for :func:`vec_form`: its address
    on the card, or on meta its byte offset into its storage."""
    if x2.device.type == "meta":
        return x2.storage_offset() * x2.element_size()
    return x2.data_ptr()


def _check(what: str, x2: torch.Tensor, **f32) -> None:
    check_cuda_operands(what, x2=x2, **f32)
    n, c = x2.shape
    if x2.dtype == torch.float64:
        raise ValueError(f"{what}: float64 x is not taken: the TPU kernel this ports never ran "
                         "f64 (f32, bf16 and f16 are)")
    if not kernel_supported(c, x2.dtype):
        raise ValueError(f"{what}: the kernel takes f32, bf16 or f16 x with C >= 1, got "
                         f"{x2.dtype} C={c}")
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")


def bn_twopass(x2, sc, *, eps: float, act: bool):
    """Row 9: ``x2`` (N, C), ``sc`` (2, C) f32 [scale, bias] -> (y (N, C) in
    x's dtype, stats (C, 2) f32). CPU tensors: :func:`bn_twopass_plain`;
    CUDA tensors: ``rkt_bn_twopass``, one cooperative launch a channel
    chunk (refused by a card that cannot hold all its CTAs at once), or
    raise; meta tensors record the launches."""
    if x2.device.type == "cpu":
        return bn_twopass_plain(x2, sc, eps=eps, act=act)
    _check("bn_twopass", x2, sc=sc)
    n, c = x2.shape
    if sc.shape != (2, c):
        raise ValueError(f"bn_twopass: sc must be (2, {c}), got {tuple(sc.shape)}")
    y = torch.empty_like(x2)
    stats = torch.empty((c, 2), dtype=torch.float32, device=x2.device)
    sms = sm_count(x2, "fused_conv")
    if x2.device.type == "meta":
        record([fact for _, fact in bn_chunk_launches("twopass", n, c, x2.dtype, sms,
                                                      _address(x2))], (x2, sc), (y, stats))
        return y, stats
    item, grid = x2.element_size(), _twopass_ctas(n)
    width0 = min(c, MAX_C)
    mi = torch.empty((4, width0), dtype=torch.float32, device=x2.device)
    partial = torch.empty((grid, 2, width0), dtype=torch.float32, device=x2.device)
    for first, width in chunks(c):
        part = sc if width == c else sc[:, first:first + width].contiguous()
        vec = vec_form(width, c, first, x2.dtype, _address(x2)) and y.data_ptr() % 16 == 0
        err = _lib().rkt_bn_twopass(
            x2.data_ptr() + first * item, part.data_ptr(), y.data_ptr() + first * item,
            stats.data_ptr() + first * 8, mi.data_ptr(), partial.data_ptr(), n, width, c, grid,
            float(eps), int(act), BN_DTYPE_CODES[x2.dtype], int(vec), stream_of(x2))
        if err:
            raise RuntimeError(f"bn_twopass: kernel launch failed with cudaError {err}")
        bn_twopass.launches += 1
    return y, stats


bn_twopass.launches = 0


def bn_normalize(x2, mi, *, act: bool):
    """Row 10: ``x2`` (N, C), ``mi`` (4, C) f32 [mean, inv, inv*scale,
    bias] -> y (N, C) in x's dtype. CPU tensors: :func:`bn_normalize_plain`;
    CUDA tensors: ``rkt_bn_normalize``, one launch a channel chunk, or
    raise; meta tensors record the launches."""
    if x2.device.type == "cpu":
        return bn_normalize_plain(x2, mi, act=act)
    _check("bn_normalize", x2, mi=mi)
    n, c = x2.shape
    if mi.shape != (4, c):
        raise ValueError(f"bn_normalize: mi must be (4, {c}), got {tuple(mi.shape)}")
    y = torch.empty_like(x2)
    if x2.device.type == "meta":
        record([fact for _, fact in bn_chunk_launches("normalize", n, c, x2.dtype,
                                                      sm_count(x2, "fused_conv"), _address(x2))],
               (x2, mi), (y,))
        return y
    item = x2.element_size()
    for first, width in chunks(c):
        rows = mi if width == c else mi[:, first:first + width].contiguous()
        vec = vec_form(width, c, first, x2.dtype, _address(x2)) and y.data_ptr() % 16 == 0
        _, norm_grid = _grids(x2, width)
        err = _lib().rkt_bn_normalize(x2.data_ptr() + first * item, rows.data_ptr(),
                                      y.data_ptr() + first * item, n, width, c, norm_grid,
                                      int(act), BN_DTYPE_CODES[x2.dtype], int(vec), stream_of(x2))
        if err:
            raise RuntimeError(f"bn_normalize: kernel launch failed with cudaError {err}")
        bn_normalize.launches += 1
    return y


bn_normalize.launches = 0


def _run(x2, scale, bias, eps: float, act: bool, schedule: str):
    """The forward of a schedule: ``"twopass"`` and ``"stats_xla"`` launch
    their kernel on a CUDA tensor; ``"plain"`` is the plain composition on
    any device."""
    if schedule == "plain":
        stats = moments(x2)
        return bn_normalize_plain(x2, epilogue_rows(stats, scale, bias, eps), act=act), stats
    if schedule == "stats_xla":
        stats = moments(x2)
        return bn_normalize(x2, epilogue_rows(stats, scale, bias, eps).contiguous(), act=act), stats
    return bn_twopass(x2, torch.stack([scale, bias]).float().contiguous(), eps=eps, act=act)


# -- autograd (the reference's plain fused backward) --------------------------


def bn_backward(dy, x2, scale, mean, inv, relu_bias=None):
    """The reference's fused train-mode BN backward (``_bn_train_bwd``; with
    ``relu_bias``, ``_bn_act_bwd``, whose relu mask is ``x̂·scale + bias >
    0``): one stacked (C, 2) reduction of dy and dy·x̂ gives d_bias, d_scale
    and dx. Returns ``(dx in x2's dtype, d_scale, d_bias)``."""
    n = x2.shape[0]
    dyf = dy.float()
    xhat = (x2.float() - mean) * inv
    if relu_bias is not None:
        dyf = torch.where(xhat * scale + relu_bias > 0, dyf, torch.zeros((), device=dyf.device))
    sum_dy = dyf.sum(0)
    sum_dy_xhat = (dyf * xhat).sum(0)
    dx = (scale * inv) * (dyf - sum_dy / n - xhat * (sum_dy_xhat / n))
    return dx.to(x2.dtype), sum_dy_xhat, sum_dy


class BnAct(torch.autograd.Function):
    """Train-mode BN(+relu) over the rows of ``x2`` (N, C):
    ``apply(x2, scale, bias, eps, act, schedule)`` -> ``(y, stats)``. The
    forward is the ``schedule``'s (:func:`_run`: a kernel, or ``"plain"``);
    the backward is always :func:`bn_backward`."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps, act, schedule):
        y, stats = _run(x2, scale, bias, eps, act, schedule)
        mi = epilogue_rows(stats, scale, bias, eps)
        ctx.save_for_backward(x2, scale, bias, mi[0], mi[1])
        ctx.act = act
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        """The stats cotangent is ignored: the running averages take no
        gradient."""
        x2, scale, bias, mean, inv = ctx.saved_tensors
        return (*bn_backward(dy, x2, scale, mean, inv, bias if ctx.act else None),
                None, None, None)


def fused_bn_act(x, scale, bias, *, eps: float = 1e-5, act: bool = True,
                 schedule: str = "twopass", block_rows: int = 512):
    """Fused train-mode BN(+relu) over the channel-minor activation ``x``
    (..., C); ``scale``/``bias`` (C,) f32 masters. Returns ``(y, stats)``
    with ``stats`` the (C, 2) raw moments (mean, E[x^2]). The leading dims
    flatten to N rows, which must tile ``block_rows`` exactly
    (:func:`fused_bn_act_supported`)."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"fused_bn_act: unknown schedule {schedule!r} — the table is "
            f"ahead of the implementation (expected one of {SCHEDULES})"
        )
    c = x.shape[-1]
    n = x.numel() // c if c else 0
    itemsize = x.element_size()
    if not fused_bn_act_supported(n, block_rows, itemsize):
        raise ValueError(
            f"fused_bn_act: N={n} must tile block_rows={block_rows} "
            f"(sublane {_SUBLANE.get(itemsize, 8)} for {x.dtype})"
        )
    y, stats = BnAct.apply(x.reshape(n, c).contiguous(), scale.float(), bias.float(),
                           float(eps), bool(act), schedule)
    return y.reshape(x.shape), stats
