"""Core layers: Dense, the NHWC convolution and pools, BatchNorm,
LayerNorm, RMSNorm, Embedding, Dropout, Flatten and the activations
(``relu()``, ``gelu()``, ``tanh()``, ``silu()`` and ``softmax()`` are
:class:`~rocket_tpu_torch.nn.module.Lambda` layers, as in the reference;
``relu_fn``, ``gelu_fn`` and ``silu_fn`` are their tensor functions).

Numerics follow ``rocket_tpu/nn/layers.py``: parameters are float32
masters cast to the activation dtype at use; the norms compute their
statistics in float32 and cast back; ``gelu`` is the tanh approximation
(``jax.nn.gelu``'s default).

Convolutions and pools take and return **NHWC** activations with **HWIO**
kernels, the JAX package's layout, so params and checkpoints carry over
rename-free. Inside, an NHWC tensor permuted to NCHW is a ``channels_last``
tensor, which cuDNN convolves without a copy, and the conv's NHWC output
viewed as (N, C) rows is what the BatchNorm kernels read. ``"SAME"``
padding splits as XLA's does, ``lo = total // 2`` and the rest high, and
pads explicitly where the split is uneven (a stride-2 3x3 on an even size
pads (0, 1), where ``F.conv2d(padding=1)`` would pad (1, 1)).
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Union

import torch
import torch.nn.functional as F

from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.module import Lambda, Layer
from rocket_tpu_torch.ops import fused_conv

__all__ = [
    "Dense", "Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D", "BatchNorm", "bn_act_train",
    "LayerNorm", "RMSNorm", "Embedding", "Dropout", "Flatten", "relu", "gelu", "tanh", "silu",
    "softmax", "relu_fn", "gelu_fn", "silu_fn",
]

#: Standard deviation of a unit normal truncated to [-2, 2]; dividing by it
#: keeps lecun-normal's variance after truncation (as jax's initializer does).
_TRUNC_STD = 0.87962566103423978


def relu_fn(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def gelu_fn(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu_fn(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _softmax_fn(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


# The activation layers (the reference's ``nn.relu()`` ... factories).
def relu() -> Lambda:
    return Lambda(relu_fn, "relu")


def gelu() -> Lambda:
    return Lambda(gelu_fn, "gelu")


def tanh() -> Lambda:
    return Lambda(torch.tanh, "tanh")


def silu() -> Lambda:
    return Lambda(silu_fn, "silu")


def softmax() -> Lambda:
    return Lambda(_softmax_fn, "softmax")


class Dense(Layer):
    """``y = x @ w + b`` with ``w`` (in, out); lecun-normal init.

    ``tp_role`` opts the layer into the collective matmuls of
    ``parallel/collectives.py`` while a tensor-parallel context is active
    (reference ``rocket_tpu/nn/layers.py:44-116``): ``"column"`` (``w``
    this rank's output columns; the sequence-sharded input is gathered
    into the matmul), ``"row"`` (``w`` this rank's input rows; the output
    reduce-scatters onto the sequence shards). Off the context, or where
    the sharded width or (row) the sequence does not divide the group, the
    layer is the plain matmul. The transformer's projections use the
    grouped primitives directly (one gather for the fused QKV and for
    swiglu's pair), so their Dense layers keep ``tp_role=None``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 tp_role=None):
        if tp_role not in (None, "column", "row"):
            raise ValueError(f"Dense: tp_role must be None|'column'|'row', got {tp_role!r}")
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.tp_role = tp_role

    def init_params(self, gen):
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        w = torch.empty(self.in_features, self.out_features)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        params = {"w": w}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_features)
        return params

    def _tp_spec(self, x):
        """The active TP spec when this layer's role engages on ``x``: a
        ``(B, T, F)`` activation (the local sequence shard for a column
        layer, the whole sequence for a row layer, whose T must divide the
        group) and a sharded width that divides the group."""
        if self.tp_role is None or x.dim() != 3:
            return None
        from rocket_tpu_torch.parallel import collectives as coll

        spec = coll.current_tp()
        if spec is None:
            return None
        n = spec.tp_size
        width = self.out_features if self.tp_role == "column" else self.in_features
        if width % n or (self.tp_role == "row" and x.shape[1] % n):
            return None
        return spec

    def apply(self, params, x):
        w = params["w"].to(x.dtype)
        spec = self._tp_spec(x)
        if spec is None:
            y = x @ w
        else:
            from rocket_tpu_torch.parallel import collectives as coll

            if self.tp_role == "column":
                (y,) = coll.all_gather_matmul(spec, x, (w,))
            else:
                y = coll.matmul_reduce_scatter(spec, x, w)
        if self.use_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def __repr__(self):
        return f"Dense({self.in_features}->{self.out_features})"


def _pair(v: Union[int, Sequence[int]]) -> tuple:
    return (v, v) if isinstance(v, int) else (v[0], v[1])


def _same_pads(size: int, k: int, s: int) -> tuple:
    """XLA's ``"SAME"`` split of one spatial dim: the output is ``ceil(size
    / s)``, the padding ``total = max((out - 1) * s + k - size, 0)``, ``lo =
    total // 2`` and the rest high."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, window, strides) -> list:
    """((lo, hi), (lo, hi)) for H and W from ``"SAME"``, ``"VALID"`` or an
    explicit ``[(lo, hi), (lo, hi)]``."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        if padding.upper() == "SAME":
            return [_same_pads(n, k, s) for n, k, s in zip(spatial, window, strides)]
        raise ValueError(f"unknown padding {padding!r}")
    return [tuple(p) for p in padding]


def _pad_nhwc(x, pads, value: float = 0.0):
    (ht, hb), (wl, wr) = pads
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value)


def _nchw(x):
    """An NHWC tensor as its NCHW view: ``channels_last`` memory."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv2D(Layer):
    """NHWC convolution with an HWIO kernel; he-normal init truncated as
    jax's (fan_in = kh * kw * cin). ``padding``: ``"SAME"``, ``"VALID"``,
    an int or ``[(lo, hi), (lo, hi)]``. The convolution itself is
    ``F.conv2d`` on ``channels_last`` operands: the JAX package leaves it to
    XLA outside any Pallas kernel, as it leaves the big matmuls."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 padding="SAME", use_bias: bool = True):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        if isinstance(padding, int):
            padding = [(padding, padding), (padding, padding)]
        self.padding = padding
        self.use_bias = use_bias

    def init_params(self, gen):
        kh, kw = self.kernel_size
        std = math.sqrt(2.0 / (kh * kw * self.in_channels)) / _TRUNC_STD
        w = torch.empty(kh, kw, self.in_channels, self.out_channels)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        params = {"w": w}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_channels)
        return params

    def apply(self, params, x):
        pads = _pads(self.padding, x.shape[1:3], self.kernel_size, self.stride)
        if any(lo != hi for lo, hi in pads):
            x, conv_pad = _pad_nhwc(x, pads), (0, 0)
        else:
            conv_pad = (pads[0][0], pads[1][0])
        w = params["w"].to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y = _nhwc(F.conv2d(_nchw(x), w, stride=self.stride, padding=conv_pad))
        if self.use_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def __repr__(self):
        return (f"Conv2D({self.in_channels}->{self.out_channels}, "
                f"k={self.kernel_size}, s={self.stride})")


class _Pool2D(Layer):
    def __init__(self, window, stride=None, padding="VALID"):
        self.window = _pair(window)
        self.stride = _pair(stride if stride is not None else window)
        self.padding = padding

    def _padded(self, x, value: float):
        pads = _pads(self.padding, x.shape[1:3], self.window, self.stride)
        return _nchw(_pad_nhwc(x, pads, value) if any(map(any, pads)) else x)


class MaxPool2D(_Pool2D):
    """Max over each window; ``"SAME"`` pads with -inf, as XLA does."""

    def apply(self, params, x):
        return _nhwc(F.max_pool2d(self._padded(x, float("-inf")), self.window, self.stride))


class AvgPool2D(_Pool2D):
    """Sum over each window divided by the full window size, zero padding
    included, as the reference does."""

    def apply(self, params, x):
        y = F.avg_pool2d(self._padded(x, 0.0), self.window, self.stride)
        return _nhwc(y).to(x.dtype)


class GlobalAvgPool2D(Layer):
    def apply(self, params, x):
        return x.mean(dim=(1, 2))


class Flatten(Layer):
    def apply(self, params, x):
        return x.reshape(x.shape[0], -1)


# -- BatchNorm ------------------------------------------------------------------


def _bn_train(x, scale, bias, eps: float):
    """Train-mode BN over all but the last (channel) axis of ``x``: returns
    ``(y, stats)`` with ``stats`` (C, 2) f32 [mean, E[x^2]]. One-pass
    statistics ``var = E[x^2] - E[x]^2`` in f32, clamped at 0, and the
    reference's fused backward (``_bn_train_bwd``: one stacked (C, 2) sum of
    ``dy`` and ``dy * x̂`` gives d_bias, d_scale and dx); ``stats`` feeds the
    running averages only and takes no gradient."""
    c = x.shape[-1]
    y, stats = fused_conv.BnAct.apply(x.reshape(-1, c), scale.float(), bias.float(),
                                      float(eps), False, "plain")
    return y.reshape(x.shape), stats


def _fused_conv_config(n: int, c: int, dtype: torch.dtype) -> dict:
    """The ``fused_conv`` tune table's entry for an (N, C) activation on
    this card, or ``{}`` (the shipped table is empty)."""
    from rocket_tpu_torch.tune import get_config

    return get_config("fused_conv", shape={"n": n, "c": c}, dtype=dtype) or {}


#: Sync-BN's collectives in this process (:func:`bn_act_train` over
#: several data ranks): one all-reduce per forward and per backward.
SYNC_BN_STATS = {"all_reduces": 0}


def _sync_group():
    """``(group, data ranks)`` of the current Runtime when its data axis
    spans more than one rank (sync-BN), else None."""
    from rocket_tpu_torch.runtime import Runtime

    runtime = Runtime.current()
    if runtime is None or runtime.data_axis_size <= 1 or not runtime.grouped:
        return None
    return runtime.axis_group("data"), runtime.data_axis_size


def _all_reduce(t: torch.Tensor, group, ranks: int) -> torch.Tensor:
    """``t`` summed in place over the ``ranks`` of ``group`` (on meta
    tensors, recorded for the schedule audit: ``collectives.collective``)."""
    import torch.distributed as dist

    from rocket_tpu_torch.parallel.collectives import collective

    collective("all_reduce", lambda: dist.all_reduce(t, group=group, async_op=True), (t,), (t,),
               2 * (ranks - 1) / ranks * t.numel() * t.element_size(), ranks, "data").wait()
    SYNC_BN_STATS["all_reduces"] += 1
    return t


class SyncBnAct(torch.autograd.Function):
    """Train-mode BN(+relu) over the global batch of ``ranks`` data ranks
    (``rocket_tpu/nn/layers.py:294``'s path under a data-sharded batch):
    ``apply(x2, scale, bias, eps, act, group, ranks)`` -> ``(y, stats)``.
    The forward all-reduces the stacked (C, 2) sums ``[Σx, Σx²]`` over
    ``group`` and divides by the global row count, so ``stats`` (the
    running averages' input) are the global batch's on every rank; the
    backward all-reduces the stacked (C, 2) ``[Σdy, Σdy·x̂]`` and takes
    ``dx`` from the global sums over the global count (the reference's
    ``_bn_train_bwd``), while ``d_scale``/``d_bias`` are this rank's sums,
    which the gradient reduction means over the ranks like any other
    param's (each rank's loss is its stripe's mean)."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps, act, group, ranks):
        xf = x2.float()
        n = x2.shape[0] * ranks
        sums = _all_reduce(torch.stack([xf.sum(0), xf.square().sum(0)], dim=-1), group, ranks)
        stats = sums / n
        mi = fused_conv.epilogue_rows(stats, scale, bias, eps)
        y = fused_conv.bn_normalize_plain(x2, mi, act=act)
        ctx.save_for_backward(x2, scale, bias, mi[0], mi[1])
        ctx.act, ctx.group, ctx.n, ctx.ranks = act, group, n, ranks
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        x2, scale, bias, mean, inv = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x2.float() - mean) * inv
        if ctx.act:
            dyf = torch.where(xhat * scale + bias > 0, dyf, torch.zeros((), device=dyf.device))
        local = torch.stack([dyf.sum(0), (dyf * xhat).sum(0)], dim=-1)
        sums = _all_reduce(local.clone(), ctx.group, ctx.ranks)
        n = ctx.n
        dx = (scale * inv) * (dyf - sums[:, 0] / n - xhat * (sums[:, 1] / n))
        return dx.to(x2.dtype), local[:, 1], local[:, 0], None, None, None, None


def bn_act_train(x, scale, bias, eps: float, act: bool = False):
    """Train-mode BN with an optionally fused relu — the conv stack's seam
    (the reference's gate, ``rocket_tpu/nn/layers.py:294-348``).

    Over several data ranks (the current Runtime's data axis) the
    statistics are the global batch's: sync-BN (:class:`SyncBnAct`), on
    the reference path, whatever the table or ``ROCKET_TPU_FUSED_CONV``
    say, as the reference's gate keeps multi-device traces off the fused
    kernels (``rocket_tpu/ops/fused_conv.py:35-39``).

    The impl comes from the ``fused_conv`` tune table
    (:func:`_fused_conv_config`, shipped empty, as the reference's), so it is
    ``"reference"`` — bitwise :func:`_bn_train` followed by relu — unless
    ``ROCKET_TPU_FUSED_CONV=pallas`` forces the fused kernel
    (``ops/fused_conv.py``) at the table's schedule and ``block_rows``
    (defaults ``"twopass"`` and 512, the reference's). A table entry
    engages the kernel on CUDA tensors only; forced, CPU tensors run its
    plain version (the reference's interpret mode) and CUDA tensors the
    kernel, whatever C and whichever of f32, bf16 and f16 (a float64 CUDA
    tensor raises: the TPU kernel never ran it). Shapes past the
    reference's gate stay on the reference path. Returns ``(y, stats)``
    like :func:`_bn_train`."""
    c = x.shape[-1]
    n = x.numel() // c
    sync = _sync_group()
    if sync is not None:
        y, stats = SyncBnAct.apply(x.reshape(-1, c), scale.float(), bias.float(), float(eps),
                                   bool(act), *sync)
        return y.reshape(x.shape), stats
    config = _fused_conv_config(n, c, x.dtype)
    forced = os.environ.get("ROCKET_TPU_FUSED_CONV")
    impl = forced or config.get("impl", "reference")
    if impl == "pallas":
        block_rows = config.get("block_rows", 512)
        if ((forced or x.device.type != "cpu")
                and fused_conv.fused_bn_act_supported(n, block_rows, x.element_size())):
            return fused_conv.fused_bn_act(x, scale, bias, eps=eps, act=act,
                                           schedule=config.get("schedule", "twopass"),
                                           block_rows=block_rows)
    return fused_conv.reference_bn_act(x, scale, bias, eps, act)


class BatchNorm(Layer):
    """Batch normalization over all but the last (channel) axis: params
    ``scale``/``bias``, state ``mean``/``var`` (the biased batch variance),
    updated as ``momentum * old + (1 - momentum) * batch`` in train mode
    from the detached batch statistics. Eval normalises with the state,
    associating as ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps

    def init_params(self, gen):
        return {"scale": torch.ones(self.num_features), "bias": torch.zeros(self.num_features)}

    def init_state(self):
        return {"mean": torch.zeros(self.num_features), "var": torch.ones(self.num_features)}

    def apply(self, params, x, *, state, mode="train"):
        return self.apply_act(params, x, state=state, mode=mode, act=False)

    def apply_act(self, params, x, *, state, mode="train", act=False):
        """``apply`` with the relu folded into the BN epilogue, so the
        ``fused_conv`` kernel can serve the whole post-conv chain
        (:func:`bn_act_train`); unforced it is bitwise ``relu(apply(...))``.
        Returns ``(y, new_state)``."""
        if mode == "train":
            y, stats = bn_act_train(x, params["scale"], params["bias"], self.eps, act=act)
            stats = stats.detach()
            mean = stats[:, 0]
            var = torch.clamp(stats[:, 1] - mean.square(), min=0.0)
            m = self.momentum
            return y, {"mean": m * state["mean"] + (1 - m) * mean,
                       "var": m * state["var"] + (1 - m) * var}
        inv = torch.rsqrt(state["var"] + self.eps) * params["scale"]
        y = ((x.float() - state["mean"]) * inv + params["bias"]).to(x.dtype)
        if act:
            y = relu_fn(y)
        return y, state

    def __repr__(self):
        return f"BatchNorm({self.num_features})"


class LayerNorm(Layer):
    def __init__(self, num_features: int, eps: float = 1e-5, use_bias: bool = True):
        self.num_features = num_features
        self.eps = eps
        self.use_bias = use_bias

    def init_params(self, gen):
        params = {"scale": torch.ones(self.num_features)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.num_features)
        return params

    def apply(self, params, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * params["scale"].float()
        if self.use_bias:
            y = y + params["bias"].float()
        return y.to(x.dtype)

    def __repr__(self):
        return f"LayerNorm({self.num_features})"


class RMSNorm(Layer):
    """Root-mean-square norm (no centering, no bias), f32 statistics."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        self.num_features = num_features
        self.eps = eps

    def init_params(self, gen):
        return {"scale": torch.ones(self.num_features)}

    def apply(self, params, x):
        xf = x.float()
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * params["scale"].float()
        return y.to(x.dtype)

    def __repr__(self):
        return f"RMSNorm({self.num_features})"


class Embedding(Layer):
    def __init__(self, num_embeddings: int, features: int, stddev: float = 0.02):
        self.num_embeddings = num_embeddings
        self.features = features
        self.stddev = stddev

    def init_params(self, gen):
        table = torch.empty(self.num_embeddings, self.features)
        table.normal_(0.0, self.stddev, generator=gen)
        return {"table": table}

    def apply(self, params, x):
        return params["table"][x.long()]

    def __repr__(self):
        return f"Embedding({self.num_embeddings}, {self.features})"


class Dropout(Layer):
    """Inverted dropout: in train mode keeps each element with probability
    ``1 - rate`` and scales the kept ones by ``1 / (1 - rate)``; the
    identity otherwise. The mask comes from the counter-hash key ``rng``
    (``nn/keys.py``), never from a generator, so a checkpointed forward
    and its recompute drop the same elements; under data parallelism a
    rank hashes its rows' global element indices, and under tensor
    parallelism ``split = (dim, index, count)`` says which chunk of the
    global activation ``x`` is (``keys.dropout_mask``)."""

    def __init__(self, rate: float):
        self.rate = rate

    def apply(self, params, x, *, mode="eval", rng=None, split=None):
        if mode != "train" or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout needs an rng in train mode")
        keep = 1.0 - self.rate
        mask = keys.dropout_mask(rng, keep, x.shape, x.device, split)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def __repr__(self):
        return f"Dropout({self.rate})"
