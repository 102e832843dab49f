"""Core layers of the decode path: Dense, LayerNorm, RMSNorm, Embedding,
Dropout (the identity in eval) and the activations.

Numerics follow ``rocket_tpu/nn/layers.py``: parameters are float32
masters cast to the activation dtype at use; both norms compute their
statistics in float32 and cast back; ``gelu`` is the tanh approximation
(``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rocket_tpu_torch.nn.module import Layer

__all__ = ["Dense", "LayerNorm", "RMSNorm", "Embedding", "Dropout", "gelu", "silu"]

#: Standard deviation of a unit normal truncated to [-2, 2]; dividing by it
#: keeps lecun-normal's variance after truncation (as jax's initializer does).
_TRUNC_STD = 0.87962566103423978


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class Dense(Layer):
    """``y = x @ w + b`` with ``w`` (in, out); lecun-normal init."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias

    def init_params(self, gen):
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        w = torch.empty(self.in_features, self.out_features)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        params = {"w": w}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_features)
        return params

    def apply(self, params, x):
        y = x @ params["w"].to(x.dtype)
        if self.use_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def __repr__(self):
        return f"Dense({self.in_features}->{self.out_features})"


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
    """Dropout in eval semantics: the identity. The port has no training
    path yet, so there is no train mode to drop in."""

    def __init__(self, rate: float):
        self.rate = rate

    def apply(self, params, x):
        return x

    def __repr__(self):
        return f"Dropout({self.rate})"
