"""Layers of the port (counterpart of ``rocket_tpu.nn``): the same 20
names at the package level."""

from rocket_tpu_torch.nn.layers import (
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GlobalAvgPool2D,
    LayerNorm,
    MaxPool2D,
    gelu,
    relu,
    silu,
    softmax,
    tanh,
)
from rocket_tpu_torch.nn.module import Lambda, Layer, Model, Sequential, Variables

__all__ = [
    "AvgPool2D", "BatchNorm", "Conv2D", "Dense", "Dropout", "Embedding", "Flatten",
    "GlobalAvgPool2D", "Lambda", "Layer", "LayerNorm", "MaxPool2D", "Model", "Sequential",
    "Variables", "gelu", "relu", "silu", "softmax", "tanh",
]
