"""ResNet family (18/34/50/101) — NHWC at the boundary, BatchNorm state
threaded through ``apply`` (counterpart of ``rocket_tpu/models/resnet.py``).

The param and state trees carry the JAX package's names (``stem``,
``blocks/<i>/c1|c2|c3|down/conv|bn``, ``head``) with HWIO conv kernels, so
a JAX tree bridges rename-free. ``batch["image"]`` is NHWC (or NHW); the
forward writes ``batch["logits"]``. Inside, every activation is an NHWC
tensor, which the convolutions see as ``channels_last`` NCHW
(``nn/layers.py``). Downsampling shortcuts are 1x1 strided convs
(projection option B).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from rocket_tpu_torch.nn.layers import BatchNorm, Conv2D, Dense, MaxPool2D, relu_fn
from rocket_tpu_torch.nn.module import Layer, map_params
from rocket_tpu_torch.runtime import resolve_device

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101"]


class _ConvBN(Layer):
    """conv -> BN [-> relu]. ``act=True`` folds the relu into the BN
    epilogue (``BatchNorm.apply_act``), so the ``fused_conv`` kernel can
    serve the whole post-conv chain; unforced the path is bitwise conv ->
    BN -> relu."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME", act=False):
        self.conv = Conv2D(cin, cout, kernel, stride=stride, padding=padding, use_bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def init_params(self, gen):
        return {"conv": self.conv.init_params(gen), "bn": self.bn.init_params(gen)}

    def init_state(self):
        return {"bn": self.bn.init_state()}

    def apply(self, params, x, *, state, mode="train"):
        x = self.conv.apply(params["conv"], x)
        x, bn_state = self.bn.apply_act(params["bn"], x, state=state["bn"], mode=mode,
                                        act=self.act)
        return x, {"bn": bn_state}


class _Block(Layer):
    """A residual block: its ``_ConvBN`` chain (named ``c1``, ``c2``[,
    ``c3``]), the optional projection ``down``, then ``relu(x + h)``."""

    def _layers(self):
        names = ("c1", "c2", "c3")
        out = list(zip(names, self.chain))
        if self.downsample is not None:
            out.append(("down", self.downsample))
        return out

    def init_params(self, gen):
        return {name: layer.init_params(gen) for name, layer in self._layers()}

    def init_state(self):
        return {name: layer.init_state() for name, layer in self._layers()}

    def apply(self, params, x, *, state, mode="train"):
        new_state = {}
        h = x
        for name, layer in zip(("c1", "c2", "c3"), self.chain):
            h, new_state[name] = layer.apply(params[name], h, state=state[name], mode=mode)
        if self.downsample is not None:
            x, new_state["down"] = self.downsample.apply(params["down"], x,
                                                         state=state["down"], mode=mode)
        return relu_fn(x + h), new_state


class _BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin, width, stride):
        self.chain = (_ConvBN(cin, width, 3, stride=stride, act=True), _ConvBN(width, width, 3))
        self.downsample = (_ConvBN(cin, width, 1, stride=stride)
                           if stride != 1 or cin != width else None)


class _Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin, width, stride):
        cout = width * self.expansion
        self.chain = (_ConvBN(cin, width, 1, act=True),
                      _ConvBN(width, width, 3, stride=stride, act=True),
                      _ConvBN(width, cout, 1))
        self.downsample = (_ConvBN(cin, cout, 1, stride=stride)
                           if stride != 1 or cin != cout else None)


class ResNet:
    """Batch contract: reads ``batch["image"]`` (B, H, W, C or B, H, W),
    writes ``batch["logits"]``. ``stem="imagenet"``: 7x7/2 conv + 3x3/2
    max pool; ``stem="cifar"``: 3x3/1 conv, no pool.

    ``init(generator, device)`` draws the params, ``init_state(device)`` the
    BatchNorm state; ``apply(params, batch, *, state, mode, rng)`` returns
    ``(batch with logits, new_state)``."""

    def __init__(self, block: str, stage_sizes: Sequence[int], num_classes: int = 1000,
                 in_channels: int = 3, stem: str = "imagenet", image_key: str = "image",
                 logits_key: str = "logits"):
        block_cls = {"basic": _BasicBlock, "bottleneck": _Bottleneck}[block]
        self.stem_kind = stem
        if stem == "imagenet":
            self.stem = _ConvBN(in_channels, 64, 7, stride=2, act=True)
            self.pool = MaxPool2D(3, stride=2, padding="SAME")
        else:
            self.stem = _ConvBN(in_channels, 64, 3, stride=1, act=True)
            self.pool = None
        self.blocks: list = []
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            width = 64 * (2 ** stage)
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.blocks.append(block_cls(cin, width, stride))
                cin = width * block_cls.expansion
        self.head = Dense(cin, num_classes)
        self.image_key = image_key
        self.logits_key = logits_key

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> dict:
        """f32 params drawn on the CPU from ``generator`` (seed 0 when None)
        and moved to ``device`` (``runtime.resolve_device``: the GPU unless
        the caller asks for the CPU)."""
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {"stem": self.stem.init_params(gen),
                  "blocks": {str(i): blk.init_params(gen) for i, blk in enumerate(self.blocks)},
                  "head": self.head.init_params(gen)}
        return map_params(lambda t: t.to(device), params)

    def init_state(self, device=None) -> dict:
        """The BatchNorm running statistics: mean 0, var 1 (f32)."""
        device = resolve_device(device)
        state = {"stem": self.stem.init_state(),
                 "blocks": {str(i): blk.init_state() for i, blk in enumerate(self.blocks)}}
        return map_params(lambda t: t.to(device), state)

    def apply(self, params, batch, *, state, mode="train", rng=None):
        x = batch[self.image_key]
        if x.dim() == 3:
            x = x[..., None]
        new_state = {"blocks": {}}
        x, new_state["stem"] = self.stem.apply(params["stem"], x, state=state["stem"], mode=mode)
        if self.pool is not None:
            x = self.pool.apply({}, x)
        for i, blk in enumerate(self.blocks):
            key = str(i)
            x, new_state["blocks"][key] = blk.apply(params["blocks"][key], x,
                                                    state=state["blocks"][key], mode=mode)
        x = x.mean(dim=(1, 2))  # global average pool
        out = dict(batch)
        out[self.logits_key] = self.head.apply(params["head"], x)
        return out, new_state

    def __repr__(self):
        return f"ResNet({self.stem_kind}, {len(self.blocks)} blocks)"


def resnet18(num_classes=1000, **kw) -> ResNet:
    return ResNet("basic", [2, 2, 2, 2], num_classes=num_classes, **kw)


def resnet34(num_classes=1000, **kw) -> ResNet:
    return ResNet("basic", [3, 4, 6, 3], num_classes=num_classes, **kw)


def resnet50(num_classes=1000, **kw) -> ResNet:
    return ResNet("bottleneck", [3, 4, 6, 3], num_classes=num_classes, **kw)


def resnet101(num_classes=1000, **kw) -> ResNet:
    return ResNet("bottleneck", [3, 4, 23, 3], num_classes=num_classes, **kw)
