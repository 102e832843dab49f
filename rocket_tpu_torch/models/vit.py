"""Vision Transformer (counterpart of ``rocket_tpu/models/vit.py``): a
strided-conv patch embedding, a learned CLS token and position table, an
encoder of the port's :class:`~rocket_tpu_torch.models.transformer.Block`
under ``TransformerConfig(causal=False)``, a final LayerNorm and a class
head on the CLS token.

The param tree is the reference's (``patch``, ``cls`` (1, 1, D), ``pos``
(1, N + 1, D), ``blocks/<i>``, ``ln_f``, ``head``), so a JAX tree bridges
rename-free. On CUDA the attention resolves to the flash kernels
(``nn/attention.py``: non-causal, fused qkv, any T; at CIFAR's 32 / 4
patches T = 65). The fused whole-block kernel is gated to causal blocks, so
ViT does not reach it.
"""

from __future__ import annotations

import torch

from rocket_tpu_torch.models.transformer import Block, TransformerConfig
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.layers import Conv2D, Dense, Dropout, LayerNorm
from rocket_tpu_torch.nn.module import Model

__all__ = ["ViT", "vit_tiny", "vit_small"]


class ViT(Model):
    """Reads ``batch[image_key]`` (B, H, W, C) or (B, H, W), writes
    ``batch[logits_key]`` (B, num_classes)."""

    def __init__(self, image_size: int = 32, patch_size: int = 4, in_channels: int = 3,
                 num_classes: int = 10, dim: int = 192, depth: int = 9, num_heads: int = 3,
                 mlp_ratio: int = 4, dropout: float = 0.0, image_key: str = "image",
                 logits_key: str = "logits"):
        if image_size % patch_size:
            raise ValueError(f"ViT: image_size {image_size} is not a multiple of patch_size "
                             f"{patch_size}")
        self.num_patches = (image_size // patch_size) ** 2
        self.dim = dim
        self.config = TransformerConfig(vocab_size=1, max_seq_len=self.num_patches + 1, dim=dim,
                                        num_layers=depth, num_heads=num_heads,
                                        mlp_ratio=mlp_ratio, dropout=dropout, causal=False)
        self.patch = Conv2D(in_channels, dim, kernel_size=patch_size, stride=patch_size,
                            padding="VALID")
        self.blocks = [Block(self.config, i) for i in range(depth)]
        self.ln_f = LayerNorm(dim)
        self.head = Dense(dim, num_classes)
        self.dropout = Dropout(dropout) if dropout else None
        self.image_key = image_key
        self.logits_key = logits_key

    def init_params(self, gen):
        def normal(*shape):
            return torch.empty(shape).normal_(0.0, 0.02, generator=gen)

        return {"patch": self.patch.init_params(gen),
                "cls": normal(1, 1, self.dim),
                "pos": normal(1, self.num_patches + 1, self.dim),
                "blocks": {str(i): blk.init_params(gen) for i, blk in enumerate(self.blocks)},
                "ln_f": self.ln_f.init_params(gen),
                "head": self.head.init_params(gen)}

    def apply(self, params, batch, *, mode="train", rng=None):
        x = batch[self.image_key]
        if x.dim() == 3:
            x = x[..., None]
        b = x.shape[0]
        x = self.patch(params["patch"], x).reshape(b, self.num_patches, self.dim)
        cls = params["cls"].to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
        if self.dropout is not None:
            x = self.dropout.apply({}, x, mode=mode,
                                   rng=None if rng is None else keys.fold_in(rng, 0xA11))
        for i, blk in enumerate(self.blocks):
            x = blk.apply(params["blocks"][str(i)], x, mode=mode, rng=rng)
        x = self.ln_f(params["ln_f"], x)
        out = dict(batch)
        out[self.logits_key] = self.head(params["head"], x[:, 0])
        return out

    def __repr__(self):
        return f"ViT(d={self.dim}, depth={len(self.blocks)}, patches={self.num_patches})"


def vit_tiny(image_size=32, patch_size=4, num_classes=10, **kw) -> ViT:
    """ViT-Ti at CIFAR scale: D=192, 9 blocks, 3 heads."""
    return ViT(image_size, patch_size, num_classes=num_classes, **kw)


def vit_small(image_size=224, patch_size=16, num_classes=1000, **kw) -> ViT:
    """ViT-S/16: D=384, 12 blocks, 6 heads."""
    return ViT(image_size, patch_size, num_classes=num_classes, dim=384, depth=12, num_heads=6,
               **kw)
