"""LeNet-5 on NHWC images (counterpart of ``rocket_tpu/models/lenet.py``):
two 5x5 convolutions with relu and 2x2 max pools, then three Dense layers,
as one :class:`~rocket_tpu_torch.nn.module.Sequential` whose param keys
are the reference's. Reads ``batch[image_key]`` ((B, H, W) or (B, H, W,
1)), writes ``batch[logits_key]``."""

from __future__ import annotations

from rocket_tpu_torch.nn.layers import Conv2D, Dense, Flatten, MaxPool2D, relu
from rocket_tpu_torch.nn.module import Model, Sequential

__all__ = ["LeNet"]


class LeNet(Model):
    def __init__(self, num_classes: int = 10, image_key: str = "image",
                 logits_key: str = "logits"):
        self.trunk = Sequential(
            Conv2D(1, 6, kernel_size=5, padding="SAME"), relu(), MaxPool2D(2),
            Conv2D(6, 16, kernel_size=5, padding="VALID"), relu(), MaxPool2D(2),
            Flatten(),
            Dense(16 * 5 * 5, 120), relu(),
            Dense(120, 84), relu(),
            Dense(84, num_classes),
        )
        self.image_key = image_key
        self.logits_key = logits_key

    def init_params(self, gen):
        return self.trunk.init_params(gen)

    def apply(self, params, batch, *, mode="train", rng=None):
        x = batch[self.image_key]
        if x.dim() == 3:
            x = x[..., None]  # (B, H, W) -> (B, H, W, 1)
        out = dict(batch)
        out[self.logits_key] = self.trunk.apply(params, x, mode=mode, rng=rng)
        return out
