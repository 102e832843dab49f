"""MLP classifier (counterpart of ``rocket_tpu/models/mlp.py``): Flatten,
then Dense + relu (+ Dropout) per hidden width, then the class head, as one
:class:`~rocket_tpu_torch.nn.module.Sequential` whose param keys are the
reference's. Reads ``batch[image_key]``, writes ``batch[logits_key]``."""

from __future__ import annotations

from typing import Sequence

from rocket_tpu_torch.nn.layers import Dense, Dropout, Flatten, relu
from rocket_tpu_torch.nn.module import Model, Sequential

__all__ = ["MLP"]


class MLP(Model):
    def __init__(self, in_features: int, num_classes: int, hidden: Sequence[int] = (512, 256),
                 dropout: float = 0.0, image_key: str = "image", logits_key: str = "logits"):
        layers = [Flatten()]
        width_in = in_features
        for width in hidden:
            layers += [Dense(width_in, width), relu()]
            if dropout:
                layers.append(Dropout(dropout))
            width_in = width
        layers.append(Dense(width_in, num_classes))
        self.trunk = Sequential(*layers)
        self.image_key = image_key
        self.logits_key = logits_key

    def init_params(self, gen):
        return self.trunk.init_params(gen)

    def apply(self, params, batch, *, mode="train", rng=None):
        out = dict(batch)
        out[self.logits_key] = self.trunk.apply(params, batch[self.image_key], mode=mode, rng=rng)
        return out
