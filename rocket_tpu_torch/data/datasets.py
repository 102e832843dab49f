"""In-memory datasets (counterpart of ``rocket_tpu/data/datasets.py``):
``ArrayDataset``, the synthetic MNIST stand-in and ``mnist()``.

There is no download. ``mnist()`` reads MNIST from a local torchvision
copy (``download=False``) when one exists and torchvision is installed,
and otherwise returns :class:`SyntheticMNIST`: a learnable ten-class task
with MNIST's shapes (28x28 grayscale), drawn by the same numpy code as the
reference's, so both packages see the same samples for a seed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["ArrayDataset", "SyntheticMNIST", "mnist"]


class ArrayDataset:
    """In-memory images and labels with a vectorised batch fetch: the
    ``Dataset`` capsule calls :meth:`get_batch` with a batch's indices."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self._images = images
        self._labels = labels

    def __len__(self) -> int:
        return len(self._labels)

    def __getitem__(self, idx: int) -> dict:
        return {"image": self._images[idx], "label": np.int32(self._labels[idx])}

    def get_batch(self, indices: np.ndarray) -> dict:
        return {"image": self._images[indices], "label": self._labels[indices].astype(np.int32)}


class SyntheticMNIST:
    """Digit-like images: a smooth template per class (the same for train
    and test, so the task is one), shifted by up to 3 pixels, scaled by
    0.7–1.3 and given unit-0.3 Gaussian noise per sample. Samples are
    ``{"image": float32 (28, 28), "label": int32}``."""

    def __init__(self, num_samples: int = 60000, seed: int = 0, train: bool = True):
        self._n = num_samples
        coarse = np.random.default_rng(seed ^ 0xD161).normal(size=(10, 7, 7)).astype(np.float32)
        self._templates = coarse.repeat(4, axis=1).repeat(4, axis=2)
        draws = np.random.default_rng((seed if train else seed + 1_000_003) ^ 0x5A3B1E)
        self._labels = draws.integers(0, 10, size=num_samples).astype(np.int32)
        self._shifts = draws.integers(-3, 4, size=(num_samples, 2)).astype(np.int8)
        self._scales = draws.uniform(0.7, 1.3, size=num_samples).astype(np.float32)
        self._noise_seeds = draws.integers(0, 2**31, size=num_samples)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> dict:
        label = self._labels[idx]
        image = np.roll(self._templates[label], shift=tuple(self._shifts[idx]), axis=(0, 1))
        noise = np.random.default_rng(int(self._noise_seeds[idx])).normal(size=image.shape)
        image = image * self._scales[idx] + noise.astype(np.float32) * 0.3
        return {"image": image.astype(np.float32), "label": np.int32(label)}


def mnist(root: Optional[str] = None, train: bool = True):
    """MNIST from a local torchvision copy under ``root`` (default
    ``$MNIST_ROOT`` or ``data``), normalised as the reference does, else
    :class:`SyntheticMNIST` (60,000 train or 10,000 test samples)."""
    root = root or os.environ.get("MNIST_ROOT", "data")
    try:
        from torchvision.datasets import MNIST

        local = MNIST(root=root, train=train, download=False)
    except (ImportError, RuntimeError, OSError):  # no torchvision, or no local copy
        return SyntheticMNIST(num_samples=60000 if train else 10000, train=train)
    images = (local.data.numpy().astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return ArrayDataset(images, local.targets.numpy().astype(np.int32))
