"""In-memory array datasets (counterpart of ``rocket_tpu/data/datasets.py``).

``SyntheticMNIST`` and ``mnist()`` wait for the MNIST slice (ROADMAP Queue
A 2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ArrayDataset"]


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
