"""Stock metrics (counterpart of ``rocket_tpu/utils/metrics.py``):
``TopKAccuracy`` and ``Accuracy``. Each sums its hits on the device per
batch (the Meter's device path) and reads them on the host once per
``reset``; ``launch`` serves a Meter's host path. ``Perplexity`` waits for
a later slice.
"""

from __future__ import annotations

import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.meter import Metric

__all__ = ["Accuracy", "TopKAccuracy"]


class TopKAccuracy(Metric):
    """Top-k accuracy over logits/labels; ``Accuracy`` is the k=1 case."""

    def __init__(self, k: int = 5, logits_key: str = "logits", labels_key: str = "label",
                 tag: str = None, statefull: bool = False, priority: int = 1000,
                 runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        self._k = int(k)
        self._logits_key = logits_key
        self._labels_key = labels_key
        self._tag = tag or f"top{k}_accuracy"
        self._correct = 0
        self._total = 0
        self.value: float | None = None

    def _hits(self, logits, labels):
        labels = torch.as_tensor(labels, device=logits.device)
        if self._k == 1:
            return logits.argmax(-1) == labels
        return (logits.topk(self._k, dim=-1).indices == labels[..., None]).any(-1)

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is None:
            return
        logits = torch.as_tensor(attrs.batch[self._logits_key])
        hit = self._hits(logits, attrs.batch[self._labels_key])
        self._correct = self._correct + hit.sum()
        self._total += int(hit.shape[0])

    def device_reduce(self, batch, real_size):
        hit = self._hits(batch[self._logits_key], batch[self._labels_key])
        valid = torch.arange(hit.shape[0], device=hit.device) < real_size
        return {"correct": (hit & valid).sum(), "total": int(real_size)}

    def consume(self, reduced) -> None:
        self._correct = self._correct + reduced["correct"]
        self._total += reduced["total"]

    def reset(self, attrs: Attributes | None = None) -> None:
        # The once-per-epoch host read of the device sum.
        if self._total:
            self.value = float(self._correct) / self._total
            self.publish(attrs, self._tag, self.value)
        self._correct = 0
        self._total = 0


class Accuracy(TopKAccuracy):
    """Top-1 accuracy (the reference example's metric)."""

    def __init__(self, logits_key: str = "logits", labels_key: str = "label",
                 tag: str = "accuracy", statefull: bool = False, priority: int = 1000,
                 runtime=None) -> None:
        super().__init__(k=1, logits_key=logits_key, labels_key=labels_key, tag=tag,
                         statefull=statefull, priority=priority, runtime=runtime)
