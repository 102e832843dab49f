"""Stock metrics (counterpart of ``rocket_tpu/utils/metrics.py``):
``TopKAccuracy``, ``Accuracy`` and ``Perplexity``. Each sums its counts on
the device per batch (the Meter's device path) and reads them on the host
once per ``reset``; ``launch`` serves a Meter's host path.
"""

from __future__ import annotations

import math

import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.meter import Metric

__all__ = ["Accuracy", "TopKAccuracy", "Perplexity"]


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


class Perplexity(Metric):
    """exp(mean next-token cross-entropy) over an eval epoch.

    The batch contract is ``next_token_loss``'s: logits (B, T, V) against
    tokens (B, T) shifted by one; rows past the real batch size (the
    padding of a last batch) are masked out. The NLL sum and the token
    count stay on the device until ``reset``."""

    def __init__(self, logits_key: str = "logits", tokens_key: str = "tokens",
                 tag: str = "perplexity", statefull: bool = False, priority: int = 1000,
                 runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        self._logits_key = logits_key
        self._tokens_key = tokens_key
        self._tag = tag
        self._nll = 0.0
        self._count = 0
        self.value: float | None = None

    def _nll_sum(self, logits, tokens, real_size):
        """(sum of the real rows' next-token NLL in f32, their token count)."""
        logits = torch.as_tensor(logits)
        tokens = torch.as_tensor(tokens, device=logits.device)
        lp = logits[:, :-1].float()
        tgt = tokens[:, 1:].long()
        nll = torch.nn.functional.cross_entropy(lp.reshape(-1, lp.shape[-1]), tgt.reshape(-1),
                                                reduction="none").reshape(tgt.shape)
        valid = torch.arange(tokens.shape[0], device=nll.device) < real_size
        return (nll * valid[:, None]).sum(), min(int(real_size), tokens.shape[0]) * tgt.shape[1]

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is None:
            return
        tokens = attrs.batch[self._tokens_key]
        size = attrs.batch_info.size if attrs.batch_info is not None else None
        s, n = self._nll_sum(attrs.batch[self._logits_key], tokens,
                             len(tokens) if size is None else size)
        self._nll = self._nll + s
        self._count += n

    def device_reduce(self, batch, real_size):
        s, n = self._nll_sum(batch[self._logits_key], batch[self._tokens_key], real_size)
        return {"nll": s, "count": n}

    def consume(self, reduced) -> None:
        self._nll = self._nll + reduced["nll"]
        self._count += reduced["count"]

    def reset(self, attrs: Attributes | None = None) -> None:
        # The once-per-epoch host read of the device sum.
        if self._count:
            self.value = math.exp(float(self._nll) / self._count)
            self.publish(attrs, self._tag, self.value)
        self._nll = 0.0
        self._count = 0
