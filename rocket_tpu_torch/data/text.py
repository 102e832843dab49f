"""Text data (counterparts in ``rocket_tpu/data/text.py``): the
TinyShakespeare loader with its deterministic synthetic fallback, the
character tokenizer and :class:`TokenDataset`, fixed-length windows over a
token stream. The BPE tokenizer waits for a later slice (ROADMAP Queue A
2)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["CharTokenizer", "TokenDataset", "synthetic_corpus", "tiny_shakespeare"]


def synthetic_corpus(num_chars: int = 1_000_000, seed: int = 0) -> str:
    """Grammar-ish pseudo-text: sentences of made-up words drawn from a
    skewed bigram word model. Same text as the JAX package's for a seed."""
    rng = np.random.default_rng(seed ^ 0x7E47)
    syllables = ["ba", "co", "di", "fu", "ga", "hi", "jo", "ku", "la", "me",
                 "no", "pi", "qua", "ro", "su", "ti", "vo", "wi", "xa", "zu"]
    words = ["".join(rng.choice(syllables, size=rng.integers(1, 4))) for _ in range(200)]
    trans = rng.dirichlet(np.full(len(words), 0.05), size=len(words))
    out, total, sentence_len = [], 0, 0
    word = int(rng.integers(len(words)))
    while total < num_chars:
        out.append(words[word])
        total += len(words[word]) + 1
        sentence_len += 1
        if sentence_len >= rng.integers(5, 12):
            out.append(".\n")
            total += 2
            sentence_len = 0
        else:
            out.append(" ")
        word = int(rng.choice(len(words), p=trans[word]))
    return "".join(out)[:num_chars]


def tiny_shakespeare(root: Optional[str] = None) -> str:
    """The TinyShakespeare text from ``root`` (default: ``$TEXT_ROOT`` or
    ``data``) under any of its usual file names, else
    :func:`synthetic_corpus` (there is no download)."""
    root = root or os.environ.get("TEXT_ROOT", "data")
    for name in ("tinyshakespeare.txt", "tiny_shakespeare.txt", "input.txt"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return f.read()
    return synthetic_corpus()


class CharTokenizer:
    """One id per distinct character of ``text``, in sorted order."""

    def __init__(self, text: str):
        self.vocab = sorted(set(text))
        self.vocab_size = len(self.vocab)
        self._index = {ch: i for i, ch in enumerate(self.vocab)}

    def encode(self, text: str) -> np.ndarray:
        return np.asarray([self._index[c] for c in text], np.int32)

    def decode(self, tokens) -> str:
        return "".join(self.vocab[int(t)] for t in tokens)


class TokenDataset:
    """Fixed-length windows over a token stream: sample i is
    ``tokens[i*stride : i*stride + seq_len]``, batches are ``{"tokens":
    (B, T) int32}`` (the next-token objective shifts internally).
    ``get_batch`` is the vectorized path the ``Dataset`` capsule takes."""

    def __init__(self, tokens: np.ndarray, seq_len: int, stride: int | None = None):
        self._tokens = np.asarray(tokens, np.int32)
        self.seq_len = seq_len
        self.stride = stride or seq_len
        self._n = max(0, (len(self._tokens) - seq_len) // self.stride + 1)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> dict:
        start = idx * self.stride
        return {"tokens": self._tokens[start:start + self.seq_len]}

    def get_batch(self, indices) -> dict:
        starts = np.asarray(indices) * self.stride
        window = starts[:, None] + np.arange(self.seq_len)[None, :]
        return {"tokens": self._tokens[window]}
