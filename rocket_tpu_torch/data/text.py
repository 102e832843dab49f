"""Text data for the char-LM serving config: the character tokenizer and
the deterministic synthetic corpus (counterparts of the two in
``rocket_tpu/data/text.py``; the rest of that module lands with the
training slice)."""

from __future__ import annotations

import numpy as np

__all__ = ["CharTokenizer", "synthetic_corpus"]


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
