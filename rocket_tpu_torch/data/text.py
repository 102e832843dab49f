"""Text data (counterparts in ``rocket_tpu/data/text.py``): the
TinyShakespeare loader with its deterministic synthetic fallback, the
character tokenizer, the byte-level :class:`BPETokenizer` and
:class:`TokenDataset`, fixed-length windows over a token stream."""

from __future__ import annotations

import json
import os
import re
from collections import Counter, defaultdict
from typing import Optional

import numpy as np

__all__ = ["BPETokenizer", "CharTokenizer", "TokenDataset", "synthetic_corpus",
           "tiny_shakespeare"]


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


#: Word and whitespace runs: the units BPE merges within (never across), so
#: concatenating their bytes gives back the text.
_CHUNK = re.compile(r"\S+|\s+")


def _replace_pair(seq: tuple, pair: tuple, new_id: int) -> tuple:
    """``seq`` with every occurrence of ``pair``, scanned left to right
    without overlap, replaced by ``new_id``."""
    out = []
    i, n = 0, len(seq)
    while i < n:
        if i + 1 < n and seq[i] == pair[0] and seq[i + 1] == pair[1]:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return tuple(out)


class BPETokenizer:
    """Byte-level BPE trained from a corpus, with no vocabulary files.

    Ids 0-255 are the raw bytes; merge ``i`` (a pair of ids) makes id
    ``256 + i``. Training splits the text into word and whitespace runs,
    counts each distinct run once with its frequency, and repeatedly merges
    the adjacent pair with the highest count (the smallest pair on a tie)
    until ``vocab_size`` ids exist or no pair is left: the JAX package's
    merges and ids exactly. Encoding applies, within each run, the earliest
    trained merge present until none is; any text round-trips (a byte no
    merge covers stays its byte id). ``save``/``load`` keep the merges as a
    JSON list, the JAX package's file."""

    def __init__(self, merges) -> None:
        self.merges = [tuple(int(x) for x in m) for m in merges]
        self._rank = {pair: r for r, pair in enumerate(self.merges)}
        self.vocab = [bytes([b]) for b in range(256)]
        for left, right in self.merges:
            self.vocab.append(self.vocab[left] + self.vocab[right])
        self.vocab_size = len(self.vocab)
        self._memo: dict = {}

    @classmethod
    def train(cls, text: str, vocab_size: int) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges (fewer when the text runs out of
        pairs). Pair counts are kept up to date incrementally: a merge
        recounts only the runs that hold its pair."""
        if vocab_size < 256:
            raise ValueError("BPETokenizer: vocab_size must be >= 256")
        runs = Counter(_CHUNK.findall(text))
        words = [tuple(run.encode("utf-8")) for run in runs]
        weight = list(runs.values())
        counts: Counter = Counter()
        holders = defaultdict(set)   # pair -> runs that may hold it
        for w, word in enumerate(words):
            for pair in zip(word, word[1:]):
                counts[pair] += weight[w]
                holders[pair].add(w)
        merges = []
        while 256 + len(merges) < vocab_size:
            live = [(c, pair) for pair, c in counts.items() if c > 0]
            if not live:
                break
            top = max(c for c, _ in live)
            best = min(pair for c, pair in live if c == top)
            new_id = 256 + len(merges)
            merges.append(best)
            for w in holders.pop(best, ()):
                word = words[w]
                merged = _replace_pair(word, best, new_id)
                if merged == word:
                    continue
                for pair in zip(word, word[1:]):
                    counts[pair] -= weight[w]
                for pair in zip(merged, merged[1:]):
                    counts[pair] += weight[w]
                    holders[pair].add(w)
                words[w] = merged
            del counts[best]
        return cls(merges)

    def _encode_run(self, run: str) -> tuple:
        ids = self._memo.get(run)
        if ids is None:
            ids = tuple(run.encode("utf-8"))
            while len(ids) > 1:
                ranked = [self._rank[p] for p in zip(ids, ids[1:]) if p in self._rank]
                if not ranked:
                    break
                first = min(ranked)
                ids = _replace_pair(ids, self.merges[first], 256 + first)
            if len(self._memo) >= 1 << 16:   # bound the memo on high-cardinality text
                self._memo.clear()
            self._memo[run] = ids
        return ids

    def encode(self, text: str) -> np.ndarray:
        out = []
        for run in _CHUNK.findall(text):
            out.extend(self._encode_run(run))
        return np.asarray(out, np.int32)

    def decode(self, tokens) -> str:
        return b"".join(self.vocab[int(t)] for t in tokens).decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        """Write the merges as JSON through a temp file and a rename, so an
        interrupted save never leaves a truncated vocabulary."""
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"merges": [list(m) for m in self.merges]}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f)["merges"])


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
