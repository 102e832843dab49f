"""Ring chunk scheduling for the overlapped collective matmuls
(counterpart of ``rocket_tpu/ops/ring.py``, as plain integer math).

A ring over a model group of ``n`` ranks moves one chunk per hop, and the
product computed between hops must know which global chunk it holds
(``parallel/collectives.py`` runs the hops; the identities are held
against a brute-force simulation in ``tests/test_torch_tp.py``):

* forward ring: rank ``i`` sends to ``(i+1) % n`` every hop, so after
  ``s`` hops rank ``d`` holds the chunk that started on ``(d-s) % n``;
* all-gather ring: chunks are collected in arrival order and re-indexed
  into global order at the end (:func:`gather_order`);
* reduce-scatter ring: the accumulator that lands on rank ``d`` visits
  every other rank first, so rank ``d`` seeds it with its partial for
  chunk ``(d-1) % n`` and, after hop ``s``, adds its own partial for chunk
  :func:`rs_chunk_index` ``(d, s, n)``.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["fwd_perm", "gather_order", "rs_seed_index", "rs_chunk_index", "use_ring"]


def fwd_perm(n: int) -> List[Tuple[int, int]]:
    """The forward ring's (source, destination) pairs: ``i -> (i+1) % n``."""
    return [(i, (i + 1) % n) for i in range(n)]


def gather_order(d: int, n: int) -> List[int]:
    """Global-order indices for an all-gather ring: after ``s`` hops rank
    ``d`` holds the chunk from ``(d-s) % n``, so the arrival-order stack
    ``arr`` has ``arr[(d-j) % n] == global chunk j``; taking ``arr`` at
    these indices gives global order."""
    return [(d - j) % n for j in range(n)]


def rs_seed_index(d: int, n: int) -> int:
    """The chunk rank ``d`` seeds its reduce-scatter accumulator with:
    ``(d-1) % n``, the one that travels ``n-1`` hops to its home."""
    return (d - 1) % n


def rs_chunk_index(d: int, s: int, n: int) -> int:
    """The chunk rank ``d`` adds to the accumulator it received at hop
    ``s`` (``1 .. n-1``): ``(d - s - 1) % n``; at the last hop its own."""
    return (d - s - 1) % n


def use_ring(shard_bytes: int, mode: str, min_ring_bytes: int) -> bool:
    """Ring or bulk for one collective matmul: ``"ring"`` / ``"bulk"``
    force; ``"auto"`` rings when the per-hop chunk holds at least
    ``min_ring_bytes``, below which the ``n-1`` hops' latencies outweigh
    the compute they could hide."""
    if mode == "ring":
        return True
    if mode == "bulk":
        return False
    if mode != "auto":
        raise ValueError(f"ring mode must be ring|bulk|auto, got {mode!r}")
    return shard_bytes >= min_ring_bytes
