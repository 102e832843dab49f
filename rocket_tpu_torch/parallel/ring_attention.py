"""Ring attention — sequence parallelism for long contexts (counterpart of
``rocket_tpu/parallel/ring_attention.py``).

The sequence axis is sharded over the Runtime's ``seq`` mesh axis: each
rank holds a contiguous block of Q, K and V (rank ``r`` the positions
``[r·T/n, (r+1)·T/n)``). K/V blocks rotate around the seq group's ring,
and each rank accumulates its Q block's attention over every K/V block
with the flash-attention online-softmax recurrence (:func:`_block_attend`:
f32 accumulators, the ``_NEG_BIG`` mask, not ``-inf``), so the full (T, T)
score matrix never exists and a block's is ``(T/n, T/n)``.

Differences from the reference, none of which changes the function:

* the reference's last rotation, which only restores the loop's shape,
  is left out (``n - 1`` hops a pass);
* a causal block that lies wholly in a rank's future (its K/V rank above
  the Q rank) is skipped: the reference's recurrence adds exactly zero for
  it (``exp(_NEG_BIG - m)`` underflows once the rank's own block has set
  ``m``, and that block comes first);
* the backward is written by hand (:class:`_RingAttention`), as the flash
  kernels' is: the forward saves only q, k, v, the output and the
  log-sum-exp; the backward recomputes each block's probabilities, rotates
  K/V again with their f32 gradient accumulators beside them, and sends
  each block's dK/dV home with one more hop. Autodiff of the forward
  would keep every block's (T/n, T/n) probabilities for the backward.

The hops go through ``parallel.collectives.Hop``: over gloo a CUDA block
crosses through host memory. The block products are plain ``torch``
matmuls in f32 (the reference's einsums accumulate in f32 outside any
Pallas kernel, so no kernel stands behind this module). :data:`STATS`
counts the hops, their bytes and the seconds waited on them, and the
forward's K/V hops and bytes apart (``kv_hops``, ``kv_bytes``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from rocket_tpu_torch.parallel.collectives import Hop

__all__ = ["ring_attention", "ring_attention_sharded", "SeqSpec", "seq_spec", "next_tokens",
           "STATS", "reset_stats"]

_NEG_BIG = -1e30  # mask value: large-negative, not -inf (NaN-safe recurrence)

#: Per-process counters of the ring's hops (module docstring).
STATS: dict = {"wait_s": 0.0, "wire_bytes": 0, "hops": 0, "kv_hops": 0, "kv_bytes": 0,
               "staged": False}


def reset_stats() -> None:
    STATS.update(wait_s=0.0, wire_bytes=0, hops=0, kv_hops=0, kv_bytes=0)


@dataclass(frozen=True)
class SeqSpec:
    """The sequence group of one rank: ``group`` its process group (None
    for a group of one), ``ranks`` its global ranks in coordinate order,
    ``index`` this rank's coordinate (its block of every sequence)."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def seq_spec(runtime=None) -> Optional[SeqSpec]:
    """The :class:`SeqSpec` of ``runtime`` (default the current Runtime)
    when its mesh has a sequence axis, else None."""
    if runtime is None:
        from rocket_tpu_torch.runtime import Runtime

        runtime = Runtime.current()
    axis = getattr(runtime, "seq_axis", None)
    if axis is None:
        return None
    spec = getattr(runtime, "_seq_spec", None)
    if spec is None:
        n = runtime.seq_axis_size
        spec = SeqSpec(group=runtime.axis_group(axis) if n > 1 else None,
                       ranks=tuple(runtime.axis_ranks(axis)), index=runtime.axis_index(axis))
        runtime._seq_spec = spec
    return spec


def _hop(spec: SeqSpec, tensors, shift: int = 1) -> list:
    """Send ``tensors`` ``shift`` ranks on around the ring and receive the
    same shapes from ``shift`` ranks back."""
    n, r = spec.size, spec.index
    hop = Hop(spec.group, [(t, spec.ranks[(r + shift) % n]) for t in tensors],
              [(t, spec.ranks[(r - shift) % n]) for t in tensors], stats=STATS,
              what="ring attention")
    STATS["hops"] += 1
    return hop


def next_tokens(spec: SeqSpec, tokens: torch.Tensor) -> torch.Tensor:
    """The first token column ``(B,)`` of the next rank's block of every
    sequence (the target of this block's last position); the last rank
    gets the first rank's, which no loss reads."""
    first = tokens[:, 0].contiguous()
    if spec.size == 1:
        return first
    return _hop(spec, [first], shift=-1).wait()[0]


def _logits(q, k, q_offset: int, kv_offset: int, causal: bool) -> torch.Tensor:
    """f32 ``q kᵀ / sqrt(D)`` of a block pair, masked to ``_NEG_BIG``
    above the causal diagonal of the global positions."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        q_pos = q_offset + torch.arange(q.shape[-2], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[-2], device=q.device)
        logits = torch.where(q_pos[:, None] >= kv_pos[None, :], logits,
                             torch.full((), _NEG_BIG, device=q.device))
    return logits


def _block_attend(q, k, v, q_offset, kv_offset, causal, m, l, o):
    """One online-softmax accumulation step of q against a (k, v) block
    (the reference's ``_block_attend``): q ``(B, H, Tq, D)``, k/v ``(B, H,
    Tk, D)``; m, l ``(B, H, Tq)`` and o ``(B, H, Tq, D)`` in f32. The
    probabilities are cast to v's dtype before the f32-accumulated PV
    product, as there."""
    logits = _logits(q, k, q_offset, kv_offset, causal)
    m_new = torch.maximum(m, logits.amax(-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * correction + p.sum(-1)
    o_new = o * correction[..., None] + torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def _skipped(kv_rank: int, rank: int, causal: bool) -> bool:
    """A causal block wholly in the future of every query of this rank."""
    return causal and kv_rank > rank


class _RingAttention(torch.autograd.Function):
    """Ring attention of this rank's blocks with the hand-written backward
    (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, spec, causal):
        n, r = spec.size, spec.index
        b, h, t, d = q.shape
        m = torch.full((b, h, t), _NEG_BIG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            hop = None
            if step < n - 1:
                hop = _hop(spec, [k_blk, v_blk])
                STATS["kv_hops"] += 1
                STATS["kv_bytes"] += k_blk.nbytes + v_blk.nbytes
            kv_rank = (r - step) % n
            if not _skipped(kv_rank, r, causal):
                m, l, o = _block_attend(q, k_blk, v_blk, r * t, kv_rank * t, causal, m, l, o)
            if hop is not None:
                k_blk, v_blk = hop.wait()
        l = torch.clamp(l, min=1e-30)
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.spec, ctx.causal = spec, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        spec, causal = ctx.spec, ctx.causal
        n, r = spec.size, spec.index
        t = q.shape[-2]
        scale = 1.0 / math.sqrt(q.shape[-1])
        do = dout.float()
        delta = (do * out).sum(-1)                                 # (B, H, T)
        qf = q.float()
        dq = torch.zeros_like(qf)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            kv_rank = (r - step) % n
            if not _skipped(kv_rank, r, causal):
                p = torch.exp(_logits(q, k_blk, r * t, kv_rank * t, causal) - lse[..., None])
                dv_blk = dv_blk + torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, v_blk.float().transpose(-1, -2)) - delta[..., None])
                del p
                dq = dq + torch.matmul(ds, k_blk.float()) * scale
                dk_blk = dk_blk + torch.matmul(ds.transpose(-1, -2), qf) * scale
                del ds
            if step < n - 1:
                k_blk, v_blk, dk_blk, dv_blk = _hop(spec, [k_blk, v_blk, dk_blk, dv_blk]).wait()
            elif n > 1:
                # The accumulators of the block held last go home, one hop on.
                dk_blk, dv_blk = _hop(spec, [dk_blk, dv_blk]).wait()
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: SeqSpec,
                   causal: bool = True) -> torch.Tensor:
    """Per-rank body: this rank's blocks ``(B, H, T_loc, D)`` of q, k and
    v, the sequence sharded over ``spec``'s group -> this rank's block of
    the attention output, in q's dtype."""
    return _RingAttention.apply(q, k, v, spec, causal)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, runtime=None,
                           seq_axis: str = "seq", causal: bool = True) -> torch.Tensor:
    """The Runtime's entry (the reference's global-view entry over its
    mesh): this rank's ``(B, H, T_loc, D)`` blocks, the sequence sharded
    over ``runtime``'s (default the current Runtime's) ``seq_axis``; the
    batch dim is this rank's data stripe already."""
    spec = seq_spec(runtime)
    if spec is None or (runtime is not None and runtime.seq_axis != seq_axis):
        raise RuntimeError(f"ring_attention_sharded needs a Runtime whose mesh has a "
                           f"{seq_axis!r} axis (e.g. Runtime(mesh_shape={{'data': 2, "
                           f"'{seq_axis}': 4}})).")
    return ring_attention(q, k, v, spec, causal)
