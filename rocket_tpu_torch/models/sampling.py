"""Token sampling shared by ``generate()`` and the serve engine
(counterpart of ``rocket_tpu/models/sampling.py``).

The work splits in two:

* :func:`filter_logits` — the deterministic half: top-k, temperature
  scaling and top-p, each as a Python scalar (one value for the batch)
  or a per-row tensor. Its masks equal the JAX package's exactly, which
  is what the tests compare.
* :func:`draw` — the random half: Gumbel-max over uniforms hashed from a
  ``seed`` and a ``salt``. The salt plays the part of JAX's ``fold_in``:
  a scalar salt is shared by the batch (rows differ by their row index,
  the ``generate()`` convention), a per-row salt keys each row alone (the
  serve convention: a slot's draw never depends on its neighbours or on
  how waves were grouped into dispatches). The hash runs on the logits'
  device, so a decode loop never synchronises with the host and keeps no
  generator state. Callers take ``seed`` from a ``torch.Generator``. The
  bits cannot match JAX's random bits.

Per-row conventions: ``temperature <= 0`` greedy, ``top_k <= 0`` no
top-k filter, ``top_p >= 1`` no nucleus filter, ``eos < 0`` EOS freezing
off (frozen rows fill with 0).
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["filter_logits", "draw", "sample_tokens", "freeze_after_eos", "seed_from"]

_M32 = 0xFFFFFFFF


def _scalar(value) -> bool:
    """A Python or numpy scalar; tensors (even 0-d) are per-row values."""
    return isinstance(value, numbers.Number)


def _top_k(logits, top_k):
    if top_k is None:
        return logits
    if _scalar(top_k):
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        return logits.masked_fill(logits < kth, float("-inf"))
    vocab = logits.shape[-1]
    k = torch.as_tensor(top_k, device=logits.device).long()
    ranked = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(ranked, -1, (k.clamp(1, vocab) - 1)[..., None])
    return logits.masked_fill((k[..., None] > 0) & (logits < kth), float("-inf"))


def _top_p(scaled, top_p):
    if top_p is None or (_scalar(top_p) and top_p >= 1.0):
        return scaled
    # Nucleus: keep the smallest descending-probability prefix whose mass
    # reaches top_p (the first token always survives: cum - p < top_p).
    ranked = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(ranked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if _scalar(top_p):
        p = float(top_p)  # a Python scalar: no host-to-device copy
    else:
        p = torch.as_tensor(top_p, device=scaled.device).float()[..., None]
    keep = cum - probs < p
    cutoff = torch.where(keep, ranked, float("inf")).amin(-1, keepdim=True)
    if not _scalar(top_p):
        cutoff = torch.where(p < 1.0, cutoff, float("-inf"))   # row opt-out
    return scaled.masked_fill(scaled < cutoff, float("-inf"))


def filter_logits(logits, temperature, top_k=None, top_p=None):
    """The deterministic half of sampling on ``logits`` ``(..., V)``.

    Returns ``(scaled, greedy)``: the top-k-filtered, temperature-scaled,
    top-p-filtered f32 logits (``-inf`` where masked; a greedy row is
    scaled by 1), and the argmax of the top-k-filtered logits."""
    logits = _top_k(logits.float(), top_k)
    greedy = torch.argmax(logits, dim=-1)
    if _scalar(temperature):
        scaled = logits / temperature if temperature > 0 else logits
    else:
        t = torch.as_tensor(temperature, device=logits.device).float()
        scaled = logits / torch.where(t > 0, t, torch.ones_like(t))[..., None]
    return _top_p(scaled, top_p), greedy


def _mix_int(x: int) -> int:
    """The host twin of :func:`_mix` on a Python int (its low 32 bits)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _mix(x):
    """A 32-bit integer hash (xor-shift-multiply) on int64 tensors holding
    values below 2**32; multipliers below 2**31 keep products in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def draw(scaled, seed: int, salt):
    """Gumbel-max draw from ``scaled`` ``(rows, V)`` (or ``(V,)``).

    ``salt`` is an int (shared by the batch; the row index separates the
    rows) or a per-row integer tensor (each row keyed by its own salt).
    Masked (``-inf``) entries are never drawn."""
    from rocket_tpu_torch.nn import keys

    keys.note_draw("sample", (int(seed), salt), ("range", 0, scaled.numel()), scaled.shape)
    squeeze = scaled.dim() == 1
    scaled = scaled.reshape(-1, scaled.shape[-1])
    rows, vocab = scaled.shape
    device = scaled.device
    idx = torch.arange(vocab, device=device, dtype=torch.int64)[None, :]
    # The seed's and a shared salt's hashes on the host: a scalar made on
    # the device would be a synchronising copy every wave.
    base = _mix_int(int(seed) & _M32)
    if isinstance(salt, torch.Tensor) and salt.dim() > 0:
        key = _mix(salt.to(device=device, dtype=torch.int64).reshape(rows, 1) & _M32 ^ base)
    else:
        key = _mix_int((int(salt) & _M32) ^ base)
        idx = idx + vocab * torch.arange(rows, device=device, dtype=torch.int64)[:, None]
    bits = _mix((key * 0x5BD1E995 + idx) & _M32)
    bits = _mix(bits ^ key)
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))         # (0, 1)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return sampled[0] if squeeze else sampled


def sample_tokens(logits, seed: int, salt, temperature, top_k=None, top_p=None):
    """Next tokens from ``logits`` ``(..., V)``: :func:`filter_logits` then
    :func:`draw`; rows with ``temperature <= 0`` take the greedy pick."""
    scaled, greedy = filter_logits(logits, temperature, top_k, top_p)
    if _scalar(temperature):
        return greedy if temperature <= 0 else draw(scaled, seed, salt)
    t = torch.as_tensor(temperature, device=logits.device)
    return torch.where(t > 0, draw(scaled, seed, salt), greedy)


def freeze_after_eos(nxt, done, eos):
    """Force the fill token for rows whose carried ``done`` flag is set and
    fold this step's token into the flag. ``eos`` is an int (always on) or
    a per-row tensor where ``< 0`` disables EOS for that row (such rows
    fill with 0 once frozen)."""
    if _scalar(eos):
        nxt = torch.where(done, torch.full_like(nxt, int(eos)), nxt)
        return nxt, done | (nxt == int(eos))
    eos = torch.as_tensor(eos, device=nxt.device).to(nxt.dtype)
    enabled = eos >= 0
    fill = torch.where(enabled, eos, torch.zeros_like(eos))
    nxt = torch.where(done, fill, nxt)
    return nxt, done | (enabled & (nxt == eos))


def seed_from(generator) -> int:
    """A 31-bit sampling seed drawn from a ``torch.Generator`` (CPU)."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator).item())
