"""Multi-head attention for decoding — the inference half of
``rocket_tpu/nn/attention.py``: the fused QKV projection, RoPE, the
dense-cache decode step (:meth:`MultiHeadAttention.apply_cached`) and the
paged-pool step (:meth:`MultiHeadAttention.apply_paged`).

The training forward, flash, ring attention and the tensor-parallel paths
are not ported yet (ROADMAP, Queue A 1 and 6).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rocket_tpu_torch.nn.layers import Dense
from rocket_tpu_torch.nn.module import Layer
from rocket_tpu_torch.ops.decode_attention import decode_attention, decode_attention_supported
from rocket_tpu_torch.ops.paged_attention import paged_attention

__all__ = ["MultiHeadAttention", "apply_rope", "apply_rope_offsets"]


def _rope_freqs(half: int, base: float, device) -> torch.Tensor:
    """``base ** (-i / half)`` for ``i < half``, in f32."""
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device), exponent)


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half combine in f32; ``cos``/``sin`` broadcast against x's
    leading dims with ``half`` trailing. Cast back to x's dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, offset: int = 0, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on ``(B, H, T, D)`` at positions ``offset ..
    offset+T`` (rotate-half, f32 trig)."""
    half = x.shape[-1] // 2
    pos = offset + torch.arange(x.shape[-2], device=x.device)
    angles = pos[:, None].float() * _rope_freqs(half, base, x.device)[None, :]
    return _rope_rotate(x, torch.cos(angles), torch.sin(angles))


def apply_rope_offsets(x: torch.Tensor, offsets: torch.Tensor,
                       base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on feature-major ``(B, T, H, D)`` with a per-row
    offset: row ``b``'s positions are ``offsets[b] .. offsets[b]+T`` (the
    paged layout, every serving slot at its own position)."""
    half = x.shape[-1] // 2
    pos = offsets.float()[:, None] + torch.arange(x.shape[1], dtype=torch.float32,
                                                  device=x.device)[None, :]
    angles = pos[..., None] * _rope_freqs(half, base, x.device)        # (B, T, half)
    return _rope_rotate(x, torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :])


class MultiHeadAttention(Layer):
    """Self-attention with a fused ``[q | k | v]`` projection (k and v with
    ``num_kv_heads`` heads each: GQA) and GPT-2 parameter layout."""

    def __init__(
        self,
        features: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        use_bias: bool = True,
        rope: bool = False,
        rope_base: float = 10000.0,
    ):
        if features % num_heads:
            raise ValueError(
                f"MultiHeadAttention: features {features} not divisible by num_heads {num_heads}"
            )
        num_kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        if num_kv_heads < 1 or num_heads % num_kv_heads:
            raise ValueError(
                f"MultiHeadAttention: num_kv_heads {num_kv_heads} must be a positive "
                f"divisor of num_heads {num_heads}"
            )
        if rope and (features // num_heads) % 2:
            raise ValueError("MultiHeadAttention: rope needs an even head_dim")
        self.features = features
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = features // num_heads
        self.rope = rope
        self.rope_base = rope_base
        self.qkv = Dense(features, (num_heads + 2 * num_kv_heads) * self.head_dim, use_bias)
        self.proj = Dense(features, features, use_bias)

    def init_params(self, gen):
        return {"qkv": self.qkv.init_params(gen), "proj": self.proj.init_params(gen)}

    def _split(self, fused: torch.Tensor):
        """``(..., (H+2Hkv)*D)`` -> q ``(..., H, D)``, k/v ``(..., Hkv, D)``."""
        hw = self.num_heads * self.head_dim
        kvw = self.num_kv_heads * self.head_dim
        lead = fused.shape[:-1]
        q = fused[..., :hw].reshape(*lead, self.num_heads, self.head_dim)
        k = fused[..., hw:hw + kvw].reshape(*lead, self.num_kv_heads, self.head_dim)
        v = fused[..., hw + kvw:].reshape(*lead, self.num_kv_heads, self.head_dim)
        return q, k, v

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None) -> dict:
        """Empty ``(B, Hkv, T_max, D)`` K/V caches for :meth:`apply_cached`."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def apply_cached(self, params, x: torch.Tensor, cache: dict, pos: int):
        """Cached decode: ``x`` ``(B, S, D)`` at key positions ``[pos,
        pos+S)``; attends causally over ``cache[:pos+S]``. The caches are
        updated in place. Returns ``(out, cache)``.

        S = 1 steps on CUDA run the fused kernel (``ops/decode_attention``:
        row write + attention in one launch); prefill (S > 1) and CPU
        tensors take the einsum path, as the JAX package does on CPU."""
        b, s, _ = x.shape
        q, k, v = (t.transpose(1, 2) for t in self._split(self.qkv(params["qkv"], x)))
        if self.rope:
            # Keys enter the cache already rotated; cached rows never re-rotate.
            q = apply_rope(q, pos, self.rope_base)
            k = apply_rope(k, pos, self.rope_base)
        k_cache, v_cache = cache["k"], cache["v"]

        if s == 1 and x.is_cuda and decode_attention_supported(self.head_dim):
            out3, _, _ = decode_attention(
                q[:, :, 0].contiguous(),
                k[:, :, 0].to(k_cache.dtype).contiguous(),
                v[:, :, 0].to(v_cache.dtype).contiguous(),
                k_cache, v_cache, pos,
            )
            return self.proj(params["proj"], out3.reshape(b, 1, self.features)), cache

        k_cache[:, :, pos:pos + s] = k.to(k_cache.dtype)
        v_cache[:, :, pos:pos + s] = v.to(v_cache.dtype)
        h_kv = self.num_kv_heads
        g = self.num_heads // h_kv
        q5 = q.reshape(b, h_kv, g, s, self.head_dim)
        logits = torch.einsum("bkgqd,bkmd->bkgqm", q5.float(), k_cache.float())
        logits = logits / math.sqrt(self.head_dim)
        t_max = k_cache.shape[-2]
        # Query at position pos+i may see key positions <= pos+i.
        mask = (torch.arange(t_max, device=x.device)[None, :]
                <= pos + torch.arange(s, device=x.device)[:, None])
        logits = logits.masked_fill(~mask, float("-inf"))
        weights = torch.softmax(logits, dim=-1).to(v_cache.dtype)
        out = torch.einsum("bkgqm,bkmd->bkgqd", weights, v_cache)
        out = out.reshape(b, self.num_heads, s, self.head_dim).transpose(1, 2)
        return self.proj(params["proj"], out.reshape(b, s, self.features)), cache

    def apply_paged(self, params, x, k_pages, v_pages, block_table, positions, valid):
        """Paged-pool chunk: ``x`` ``(S, C, D)``, slot ``s``'s chunk at global
        positions ``[positions[s], positions[s]+C)`` with its first
        ``valid[s]`` rows real. K/V rows go into the pool in place, then
        attention runs over the slot's prefix (``ops/paged_attention``).
        Returns ``(out (S, C, D), k_pages, v_pages)``."""
        q, k, v = self._split(self.qkv(params["qkv"], x))
        if self.rope:
            q = apply_rope_offsets(q, positions, self.rope_base)
            k = apply_rope_offsets(k, positions, self.rope_base)
        out, k_pages, v_pages = paged_attention(
            q, k, v, k_pages, v_pages, block_table, positions, valid
        )
        return self.proj(params["proj"], out), k_pages, v_pages

    def __repr__(self):
        kv = f", kv={self.num_kv_heads}" if self.num_kv_heads != self.num_heads else ""
        return f"MultiHeadAttention(d={self.features}, h={self.num_heads}{kv})"
