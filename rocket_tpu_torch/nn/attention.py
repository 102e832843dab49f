"""Multi-head attention (counterpart of ``rocket_tpu/nn/attention.py``):
the fused QKV projection, RoPE, the training forward
(:meth:`MultiHeadAttention.apply`: the flash kernels of
``ops/flash_native.py`` or the plain path), its tensor-parallel form
(:meth:`MultiHeadAttention._apply_tp`: one gather feeding q, k and v on
this rank's heads, the output projection reduce-scattered), the
dense-cache decode step (:meth:`MultiHeadAttention.apply_cached`) and the
paged-pool step (:meth:`MultiHeadAttention.apply_paged`), and the ring
path (:meth:`MultiHeadAttention._apply_ring`, ``impl="ring"``): the
sequence sharded over the Runtime's seq axis, K/V rotating around its
ring (``parallel/ring_attention.py``). Every other impl on a seq-sharded
batch gathers the sequence (:meth:`MultiHeadAttention._apply_seq`), and
under tensor parallelism heads that do not divide the model group run the
replicated program (:meth:`MultiHeadAttention._apply_tp_replicated`). A
rank holds its own stripe of the batch and its own heads, so the flash
kernels run on them directly: the mesh seams of ``ops/flash_native.py``
would call the same kernel on the same local heads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.layers import Dense
from rocket_tpu_torch.nn.module import Layer
from rocket_tpu_torch.ops.decode_attention import decode_attention, decode_attention_supported
from rocket_tpu_torch.ops.flash_native import flash_bthd, flash_fused, flash_supported
from rocket_tpu_torch.ops.paged_attention import paged_attention

__all__ = [
    "MultiHeadAttention", "apply_rope", "apply_rope_bthd", "apply_rope_offsets",
    "dot_product_attention", "grouped_dot_product_attention", "resolve_impl",
]

#: "xla" is the reference's name of the plain path.
IMPLS = ("auto", "plain", "xla", "flash", "ring")


def resolve_impl(impl: str, d: int, device) -> str:
    """Resolve an ``attention_impl`` of "auto" to "plain" or "flash", by
    the reference's rule (``rocket_tpu/nn/attention.py:97``).

    CPU tensors take the plain path (the reference's "xla" on the CPU).
    CUDA tensors take the flash kernels for every head dim D <= 128 (D in
    ``ops.flash_native.HEAD_DIMS`` runs its own kernel, any other D the
    next compiled one on zero-padded heads) and the plain path above 128,
    where no kernel exists. T needs no rule: the kernels take any T (the
    reference's 128-multiple block rule is a TPU rule). Nor does the mesh:
    the reference falls back to "xla" on a mesh where neither the batch nor
    the heads shard, because GSPMD would gather a replicated kernel call's
    batch; a rank of the port already holds its stripe, so nothing is
    gathered (a known difference by design). Explicit impls pass through
    (an explicit "flash" past D = 128 raises in the kernel wrapper; "ring"
    is :meth:`MultiHeadAttention._apply_ring`'s)."""
    if impl != "auto":
        return impl
    if torch.device(device).type == "cpu" or not flash_supported(d):
        return "plain"
    return "flash"


def dot_product_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """``(B, H, T, D)`` attention, scores and softmax in f32, the weights
    cast to v's dtype before the PV product (the plain path)."""
    t_q, d = q.shape[-2], q.shape[-1]
    t_k = k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril(t_k - t_q)
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def grouped_dot_product_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """GQA attention: q ``(B, H, Tq, D)`` against k/v ``(B, Hkv, Tk, D)``,
    each kv head serving its group of H/Hkv query heads (no repeat of K/V).
    f32 softmax."""
    b, h, t_q, d = q.shape
    h_kv, t_k = k.shape[1], k.shape[-2]
    q5 = q.reshape(b, h_kv, h // h_kv, t_q, d)
    logits = torch.einsum("bkgqd,bkmd->bkgqm", q5.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril(t_k - t_q)
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqm,bkmd->bkgqd", weights.to(v.dtype), v)
    return out.reshape(b, h, t_q, d)


def _rope_freqs(half: int, base: float, device) -> torch.Tensor:
    """``base ** (-i / half)`` for ``i < half``, in f32. The base stays a
    Python number (an f32 kernel argument): a tensor made of it would be a
    host-to-device copy in every training step."""
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    return float(base) ** exponent


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


def apply_rope_bthd(x: torch.Tensor, offset: int = 0, base: float = 10000.0) -> torch.Tensor:
    """:func:`apply_rope` on feature-major ``(B, T, H, D)``, the flash
    kernels' layout: positions ``offset .. offset+T`` along axis 1."""
    half = x.shape[-1] // 2
    pos = offset + torch.arange(x.shape[1], device=x.device)
    angles = pos[:, None].float() * _rope_freqs(half, base, x.device)[None, :]
    return _rope_rotate(x, torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :])


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
    ``num_kv_heads`` heads each: GQA) and GPT-2 parameter layout.
    ``dropout`` drops the attention OUTPUT (``(B, T, H, D)``, before the
    output projection) in train mode, as the reference does."""

    def __init__(
        self,
        features: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        causal: bool = True,
        dropout: float = 0.0,
        use_bias: bool = True,
        impl: str = "auto",
        rope: bool = False,
        rope_base: float = 10000.0,
        seq_axis: str = "seq",
    ):
        if features % num_heads:
            raise ValueError(
                f"MultiHeadAttention: features {features} not divisible by num_heads {num_heads}"
            )
        if impl not in IMPLS:
            raise ValueError(f"MultiHeadAttention: unknown impl {impl!r}")
        num_kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        if num_kv_heads < 1 or num_heads % num_kv_heads:
            raise ValueError(
                f"MultiHeadAttention: num_kv_heads {num_kv_heads} must be a positive "
                f"divisor of num_heads {num_heads}"
            )
        if num_kv_heads != num_heads and impl == "ring":
            raise ValueError("MultiHeadAttention: impl='ring' requires num_kv_heads == num_heads")
        if rope and (features // num_heads) % 2:
            raise ValueError("MultiHeadAttention: rope needs an even head_dim")
        self.features = features
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = features // num_heads
        self.causal = causal
        self.dropout = dropout
        self.impl = impl
        self.rope = rope
        self.rope_base = rope_base
        self.seq_axis = seq_axis
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

    def _attn_dropout(self, out, mode, rng, split=None):
        """Attention-output dropout, salted ``fold_in(rng, 1)``; ``split``
        places a head shard in the global ``(B, T, H, D)`` array."""
        if not (self.dropout and mode == "train"):
            return out
        if rng is None:
            raise ValueError("MultiHeadAttention: dropout needs rng in train")
        keep = 1.0 - self.dropout
        mask = keys.dropout_mask(keys.fold_in(rng, 1), keep, out.shape, out.device, split)
        return torch.where(mask, out / keep, torch.zeros((), dtype=out.dtype, device=out.device))

    def _rotate(self, q2, k2, h, h_kv, offset: int = 0):
        """RoPE on feature-major ``(B, T, h*D)`` q and ``(B, T, h_kv*D)`` k
        (as they are without ``rope``) at positions ``offset ..
        offset+T``."""
        if not self.rope:
            return q2, k2
        b, t, d = q2.shape[0], q2.shape[1], self.head_dim
        return (apply_rope_bthd(q2.reshape(b, t, h, d), offset,
                                self.rope_base).reshape(b, t, h * d),
                apply_rope_bthd(k2.reshape(b, t, h_kv, d), offset,
                                self.rope_base).reshape(b, t, h_kv * d))

    def _core(self, q2, k2, v2, h, h_kv, device):
        """Attention over feature-major ``(B, T, h*D)`` q and ``(B, T,
        h_kv*D)`` k/v (RoPE applied) -> ``(B, T, h, D)``: the flash kernels
        (``flash_bthd``) or the plain path, as :func:`resolve_impl` says."""
        b, t = q2.shape[:2]
        d = self.head_dim
        if resolve_impl(self.impl, d, device) == "flash":
            return flash_bthd(q2, k2, v2, h, h_kv, causal=self.causal).reshape(b, t, h, d)
        q = q2.reshape(b, t, h, d).transpose(1, 2)
        k = k2.reshape(b, t, h_kv, d).transpose(1, 2)
        v = v2.reshape(b, t, h_kv, d).transpose(1, 2)
        if h_kv != h:
            out = grouped_dot_product_attention(q, k, v, causal=self.causal)
        else:
            out = dot_product_attention(q, k, v, causal=self.causal)
        return out.transpose(1, 2)

    def _tp_spec(self):
        """The active tensor-parallel spec, or None (reference
        ``attention.py:420-438``). Heads that do not divide the group take
        :meth:`_apply_tp_replicated`; a sequence that does not divide it
        runs the whole model's replicated program (the Module's)."""
        from rocket_tpu_torch.parallel.collectives import current_tp

        return current_tp()

    def _apply_tp(self, spec, params, x: torch.Tensor, mode: str, rng) -> torch.Tensor:
        """The tensor-parallel path (reference ``rocket_tpu/nn/attention.py:
        448-503``): ``x`` arrives as this rank's sequence shard ``(B, T/n,
        D)``; one gather feeds its heads' q, k and v (``qkv_fused_views``
        rebuilds the head-aligned columns from the contiguous shard), the
        attention runs on the ``H/n`` (and ``Hkv/n``) local heads, and the
        output projection reduce-scatters back onto the sequence shards."""
        from rocket_tpu_torch.parallel import collectives as coll

        n = spec.tp_size
        if self.num_heads % n or self.num_kv_heads % n:
            return self._apply_tp_replicated(spec, params, x, mode, rng)
        b, t = x.shape[0], x.shape[1] * n
        dt, d = x.dtype, self.head_dim
        h, h_kv = self.num_heads // n, self.num_kv_heads // n
        pq, pp = params["qkv"], params["proj"]
        wq, wk, wv, bq, bk, bv = coll.qkv_fused_views(
            spec, pq["w"].to(dt), pq["b"].to(dt) if "b" in pq else None,
            self.num_heads * d, self.num_kv_heads * d)
        q2, k2, v2 = coll.all_gather_matmul(spec, x, (wq, wk, wv))
        if bq is not None:
            q2, k2, v2 = q2 + bq, k2 + bk, v2 + bv
        q2, k2 = self._rotate(q2, k2, h, h_kv)
        out = self._core(q2, k2, v2, h, h_kv, x.device)
        out = self._attn_dropout(out, mode, rng, split=(2, spec.index, n))
        return coll.matmul_reduce_scatter(spec, out.reshape(b, t, h * d), pp["w"].to(dt),
                                          bias=pp["b"].to(dt) if "b" in pp else None)

    def _apply_tp_replicated(self, spec, params, x: torch.Tensor, mode: str,
                             rng) -> torch.Tensor:
        """The replicated program over the model group, where the query or
        key/value heads do not divide it (the reference's plain GSPMD
        program for the layer): the sequence shards and the layer's
        model-sharded leaves gathered whole, the attention run whole on
        every rank, this rank's rows of its output kept. The output's
        gradient is gathered whole (``seq_shard``), so every rank computes
        the complete, equal gradients and keeps its own part of each."""
        from rocket_tpu_torch.parallel import collectives as coll

        coll.note_replicated("attention")
        width = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        pq, pp = params["qkv"], params["proj"]
        whole = {"qkv": {"w": coll.gather_whole(spec, pq["w"], 1, width)},
                 "proj": {"w": coll.gather_whole(spec, pp["w"], 0, self.features)}}
        if "b" in pq:
            whole["qkv"]["b"] = coll.gather_whole(spec, pq["b"], 0, width)
        if "b" in pp:
            whole["proj"]["b"] = pp["b"]
        out = self._apply_whole(whole, coll.seq_all_gather(spec, x), mode, rng)
        return coll.seq_shard(spec, out)

    def _apply_seq(self, seq, params, x: torch.Tensor, mode: str, rng) -> torch.Tensor:
        """A non-ring impl on a seq-sharded batch (the reference's seam
        in-spec ``P(batch, None, heads)`` gathers the sequence): ``x`` is
        this rank's block ``(B, T/n, D)``; its q, k and v are gathered
        over the seq group (the flash kernels take one T for q and K/V),
        the attention runs on the whole sequence, and this rank keeps its
        block of the output. The gather's backward reduce-scatters the
        partial cotangents onto the blocks (``seq_gather_sum``)."""
        from rocket_tpu_torch.parallel import collectives as coll

        b, t, _ = x.shape
        whole = coll.seq_gather_sum(seq, self.qkv(params["qkv"], x))
        out = self._attend(whole).chunk(seq.size, 1)[seq.index]
        out = self._attn_dropout(out, mode, rng, split=(1, seq.index, seq.size))
        return self.proj(params["proj"], out.reshape(b, t, self.features))

    def _ring_spec(self):
        """The sequence group of ``impl="ring"``: the current Runtime's (a
        group of one where its seq axis has size 1), as the reference pins
        its Runtime's mesh."""
        from rocket_tpu_torch.parallel.ring_attention import seq_spec
        from rocket_tpu_torch.runtime import Runtime

        runtime = Runtime.current()
        if runtime is None or runtime.seq_axis != self.seq_axis:
            raise RuntimeError("MultiHeadAttention(impl='ring') needs a live Runtime whose mesh "
                               f"has a {self.seq_axis!r} axis (e.g. Runtime(mesh_shape="
                               f"{{'data': 2, '{self.seq_axis}': 4}})).")
        return seq_spec(runtime)

    def _apply_ring(self, params, x: torch.Tensor, mode: str, rng) -> torch.Tensor:
        """The sequence-parallel path (reference ``attention.py:391-420``):
        ``x`` is this rank's block ``(B, T/n, D)`` of every sequence; RoPE
        rotates at the block's global positions, K/V rotate around the seq
        group's ring (``parallel/ring_attention.py``), and the output
        dropout draws the block's part of the global mask."""
        from rocket_tpu_torch.parallel.ring_attention import ring_attention

        spec = self._ring_spec()
        b, t, _ = x.shape
        h, d = self.num_heads, self.head_dim
        fused = self.qkv(params["qkv"], x)
        q2, k2 = self._rotate(fused[..., :h * d], fused[..., h * d:2 * h * d], h, h,
                              offset=spec.index * t)
        q, k, v = (u.reshape(b, t, h, d).transpose(1, 2)
                   for u in (q2, k2, fused[..., 2 * h * d:]))
        out = ring_attention(q, k, v, spec, causal=self.causal).transpose(1, 2)
        split = (1, spec.index, spec.size) if spec.size > 1 else None
        out = self._attn_dropout(out, mode, rng, split=split)
        return self.proj(params["proj"], out.reshape(b, t, self.features))

    def apply(self, params, x: torch.Tensor, *, mode: str = "train", rng=None) -> torch.Tensor:
        """Full-sequence attention ``(B, T, D) -> (B, T, D)``; under an
        active tensor-parallel context, :meth:`_apply_tp` on the sequence
        shard; with ``impl="ring"``, :meth:`_apply_ring` on this rank's
        block of the sequence, and with another impl on a seq-sharded batch
        :meth:`_apply_seq`.

        The flash path keeps operands feature-major: MHA without RoPE runs
        :func:`flash_fused` on the QKV projection output itself; RoPE or
        GQA slice it into ``(B, T, Hq*D)`` / ``(B, T, Hkv*D)`` operands for
        :func:`flash_bthd`. The plain path is head-major einsums."""
        spec = self._tp_spec()
        if spec is not None:
            return self._apply_tp(spec, params, x, mode, rng)
        if self.impl == "ring":
            return self._apply_ring(params, x, mode, rng)
        from rocket_tpu_torch.parallel.ring_attention import seq_spec

        seq = seq_spec()
        if seq is not None and seq.size > 1:
            return self._apply_seq(seq, params, x, mode, rng)
        return self._apply_whole(params, x, mode, rng)

    def _attend(self, fused: torch.Tensor) -> torch.Tensor:
        """The attention core on the whole sequence's fused projection
        output ``(B, T, (H+2Hkv)*D)`` of every head -> ``(B, T, H, D)``."""
        b, t, _ = fused.shape
        h, h_kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        if resolve_impl(self.impl, d, fused.device) == "flash" and not self.rope and h_kv == h:
            return flash_fused(fused, h, causal=self.causal).reshape(b, t, h, d)
        hw, kvw = h * d, h_kv * d
        q2, k2 = self._rotate(fused[..., :hw], fused[..., hw:hw + kvw], h, h_kv)
        return self._core(q2, k2, fused[..., hw + kvw:], h, h_kv, fused.device)

    def _apply_whole(self, params, x: torch.Tensor, mode: str, rng) -> torch.Tensor:
        """Every head on the whole sequence ``x`` (the path off the mesh)."""
        b, t, _ = x.shape
        out = self._attend(self.qkv(params["qkv"], x))
        out = self._attn_dropout(out, mode, rng, split=keys.current_split())
        return self.proj(params["proj"], out.reshape(b, t, self.features))

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
