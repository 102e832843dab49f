"""Decoder-only transformer LM for decoding and serving (counterpart of
``rocket_tpu/models/transformer.py``): the config and its presets, the
pre-LN :class:`Block` decode paths and :class:`TransformerLM`'s
``init`` / ``init_cache`` / ``decode_step`` / ``decode_step_paged``, plus
:func:`generate` with the KV cache.

Parameters are nested dicts laid out as the JAX param tree with the
per-layer ``blocks`` subtree (a scanned JAX tree's ``blocks_stacked`` is
unstacked by ``rocket_tpu_torch.bridge``). Not ported yet, and raising
``NotImplementedError`` where a config asks for them: the training
forward and ``generate(use_cache=False)`` (ROADMAP Queue A 1), MoE
(Queue A 5), pipeline and tensor parallelism (Queue A 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rocket_tpu_torch.models.sampling import freeze_after_eos, sample_tokens, seed_from
from rocket_tpu_torch.nn.attention import MultiHeadAttention
from rocket_tpu_torch.nn.layers import Dense, Embedding, LayerNorm, RMSNorm, gelu, silu
from rocket_tpu_torch.nn.module import Layer, map_params
from rocket_tpu_torch.runtime import resolve_device

__all__ = ["TransformerConfig", "TransformerLM", "Block", "generate", "decode_params"]


@dataclass
class TransformerConfig:
    vocab_size: int
    max_seq_len: int
    dim: int
    num_layers: int
    num_heads: int
    #: Grouped-query attention: K/V heads (None = num_heads; 1 = MQA).
    num_kv_heads: Optional[int] = None
    mlp_ratio: int = 4
    #: Training-only in the JAX package; decoding runs in eval semantics.
    dropout: float = 0.0
    tied_embeddings: bool = True
    #: Activation dtype of the trunk (e.g. "bfloat16"); params stay f32
    #: masters and are cast once before decoding (:func:`decode_params`).
    activation_dtype: Optional[str] = None
    #: "learned" (GPT-2 wpe table) or "rope".
    pos_embedding: str = "learned"
    rope_base: float = 10000.0
    #: "layernorm" (GPT-2) or "rmsnorm" (Llama family).
    norm: str = "layernorm"
    #: "gelu" (GPT-2) or "swiglu" (Llama family).
    mlp: str = "gelu"
    #: Mixture-of-Experts FFN: not ported yet (must stay 0).
    num_experts: int = 0
    #: Pipeline parallelism: not ported yet (must stay None).
    pipeline_axis: Optional[str] = None

    def validate(self) -> None:
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"TransformerConfig: unknown norm {self.norm!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"TransformerConfig: unknown mlp {self.mlp!r}")
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(f"TransformerConfig: unknown pos_embedding {self.pos_embedding!r}")
        if self.num_experts > 0:
            raise NotImplementedError(
                "TransformerConfig: MoE (num_experts > 0) is not ported yet "
                "(ROADMAP Queue A 5)"
            )
        if self.pipeline_axis is not None:
            raise NotImplementedError(
                "TransformerConfig: pipeline parallelism is not ported yet (ROADMAP Queue A 6)"
            )

    def norm_cls(self):
        self.validate()
        return RMSNorm if self.norm == "rmsnorm" else LayerNorm

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype as a torch dtype (float32 when unset)."""
        return getattr(torch, self.activation_dtype or "float32")

    @staticmethod
    def char_lm(vocab_size: int = 128, max_seq_len: int = 256) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size, max_seq_len=max_seq_len,
            dim=256, num_layers=6, num_heads=4, dropout=0.1,
            activation_dtype="bfloat16",
        )

    @staticmethod
    def gpt2_124m(vocab_size: int = 50257, max_seq_len: int = 1024) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size, max_seq_len=max_seq_len,
            dim=768, num_layers=12, num_heads=12, dropout=0.1,
            activation_dtype="bfloat16",
        )

    @staticmethod
    def llama_style(vocab_size: int = 50257, max_seq_len: int = 1024, dim: int = 768,
                    num_layers: int = 12, num_heads: int = 12,
                    num_kv_heads: int = 4) -> "TransformerConfig":
        """RoPE positions, RMSNorm, SwiGLU FFN, GQA, untied head."""
        return TransformerConfig(
            vocab_size=vocab_size, max_seq_len=max_seq_len,
            dim=dim, num_layers=num_layers, num_heads=num_heads,
            num_kv_heads=num_kv_heads, pos_embedding="rope", norm="rmsnorm",
            mlp="swiglu", tied_embeddings=False, dropout=0.0,
            activation_dtype="bfloat16",
        )

    @staticmethod
    def gpt2_350m(vocab_size: int = 50257, max_seq_len: int = 1024) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size, max_seq_len=max_seq_len,
            dim=1024, num_layers=24, num_heads=16, dropout=0.1,
            activation_dtype="bfloat16",
        )


class Block(Layer):
    """Pre-LN block: ``x += attn(ln1(x)); x += mlp(ln2(x))``."""

    def __init__(self, config: TransformerConfig):
        c = config
        norm_cls = c.norm_cls()
        self.ln1 = norm_cls(c.dim)
        self.attn = MultiHeadAttention(
            c.dim, c.num_heads, num_kv_heads=c.num_kv_heads,
            rope=c.pos_embedding == "rope", rope_base=c.rope_base,
        )
        self.ln2 = norm_cls(c.dim)
        hidden = c.mlp_ratio * c.dim
        self.fc_in = Dense(c.dim, hidden)        # the "up" projection under swiglu
        self.fc_gate = Dense(c.dim, hidden) if c.mlp == "swiglu" else None
        self.fc_out = Dense(hidden, c.dim)
        # GPT-2: residual projections scaled by 1/sqrt(2 * num_layers).
        self._resid_scale = (2 * c.num_layers) ** -0.5

    def init_params(self, gen):
        params = {
            "ln1": self.ln1.init_params(gen),
            "attn": self.attn.init_params(gen),
            "ln2": self.ln2.init_params(gen),
            "mlp": {"fc_in": self.fc_in.init_params(gen), "fc_out": self.fc_out.init_params(gen)},
        }
        if self.fc_gate is not None:
            params["mlp"]["fc_gate"] = self.fc_gate.init_params(gen)
        params["attn"]["proj"]["w"] *= self._resid_scale
        params["mlp"]["fc_out"]["w"] *= self._resid_scale
        return params

    def _mlp(self, p, h):
        up = self.fc_in(p["fc_in"], h)
        if self.fc_gate is not None:
            h = silu(self.fc_gate(p["fc_gate"], h)) * up
        else:
            h = gelu(up)
        return self.fc_out(p["fc_out"], h)

    def apply_cached(self, params, x, cache: dict, pos: int):
        """``(B, S, D)`` through the block with the dense KV cache."""
        h, cache = self.attn.apply_cached(params["attn"], self.ln1(params["ln1"], x), cache, pos)
        x = x + h
        return x + self._mlp(params["mlp"], self.ln2(params["ln2"], x)), cache

    def apply_paged(self, params, x, k_pages, v_pages, block_table, positions, valid):
        """``(S, C, D)`` through the block against a paged KV pool."""
        h, k_pages, v_pages = self.attn.apply_paged(
            params["attn"], self.ln1(params["ln1"], x), k_pages, v_pages,
            block_table, positions, valid,
        )
        x = x + h
        return x + self._mlp(params["mlp"], self.ln2(params["ln2"], x)), k_pages, v_pages


class TransformerLM:
    """GPT-2 / Llama-style decoder LM: the decode and serving entry points."""

    def __init__(self, config: TransformerConfig):
        config.validate()
        self.config = config
        self.wte = Embedding(config.vocab_size, config.dim)
        self.wpe = (
            None if config.pos_embedding == "rope"
            else Embedding(config.max_seq_len, config.dim)
        )
        self.blocks = [Block(config) for _ in range(config.num_layers)]
        self.ln_f = config.norm_cls()(config.dim)
        self.head = (
            None if config.tied_embeddings
            else Dense(config.dim, config.vocab_size, use_bias=False)
        )

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> dict:
        """Random f32 parameters (GPT-2 init: normal(0.02) embeddings,
        truncated lecun-normal kernels, residual projections scaled by
        ``1/sqrt(2L)``), drawn on the CPU from ``generator`` (seed 0 when
        None) and moved to ``device``."""
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {"wte": self.wte.init_params(gen)}
        if self.wpe is not None:
            params["wpe"] = self.wpe.init_params(gen)
        params["blocks"] = {str(i): b.init_params(gen) for i, b in enumerate(self.blocks)}
        params["ln_f"] = self.ln_f.init_params(gen)
        if self.head is not None:
            params["head"] = self.head.init_params(gen)
        return map_params(lambda t: t.to(device), params)

    # -- incremental decoding ---------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None) -> list:
        """Per-layer KV caches for :meth:`decode_step`: a list of L dicts.
        Each layer gets its OWN tensors — the caches are updated in place."""
        attn = self.blocks[0].attn
        return [attn.init_cache(batch, max_len, dtype, device) for _ in self.blocks]

    def _head(self, params, x):
        x = self.ln_f(params["ln_f"], x[:, -1:])  # only the last position is consumed
        if self.head is not None:
            logits = self.head(params["head"], x)
        else:
            logits = torch.einsum("btd,vd->btv", x, params["wte"]["table"].to(x.dtype))
        return logits[:, 0]

    def decode_step(self, params, tokens, caches, pos: int):
        """``tokens`` ``(B, S)`` written at positions ``[pos, pos+S)``
        (S = the prompt for the batched prefill, 1 per step after) ->
        ``(logits (B, V) of the LAST position, caches)``; the caches are
        updated in place."""
        s = tokens.shape[1]
        x = self.wte(params["wte"], tokens)
        if self.wpe is not None:
            # dynamic_slice semantics: the window start is clamped in range.
            start = max(0, min(int(pos), self.config.max_seq_len - s))
            x = x + params["wpe"]["table"][start:start + s]
        x = x.to(self.config.dtype)
        for i, block in enumerate(self.blocks):
            x, caches[i] = block.apply_cached(params["blocks"][str(i)], x, caches[i], pos)
        return self._head(params, x), caches

    def decode_step_paged(self, params, tokens, k_pages, v_pages, block_table, positions, valid):
        """Decode/prefill chunk against an external paged pool.

        ``tokens`` ``(S, C)`` — slot ``s``'s chunk at global positions
        ``[positions[s], positions[s]+C)`` with its first ``valid[s]`` rows
        real; ``k_pages``/``v_pages`` the layer-stacked pool ``(L, NB, BL,
        Hkv, D)``, updated IN PLACE layer by layer (the JAX step donates
        the pool and returns a new one; here the update is the donation).
        Returns ``(logits (S, V) of the chunk's LAST position, k_pages,
        v_pages)``. C = 1 is the decode wave, C = chunk the prefill step."""
        c = tokens.shape[1]
        x = self.wte(params["wte"], tokens)
        if self.wpe is not None:
            steps = torch.arange(c, device=tokens.device, dtype=torch.int64)
            pos_ids = (positions.long()[:, None] + steps[None, :]).clamp(
                0, self.config.max_seq_len - 1
            )
            x = x + params["wpe"]["table"][pos_ids]
        x = x.to(self.config.dtype)
        for i, block in enumerate(self.blocks):
            x, _, _ = block.apply_paged(
                params["blocks"][str(i)], x, k_pages[i], v_pages[i],
                block_table, positions, valid,
            )
        return self._head(params, x), k_pages, v_pages


def decode_params(params: dict, activation_dtype: Optional[str]) -> dict:
    """Cast float params ONCE to the compute dtype before decoding: decode
    streams every weight each step, and reading f32 masters to make bf16
    operands would double the bytes on the binding resource."""
    if activation_dtype is None:
        return params
    dt = getattr(torch, activation_dtype)
    return map_params(lambda t: t.to(dt) if t.is_floating_point() else t, params)


def _as_rows(value, b: int, what: str) -> np.ndarray:
    if np.ndim(value) == 0:
        return np.full((b,), int(value), np.int32)
    rows = np.asarray(value, np.int32)
    if rows.shape != (b,):
        raise ValueError(f"generate: per-sequence {what} must have shape ({b},), got {rows.shape}")
    return rows


def generate(
    model: TransformerLM,
    params: dict,
    prompt_tokens,
    max_new_tokens,
    *,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_token_id=None,
    use_cache: bool = True,
    device=None,
) -> torch.Tensor:
    """Autoregressive sampling through the per-layer KV caches.

    The prompt is prefilled in one batched pass, then each token is one
    S = 1 :meth:`TransformerLM.decode_step` (on CUDA: one fused
    ``decode_attention`` kernel per layer). ``temperature=0`` is greedy;
    otherwise ``generator`` (a ``torch.Generator``) seeds the draws, and
    the per-step salt is the position, as in the JAX package.
    ``max_new_tokens`` and ``eos_token_id`` may be per-sequence arrays:
    the loop runs to the longest limit and sequences that hit their own
    limit (or EOS) freeze, filling with their EOS (or 0 without one).
    Returns ``(B, prompt_len + max(max_new_tokens))`` int32 on the device.

    ``use_cache=False`` (recomputing the prefix through the training
    forward) is not ported yet (ROADMAP Queue A 1)."""
    if not use_cache:
        raise NotImplementedError(
            "generate(use_cache=False) needs the training forward and flash "
            "attention, not ported yet (ROADMAP Queue A 1)"
        )
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int32))
    if prompt.dim() == 1:
        prompt = prompt[None, :]
    b, start = prompt.shape
    per_seq_new = _as_rows(max_new_tokens, b, "max_new_tokens")
    if (per_seq_new < 0).any():
        raise ValueError("generate: max_new_tokens must be >= 0")
    total = start + int(per_seq_new.max())
    if total > model.config.max_seq_len:
        raise ValueError(
            f"generate: prompt {start} + new {int(per_seq_new.max())} tokens exceed "
            f"max_seq_len {model.config.max_seq_len}"
        )
    if temperature > 0 and generator is None:
        raise ValueError("generate: sampling (temperature > 0) needs a torch.Generator")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"generate: top_p must be in (0, 1], got {top_p}")
    eos_vec = torch.as_tensor(
        _as_rows(-1 if eos_token_id is None else eos_token_id, b, "eos_token_id"),
        device=device,
    )
    seed = seed_from(generator) if generator is not None else 0

    params = decode_params(map_params(lambda t: t.to(device), params),
                           model.config.activation_dtype)
    buf = torch.zeros((b, total), dtype=torch.int32, device=device)
    buf[:, :start] = prompt.to(device)
    limits = torch.as_tensor(start + per_seq_new, device=device)
    caches = model.init_cache(b, total, model.config.dtype, device)
    with torch.no_grad():
        logits, caches = model.decode_step(params, buf[:, :start], caches, 0)
        done = start >= limits
        for i in range(start, total):
            nxt = sample_tokens(logits, seed, i, temperature, top_k, top_p)
            nxt, done = freeze_after_eos(nxt.to(torch.int32), done, eos_vec)
            done = done | (i + 1 >= limits)
            buf[:, i] = nxt
            logits, caches = model.decode_step(params, buf[:, i:i + 1], caches, i)
    return buf
