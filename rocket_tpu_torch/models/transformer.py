"""Decoder-only transformer LM (counterpart of
``rocket_tpu/models/transformer.py``): the config and its presets, the
pre-LN :class:`Block`, :class:`TransformerLM`'s training forward
(``apply``, with the fused chunked head + cross-entropy), its decode
entry points (``init_cache`` / ``decode_step`` / ``decode_step_paged``),
:func:`next_token_loss` and :func:`generate` (KV cache or recompute).

Parameters are nested dicts laid out as the JAX param tree with the
per-layer ``blocks`` subtree (a scanned JAX tree's ``blocks_stacked`` is
unstacked by ``rocket_tpu_torch.bridge``). With ``num_experts > 0`` each
block's FFN is the routed MoE (``nn/moe.py``, params under ``moe``): the
training forward surfaces the layers' summed, pre-weighted load-balancing
loss as ``batch["moe_aux_loss"]`` (which :func:`next_token_loss` adds) and
their mean dropped fraction as ``batch["moe_frac_dropped"]``; the decode
paths route each position as the reference does. Under a
tensor-parallel context (``parallel/collectives.py``, installed by the
Module for ``gpt2_tp_rules``) :meth:`TransformerLM.apply` runs the
residual stream sequence-sharded over the model group (reference
``rocket_tpu/models/transformer.py:948-1097``). On a Runtime with a seq
axis, ``attention_impl="ring"`` runs each rank's block of every sequence
(positions, dropout masks and the next-token loss across the blocks'
edges at their global places). With ``pipeline_axis`` the blocks run as
pipeline stages over that mesh axis (``parallel/pipeline.py``): GPipe for
eval and both schedules' training through
:meth:`TransformerLM.pipelined_value_and_grad`. The MoE runs under every
axis: over an ``expert`` axis each rank computes its own experts
(``nn/moe.py``); under tensor parallelism and ring attention it gathers
the sequence at its boundary (its routing groups span the whole
sequence), counting the aux loss ``1/n`` on each seq rank, whose loss is a
share; under GPipe the aux loss rides the pipeline's aux channel (each
stage's layers, the microbatch mean, in the stage's own loss share); 1F1B
refuses MoE at config time, as the reference. ``scan_layers``
keeps the blocks a Python loop (a scanned JAX tree's ``blocks_stacked``
is unstacked on load); with ``scan_remat`` the train forward checkpoints
each block under ``scan_remat_policy``, as the reference's scanned body
does (:meth:`Block.apply_remat`).

``Block``'s attention half takes the fused whole-block kernel
(``ops/fused_block.py``) where the reference's gate would: the
``block_attn`` tune table pins it (``rocket_tpu_torch.tune``; shipped
empty, as the reference's) or ``ROCKET_TPU_BLOCK_ATTN=fused`` forces it.
By default the chain is the per-op one, as before.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from rocket_tpu_torch.models.sampling import freeze_after_eos, sample_tokens, seed_from
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.attention import IMPLS, MultiHeadAttention
from rocket_tpu_torch.nn.layers import (
    Dense,
    Dropout,
    Embedding,
    LayerNorm,
    RMSNorm,
    gelu_fn,
    silu_fn,
)
from rocket_tpu_torch.nn.module import Layer, map_params
from rocket_tpu_torch.nn.moe import MoE
from rocket_tpu_torch.ops import fused_block
from rocket_tpu_torch.runtime import resolve_device

__all__ = [
    "TransformerConfig", "TransformerLM", "Block", "next_token_loss", "generate",
    "decode_params",
]


#: The non-batched matrix products a ``"dots"`` remat saves.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_save_dots_context = functools.partial(create_selective_checkpoint_contexts, _save_dots)


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
    #: Train-mode dropout on the embedding, each residual branch and the
    #: attention output; decoding runs in eval semantics.
    dropout: float = 0.0
    #: Causal (decoder) attention; False builds encoder blocks.
    causal: bool = True
    tied_embeddings: bool = True
    #: "auto" | "plain" (alias "xla", the reference's name) | "flash"
    #: (``nn.attention.resolve_impl``) | "ring": the sequence sharded over
    #: the Runtime's ``seq_axis`` (``parallel/ring_attention.py``).
    attention_impl: str = "auto"
    #: Mesh axis of impl="ring".
    seq_axis: str = "seq"
    #: The blocks run as a Python loop either way and a scanned JAX tree's
    #: ``blocks_stacked`` is unstacked on load (``bridge.py``). With
    #: ``scan_layers`` and ``scan_remat`` the train forward recomputes each
    #: block in the backward: ``scan_remat_policy`` None saves only the
    #: block's input, ``"dots"`` also the outputs of its non-batched matrix
    #: products, ``"block_io"`` also its attention half's output (one
    #: checkpoint per half). ``scan_unroll`` has no effect in the port.
    scan_layers: bool = False
    scan_remat: bool = True
    scan_remat_policy: Optional[str] = None
    scan_unroll: int = 1
    #: Pipeline parallelism: the blocks run as stages over this mesh axis
    #: (``parallel/pipeline.py``; lay the params out with
    #: ``parallel.sharding.pipeline_rules``; requires ``scan_layers``),
    #: in ``pipeline_microbatches`` microbatches (default 2P), on the
    #: "gpipe" or "1f1b" schedule (the latter's live activations O(P)).
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: Optional[int] = None
    pipeline_schedule: str = "gpipe"
    #: ``num_experts`` routed experts per block FFN (``nn/moe.py``); 0 =
    #: dense. ``expert_dispatch``: "einsum" (default), "scatter" or
    #: "dropless" (grouped matmuls over exactly the routed rows).
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    expert_dispatch: str = "einsum"
    #: Weight of the router load-balancing loss, surfaced pre-weighted as
    #: ``batch["moe_aux_loss"]``.
    moe_aux_weight: float = 0.01
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
    #: Fused head + cross-entropy chunk (0 = off): in train mode the model
    #: writes the next-token NLL (``batch["nll"]``) computed per T-chunk
    #: with each chunk's logits recomputed in the backward, so the (B, T,
    #: V) logits never exist. Eval mode always materializes logits.
    loss_chunk: int = 0
    #: Label smoothing of the training loss (target (1-eps) one-hot + eps
    #: uniform), applied by whichever loss path runs.
    label_smoothing: float = 0.0

    def validate(self) -> None:
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"TransformerConfig: unknown norm {self.norm!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"TransformerConfig: unknown mlp {self.mlp!r}")
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(f"TransformerConfig: unknown pos_embedding {self.pos_embedding!r}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(
                f"TransformerConfig: label_smoothing must be in [0, 1), got {self.label_smoothing}"
            )
        if self.attention_impl not in IMPLS:
            raise ValueError(f"TransformerConfig: unknown attention_impl {self.attention_impl!r}")
        if self.scan_remat_policy not in (None, "dots", "block_io"):
            raise ValueError(f"TransformerConfig: unknown scan_remat_policy "
                             f"{self.scan_remat_policy!r} (None | 'dots' | 'block_io')")
        if self.num_experts > 0 and self.mlp != "gelu":
            raise ValueError(f"TransformerConfig: mlp={self.mlp!r} has no effect with "
                             "num_experts > 0 (the MoE brings its own FFN)")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"TransformerConfig: unknown pipeline_schedule "
                             f"{self.pipeline_schedule!r} ('gpipe' | '1f1b')")
        if self.pipeline_schedule == "1f1b" and self.num_experts > 0:
            raise ValueError("TransformerConfig: pipeline_schedule='1f1b' does not carry the MoE "
                             "aux-loss channel; use 'gpipe' for MoE pipelines.")
        if self.pipeline_schedule == "1f1b" and not self.pipeline_axis:
            raise ValueError("TransformerConfig: pipeline_schedule='1f1b' requires "
                             "pipeline_axis — without it the model would silently train "
                             "unpipelined on the standard O(M)-memory path.")

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
            activation_dtype="bfloat16", loss_chunk=128,
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
            activation_dtype="bfloat16", loss_chunk=128,
        )

    @staticmethod
    def gpt2_350m(vocab_size: int = 50257, max_seq_len: int = 1024) -> "TransformerConfig":
        return TransformerConfig(
            vocab_size=vocab_size, max_seq_len=max_seq_len,
            dim=1024, num_layers=24, num_heads=16, dropout=0.1,
            activation_dtype="bfloat16", loss_chunk=128,
        )


class Block(Layer):
    """Pre-LN block: ``x += attn(ln1(x)); x += mlp(ln2(x))``."""

    def __init__(self, config: TransformerConfig, layer_idx: int = 0):
        c = config
        norm_cls = c.norm_cls()
        self.ln1 = norm_cls(c.dim)
        self.attn = MultiHeadAttention(
            c.dim, c.num_heads, num_kv_heads=c.num_kv_heads, causal=c.causal,
            dropout=c.dropout, impl=c.attention_impl,
            rope=c.pos_embedding == "rope", rope_base=c.rope_base, seq_axis=c.seq_axis,
        )
        self.ln2 = norm_cls(c.dim)
        hidden = c.mlp_ratio * c.dim
        if c.num_experts > 0:
            self.moe = MoE(c.dim, hidden, c.num_experts, top_k=c.expert_top_k,
                           capacity_factor=c.expert_capacity_factor, dispatch=c.expert_dispatch)
            self.fc_in = self.fc_gate = self.fc_out = None
        else:
            self.moe = None
            self.fc_in = Dense(c.dim, hidden)        # the "up" projection under swiglu
            self.fc_gate = Dense(c.dim, hidden) if c.mlp == "swiglu" else None
            self.fc_out = Dense(hidden, c.dim)
        self.dropout = Dropout(c.dropout) if c.dropout else None
        # GPT-2: residual projections scaled by 1/sqrt(2 * num_layers).
        self._resid_scale = (2 * c.num_layers) ** -0.5
        self.layer_idx = layer_idx
        # The fused ln1 + QKV + attention (+ proj) kernel covers exactly the
        # LayerNorm / learned-positions / MHA / causal / biased layer (the
        # char-LM shape) outside ring attention; anything else stays on the
        # per-op chain.
        self._block_attn_ok = (
            c.attention_impl != "ring"
            and c.norm == "layernorm"
            and c.pos_embedding != "rope"
            and c.causal
            and (c.num_kv_heads is None or c.num_kv_heads == c.num_heads)
            and self.ln1.use_bias
            and self.attn.qkv.use_bias
            and self.attn.proj.use_bias
        )

    def init_params(self, gen):
        params = {
            "ln1": self.ln1.init_params(gen),
            "attn": self.attn.init_params(gen),
            "ln2": self.ln2.init_params(gen),
        }
        params["attn"]["proj"]["w"] *= self._resid_scale
        if self.moe is not None:
            params["moe"] = self.moe.init_params(gen)
            params["moe"]["experts"]["w_out"] *= self._resid_scale
            return params
        params["mlp"] = {"fc_in": self.fc_in.init_params(gen),
                         "fc_out": self.fc_out.init_params(gen)}
        if self.fc_gate is not None:
            params["mlp"]["fc_gate"] = self.fc_gate.init_params(gen)
        params["mlp"]["fc_out"]["w"] *= self._resid_scale
        return params

    def _ffn(self, params, h, seq=None):
        """The FFN half on ``ln2(x)``: ``(out, aux)``, with ``aux`` the MoE's
        ``{"aux_loss", "frac_dropped"}`` or None for the dense MLP. Under a
        tensor-parallel context the MLP takes the collective matmuls
        (reference ``transformer.py:520-560``): one gather feeds the
        column-parallel projection(s) (swiglu's two share it), the
        activation runs on this rank's hidden shard, and ``fc_out``
        reduce-scatters onto the sequence shards (a width that does not
        divide the group runs :meth:`_ffn_replicated`); the MoE gathers the
        sequence itself, as under a seq axis (``seq``)."""
        if self.moe is not None:
            return self.moe.apply(params["moe"], h, seq=seq)
        p = params["mlp"]
        from rocket_tpu_torch.parallel import collectives as coll

        spec = coll.current_tp()
        if spec is not None and (self.fc_in.out_features % spec.tp_size):
            return self._ffn_replicated(spec, p, h), None
        if spec is not None:
            dt = h.dtype
            ws = [p["fc_in"]["w"].to(dt)]
            if self.fc_gate is not None:
                ws.append(p["fc_gate"]["w"].to(dt))
            outs = coll.all_gather_matmul(spec, h, ws)
            up = outs[0] + p["fc_in"]["b"].to(dt)
            if self.fc_gate is not None:
                hid = silu_fn(outs[1] + p["fc_gate"]["b"].to(dt)) * up
            else:
                hid = gelu_fn(up)
            return coll.matmul_reduce_scatter(spec, hid, p["fc_out"]["w"].to(dt),
                                              bias=p["fc_out"]["b"].to(dt)), None
        return self._mlp(p, h), None

    def _mlp(self, p, h):
        """The dense MLP on ``h`` whole (off the mesh)."""
        up = self.fc_in(p["fc_in"], h)
        if self.fc_gate is not None:
            h = silu_fn(self.fc_gate(p["fc_gate"], h)) * up
        else:
            h = gelu_fn(up)
        return self.fc_out(p["fc_out"], h)

    def _ffn_replicated(self, spec, p, h):
        """The dense MLP as the replicated program over the model group,
        where its width does not divide it (the reference's plain GSPMD
        program, ``transformer.py:522-532``): its leaves are whole (a rule
        never shards a dim that does not divide), the sequence shards are
        gathered, the MLP runs whole on every rank, and this rank's rows of
        its output are kept (their gradient gathered whole, so each rank's
        gradients are complete and equal)."""
        from rocket_tpu_torch.parallel import collectives as coll

        coll.note_replicated("mlp")
        return coll.seq_shard(spec, self._mlp(p, coll.seq_all_gather(spec, h)))

    def apply(self, params, x, *, mode="train", rng=None):
        """``(B, T, D)`` through the block (:meth:`apply_aux` without the
        MoE's aux outputs)."""
        return self.apply_aux(params, x, mode=mode, rng=rng)[0]

    def _keys(self, rng):
        """The reference's keys: ``split(fold_in(rng, layer_idx), 3)`` for
        attention and the two residual dropouts."""
        if rng is None:
            return (None, None, None)
        return keys.split(keys.fold_in(rng, self.layer_idx), 3)

    @staticmethod
    def _split():
        """Where the residual stream's dropout masks sit in the global
        array: this rank's sequence shard under tensor parallelism or ring
        attention, a pipeline microbatch's rows (``keys.current_split``),
        or None."""
        from rocket_tpu_torch.parallel.collectives import current_tp
        from rocket_tpu_torch.parallel.ring_attention import seq_spec

        spec = current_tp()
        if spec is not None:
            return (1, spec.index, spec.tp_size)
        seq = seq_spec()
        if seq is not None and seq.size > 1:
            return (1, seq.index, seq.size)
        return keys.current_split()

    def _attn_residual(self, params, x, mode, rngs):
        """``x + dropout(attn(ln1(x)))``: the attention half and its residual."""
        h = self._attn_half(params, x, mode, rngs[0])
        if self.dropout is not None:
            h = self.dropout.apply({}, h, mode=mode, rng=rngs[1], split=self._split())
        return x + h

    def _ring_seq(self):
        """The sequence group when the MoE must gather the sequence (a seq
        axis larger than 1), else None."""
        if self.moe is None:
            return None
        from rocket_tpu_torch.parallel.ring_attention import seq_spec

        seq = seq_spec()
        return seq if seq is not None and seq.size > 1 else None

    def _ffn_residual(self, params, x, mode, rngs):
        """``(x + dropout(ffn(ln2(x))), aux)``: the FFN half and its residual."""
        h, aux = self._ffn(params, self.ln2(params["ln2"], x), seq=self._ring_seq())
        if self.dropout is not None:
            h = self.dropout.apply({}, h, mode=mode, rng=rngs[2], split=self._split())
        return x + h, aux

    def apply_aux(self, params, x, *, mode="train", rng=None):
        """``(B, T, D)`` through the block -> ``(x, aux)``, ``aux`` as in
        :meth:`_ffn`."""
        rngs = self._keys(rng)
        return self._ffn_residual(params, self._attn_residual(params, x, mode, rngs), mode, rngs)

    def apply_remat(self, params, x, *, rng=None, policy=None):
        """:meth:`apply_aux` in train mode, recomputed in the backward (the
        reference's scanned body under ``jax.checkpoint(policy=...)``):
        ``policy`` None keeps only the block's input; ``"dots"`` also the
        outputs of the non-batched matrix products (``aten.mm``/``addmm``,
        as ``dots_with_no_batch_dims_saveable``); ``"block_io"`` checkpoints
        each half apart, so it also keeps the attention half's output, with
        its residual added, which the FFN half starts from (the projections
        and the attention are recomputed). The dropout keys are counter
        hashes, so a recompute draws the same masks."""
        if policy == "block_io":
            rngs = self._keys(rng)
            x = checkpoint(self._attn_residual, params, x, "train", rngs, use_reentrant=False)
            return checkpoint(self._ffn_residual, params, x, "train", rngs, use_reentrant=False)
        context_fn = _save_dots_context if policy == "dots" else noop_context_fn
        return checkpoint(self.apply_aux, params, x, mode="train", rng=rng, use_reentrant=False,
                          context_fn=context_fn)

    def _block_attn_config(self, x):
        """The ``block_attn`` config when the fused kernel serves this call,
        else None. It engages only when the tune table or the
        ``ROCKET_TPU_BLOCK_ATTN`` override pins ``impl="fused"``; forced,
        it runs on the CPU too, through the kernel's plain version (the
        reference's interpret mode). Shapes past
        :func:`block_attn_supported` or the kernel's own limits stay on
        the per-op chain, and so does every block under tensor parallelism
        (reference ``transformer.py:422``)."""
        if not self._block_attn_ok or x.dim() != 3 or self._split() is not None:
            return None
        b, t, d = x.shape
        h = self.attn.num_heads
        from rocket_tpu_torch.tune import get_config

        config = get_config("block_attn", shape={"b": b, "t": t, "d": d, "h": h},
                            dtype=x.dtype) or {}
        forced = os.environ.get("ROCKET_TPU_BLOCK_ATTN")
        if (forced or config.get("impl", "reference")) != "fused":
            return None
        if not forced and x.device.type == "cpu":
            return None
        block_b = config.get("block_b", 1)
        epilogue = config.get("epilogue", "fused")
        if not (fused_block.block_attn_supported(b, t, d, h, block_b)
                and fused_block.kernel_supported(t, d, h, epilogue)):
            return None
        return {"epilogue": epilogue, "block_b": block_b}

    def _attn_half(self, params, x, mode, rng):
        """ln1 + attention, through the per-op chain (the default) or the
        fused kernel when :meth:`_block_attn_config` pins it. Train-mode
        attention dropout forces ``epilogue="separate"``: dropout sits
        between the attention core and the output projection, so the
        kernel stops there and the same dropout + projection run outside."""
        cfg = self._block_attn_config(x)
        if cfg is None:
            return self.attn.apply(params["attn"], self.ln1(params["ln1"], x), mode=mode, rng=rng)
        attn, pa = self.attn, params["attn"]
        epilogue = cfg["epilogue"]
        if attn.dropout and mode == "train":
            epilogue = "separate"
        out = fused_block.block_attn_half(
            x, params["ln1"]["scale"], params["ln1"]["bias"], pa["qkv"]["w"], pa["qkv"]["b"],
            pa["proj"]["w"], pa["proj"]["b"], num_heads=attn.num_heads, eps=self.ln1.eps,
            causal=attn.causal, epilogue=epilogue, block_b=cfg["block_b"],
        )
        if epilogue == "separate":
            b, t, _ = x.shape
            out = attn._attn_dropout(out.reshape(b, t, attn.num_heads, attn.head_dim), mode, rng)
            out = attn.proj(pa["proj"], out.reshape(b, t, attn.features))
        return out

    def apply_cached(self, params, x, cache: dict, pos: int):
        """``(B, S, D)`` through the block with the dense KV cache."""
        h, cache = self.attn.apply_cached(params["attn"], self.ln1(params["ln1"], x), cache, pos)
        x = x + h
        return x + self._ffn(params, self.ln2(params["ln2"], x))[0], cache

    def apply_paged(self, params, x, k_pages, v_pages, block_table, positions, valid):
        """``(S, C, D)`` through the block against a paged KV pool."""
        h, k_pages, v_pages = self.attn.apply_paged(
            params["attn"], self.ln1(params["ln1"], x), k_pages, v_pages,
            block_table, positions, valid,
        )
        x = x + h
        return x + self._ffn(params, self.ln2(params["ln2"], x))[0], k_pages, v_pages


class TransformerLM:
    """GPT-2 / Llama-style decoder LM.

    Batch contract of :meth:`apply`: reads ``batch["tokens"]`` (B, T) and
    writes ``batch["logits"]`` (B, T, V) — except in train mode with
    ``config.loss_chunk > 0`` (and T a multiple of it), where the fused
    head + cross-entropy writes the scalar ``batch["nll"]`` and no logits
    exist."""

    def __init__(self, config: TransformerConfig, tokens_key: str = "tokens",
                 logits_key: str = "logits"):
        config.validate()
        self.config = config
        self.tokens_key = tokens_key
        self.logits_key = logits_key
        self.wte = Embedding(config.vocab_size, config.dim)
        self.wpe = (
            None if config.pos_embedding == "rope"
            else Embedding(config.max_seq_len, config.dim)
        )
        self.blocks = [Block(config, i) for i in range(config.num_layers)]
        self.ln_f = config.norm_cls()(config.dim)
        self.head = (
            None if config.tied_embeddings
            else Dense(config.dim, config.vocab_size, use_bias=False)
        )
        self.drop = Dropout(config.dropout) if config.dropout else None

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

    @staticmethod
    def tp_partial(path) -> bool:
        """Whether the replicated leaf at ``path`` gets a partial gradient
        under tensor parallelism: the norms, which run on the sequence
        shards (the Module sums these over the model group). Every other
        replicated leaf is used on a whole sequence repeated on every rank
        (the embeddings before :func:`seq_shard`, the head after
        :func:`seq_all_gather`, the row-parallel biases whose gradient the
        collective computes from the gathered ``dy``), so its gradient is
        complete on each."""
        return len(path) >= 2 and path[-2] in ("ln1", "ln2", "ln_f")

    def num_params(self, params: dict) -> int:
        """The number of parameter elements."""
        sizes = []
        map_params(lambda t: sizes.append(t.numel()), params)
        return sum(sizes)

    # -- the training forward ----------------------------------------------

    def tp_serves(self, batch: dict, n: int) -> bool:
        """Whether the tensor-parallel path serves ``batch`` over ``n``
        model ranks (reference ``transformer.py:946-957``): not for a
        sequence that does not divide the group. Where it does not, the
        Module runs the whole model's replicated program over the model
        group. Heads or an MLP width that do not divide fall back per layer
        inside the path."""
        return batch[self.tokens_key].shape[1] % n == 0

    def _tp_spec(self, t: int):
        """The active tensor-parallel spec for this forward, or None. A
        sequence that does not divide the group runs the replicated program
        (:meth:`tp_serves`, the Module's), never this path; the query and
        key/value heads and the dense MLP width may not divide it (those
        layers run their replicated program)."""
        from rocket_tpu_torch.parallel.collectives import current_tp

        spec = current_tp()
        if spec is None:
            return None
        if t % spec.tp_size:
            raise RuntimeError(
                f"TransformerLM: the tensor-parallel path over {spec.tp_size} ranks needs the "
                f"sequence ({t}) to divide the model axis; such a batch runs the replicated "
                "program (Module asks tp_serves)")
        return spec

    def _embed_tp(self, spec, params, tokens):
        """The TP embedding -> this rank's ``(B, T/n, D)`` rows: the
        vocab-parallel lookup reduce-scattered onto the sequence shards
        where the table is vocab-sharded and there are no learned
        positions (the Llama-style path); else the whole lookup (a
        vocab-sharded table summed over the group) plus ``wpe``, then
        :func:`seq_shard` (GPT-2's path)."""
        from rocket_tpu_torch.parallel import collectives as coll

        c = self.config
        table = params["wte"]["table"]
        sharded = table.shape[0] != c.vocab_size
        if spec.vocab_sharded_embed and sharded and self.wpe is None:
            return coll.embed_lookup_sharded(spec, table, tokens,
                                             compute_dtype=c.dtype if c.activation_dtype else None)
        x = coll.vocab_lookup(spec, table, tokens) if sharded else self.wte(params["wte"], tokens)
        if self.wpe is not None:
            x = x + params["wpe"]["table"][:tokens.shape[1]]
        return coll.seq_shard(spec, x)

    def _whole_head(self, spec, params) -> dict:
        """``params`` with a vocab-sharded head (or tied table) gathered
        whole, for a head repeated on every rank of the group over the
        gathered sequence (its gradient is then complete on each)."""
        from rocket_tpu_torch.parallel import collectives as coll

        v = self.config.vocab_size
        params = dict(params)
        if self.head is not None and params["head"]["w"].shape[1] != v:
            params["head"] = {"w": coll.gather_replicated(spec, params["head"]["w"], 1)}
        elif self.head is None and params["wte"]["table"].shape[0] != v:
            params["wte"] = {"table": coll.gather_replicated(spec, params["wte"]["table"], 0)}
        return params

    def _seq_spec(self):
        """The sequence group when the current Runtime shards the token dim
        (a seq axis larger than 1), else None. Ring attention rotates K/V
        around it; every other impl gathers the sequence in each attention
        layer (``MultiHeadAttention._apply_seq``)."""
        from rocket_tpu_torch.parallel.ring_attention import seq_spec

        spec = seq_spec()
        if spec is None or spec.size <= 1:
            return None
        return spec

    def _embed(self, params, tokens, mode, rng, seq=None, spec=None):
        """The embedding (tokens, positions, cast, dropout) -> ``(x,
        split)``: under tensor parallelism this rank's sequence shard, under
        ring attention this rank's block at its global positions; ``split``
        places the rows' dropout masks."""
        c = self.config
        t = tokens.shape[1]
        split = None
        if spec is not None:
            x = self._embed_tp(spec, params, tokens)
            split = (1, spec.index, spec.tp_size)
        else:
            x = self.wte(params["wte"], tokens)
            if self.wpe is not None:
                offset = 0 if seq is None else seq.index * t
                x = x + params["wpe"]["table"][offset:offset + t]
            if seq is not None:
                split = (1, seq.index, seq.size)
        x = x.to(c.dtype)
        if self.drop is not None:
            x = self.drop.apply({}, x, mode=mode,
                                rng=None if rng is None else keys.fold_in(rng, 0x0E0BED),
                                split=split)
        return x

    def _head_out(self, params, x, tokens, out: dict, mode: str, spec=None, seq=None) -> dict:
        """``ln_f``, then the head into ``out``: the fused chunked
        cross-entropy (``nll``) in train mode with ``loss_chunk``, or under
        ring attention always (each rank's share of the global mean,
        across its block's edge), else the logits."""
        c = self.config
        t = tokens.shape[1]
        x = self.ln_f(params["ln_f"], x)
        if c.label_smoothing and mode == "train":
            out["label_smoothing"] = c.label_smoothing
        fused = c.loss_chunk > 0 and mode == "train" and t > 1 and t % c.loss_chunk == 0
        if spec is not None:
            from rocket_tpu_torch.parallel import collectives as coll

            if not fused and c.vocab_size % spec.tp_size == 0:
                # The head as a collective matmul into this rank's logit
                # columns, then the columns gathered for the loss.
                w = (params["head"]["w"] if self.head is not None
                     else params["wte"]["table"].t())
                (logits,) = coll.all_gather_matmul(spec, x, (w.to(x.dtype),))
                out[self.logits_key] = coll.gather_replicated(spec, logits, 2)
                return out
            x = coll.seq_all_gather(spec, x)
            params = self._whole_head(spec, params)
        edge = None
        if seq is not None and mode == "train":
            from rocket_tpu_torch.parallel.ring_attention import next_tokens

            # Position T/n - 1 of this block predicts the next block's
            # first token; the last block's last position has none.
            edge = (next_tokens(seq, tokens), seq.index == seq.size - 1, t * seq.size)
            fused = True
        if fused:
            # The head weight is cast once, outside the chunk loop.
            if self.head is not None:
                w = params["head"]["w"].to(x.dtype)
                proj = lambda xc: xc @ w  # noqa: E731
            else:
                table = params["wte"]["table"].to(x.dtype)
                proj = lambda xc: torch.einsum("bcd,vd->bcv", xc, table)  # noqa: E731
            chunk = c.loss_chunk if c.loss_chunk > 0 and t % c.loss_chunk == 0 else t
            out["nll"] = _chunked_next_token_nll(x, tokens, chunk, proj, c.label_smoothing,
                                                 edge=edge)
        elif self.head is not None:
            out[self.logits_key] = self.head(params["head"], x)
        else:
            out[self.logits_key] = torch.einsum(
                "btd,vd->btv", x, params["wte"]["table"].to(x.dtype))
        return out

    def apply(self, params, batch: dict, *, mode: str = "train", rng=None) -> dict:
        """The full-sequence forward -> a copy of ``batch`` with ``logits``
        (or, fused, ``nll``) added. ``rng`` is the step's counter-hash key
        (``nn/keys.py``); train-mode dropout needs it. The embedding's key
        is ``fold_in(rng, 0x0E0BED)``, a domain apart from the blocks'
        ``fold_in(rng, layer_idx)``, as in the reference.

        Under a tensor-parallel context the residual stream runs
        sequence-sharded from the embedding to ``ln_f`` (:meth:`_embed_tp`);
        then the vocab-parallel head gathers the sequence into this rank's
        logit columns where the vocab divides and the loss is not fused,
        else :func:`seq_all_gather` gives every rank the whole sequence for
        the head (GPT-2: 50257 rows do not divide). The outputs are whole
        on every rank of the group.

        On a Runtime whose seq axis is larger than 1 the batch is this
        rank's block of every sequence (``Runtime.shard_batch``): positions
        start at the block's offset, and in train mode the model writes
        ``nll``, its share of the global next-token mean (eval: the block's
        logits). With ``pipeline_axis`` the blocks run as GPipe stages
        (:meth:`_apply_pipelined`; every stage gets the trunk's output);
        training goes through :meth:`pipelined_value_and_grad`."""
        c = self.config
        tokens = batch[self.tokens_key]
        b, t = tokens.shape
        spec = self._tp_spec(t)
        seq = self._seq_spec() if spec is None else None
        if t * (seq.size if seq is not None else 1) > c.max_seq_len:
            raise ValueError(f"sequence length {t * (seq.size if seq else 1)} > max_seq_len "
                             f"{c.max_seq_len}")
        x = self._embed(params, tokens, mode, rng, seq=seq, spec=spec)
        aux_total = dropped_total = None
        if c.pipeline_axis:
            x = self._apply_pipelined(params, x, mode=mode, rng=rng)
            if c.num_experts > 0:
                # The pipelined aux channel carries the loss scalar only.
                x, aux_total = x
        else:
            remat = (c.scan_layers and c.scan_remat and mode == "train"
                     and torch.is_grad_enabled())
            for i, block in enumerate(self.blocks):
                if remat:
                    x, aux = block.apply_remat(params["blocks"][str(i)], x, rng=rng,
                                               policy=c.scan_remat_policy)
                else:
                    x, aux = block.apply_aux(params["blocks"][str(i)], x, mode=mode, rng=rng)
                if aux is not None:
                    aux_total = (aux["aux_loss"] if aux_total is None
                                 else aux_total + aux["aux_loss"])
                    dropped_total = (aux["frac_dropped"] if dropped_total is None
                                     else dropped_total + aux["frac_dropped"])
        out = dict(batch)
        if aux_total is not None:
            # The pre-weighted router load-balancing loss (next_token_loss
            # adds it) and the layer-mean fraction of routed pairs that
            # overflowed expert capacity. A seq rank's train loss is its
            # share of the sum over the group, so it counts 1/n of the aux
            # loss every seq rank computed whole.
            share = seq.size if seq is not None and mode == "train" else 1
            out["moe_aux_loss"] = aux_total * (c.moe_aux_weight / share)
            if dropped_total is not None:
                out["moe_frac_dropped"] = dropped_total / c.num_layers
        return self._head_out(params, x, tokens, out, mode, spec=spec, seq=seq)

    # -- pipeline parallelism -----------------------------------------------

    def _pipe_spec(self):
        """The pipe group of the current Runtime's ``pipeline_axis`` (the
        reference pins its Runtime's mesh the same way)."""
        from rocket_tpu_torch.parallel.pipeline import pipe_spec
        from rocket_tpu_torch.runtime import Runtime

        c = self.config
        if not c.scan_layers:
            raise RuntimeError("TransformerConfig.pipeline_axis requires scan_layers=True "
                               "(stacked block params are the pipeline stages).")
        runtime = Runtime.current()
        if runtime is None or c.pipeline_axis not in runtime.mesh:
            raise RuntimeError(f"pipeline_axis={c.pipeline_axis!r} needs a live Runtime whose "
                               "mesh has that axis (e.g. Runtime(mesh_shape={'data': 2, "
                               "'pipe': 4})).")
        return pipe_spec(runtime, c.pipeline_axis)

    def _stage_layers(self, params, spec) -> list:
        """``(layer index, params)`` of the stage's own blocks."""
        c = self.config
        if c.num_layers % spec.size:
            raise ValueError(f"pipeline: {c.num_layers} layers must divide over {spec.size} "
                             "pipeline stages.")
        per = c.num_layers // spec.size
        idx = range(spec.index * per, (spec.index + 1) * per)
        missing = [i for i in idx if str(i) not in params["blocks"]]
        if missing:
            raise RuntimeError(f"pipeline: stage {spec.index} lacks blocks {missing}")
        return [(i, params["blocks"][str(i)]) for i in idx]

    def _block_apply(self, mode: str, rng):
        """One block of the pipeline's stages: ``(params, layer index, h) ->
        h`` (the stage, not the block, is the remat unit there); for an MoE
        config ``(h, the block's aux loss)``, the pipeline's aux channel."""
        moe = self.config.num_experts > 0

        def block_apply(p, i, h):
            h, aux = self.blocks[i].apply_aux(p, h, mode=mode, rng=rng)
            return (h, aux["aux_loss"]) if moe else h

        return block_apply

    def _apply_pipelined(self, params, x, *, mode, rng):
        """The trunk as GPipe stages over ``pipeline_axis`` (reference
        ``transformer.py:804``), every stage getting the last stage's
        output. Training runs :meth:`pipelined_value_and_grad` instead."""
        from rocket_tpu_torch.parallel.pipeline import pipeline_blocks

        if torch.is_grad_enabled() and mode == "train":
            raise RuntimeError("TransformerLM: a pipelined model trains through "
                               "pipelined_value_and_grad (the Module's train step)")
        spec = self._pipe_spec()
        return pipeline_blocks(self._block_apply(mode, rng), self._stage_layers(params, spec), x,
                               spec=spec, num_microbatches=self.config.pipeline_microbatches,
                               remat=False, with_aux=self.config.num_experts > 0)

    def pipelined_value_and_grad(self, objective):
        """The pipelined train step (``Module`` calls it when present;
        reference ``transformer.py:832``) -> ``fn(params, batch, rng,
        leaves) -> (loss, out, grads)``: the loss this rank holds (the last
        stage's mean over its stripe, 0 elsewhere), a copy of ``batch``
        with ``nll``, and the gradients of ``leaves`` (the step's param
        leaves; None where a leaf got none). None without
        ``pipeline_axis``.

        The embedding runs on every stage (stage 0 differentiates it with
        the cotangent its stage sends back); under ``"gpipe"`` the
        microbatches flow through :func:`pipeline_blocks` and autograd
        runs the reverse schedule from the last stage's loss; under
        ``"1f1b"`` :func:`pipeline_train_1f1b` runs each microbatch's
        ``ln_f`` + head + loss on the last stage and its backward inside
        the schedule. The objective must read ``batch["nll"]``
        (``next_token_loss`` does). An MoE config (GPipe only) rides the
        pipeline's aux channel: each stage's weighted share of the aux loss
        joins its own loss, through the objective's ``moe_aux_loss`` on the
        last stage and directly elsewhere; the losses sum over the pipe
        group."""
        c = self.config
        if not c.pipeline_axis:
            return None
        from rocket_tpu_torch.parallel import pipeline as pl

        def vag(params, batch, rng, leaves):
            spec = self._pipe_spec()
            tokens = batch[self.tokens_key]
            m = c.pipeline_microbatches or 2 * spec.size
            leaves = list(leaves)
            with torch.set_grad_enabled(spec.index == 0):
                x = self._embed(params, tokens, "train", rng)
            layers = self._stage_layers(params, spec)
            block_apply = self._block_apply("train", rng)
            if c.pipeline_schedule == "1f1b":
                mb_tokens = tokens.chunk(m, 0)

                def tail_fn(h, mb):
                    out_mb = {self.tokens_key: mb_tokens[mb]}
                    return objective(self._head_out(params, h, mb_tokens[mb], out_mb, "train"))

                loss, grads, dx = pl.pipeline_train_1f1b(block_apply, layers, x, tail_fn, leaves,
                                                         spec=spec, num_microbatches=m)
                if dx is not None:
                    emb = torch.autograd.grad(x, leaves, dx.to(x.dtype), allow_unused=True)
                    grads = [g if e is None else (e if g is None else g + e)
                             for g, e in zip(grads, emb)]
            else:
                moe = c.num_experts > 0
                anchor = torch.zeros((), device=x.device, requires_grad=True)
                y = pl.pipeline_blocks(block_apply, layers, x, spec=spec, num_microbatches=m,
                                       remat=c.scan_remat, anchor=anchor, broadcast=False,
                                       with_aux=moe)
                head_in = {self.tokens_key: tokens}
                if moe:
                    y, aux = y
                    head_in["moe_aux_loss"] = aux.float() * c.moe_aux_weight
                if spec.last:
                    loss = objective(self._head_out(params, y, tokens, head_in, "train")).float()
                else:
                    # The send tokens are zeros: the loss is the aux share.
                    loss = y + head_in["moe_aux_loss"] if moe else y
                grads = list(torch.autograd.grad(loss, leaves + [anchor],
                                                 allow_unused=True))[:-1]
                loss = loss.detach()
            pl.finish()
            out = dict(batch)
            out["nll"] = loss
            return loss, out, grads

        return vag

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


def _chunk_nll(x_c, y_c, m_c, proj, label_smoothing):
    logits = proj(x_c).float()                                   # (b, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, y_c[..., None])[..., 0]
    if label_smoothing:
        # Smoothed CE: lse - (1-eps)*label_logit - eps*mean(logits).
        lab = (1.0 - label_smoothing) * lab + label_smoothing * logits.mean(-1)
    return ((lse - lab) * m_c).sum()


def _chunked_next_token_nll(x, tokens, chunk: int, proj, label_smoothing: float = 0.0,
                            edge=None):
    """Mean next-token NLL without materializing (B, T, V) logits.

    Each T-chunk's head projection + f32 softmax-CE runs under
    ``torch.utils.checkpoint``, so the backward recomputes the chunk's
    logits and only x (B, T, D) is kept. Position i predicts tokens[i+1];
    the last position has no target and is masked, and the sum is divided
    by ``b * (t - 1)`` — the mean of ``next_token_loss`` exactly.

    ``edge = (next_first, last, t_total)`` for one block of a sequence
    sharded over ring attention's ranks: the block's last position
    predicts ``next_first`` (the next block's first tokens), unless the
    block is the ``last``, and the sum is divided by ``b * (t_total - 1)``,
    so the ranks' values add up to the global mean."""
    b, t, _ = x.shape
    if edge is None:
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
        valid, denom = t - 1, b * (t - 1)
    else:
        next_first, last, t_total = edge
        targets = torch.cat([tokens[:, 1:], next_first[:, None].to(tokens.dtype)], dim=1).long()
        valid, denom = (t - 1 if last else t), b * (t_total - 1)
    mask = (torch.arange(t, device=x.device) < valid).float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_nll, x[:, sl], targets[:, sl], mask[sl], proj,
                                   label_smoothing, use_reentrant=False)
    return total / denom


def next_token_loss(logits_key: str = "logits", tokens_key: str = "tokens"):
    """Objective: mean cross-entropy of logits[:, :-1] vs tokens[:, 1:]
    (f32 softmax), plus the model's pre-weighted MoE load-balancing loss
    when the batch carries one. A batch from the fused path carries the
    ready ``nll`` scalar instead of logits."""

    def objective(batch):
        if "nll" in batch:
            loss = batch["nll"]  # the fused path applied any label smoothing
        else:
            logits = batch[logits_key][:, :-1].float()
            targets = batch[tokens_key][:, 1:].long()
            loss = F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="none")
            eps = batch.get("label_smoothing")
            if eps is not None:
                # CE_smooth = (1-eps)*CE + eps*(lse - mean(logits)).
                lse = torch.logsumexp(logits, dim=-1).flatten()
                loss = (1.0 - eps) * loss + eps * (lse - logits.mean(-1).flatten())
            loss = loss.mean()
        aux = batch.get("moe_aux_loss")
        return loss if aux is None else loss + aux

    return objective


def decode_params(params: dict, activation_dtype: Optional[str]) -> dict:
    """Cast float params ONCE to the compute dtype before decoding: decode
    streams every weight each step, and reading f32 masters to make bf16
    operands would double the bytes on the binding resource. Every float
    leaf is cast, the MoE router and experts included, as in the
    reference; the router still computes its logits in f32."""
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

    ``use_cache=False`` recomputes the whole causal prefix every step
    through :meth:`TransformerLM.apply` in eval mode (on CUDA: the flash
    kernels) — O(T^2) per token, but it exercises the training forward."""
    device = resolve_device(device)
    if use_cache and model.config.attention_impl == "ring":
        use_cache = False  # as the reference: the ring fills no dense KV cache
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
    with torch.no_grad():
        done = start >= limits
        if use_cache:
            caches = model.init_cache(b, total, model.config.dtype, device)
            logits, caches = model.decode_step(params, buf[:, :start], caches, 0)
        for i in range(start, total):
            if not use_cache:
                out = model.apply(params, {model.tokens_key: buf}, mode="eval")
                logits = out[model.logits_key][:, i - 1]
            nxt = sample_tokens(logits, seed, i, temperature, top_k, top_p)
            nxt, done = freeze_after_eos(nxt.to(torch.int32), done, eos_vec)
            done = done | (i + 1 >= limits)
            buf[:, i] = nxt
            if use_cache:
                logits, caches = model.decode_step(params, buf[:, i:i + 1], caches, i)
    return buf
