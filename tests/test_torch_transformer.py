"""Port parity: ``rocket_tpu_torch.models.transformer`` against
``rocket_tpu.models.transformer`` with the weights carried across by
``bridge.params_from_jax``.

Models: the ``tiny_lm`` (GPT-2 style) and ``llama_lm`` (RoPE, RMSNorm,
SwiGLU, GQA, untied head) shapes of ``tests/test_serve.py``. Logits are
compared at 1e-4 in float32 (two layers of float32 matmuls summed in
another order); greedy tokens must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rocket_tpu.models import transformer as jt
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.models import transformer as tt

CONFIGS = {
    "tiny_lm": dict(vocab_size=64, max_seq_len=64, dim=32, num_layers=2, num_heads=4,
                    dropout=0.0),
    "llama_lm": dict(vocab_size=64, max_seq_len=64, dim=32, num_layers=2, num_heads=4,
                     num_kv_heads=2, pos_embedding="rope", norm="rmsnorm", mlp="swiglu",
                     tied_embeddings=False, dropout=0.0),
}
ATOL = 1e-4


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(jax model, jax params, port model, port params) for one config."""
    kw = CONFIGS[request.param]
    jmodel = jt.TransformerLM(jt.TransformerConfig(**kw))
    jparams = jax.jit(jmodel.init)(jax.random.key(1))["params"]
    tmodel = tt.TransformerLM(tt.TransformerConfig(**kw))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def test_init_layout_and_scanned_bridge(pair):
    jmodel, jparams, tmodel, tparams = pair
    port = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), port)
    assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, jparams))
    # A scanned (blocks_stacked) JAX tree loads to the same port params.
    stacked = dict(jax.tree.map(np.asarray, jparams))
    blocks = stacked.pop("blocks")
    stacked["blocks_stacked"] = jax.tree.map(
        lambda *xs: np.stack(xs), *[blocks[str(i)] for i in range(len(blocks))]
    )
    for a, b in zip(jax.tree.leaves(params_from_jax(stacked)), jax.tree.leaves(tparams)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_decode_step_paged_logits_and_pools(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.config
    rng = np.random.default_rng(0)
    s, bl, mb, plen, chunk = 3, 4, 6, 11, 4
    h_kv = cfg.num_kv_heads or cfg.num_heads
    hd = cfg.dim // cfg.num_heads
    shape = (cfg.num_layers, 1 + s * mb, bl, h_kv, hd)
    jk = jnp.zeros(shape)
    jv = jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    table = (1 + np.arange(s)[:, None] * mb + np.arange(mb)[None, :]).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, size=(s, plen)).astype(np.int32)
    steps = [(start, chunk) for start in range(0, plen - 1, chunk)] + [(plen - 1, 1)]
    jstep = jax.jit(jmodel.decode_step_paged)
    for start, c in steps:
        piece = prompt[:, start:min(start + c, plen - 1 if c > 1 else plen)]
        valid = np.full((s,), piece.shape[1], np.int32)
        piece = np.pad(piece, ((0, 0), (0, c - piece.shape[1])))
        pos = np.full((s,), start, np.int32)
        jl, jk, jv = jstep(jparams, jnp.asarray(piece), jk, jv, jnp.asarray(table),
                           jnp.asarray(pos), jnp.asarray(valid))
        tl, tk, tv = tmodel.decode_step_paged(tparams, torch.from_numpy(piece), tk, tv,
                                              torch.from_numpy(table), torch.from_numpy(pos),
                                              torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # Pools match outside the trash block.
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], atol=ATOL)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], atol=ATOL)


def test_decode_step_dense_cache(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(1)
    b, t_max, plen = 2, 16, 6
    toks = rng.integers(0, 64, size=(b, plen + 1)).astype(np.int32)
    jc = jmodel.init_cache(b, t_max)
    jstep = jax.jit(jmodel.decode_step)
    tc = tmodel.init_cache(b, t_max, device="cpu")
    jl, jc = jstep(jparams, jnp.asarray(toks[:, :plen]), jc, 0)
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(toks[:, :plen]), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jl, jc = jstep(jparams, jnp.asarray(toks[:, plen:]), jc, plen)
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(toks[:, plen:]), tc, plen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(len(tc)):
        np.testing.assert_allclose(tc[i]["k"].numpy(), np.asarray(jc[i]["k"]), atol=ATOL)


def test_generate_greedy_tokens_identical(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 64, size=(3, 7)).astype(np.int32)
    eos = np.asarray([-1, 5, -1], np.int32)
    new = np.asarray([9, 12, 4], np.int32)
    ref = jt.generate(jmodel, {"params": jparams, "state": {}}, prompt, new,
                      temperature=0, eos_token_id=eos)
    got = tt.generate(tmodel, tparams, prompt, new, temperature=0, eos_token_id=eos,
                      device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampling_generate_deterministic_and_unported_paths_raise(pair):
    _, _, tmodel, tparams = pair
    prompt = np.arange(5, dtype=np.int32)[None]

    def run(seed, use_cache=True):
        return tt.generate(tmodel, tparams, prompt, 8, temperature=0.8, top_k=10,
                           generator=torch.Generator().manual_seed(seed), use_cache=use_cache,
                           device="cpu")

    torch.testing.assert_close(run(3), run(3))
    # The recompute path (ported with the training forward) samples the
    # same tokens: the draw is keyed by the position, not by the path.
    torch.testing.assert_close(run(3, use_cache=False), run(3))
    with pytest.raises(ValueError, match="Generator"):
        tt.generate(tmodel, tparams, prompt, 4, temperature=1.0, device="cpu")
    # Ring attention is ported: the config builds, its forward needs a
    # Runtime whose mesh has the seq axis (the reference's rule), and GQA
    # stays refused under it, as there.
    ring = tt.TransformerLM(tt.TransformerConfig(**dict(CONFIGS["tiny_lm"], attention_impl="ring")))
    assert ring.blocks[0].attn.impl == "ring" and not ring.blocks[0]._block_attn_ok
    with pytest.raises(ValueError, match="num_kv_heads == num_heads"):
        tt.TransformerLM(tt.TransformerConfig(**dict(CONFIGS["llama_lm"], attention_impl="ring")))
    # The MoE FFN is ported: a config with experts builds, its blocks route.
    moe = tt.TransformerLM(tt.TransformerConfig(**dict(CONFIGS["tiny_lm"], num_experts=4)))
    assert moe.blocks[0].moe is not None and moe.blocks[0].fc_in is None


def test_presets_match_jax():
    for name in ("char_lm", "gpt2_124m", "llama_style", "gpt2_350m"):
        port = getattr(tt.TransformerConfig, name)()
        ref = getattr(jt.TransformerConfig, name)()
        for field in tt.TransformerConfig.__dataclass_fields__:
            assert getattr(port, field) == getattr(ref, field), (name, field)
