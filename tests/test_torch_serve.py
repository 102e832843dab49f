"""Port parity: ``rocket_tpu_torch.serve`` against ``rocket_tpu.serve`` and
the sampling core against ``rocket_tpu.models.sampling``.

* ``ServeEngine`` greedy outputs equal the JAX ``ServeEngine``'s (with
  ``reqtrace=False``) token for token on a mixed workload whose pool is
  too small, so requests are evicted and resume (tiny GPT-2-style and
  Llama-style models, float32);
* the sampling filters (top-k, temperature, top-p; scalar and per-row)
  mask exactly the tokens the JAX package masks;
* the pool, allocator and engine contracts the port keeps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rocket_tpu.models import sampling as jsamp
from rocket_tpu.models import transformer as jt
from rocket_tpu.serve import ServeConfig as JServeConfig
from rocket_tpu.serve import ServeEngine as JServeEngine
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.models import sampling as tsamp
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.serve import BlockAllocator, KVPoolSpec, ServeConfig, ServeEngine

CONFIGS = {
    "tiny_lm": dict(vocab_size=64, max_seq_len=64, dim=32, num_layers=2, num_heads=4,
                    dropout=0.0),
    "llama_lm": dict(vocab_size=64, max_seq_len=64, dim=32, num_layers=2, num_heads=4,
                     num_kv_heads=2, pos_embedding="rope", norm="rmsnorm", mlp="swiglu",
                     tied_embeddings=False, dropout=0.0),
}


def _workload(seed=3, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, size=int(rng.integers(2, 12))).astype(np.int32),
             int(rng.integers(6, 14))) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serve_greedy_matches_jax_engine_with_eviction(name):
    kw = CONFIGS[name]
    jmodel = jt.TransformerLM(jt.TransformerConfig(**kw))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))["params"]
    tmodel = tt.TransformerLM(tt.TransformerConfig(**kw))
    sizing = dict(max_slots=4, block_len=4, prefill_chunk=4, max_model_len=32, num_blocks=9)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(reqtrace=False, **sizing))
    teng = ServeEngine(tmodel, params_from_jax(jax.tree.map(np.asarray, jparams)),
                       ServeConfig(**sizing), device="cpu")
    work = _workload()
    jids = [jeng.submit(p, max_new_tokens=m, temperature=0.0) for p, m in work]
    tids = [teng.submit(p, max_new_tokens=m, temperature=0.0) for p, m in work]
    jeng.drain()
    teng.drain()
    rep = teng.report()
    assert rep["requests"]["completed"] == len(work)
    assert rep["requests"]["preemptions"] > 0  # the starved pool evicted and resumed
    assert rep["requests"]["preemptions"] == jeng.report()["requests"]["preemptions"]
    for jid, tid in zip(jids, tids):
        assert teng.result(tid).tokens == jeng.result(jid).tokens, tid
    assert teng.scheduler.allocator.free_fraction == 1.0
    eng = teng.engine
    assert (eng.decode_traces, eng.prefill_traces) == (1, 1)
    assert eng.device_gets == eng.decode_dispatches  # one host transfer per dispatch


def test_sampled_outputs_do_not_depend_on_waves_per_dispatch():
    """The per-row salt makes k waves per dispatch sample exactly as k
    single-wave dispatches (and independent of the neighbours)."""
    tmodel = tt.TransformerLM(tt.TransformerConfig(**CONFIGS["tiny_lm"]))
    params = tmodel.init(torch.Generator().manual_seed(4), device="cpu")

    def run(k):
        eng = ServeEngine(tmodel, params, ServeConfig(
            max_slots=3, block_len=4, prefill_chunk=4, max_model_len=32,
            decode_waves_per_dispatch=k,
        ), generator=torch.Generator().manual_seed(9), device="cpu")
        rids = [eng.submit(p, max_new_tokens=m, temperature=0.9, top_k=20, top_p=0.95)
                for p, m in _workload(seed=5, n=5)]
        eng.drain()
        return [eng.result(r).tokens for r in rids]

    assert run(1) == run(3)


def _jax_scaled(monkeypatch, logits, temperature, top_k, top_p):
    """The masked, scaled logits the JAX sampler hands to its draw."""
    seen = {}

    def fake(key, scaled, axis=-1):
        seen["scaled"] = np.asarray(scaled)
        return jnp.argmax(scaled, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", fake)
    jsamp.sample_tokens(jnp.asarray(logits), jax.random.key(0), 3, temperature, top_k, top_p)
    return seen["scaled"]


@pytest.mark.parametrize("form", ["scalar", "per_row"])
def test_sampling_filter_masks_equal(monkeypatch, form):
    rng = np.random.default_rng(6)
    logits = rng.normal(scale=3.0, size=(4, 50)).astype(np.float32)
    if form == "scalar":
        knobs = [(0.7, 5, None), (1.3, None, 0.8), (0.5, 12, 0.6)]
    else:
        knobs = [(np.asarray([0.7, 0.0, 1.2, 2.0], np.float32),
                  np.asarray([5, 0, 50, 1], np.int32),
                  np.asarray([0.9, 1.0, 0.5, 0.3], np.float32))]
    for temp, top_k, top_p in knobs:
        ref = _jax_scaled(monkeypatch, logits, temp, top_k, top_p)
        conv = (lambda v: v) if form == "scalar" else (
            lambda v: None if v is None else torch.from_numpy(v))
        got, _ = tsamp.filter_logits(torch.from_numpy(logits), conv(temp), conv(top_k),
                                     conv(top_p))
        np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(ref))
        np.testing.assert_allclose(got.numpy()[np.isfinite(ref)], ref[np.isfinite(ref)],
                                   rtol=1e-6)


def test_draw_respects_masks_and_salts():
    rng = np.random.default_rng(7)
    scaled = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    scaled[:, ::2] = float("-inf")
    salts = torch.arange(6, dtype=torch.int32) * 1000003
    a = tsamp.draw(scaled, 11, salts)
    assert (a % 2 == 1).all()                                   # never a masked token
    torch.testing.assert_close(a, tsamp.draw(scaled, 11, salts))  # deterministic
    # A row's draw depends only on its own salt.
    torch.testing.assert_close(tsamp.draw(scaled[2:3], 11, salts[2:3]), a[2:3])
    draws = torch.stack([tsamp.draw(scaled[:1], s, torch.tensor([0])) for s in range(200)])
    assert len(set(draws.flatten().tolist())) > 5


def test_freeze_after_eos_matches_jax():
    nxt = np.asarray([3, 7, 7, 2], np.int32)
    done = np.asarray([False, True, False, True])
    for eos in (7, np.asarray([7, -1, 7, 5], np.int32)):
        rn, rd = jsamp.freeze_after_eos(jnp.asarray(nxt), jnp.asarray(done),
                                        eos if isinstance(eos, int) else jnp.asarray(eos))
        tn, td = tsamp.freeze_after_eos(torch.from_numpy(nxt), torch.from_numpy(done),
                                        eos if isinstance(eos, int) else torch.from_numpy(eos))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))


def test_pool_and_allocator_contracts():
    alloc = BlockAllocator(8)
    a, b = alloc.alloc(3), alloc.alloc(4)
    assert sorted(a + b) == list(range(1, 8)) and alloc.alloc(1) is None
    alloc.free(a)
    assert alloc.alloc(4) is None and alloc.num_free == 3
    with pytest.raises(ValueError):
        alloc.free([0])
    with pytest.raises(ValueError):
        alloc.free([b[0], b[0]])
    spec = KVPoolSpec(num_layers=2, num_blocks=5, block_len=4, num_kv_heads=3, head_dim=8,
                      dtype="bfloat16")
    assert spec.block_bytes == 2 * 2 * 4 * 3 * 8 * 2
    k, v = spec.init_pages("cpu")
    assert k.shape == v.shape == (2, 5, 4, 3, 8) and k.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        KVPoolSpec(num_layers=1, num_blocks=1, block_len=4, num_kv_heads=1, head_dim=8)


def test_submit_validation_and_retention():
    tmodel = tt.TransformerLM(tt.TransformerConfig(**CONFIGS["tiny_lm"]))
    params = tmodel.init(device="cpu")
    eng = ServeEngine(tmodel, params, ServeConfig(max_slots=2, block_len=4, max_model_len=16,
                                                  num_blocks=4), device="cpu")
    for prompt, kw in [(np.zeros((0,), np.int32), {}),
                       (np.zeros((10,), np.int32), dict(max_new_tokens=10)),
                       (np.zeros((8,), np.int32), dict(max_new_tokens=8)),
                       (np.zeros((2,), np.int32), dict(temperature=0.9, top_p=0.0)),
                       ("text", {})]:
        with pytest.raises(ValueError):
            eng.submit(prompt, **kw)
    assert eng.report()["requests"]["rejected"] == 5
    with pytest.raises(ValueError):
        ServeEngine(tmodel, params, ServeConfig(max_model_len=1024), device="cpu")
    eng = ServeEngine(tmodel, params, ServeConfig(max_slots=2, block_len=4, prefill_chunk=4,
                                                  max_model_len=16, max_completed_requests=3),
                      device="cpu")
    rids = [eng.submit(np.asarray([1, 2], np.int32), max_new_tokens=2) for _ in range(5)]
    eng.drain()
    assert [r for r in rids if r in eng.requests] == rids[2:]
    live = eng.submit(np.asarray([1], np.int32), max_new_tokens=4)
    with pytest.raises(ValueError):
        eng.release(live)
    eng.drain()
    eng.reset_metrics()
    assert eng.report()["tokens_generated"] == 0


def _engine_pair(name, **sizing):
    kw = CONFIGS[name]
    jmodel = jt.TransformerLM(jt.TransformerConfig(**kw))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))["params"]
    tmodel = tt.TransformerLM(tt.TransformerConfig(**kw))
    jeng = JServeEngine(jmodel, jparams, JServeConfig(reqtrace=False, **sizing))
    teng = ServeEngine(tmodel, params_from_jax(jax.tree.map(np.asarray, jparams)),
                       ServeConfig(**sizing), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_until_idle_matches_the_jax_greedy_run(name):
    """``Scheduler.run_until_idle`` drives a starved pool (evictions) to
    the same greedy tokens as the JAX scheduler's; past ``max_ticks`` both
    raise."""
    sizing = dict(max_slots=4, block_len=4, prefill_chunk=4, max_model_len=32, num_blocks=9)
    jeng, teng = _engine_pair(name, **sizing)
    work = _workload(seed=5)
    jids = [jeng.submit(p, max_new_tokens=m, temperature=0.0) for p, m in work]
    tids = [teng.submit(p, max_new_tokens=m, temperature=0.0) for p, m in work]
    jeng.scheduler.run_until_idle()
    events = teng.scheduler.run_until_idle()
    assert teng.scheduler.idle and events
    for jid, tid in zip(jids, tids):
        assert teng.result(tid).finished and teng.result(tid).tokens == jeng.result(jid).tokens
    assert teng.scheduler.run_until_idle() == []          # idle: no tick
    for eng in (jeng, teng):
        eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=8)
        with pytest.raises(RuntimeError, match="not idle after 2 ticks"):
            eng.scheduler.run_until_idle(max_ticks=2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slot_engine_decode_equals_the_reference_and_its_dispatch(name):
    """``SlotEngine.decode`` after the same prefills: the JAX engine's
    tokens, done and emitted flags exactly, and the same as one
    ``decode_dispatch`` harvested (one host transfer each)."""
    sizing = dict(max_slots=4, block_len=4, prefill_chunk=4, max_model_len=32, num_blocks=9,
                  decode_waves_per_dispatch=2)
    jeng, teng = _engine_pair(name, **sizing)
    table = np.zeros((4, 8), np.int32)
    table[0, :2], table[1, :2] = [1, 2], [3, 4]
    prompts = (np.asarray([[5, 9, 2, 7]], np.int32), np.asarray([[11, 3, 0, 0]], np.int32))
    for eng in (jeng, teng):
        for slot, (prompt, valid) in enumerate(zip(prompts, (4, 2))):
            eng.engine.prefill(table[slot:slot + 1], prompt, np.zeros((1,), np.int32),
                               np.asarray([valid], np.int32))
    z_i, z_f = np.zeros((4,), np.int32), np.zeros((4,), np.float32)
    args = (table, np.asarray([4, 2, 0, 0], np.int32), np.asarray([7, 3, 0, 0], np.int32),
            np.asarray([True, True, False, False]), np.asarray([6, 1, 0, 0], np.int32), z_f, z_i,
            np.ones((4,), np.float32), np.full((4,), -1, np.int32), z_i)
    want = jeng.engine.decode(*args)
    gets = teng.engine.device_gets
    got = teng.engine.decode(*args)
    assert teng.engine.device_gets == gets + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (2, 4) and not got[2][:, 2:].any()
    again = teng.engine.harvest(teng.engine.decode_dispatch(*args))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)
