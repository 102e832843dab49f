"""The port's Mixture-of-Experts FFN and MoE LM against the JAX package, on
the CPU.

* ``nn.moe.MoE`` in the einsum, scatter, dropless (``impl="gmm"``) and
  dropless fused (``ROCKET_TPU_MOE_GMM=fused``: the gather-GMM kernel's
  plain version here, JAX's kernel in interpret mode) routes: the routing
  (top-k ids) exactly, then ``y``, ``aux_loss``, ``frac_dropped`` and every
  gradient; tight capacity, where the drops must match; bf16 dropless.
* The MoE LM bridged from JAX params: the training loss with
  ``moe_aux_loss`` and its gradients, three ``Launcher`` steps of both
  packages from one bridged start, greedy ``generate`` tokens (and the
  cache against the recompute path), ``ServeEngine`` against
  ``generate``, the checkpoint format both ways with a scanned JAX tree,
  and the ``moe_lm`` example's tree for a few steps.

Inputs and params are made with numpy (or JAX) from a seed and handed to
both packages. Tolerances, float32: values rtol = atol = 2e-5 (the same
f32 math in another order, the reference test's own), gradients within
1e-4 of each leaf's largest element, Launcher losses 1e-5 and params 2e-5
as in ``tests/test_torch_core.py``; bf16 ``2e-2 * (1 + |want|)`` (one
bf16 rounding of sums taken in another order). The kernels' launch counts
stay 0: on CPU tensors every wrapper takes its plain version.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.nn.moe import MoE as JMoE
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.examples import moe_lm
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.nn.moe import MoE
from rocket_tpu_torch.ops import gather_gmm as tg
from rocket_tpu_torch.ops import grouped_matmul as tgm
from rocket_tpu_torch.runtime import checkpoint_io as tio
from rocket_tpu_torch.serve import ServeConfig, ServeEngine

TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2
#: (dispatch, ROCKET_TPU_MOE_GMM) of the four routes.
ROUTES = {"einsum": ("einsum", None), "scatter": ("scatter", None),
          "dropless_gmm": ("dropless", None), "dropless_fused": ("dropless", "fused")}
LM = dict(vocab_size=64, max_seq_len=32, dim=32, num_layers=2, num_heads=4, dropout=0.0,
          num_experts=4, expert_top_k=2, mlp_ratio=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under parallel test workers: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches():
    before = (tg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches)
    yield
    assert (tg.gather_gmm_fwd.launches, tgm.gmm.launches, tgm.tgmm.launches) == before


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (np.abs(g - w).max(), scale)


# -- the layer ------------------------------------------------------------------


def _layer_case(route, monkeypatch, capacity_factor=1.25, dim=32, hidden=128, seed=0):
    dispatch, forced = ROUTES[route]
    if forced:
        monkeypatch.setenv("ROCKET_TPU_MOE_GMM", forced)
    else:
        monkeypatch.delenv("ROCKET_TPU_MOE_GMM", raising=False)
    jmoe = JMoE(dim, hidden, 4, top_k=2, capacity_factor=capacity_factor, dispatch=dispatch)
    tmoe = MoE(dim, hidden, 4, top_k=2, capacity_factor=capacity_factor, dispatch=dispatch)
    jparams = jmoe.init_params(jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(size=(2, 16, dim)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(2, 16, dim)).astype(np.float32)
    return jmoe, tmoe, jparams, x, cot


def _jax_layer(jmoe, jparams, x, cot):
    def loss(p, xx):
        y, aux = jmoe.apply({"params": p, "state": {}}, xx)
        return jnp.sum(y * cot) + 3.0 * aux["aux_loss"], (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    return np.asarray(y), aux, jax.tree.leaves(_np(grads[0])) + [np.asarray(grads[1])]


def _port_layer(tmoe, jparams, x, cot):
    params = jax.tree.map(lambda t: t.requires_grad_(), params_from_jax(_np(jparams)))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.apply(params, xt)
    loss = (y * torch.from_numpy(cot)).sum() + 3.0 * aux["aux_loss"]
    grads = torch.autograd.grad(loss, jax.tree.leaves(params) + [xt])
    return y.detach().numpy(), aux, [g.numpy() for g in grads]


def _jax_top_idx(jparams, x):
    logits = jnp.asarray(x) @ jparams["router"]["w"].astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)[1])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_moe_layer_routing_values_and_grads_match_jax(route, monkeypatch):
    jmoe, tmoe, jparams, x, cot = _layer_case(route, monkeypatch)
    tparams = params_from_jax(_np(jparams))
    _, _, top_idx = tmoe.route(tparams, torch.from_numpy(x))
    np.testing.assert_array_equal(top_idx.numpy(), _jax_top_idx(jparams, x))
    want_y, want_aux, want_grads = _jax_layer(jmoe, jparams, x, cot)
    got_y, got_aux, got_grads = _port_layer(tmoe, jparams, x, cot)
    np.testing.assert_allclose(got_y, want_y, rtol=TOL, atol=TOL)
    for key in ("aux_loss", "frac_dropped"):
        np.testing.assert_allclose(float(got_aux[key].detach()), float(want_aux[key]), rtol=TOL,
                                   atol=TOL)
    _grads_close(got_grads, want_grads)
    if ROUTES[route][0] == "dropless":
        assert float(got_aux["frac_dropped"]) == 0.0


@pytest.mark.parametrize("route", ["einsum", "scatter"])
def test_tight_capacity_drops_the_same_pairs(route, monkeypatch):
    jmoe, tmoe, jparams, x, cot = _layer_case(route, monkeypatch, capacity_factor=0.4)
    want_y, want_aux, want_grads = _jax_layer(jmoe, jparams, x, cot)
    got_y, got_aux, got_grads = _port_layer(tmoe, jparams, x, cot)
    assert float(want_aux["frac_dropped"]) > 0.0
    assert float(got_aux["frac_dropped"]) == pytest.approx(float(want_aux["frac_dropped"]))
    np.testing.assert_allclose(got_y, want_y, rtol=TOL, atol=TOL)
    _grads_close(got_grads, want_grads)


@pytest.mark.parametrize("route", ["dropless_gmm", "dropless_fused"])
def test_bf16_dropless_matches_jax(route, monkeypatch):
    jmoe, tmoe, jparams, x, _ = _layer_case(route, monkeypatch, seed=3)
    want, _ = jmoe.apply({"params": jparams, "state": {}}, jnp.asarray(x, jnp.bfloat16))
    got, _ = tmoe.apply(params_from_jax(_np(jparams)), torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    excess = np.abs(got.float().numpy() - want) - BF16_TOL * (1 + np.abs(want))
    assert excess.max() <= 0, excess.max()


def test_stable_top_k_breaks_ties_to_the_lower_expert():
    """Equal gates route to the lower expert id first, as lax.top_k does."""
    moe = MoE(4, 8, 4, top_k=2)
    params = {"router": {"w": torch.zeros(4, 4)}}
    _, top_gates, top_idx = moe.route(params, torch.randn(1, 3, 4))
    assert top_idx.tolist() == [[[0, 1]] * 3]
    torch.testing.assert_close(top_gates, torch.full((1, 3, 2), 0.5))


def test_moe_validation_errors_match_the_reference():
    with pytest.raises(ValueError, match="top_k"):
        MoE(8, 16, 4, top_k=5)
    with pytest.raises(ValueError, match="dispatch"):
        MoE(8, 16, 4, dispatch="alltoall")
    with pytest.raises(ValueError, match="no effect"):
        tt.TransformerLM(tt.TransformerConfig(**dict(LM, mlp="swiglu")))


# -- the MoE LM -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["einsum", "dropless"])
def lm(request):
    """(config kwargs, jax model, jax params, port model, port params)."""
    kw = dict(LM, expert_dispatch=request.param, loss_chunk=16)
    jmodel = jt.TransformerLM(jt.TransformerConfig(**kw))
    jparams = jax.jit(jmodel.init)(jax.random.key(2))["params"]
    tmodel = tt.TransformerLM(tt.TransformerConfig(**kw))
    return kw, jmodel, jparams, tmodel, params_from_jax(_np(jparams))


def test_lm_tree_loss_with_aux_and_grads_match_jax(lm):
    kw, jmodel, jparams, tmodel, tparams = lm
    port = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == jax.tree.map(np.shape, _np(jparams))
    assert "moe" in port["blocks"]["0"] and "mlp" not in port["blocks"]["0"]
    tokens = np.random.default_rng(3).integers(0, kw["vocab_size"], (2, 32)).astype(np.int32)

    def jloss(p):
        out, _ = jmodel.apply({"params": p, "state": {}}, {"tokens": jnp.asarray(tokens)},
                              mode="train", rng=jax.random.key(0))
        return jt.next_token_loss()(out), out["moe_aux_loss"]

    (want, want_aux), want_grads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = jax.tree.map(lambda t: t.requires_grad_(), tparams)
    out = tmodel.apply(params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    loss = tt.next_token_loss()(out)
    grads = torch.autograd.grad(loss, jax.tree.leaves(params))
    assert float(out["moe_frac_dropped"]) >= 0.0
    np.testing.assert_allclose(float(out["moe_aux_loss"].detach()), float(want_aux), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=TOL, atol=TOL)
    _grads_close([g.numpy() for g in grads], jax.tree.leaves(_np(want_grads)))


def test_lm_greedy_generate_matches_jax_and_the_cache_matches_recompute(lm):
    kw, jmodel, jparams, tmodel, tparams = lm
    prompt = np.random.default_rng(4).integers(0, 64, size=(2, 6)).astype(np.int32)
    ref = jt.generate(jmodel, {"params": jparams, "state": {}}, prompt, 8, temperature=0)
    got = tt.generate(tmodel, tparams, prompt, 8, temperature=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # With ample capacity the cached and recompute paths sample the same
    # tokens (tests/test_moe.py's check).
    ample = tt.TransformerLM(tt.TransformerConfig(**dict(kw, expert_capacity_factor=8.0)))
    runs = [tt.generate(ample, tparams, prompt, 8, temperature=1.0, use_cache=cache,
                        generator=torch.Generator().manual_seed(2), device="cpu")
            for cache in (True, False)]
    torch.testing.assert_close(runs[0], runs[1])


def test_serve_engine_greedy_tokens_equal_generate():
    """Dropless routes each token alone, so the paged engine's chunked
    prefill and decode waves give generate()'s greedy tokens."""
    kw = dict(LM, expert_dispatch="dropless")
    model = tt.TransformerLM(tt.TransformerConfig(**kw))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, size=n).astype(np.int32) for n in (3, 9, 14)]
    eng = ServeEngine(model, params, ServeConfig(max_slots=2, block_len=4, prefill_chunk=4,
                                                 max_model_len=32), device="cpu")
    rids = [eng.submit(p, max_new_tokens=7, temperature=0.0) for p in prompts]
    eng.drain()
    for rid, p in zip(rids, prompts):
        ref = tt.generate(model, params, p, 7, temperature=0, device="cpu")[0, len(p):]
        assert eng.result(rid).tokens == ref.tolist()


class _JRecord(JCapsule):
    def __init__(self, module):
        super().__init__(priority=10)
        self.module = module
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(float(np.asarray(attrs.step_metrics["loss"])))
        self.params = _np(self.module.state["params"])


class _Record(Capsule):
    def __init__(self):
        super().__init__(priority=10)
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(float(attrs.step_metrics["loss"]))


def test_three_launcher_steps_match_the_jax_launcher(lm, tmp_path):
    """Momentum SGD: its update is linear in the gradient, so the f32
    noise of a gradient that cancels to ~1e-9 (some expert weights at this
    size) stays that small, where Adam would normalise it into a step of
    lr size set by the noise. ``tests/test_torch_core.py`` holds AdamW."""
    kw, jmodel, jparams, tmodel, tparams = lm
    b, t, steps = 2, 32, 3
    tokens = np.random.default_rng(6).integers(0, kw["vocab_size"], steps * b * t)
    jparams = _np(jparams)
    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                        project_dir=str(tmp_path))
    jruntime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    jmodule = jrt.Module(jmodel, [jrt.Loss(jt.next_token_loss()),
                                  jrt.Optimizer(joptim.momentum(0.9), learning_rate=0.1)])
    jrec = _JRecord(jmodule)
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokenDataset(tokens, t), batch_size=b), jmodule,
                              jrec], progress=False)], runtime=jruntime).launch()

    runtime = rt.Runtime(device="cpu", seed=0)
    prepared = PreparedModule(tmodel, {"params": params_from_jax(jparams)})
    runtime.models.add(tmodel, prepared)
    rec = _Record()
    module = rt.Module(tmodel, [rt.Loss(tt.next_token_loss()),
                                rt.Optimizer(toptim.momentum(0.9), learning_rate=0.1)])
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(tokens, t), batch_size=b), module, rec],
                           progress=False)], runtime=runtime).launch()

    np.testing.assert_allclose(rec.rows, jrec.rows, atol=1e-5, rtol=1e-5)
    got = jax.tree.map(lambda v: v.detach().numpy(), prepared.state["params"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jrec.params)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    assert not np.allclose(got["blocks"]["0"]["moe"]["router"]["w"],
                           jparams["blocks"]["0"]["moe"]["router"]["w"])


def test_checkpoint_both_ways_with_a_scanned_jax_tree(tmp_path):
    kw = dict(LM, expert_dispatch="dropless")
    jmodel = jt.TransformerLM(jt.TransformerConfig(**dict(kw, scan_layers=True)))
    jparams = jax.jit(jmodel.init)(jax.random.key(7))["params"]
    assert "blocks_stacked" in jparams
    jio.save_pytree(str(tmp_path / "jax"), {"params": jparams})
    tokens = np.random.default_rng(8).integers(0, 64, (2, 16)).astype(np.int32)
    jout, _ = jmodel.apply({"params": jparams, "state": {}}, {"tokens": jnp.asarray(tokens)},
                           mode="eval")
    model = tt.TransformerLM(tt.TransformerConfig(**dict(kw, scan_layers=True)))
    flat = tio.load_pytree(str(tmp_path / "jax"))
    params = params_from_jax(tio.unflatten(flat)["params"])
    assert params["blocks"]["1"]["moe"]["experts"]["w_in"].shape == (4, 32, 128)
    out = model.apply(params, {"tokens": torch.from_numpy(tokens)}, mode="eval")
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(jout["logits"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(out["moe_aux_loss"]), float(jout["moe_aux_loss"]),
                               rtol=TOL, atol=TOL)

    # The port's (unscanned) params back into an unscanned JAX tree, bitwise.
    junscanned = jt.TransformerLM(jt.TransformerConfig(**kw))
    template = jax.jit(junscanned.init)(jax.random.key(0))["params"]
    tio.save_pytree(str(tmp_path / "port"), {"params": params})
    back = jio.load_pytree(str(tmp_path / "port"), {"params": template})["params"]
    want = jax.tree.map(lambda v: v.numpy(), params)
    assert jax.tree.structure(_np(back)) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_moe_lm_example_tree_trains_on_the_cpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["moe_lm"])
    rng = np.random.default_rng(9)
    data = TokenDataset(rng.integers(0, 40, 4 * 16 * 4 + 1), seq_len=16)
    run = moe_lm.build(data, moe_lm.config_for(40, 16, 4), batch_size=4, num_epochs=1,
                       runtime=rt.Runtime(device="cpu", seed=0))
    run["launcher"].launch()
    losses = [float(v) for v in run["trained"]["losses"]]
    assert len(losses) == len(data) // 4 and all(np.isfinite(losses))
    assert run["profiler"]._iter_idx == len(losses)
    cfg = run["model"].config
    assert (cfg.dim // cfg.num_heads, cfg.num_experts, cfg.expert_dispatch) == (32, 4, "einsum")
    assert run["trained"]["params"]["blocks"]["3"]["moe"]["experts"]["w_in"].shape == (4, 128, 512)
    # An expert axis of 2 needs two ranks (the reference's rule).
    monkeypatch.setattr(sys, "argv", ["moe_lm", "--expert-axis", "2"])
    with pytest.raises(SystemExit, match="must divide both 1 ranks and 4 experts"):
        moe_lm.main(device="cpu")
