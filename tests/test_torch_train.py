"""Port parity of the training forward: ``TransformerLM.apply`` +
``next_token_loss`` of ``rocket_tpu_torch`` against ``jax.value_and_grad``
of the JAX model, with the weights carried across by
``bridge.params_from_jax`` and tokens from a numpy seed.

Configs: a GPT-2-style and a Llama-style (RoPE, RMSNorm, SwiGLU, GQA,
untied head, label smoothing) tiny model, 2 layers, T=32 with
``loss_chunk=16`` (the fused chunked head + cross-entropy). The port runs
both attention paths on the CPU: "plain" (head-major einsums) and "flash"
(the flash autograd Functions over the kernels' plain versions).

Tolerances, float32: loss 1e-5 (the same f32 math in another order),
gradients 1e-4 (sums over B*T of products in another order), logits
1e-4. Dropout is 0 in every JAX comparison: the port's counter-hash bits
cannot match JAX's random bits; its own dropout tests check the keep
rate, the 1/keep scale and that a remat recompute draws the same mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.models import transformer as jt
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn.layers import Dropout
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.ops import flash_native as tfn

CONFIGS = {
    "gpt2": dict(vocab_size=96, max_seq_len=64, dim=64, num_layers=2, num_heads=2,
                 dropout=0.0, loss_chunk=16),
    "llama": dict(vocab_size=96, max_seq_len=64, dim=64, num_layers=2, num_heads=2,
                  num_kv_heads=1, pos_embedding="rope", norm="rmsnorm", mlp="swiglu",
                  tied_embeddings=False, dropout=0.0, loss_chunk=16, label_smoothing=0.1),
}
B, T = 2, 32


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_ref(request):
    """(config kwargs, jax params as numpy, tokens, jax loss, jax grads)."""
    kw = CONFIGS[request.param]
    model = jt.TransformerLM(jt.TransformerConfig(**kw))
    params = jax.jit(model.init)(jax.random.key(1))["params"]
    tokens = np.random.default_rng(0).integers(0, kw["vocab_size"], (B, T)).astype(np.int32)

    def loss_fn(p):
        out, _ = model.apply({"params": p, "state": {}}, {"tokens": jnp.asarray(tokens)},
                             mode="train")
        return jt.next_token_loss()(out)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits, _ = jax.jit(lambda p: model.apply({"params": p, "state": {}},
                                              {"tokens": jnp.asarray(tokens)}, mode="eval"))(params)
    return dict(kw=kw, params=jax.tree.map(np.asarray, params), tokens=tokens,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                logits=np.asarray(logits["logits"]), n=model.num_params({"params": params}))


def _port(kw, params_np, **over):
    model = tt.TransformerLM(tt.TransformerConfig(**{**kw, **over}))
    params = map_params(lambda t: t.requires_grad_(), params_from_jax(params_np))
    return model, params


def _loss_and_grads(model, params, tokens, **kw):
    out = model.apply(params, {"tokens": torch.from_numpy(tokens)}, mode="train", **kw)
    loss = tt.next_token_loss()(out)
    loss.backward()
    return out, loss


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_train_loss_and_grads_match_jax(jax_ref, impl):
    model, params = _port(jax_ref["kw"], jax_ref["params"], attention_impl=impl)
    out, loss = _loss_and_grads(model, params, jax_ref["tokens"])
    assert "nll" in out and "logits" not in out  # the fused chunked path ran
    assert abs(loss.item() - jax_ref["loss"]) <= 1e-5
    grads = jax.tree.map(lambda t: t.grad.numpy(), params)
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(jax_ref["grads"])):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    assert model.num_params(params) == jax_ref["n"]


def test_unfused_logits_path_matches_the_fused_one(jax_ref):
    """loss_chunk=0 materializes logits and next_token_loss takes its own
    cross-entropy (with the same label smoothing); both paths give one
    loss and one set of gradients. Eval logits match the JAX model's."""
    fused_model, fused_params = _port(jax_ref["kw"], jax_ref["params"])
    _, fused_loss = _loss_and_grads(fused_model, fused_params, jax_ref["tokens"])
    model, params = _port(jax_ref["kw"], jax_ref["params"], loss_chunk=0)
    out, loss = _loss_and_grads(model, params, jax_ref["tokens"])
    assert "logits" in out and "nll" not in out
    assert abs(loss.item() - fused_loss.item()) <= 1e-5
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, params)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.grad, fused_params))):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        logits = model.apply(params, {"tokens": torch.from_numpy(jax_ref["tokens"])},
                             mode="eval")["logits"]
    np.testing.assert_allclose(logits.numpy(), jax_ref["logits"], atol=1e-4, rtol=1e-4)


def test_presets_set_loss_chunk_as_the_reference():
    for name in ("gpt2_124m", "llama_style", "gpt2_350m"):
        assert getattr(tt.TransformerConfig, name)().loss_chunk == \
            getattr(jt.TransformerConfig, name)().loss_chunk == 128
    assert tt.TransformerConfig.char_lm().loss_chunk == jt.TransformerConfig.char_lm().loss_chunk


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_without_cache_matches_the_cache(name):
    kw = {**CONFIGS[name], "loss_chunk": 0}
    model = tt.TransformerLM(tt.TransformerConfig(**kw))
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    prompt = np.random.default_rng(1).integers(0, kw["vocab_size"], (2, 5))
    cached = tt.generate(model, params, prompt, 9, temperature=0, device="cpu")
    recomputed = tt.generate(model, params, prompt, 9, temperature=0, use_cache=False,
                             device="cpu")
    assert torch.equal(cached, recomputed)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200, 500)
    rate = 0.1
    y = Dropout(rate).apply({}, x, mode="train", rng=keys.key(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert torch.equal(Dropout(rate).apply({}, x, mode="eval", rng=keys.key(3)), x)
    # Another key, another mask; the same key, the same mask.
    assert not torch.equal(Dropout(rate).apply({}, x, mode="train", rng=keys.key(4)), y)
    assert torch.equal(Dropout(rate).apply({}, x, mode="train", rng=keys.key(3)), y)
    with pytest.raises(ValueError):
        Dropout(rate).apply({}, x, mode="train")


def test_dropout_masks_repeat_in_the_remat_recompute():
    """A whole-forward torch.utils.checkpoint recomputes the forward in the
    backward; the counter-hash masks repeat, so the gradients equal the
    un-checkpointed ones exactly (a generator-drawn mask would differ)."""
    kw = dict(CONFIGS["gpt2"], dropout=0.2)
    model = tt.TransformerLM(tt.TransformerConfig(**kw))
    init = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (B, T)))
    rng = keys.fold_in(keys.key(0), 5)
    grads = []
    for remat in (False, True):
        params = map_params(lambda t: t.clone().requires_grad_(), init)
        fn = lambda b: model.apply(params, b, mode="train", rng=rng)  # noqa: E731
        out = (torch.utils.checkpoint.checkpoint(fn, {"tokens": tokens}, use_reentrant=False)
               if remat else fn({"tokens": tokens}))
        tt.next_token_loss()(out).backward()
        grads.append(jax.tree.leaves(jax.tree.map(lambda t: t.grad, params)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # Dropout is live: another step key changes the loss.
    other = model.apply(init, {"tokens": tokens}, mode="train", rng=keys.fold_in(keys.key(0), 6))
    same = model.apply(init, {"tokens": tokens}, mode="train", rng=rng)
    assert tt.next_token_loss()(other).item() != tt.next_token_loss()(same).item()


def test_remat_runs_the_flash_forward_twice_per_layer(monkeypatch):
    """Under a whole-forward checkpoint each layer's flash forward runs in
    the forward and again in the recompute, its backward once: the counts
    chip_smoke.py asserts per train step (here through the plain versions)."""
    counts = {"fwd": 0, "bwd": 0}
    for name, key in (("_fwd_plain", "fwd"), ("_bwd_plain", "bwd")):
        real = getattr(tfn, name)
        monkeypatch.setattr(tfn, name, lambda *a, _r=real, _k=key, **k: (
            counts.__setitem__(_k, counts[_k] + 1), _r(*a, **k))[1])
    kw = dict(CONFIGS["gpt2"], dropout=0.1, attention_impl="flash")
    model = tt.TransformerLM(tt.TransformerConfig(**kw))
    params = map_params(lambda t: t.requires_grad_(),
                        model.init(torch.Generator().manual_seed(0), device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (B, T)))
    out = torch.utils.checkpoint.checkpoint(
        lambda b: model.apply(params, b, mode="train", rng=keys.key(1)), {"tokens": tokens},
        use_reentrant=False)
    assert counts == {"fwd": 2, "bwd": 0}
    tt.next_token_loss()(out).backward()
    assert counts == {"fwd": 2 * 2, "bwd": 2}


def test_eval_mode_ignores_dropout_and_needs_no_rng(jax_ref):
    kw = dataclasses.replace(tt.TransformerConfig(**jax_ref["kw"]), dropout=0.5)
    model = tt.TransformerLM(kw)
    _, params = _port(jax_ref["kw"], jax_ref["params"])
    with torch.no_grad():
        out = model.apply(params, {"tokens": torch.from_numpy(jax_ref["tokens"])}, mode="eval")
    np.testing.assert_allclose(out["logits"].numpy(), jax_ref["logits"], atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="rng"):
        model.apply(params, {"tokens": torch.from_numpy(jax_ref["tokens"])}, mode="train")


# -- per-block remat under scan_layers -----------------------------------------
#
# With ``scan_layers`` and ``scan_remat`` the reference checkpoints each
# block of its scanned body under ``scan_remat_policy``; the port
# checkpoints each block of its loop (``Block.apply_remat``).

SCAN = dict(vocab_size=96, max_seq_len=64, dim=64, num_layers=2, num_heads=2, dropout=0.0,
            loss_chunk=16, attention_impl="xla", scan_layers=True)
POLICIES = [None, "dots", "block_io"]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_scan_remat_loss_and_grads_match_the_jax_scanned_tree(policy):
    """Loss and every gradient of the port's per-block remat against the
    reference's scanned, rematerialised body (its ``blocks_stacked`` tree
    bridged), f32, within 1e-5 of their norm."""
    kw = {**SCAN, "scan_remat_policy": policy}
    jmodel = jt.TransformerLM(jt.TransformerConfig(**kw))
    jparams = jax.jit(jmodel.init)(jax.random.key(3))["params"]
    assert "blocks_stacked" in jparams
    tokens = np.random.default_rng(5).integers(0, kw["vocab_size"], (B, T)).astype(np.int32)

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "state": {}}, {"tokens": jnp.asarray(tokens)},
                              mode="train")
        return jt.next_token_loss()(out)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    model, params = _port(kw, jax.tree.map(np.asarray, jparams))
    _, loss = _loss_and_grads(model, params, tokens)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = jax.tree.map(lambda t: t.grad, params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


class _ForwardStorages(torch.utils._python_dispatch.TorchDispatchMode):
    """Every storage an op made while the mode was on, with its bytes, held
    by weak reference: after the forward, the live ones are what the
    autograd graph and the checkpoints keep for the backward."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef

        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.setdefault(st._cdata, (StorageWeakRef(st), st.nbytes()))
        return out

    def live_bytes(self):
        import gc

        gc.collect()
        return sum(n for ref, n in self.made.values() if not ref.expired())


def _kept_bytes(num_layers, scan_remat, policy):
    """Bytes of the storages the train forward made that it leaves alive,
    and the bytes that ``saved_tensors_hooks`` packed outside any
    checkpoint (the tensors autograd itself saves, the checkpoints' inputs
    among them)."""
    kw = {**SCAN, "num_layers": num_layers, "scan_remat": scan_remat,
          "scan_remat_policy": policy}
    model = tt.TransformerLM(tt.TransformerConfig(**kw))
    params = map_params(lambda t: t.requires_grad_(),
                        model.init(torch.Generator().manual_seed(0), device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 96, (B, T)))
    packed = []

    def pack(t):
        packed.append(t.untyped_storage().nbytes() if t.numel() else 0)
        return t

    mode = _ForwardStorages()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        loss = tt.next_token_loss()(model.apply(params, {"tokens": tokens}, mode="train"))
    kept = mode.live_bytes()
    loss.backward()  # the kept graph runs
    return kept, sum(packed)


def test_scan_remat_policies_keep_what_they_name():
    """What each policy keeps for the backward, per block (the difference
    between 2 and 1 layers), in units of one (B, T, D) f32 activation:
    None keeps the block's input (1); ``"block_io"`` also the attention
    half's output with its residual (2); ``"dots"`` also the outputs of the
    block's four non-batched products, qkv (3), the attention projection
    (1), the MLP's up (4) and down (1) projections (10); no remat keeps
    more than any. So none < block_io <= dots < no remat.
    ``saved_tensors_hooks`` alone cannot count this: a checkpoint's own
    hooks shadow any outer ones inside its region, and the selective
    checkpoint keeps its saved products in a cache of its own; so the
    forward's storages are followed by weak reference, and the hooks are
    held to what they can see, a checkpoint's inputs."""
    unit = B * T * SCAN["dim"] * 4
    kept, hooked = {}, {}
    for name, remat, policy in [("none", True, None), ("block_io", True, "block_io"),
                                ("dots", True, "dots"), ("no remat", False, None)]:
        for layers in (1, 2):
            kept[name, layers], hooked[name, layers] = _kept_bytes(layers, remat, policy)
    per_block = {name: kept[name, 2] - kept[name, 1] for name, _ in kept}
    assert per_block["none"] == unit
    assert per_block["block_io"] == 2 * unit
    assert per_block["dots"] == 10 * unit
    assert per_block["no remat"] > per_block["dots"]
    assert kept["none", 2] < kept["block_io", 2] <= kept["dots", 2] < kept["no remat", 2]
    # The hooks see a remat block only through its checkpoints' inputs (its
    # params are packed too, but they are not the forward's storages).
    assert hooked["none", 2] - hooked["none", 1] == unit
    assert hooked["block_io", 2] - hooked["block_io", 1] == 2 * unit


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_scan_remat_with_dropout_is_bitwise_the_unrematerialised_run(policy):
    """Dropout 0.1: the recompute draws the same counter-hash masks, so the
    gradients under ``scan_remat`` equal those without it bit for bit."""
    grads = []
    for scan_remat in (True, False):
        kw = {**SCAN, "dropout": 0.1, "scan_remat": scan_remat, "scan_remat_policy": policy}
        model = tt.TransformerLM(tt.TransformerConfig(**kw))
        params = map_params(lambda t: t.requires_grad_(),
                            model.init(torch.Generator().manual_seed(2), device="cpu"))
        tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 96, (B, T)))
        out = model.apply(params, {"tokens": tokens}, mode="train", rng=keys.key(9))
        tt.next_token_loss()(out).backward()
        grads.append([t.grad for t in jax.tree.leaves(params)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_module_remat_under_scan_layers_logs_and_keeps_the_block_checkpoints(caplog,
                                                                            monkeypatch):
    """``Module(remat=True)`` with ``scan_layers``: the reference's log line,
    and a train step that checkpoints each block (two per step at two
    layers) and not the whole forward."""
    import rocket_tpu_torch as rt
    from rocket_tpu_torch import optim as toptim
    from rocket_tpu_torch.core import module as tmodule
    from rocket_tpu_torch.data.text import TokenDataset

    calls = {"forward": 0, "blocks": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tmodule, "checkpoint", counting("forward", tmodule.checkpoint))
    monkeypatch.setattr(tt, "checkpoint", counting("blocks", tt.checkpoint))
    model = tt.TransformerLM(tt.TransformerConfig(**{**SCAN, "loss_chunk": 0}))
    tokens = np.random.default_rng(7).integers(0, 96, B * T)
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()), rt.Optimizer(toptim.sgd())],
                       remat=True)
    with caplog.at_level("INFO"):
        rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(tokens, T), batch_size=B), module],
                               progress=False)], runtime=rt.Runtime(device="cpu", seed=0)).launch()
    assert "remat=True ignored: scan_layers already remats per block" in caplog.text
    assert calls == {"forward": 0, "blocks": SCAN["num_layers"]}
