"""The trace audit (``rocket_tpu_torch/analysis/trace_audit.py``, RKT201-206)
against the reference's ``audit_step``/``audit_retraces``.

* each rule fires on a step seeded with its fault, and the same fault
  written for the reference (a donated argument not returned, a host
  callback, a Python scalar input, a set of inputs over the budget) makes
  the reference report the same id;
* GPT-2 124M's train step (``sched_audit._gpt2_parts``: remat, AdamW in
  place, on meta tensors) and a small GPT-2-shaped step are clean;
* ``.item()`` on a meta tensor is reported, not raised; a waiver in the
  step's source suppresses its rule;
* ``trace_signature`` tells shapes, dtypes and devices apart.

Inputs are drawn from numpy seeds; torch runs on one thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rocket_tpu.analysis import trace_audit as ref
from rocket_tpu_torch.analysis import trace_audit
from rocket_tpu_torch.analysis.rules import AUDIT_RULES
from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts, _lm_config, _meta_params

torch.set_num_threads(1)

META = torch.device("meta")


def _rules(findings) -> list:
    return sorted(f.rule for f in findings)


def _w(*shape):
    return torch.empty(shape, device=META, requires_grad=True)


def test_the_catalog_keeps_the_reference_ids_and_slugs():
    from rocket_tpu.analysis.rules import AUDIT_RULES as REF_RULES

    assert [r[:2] for r in AUDIT_RULES] == [r[:2] for r in REF_RULES]


def test_out_of_place_update_reports_rkt201_as_the_undonated_reference():
    def step(params, x):
        loss = torch.tanh(x @ params["w"]).sum()
        g, = torch.autograd.grad(loss, [params["w"]])
        return {"w": params["w"].detach() - 0.1 * g}

    params = {"w": _w(32, 32)}
    assert _rules(trace_audit.audit_step(step, params, torch.empty(4, 32, device=META),
                                         inplace_argnums=(0,))) == ["RKT201"]

    def ref_step(params, x):
        return {"w": params["w"] - 0.1 * jnp.tanh(x @ params["w"]).sum()}, {"v": params["w"]}

    # The reference: a donated leaf whose output is dropped.
    def ref_dropped(params, x):
        return jnp.tanh(x @ params["w"]).sum()

    ref_params = {"w": jnp.zeros((32, 32))}
    x = jnp.zeros((4, 32))
    assert _rules(ref.audit_step(ref_dropped, ref_params, x, donate_argnums=(0,))) == ["RKT201"]
    assert _rules(ref.audit_step(ref_step, ref_params, x, donate_argnums=(0,))) == []


def test_in_place_update_is_clean_and_a_shared_storage_is_rkt202():
    def step(params, x):
        loss = torch.tanh(x @ params[0]).sum()
        grads = torch.autograd.grad(loss, params[:1])
        with torch.no_grad():
            torch._foreach_add_(list(params[:1]), list(grads), alpha=-0.1)
        return loss.detach()

    w = _w(32, 32)
    x = torch.empty(4, 32, device=META)
    assert trace_audit.audit_step(step, [w], x, inplace_argnums=(0,)) == []
    assert _rules(trace_audit.audit_step(step, [w, w.detach().view(32, 32)], x,
                                         inplace_argnums=(0,))) == ["RKT202"]
    buf = jnp.zeros((8,))
    assert _rules(ref.audit_step(lambda p, x: (p, x), [buf, buf], jnp.zeros(2),
                                 donate_argnums=(0,))) == ["RKT202"]


def test_host_read_reports_rkt203_instead_of_raising():
    def step(x):
        total = x.sum()
        scale = float(total.item())  # a device->host sync; on meta it cannot run
        return x * scale, x.cpu()

    findings = trace_audit.audit_step(step, torch.empty(8, device=META))
    assert _rules(findings) == ["RKT203", "RKT203"]
    assert any("_local_scalar_dense" in f.message for f in findings)
    assert any("to the host" in f.message for f in findings)

    def ref_step(x):
        jax.debug.callback(lambda v: None, x.sum())
        return x * 2

    assert _rules(ref.audit_step(ref_step, jnp.zeros(8))) == ["RKT203"]


def test_python_scalar_input_reports_rkt204_as_the_reference():
    def step(x, lr):
        return x * lr

    x = torch.empty(8, device=META)
    assert _rules(trace_audit.audit_step(step, x, 0.1)) == ["RKT204"]
    assert trace_audit.audit_step(step, x, torch.tensor(0.1)) == []
    assert trace_audit.audit_step(step, x, 0.1, static_argnums=(1,)) == []
    assert _rules(ref.audit_step(lambda x, lr: x * lr, jnp.zeros(8), 0.1)) == ["RKT204"]


def test_retraces_over_the_budget_report_rkt205_as_the_reference():
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(5, 9, size=6)]
    port = [{"tokens": torch.zeros(n, 4, dtype=torch.int32)} for n in lengths]
    refs = [{"tokens": np.zeros((n, 4), np.int32)} for n in lengths]
    distinct = len(set(lengths))
    assert _rules(trace_audit.audit_retraces(port, max_traces=1)) == ["RKT205"]
    assert _rules(ref.audit_retraces(refs, max_traces=1)) == ["RKT205"]
    assert trace_audit.audit_retraces(port, max_traces=distinct) == []
    assert ref.audit_retraces(refs, max_traces=distinct) == []


def test_trace_signature_tells_shape_dtype_and_device_apart():
    sig = trace_audit.trace_signature
    a = {"x": torch.zeros(2, 3)}
    assert sig(a) == sig({"x": torch.ones(2, 3)})
    assert sig(a) != sig({"x": torch.zeros(3, 2)})
    assert sig(a) != sig({"x": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert sig(a) != sig({"x": torch.zeros(2, 3, device=META)})
    assert sig(a) != sig({"y": torch.zeros(2, 3)})


def test_wide_dtype_reports_rkt206_and_a_waiver_suppresses_it():
    def step(x):
        return x.double() * 2

    def waived(x):  # rocketlint: disable=RKT206
        return x.double() * 2

    x = torch.empty(8, device=META)
    assert _rules(trace_audit.audit_step(step, x)) == ["RKT206"]
    assert trace_audit.audit_step(waived, x) == []
    # A host-side float64 is no device math.
    assert trace_audit.audit_step(lambda x: (x * 2, torch.zeros(2, dtype=torch.float64) + 1),
                                  x) == []


def test_a_small_gpt2_shaped_step_is_clean():
    """A 2-layer GPT-2-shaped LM's train step (learned positions, LayerNorm,
    GELU, tied embeddings, dropout), AdamW's foreach update in place."""
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from rocket_tpu_torch.nn import keys

    model = TransformerLM(_lm_config(pos_embedding="learned", norm="layernorm", mlp="gelu",
                                     tied_embeddings=True, dropout=0.1))
    params, leaves = _meta_params(model)
    opt = torch.optim.AdamW(leaves, lr=1e-3, foreach=True)
    rng = keys.fold_in(keys.key(0), 0)

    def step(params, tokens):
        with torch.enable_grad():
            out = model.apply(params, {"tokens": tokens}, mode="train", rng=rng)
            loss = next_token_loss()(out).float()
            grads = torch.autograd.grad(loss, leaves)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        return loss.detach()

    tokens = torch.zeros(4, 64, dtype=torch.int32, device=META)
    assert trace_audit.audit_step(step, params, tokens, inplace_argnums=(0,)) == []


def test_gpt2_124m_train_step_is_clean():
    step, args = _gpt2_parts(1024)
    assert trace_audit.audit_step(step, *args, inplace_argnums=(0,)) == []
