"""The f32-master / cast-at-use convention in the port (counterpart of
``tests/test_precision.py``), each case asserted of both packages on the
same layer and the same seeded input: params initialise f32, a bf16
forward returns bf16, gradients arrive f32 at the masters, and the MoE's
numerics hold (f32 expert accumulation, the f32 router end to end),
asserted through each package's precision-audit facts where a dtype alone
cannot show where the accumulation ran.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.analysis.prec_audit import audit_precision as ref_audit
from rocket_tpu.analysis.prec_audit import collect_dtype_flow as ref_flow
from rocket_tpu.nn import layers as ref_layers
from rocket_tpu.nn.moe import MoE as RefMoE
from rocket_tpu_torch.analysis.prec_audit import audit_precision, collect_dtype_flow
from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.nn import layers
from rocket_tpu_torch.nn.moe import MoE

torch.set_num_threads(1)

BF16 = torch.bfloat16

LAYER_CASES = [
    ("dense", lambda m: m.Dense(16, 32), (4, 16)),
    ("conv", lambda m: m.Conv2D(3, 8, kernel_size=3), (2, 8, 8, 3)),
    ("layernorm", lambda m: m.LayerNorm(16), (4, 16)),
    ("rmsnorm", lambda m: m.RMSNorm(16), (4, 16)),
    ("batchnorm", lambda m: m.BatchNorm(16), (4, 16)),
]


def _x(shape):
    return np.random.RandomState(1).standard_normal(shape).astype(np.float32)


def _port_apply(name, layer, params, x, state):
    if name == "batchnorm":
        return layer.apply(params, x, state=state, mode="train")
    return layer.apply(params, x), state


def _port_parts(name, build, shape):
    layer = build(layers)
    params = layer.init_params(torch.Generator().manual_seed(0))
    state = layer.init_state() if name == "batchnorm" else {}
    return layer, params, state, torch.from_numpy(_x(shape)).to(BF16)


@pytest.mark.parametrize("name,build,shape", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_params_master_fp32_outputs_match_x_dtype(name, build, shape):
    ref_layer = build(ref_layers)
    variables = ref_layer.init(jax.random.key(0))
    ref_y, ref_state = ref_layer.apply(variables, jnp.asarray(_x(shape), jnp.bfloat16),
                                       mode="train")
    layer, params, state, x = _port_parts(name, build, shape)
    y, new_state = _port_apply(name, layer, params, x, state)
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(variables["params"]))
    assert all(t.dtype == torch.float32 for t in params.values())
    assert ref_y.dtype == jnp.bfloat16 and y.dtype == BF16
    assert all(jnp.asarray(v).dtype == jnp.float32 for v in jax.tree.leaves(ref_state))
    assert all(t.dtype == torch.float32 for t in new_state.values())


@pytest.mark.parametrize("name,build,shape", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_gradients_arrive_fp32_at_master_params(name, build, shape):
    ref_layer = build(ref_layers)
    variables = ref_layer.init(jax.random.key(0))
    x32 = _x(shape)

    def loss(p):
        y, _ = ref_layer.apply({"params": p, "state": variables["state"]},
                               jnp.asarray(x32, jnp.bfloat16), mode="train")
        return jnp.sum(y.astype(jnp.float32))

    assert all(g.dtype == jnp.float32 for g in jax.tree.leaves(jax.grad(loss)(variables["params"])))
    layer, params, state, x = _port_parts(name, build, shape)
    leaves = [t.requires_grad_() for t in params.values()]
    y, _ = _port_apply(name, layer, params, x, state)
    grads = torch.autograd.grad(y.float().sum(), leaves)
    assert all(g.dtype == torch.float32 for g in grads)


def test_pool_dropout_embedding_dtypes():
    x = torch.from_numpy(_x((2, 8, 8, 4))).to(BF16)
    assert layers.AvgPool2D(2).apply({}, x).dtype == BF16
    assert layers.Dropout(0.5).apply({}, x, mode="train", rng=keys.key(1)).dtype == BF16
    ref_x = jnp.asarray(_x((2, 8, 8, 4)), jnp.bfloat16)
    assert ref_layers.AvgPool2D(2).apply({"params": {}, "state": {}}, ref_x)[0].dtype == \
        jnp.bfloat16
    # The embedding gathers stay f32: the model casts after the positional add.
    emb = layers.Embedding(16, 8)
    out = emb.apply(emb.init_params(torch.Generator().manual_seed(2)),
                    torch.zeros((2, 3), dtype=torch.int32))
    ref_emb = ref_layers.Embedding(16, 8)
    ref_out, _ = ref_emb.apply(ref_emb.init(jax.random.key(2)), jnp.zeros((2, 3), jnp.int32))
    assert out.dtype == torch.float32 and ref_out.dtype == jnp.float32


# -- MoE numerics ----------------------------------------------------------------------

#: Widths the hand kernels take (K and N in 128s): the dropless route runs
#: its grouped products on meta through the kernels' declarations.
DIM, HIDDEN = 128, 256


def _moe_step(dispatch):
    moe = MoE(DIM, HIDDEN, 4, top_k=2, dispatch=dispatch)
    with torch.device("meta"):
        params = moe.init_params(torch.Generator().manual_seed(0))

    def step(variables, batch):
        return moe.apply(variables["params"], batch["x"])

    return step, {"params": params, "state": {}}, {"x": torch.empty(
        (2, 16, DIM), dtype=BF16, device="meta")}


def _ref_moe_flow(dispatch):
    moe = RefMoE(dim=DIM, hidden=HIDDEN, num_experts=4, top_k=2, dispatch=dispatch)
    params = jax.eval_shape(moe.init_params, jax.random.key(0))

    def step(variables, batch):
        return moe.apply(variables, batch["x"])

    return (step, {"params": params, "state": {}},
            {"x": jax.ShapeDtypeStruct((2, 16, DIM), jnp.bfloat16)})


@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "dropless"])
def test_expert_matmuls_accumulate_fp32(dispatch):
    ref_step, ref_vars, ref_batch = _ref_moe_flow(dispatch)
    ref_dots = [d for d in ref_flow(ref_step, ref_vars, ref_batch, compute_dtype=jnp.bfloat16)[0]
                .dots if d.param_path and d.param_path[-1] in ("w_in", "w_out")]
    assert ref_dots and all(np.dtype(d.acc_dtype) == np.float32 for d in ref_dots)
    flow = collect_dtype_flow(*_moe_step(dispatch), compute_dtype=BF16)[0]
    # The einsum and scatter routes widen both operands (f32 GEMMs); the
    # dropless route's grouped products are hand kernels declaring f32.
    expert = [d for d in flow.dots if (d.param_path and d.param_path[-1] in ("w_in", "w_out"))
              or d.prim in ("gmm", "tgmm", "gather_gmm")]
    assert expert, f"no expert matmuls seen for {dispatch}"
    assert all(d.acc_dtype == "float32" for d in expert), expert


def test_router_logits_stay_fp32_end_to_end():
    ref_step, ref_vars, ref_batch = _ref_moe_flow("einsum")
    ref_f = ref_flow(ref_step, ref_vars, ref_batch, compute_dtype=jnp.bfloat16)[0]
    flow = collect_dtype_flow(*_moe_step("einsum"), compute_dtype=BF16)[0]
    for dots, f32 in ((ref_f.dots, jnp.float32), (flow.dots, "float32")):
        router = [d for d in dots if d.param_path and "router" in d.param_path]
        assert router and all(d.acc_dtype == f32 for d in router)
    assert all(np.dtype(t.dtype) == np.float32 for t in ref_f.trans if t.prim in ("exp", "exp2"))
    assert flow.trans and all(t.dtype == "float32" for t in flow.trans)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "dropless"])
def test_moe_is_clean_under_the_precision_auditor(dispatch):
    ref_report = ref_audit(*_ref_moe_flow(dispatch), compute_dtype=jnp.bfloat16,
                           check_state=False)
    report = audit_precision(*_moe_step(dispatch), compute_dtype=BF16, check_state=False)
    assert ref_report.findings == [] and report.findings == [], \
        [f.render() for f in report.findings]


def test_moe_bf16_forward_matches_fp32_reference():
    moe = MoE(32, 64, 4, top_k=2, capacity_factor=4.0)
    params = moe.init_params(torch.Generator().manual_seed(0))
    x32 = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 8, 32))
                           .astype(np.float32))
    y32, _ = moe.apply(params, x32)
    y16, _ = moe.apply(params, x32.to(BF16))
    assert y16.dtype == BF16
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0.1, atol=0.05)
