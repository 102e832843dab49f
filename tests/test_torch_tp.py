"""Tensor parallelism's pieces (``rocket_tpu_torch/ops/ring.py``,
``rocket_tpu_torch/parallel/collectives.py``, ``Dense(tp_role=)``, the
dropout masks of a shard, the Runtime's 2-D mesh) against the reference.

The ring index math is held against a brute-force simulation, as
``tests/test_collectives.py`` holds the reference's. Each collective runs
forward and backward on spawned gloo ranks at ``m = 2`` and ``4``
(``mesh_shape={"model": m}``), in bulk and ring modes, at the f32 and the
bf16 wire, on inputs from a numpy seed; the ranks' outputs and gradients,
laid end to end, are held against the reference function of the same
name under ``jax.jit`` on a ``(1, m)`` mesh of the virtual CPU devices:
forward outputs and f32-wire gradients within 1e-5 of the largest
element (chunked products may round differently from the reference's
XLA products), bf16-wire gradients within 2^-7 of it (a last-bit
difference before a narrowing can flip a wire rounding). The reference's
bitwise properties (gather-then-matmul, einsum + psum) are not claimed:
chunked products on the CPU need not repeat the unchunked ones' bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rocket_tpu.ops import ring as jring
from rocket_tpu.parallel import collectives as jcoll
from rocket_tpu_torch.ops import ring as tring
from test_torch_grad_sync import run_ranks

B, T, K, FA, FB, D, V = 2, 8, 16, 24, 8, 16, 32
HW, KVW = 16, 8
MODES = [(mode, wire) for mode in ("bulk", "ring") for wire in (None, "bfloat16")]


# -- ring index math ---------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_index_math_matches_bruteforce_and_the_reference(n):
    for d in range(n):
        arrival = [(d - s) % n for s in range(n)]
        order = tring.gather_order(d, n)
        assert [arrival[j] for j in order] == list(range(n))
        assert order == [int(j) for j in np.asarray(jring.gather_order(d, n))]
        accs = {dd: {(dd, tring.rs_seed_index(dd, n))} for dd in range(n)}
        for s in range(1, n):
            received = {dd: accs[(dd - 1) % n] for dd in range(n)}
            accs = {dd: received[dd] | {(dd, tring.rs_chunk_index(dd, s, n))} for dd in range(n)}
            assert tring.rs_chunk_index(d, s, n) == int(jring.rs_chunk_index(d, s, n))
        assert accs[d] == {(src, d) for src in range(n)}
        assert tring.rs_seed_index(d, n) == int(jring.rs_seed_index(d, n))
    assert tring.fwd_perm(n) == jring.fwd_perm(n)


def test_use_ring_thresholds():
    for args in [(1, "ring", 1 << 20), (1 << 30, "bulk", 1), (2 << 20, "auto", 1 << 20),
                 (1 << 10, "auto", 1 << 20)]:
        assert tring.use_ring(*args) == jring.use_ring(*args)
    with pytest.raises(ValueError):
        tring.use_ring(1, "nope", 1)


# -- the collectives over spawned ranks -----------------------------------------------

WORKER = r'''
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from rocket_tpu_torch.nn.layers import Dense
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.runtime import Runtime

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
n = cfg["n"]
runtime = Runtime(device="cpu", mesh_shape={"model": n})
d = runtime.axis_index("model")
inp = {k: torch.from_numpy(v) for k, v in np.load(out + "/inputs.npz").items()}
res = {}


def own(t, dim):
    return t.chunk(n, dim)[d].contiguous()


def leaf(t):
    return t.clone().requires_grad_(True)


def grads(loss, named):
    gs = torch.autograd.grad(loss, [t for _, t in named])
    return {k: g for (k, _), g in zip(named, gs)}


for mode, wire in cfg["modes"]:
    tag = f"{mode}-{wire}"
    with coll.tp_overlap(runtime, mode=mode, wire=wire) as spec:
        x, wa, wb = leaf(own(inp["x"], 1)), leaf(own(inp["wa"], 1)), leaf(own(inp["wb"], 1))
        ya, yb = coll.all_gather_matmul(spec, x, (wa, wb))
        loss = (ya * own(inp["ra"], 2)).sum() + (yb * own(inp["rb"], 2)).sum()
        out_ = {"ya": ya, "yb": yb, **grads(loss, [("x", x), ("wa", wa), ("wb", wb)])}
        res.update({f"all_gather_matmul/{tag}/{k}": v for k, v in out_.items()})

        xc, w, b = leaf(own(inp["xc"], 2)), leaf(own(inp["w2"], 0)), leaf(inp["b2"])
        y = coll.matmul_reduce_scatter(spec, xc, w, bias=b)
        loss = (y * own(inp["ry"], 1)).sum()
        out_ = {"y": y, **grads(loss, [("xc", xc), ("w2", w), ("b2", b)])}
        res.update({f"matmul_reduce_scatter/{tag}/{k}": v for k, v in out_.items()})

        wf, bf = leaf(own(inp["wqkv"], 1)), leaf(own(inp["bqkv"], 0))
        views = coll.qkv_fused_views(spec, wf, bf, cfg["hw"], cfg["kvw"])
        loss = sum((c + 1) * (v * own(inp[f"rv{c}"], v.dim() - 1)).sum()
                   for c, v in enumerate(views))
        out_ = {f"v{c}": v for c, v in enumerate(views)}
        out_.update(grads(loss, [("wqkv", wf), ("bqkv", bf)]))
        res.update({f"qkv_fused_views/{tag}/{k}": v for k, v in out_.items()})

        table = leaf(own(inp["table"], 0))
        e = coll.embed_lookup_sharded(spec, table, inp["tokens"])
        loss = (e * own(inp["re"], 1)).sum()
        out_ = {"e": e, **grads(loss, [("table", table)])}
        res.update({f"embed_lookup_sharded/{tag}/{k}": v for k, v in out_.items()})

        xf, xs = leaf(inp["xf"]), leaf(own(inp["xf"], 1))
        sh = coll.seq_shard(spec, xf)
        ga = coll.seq_all_gather(spec, xs)
        loss = (sh * own(inp["rs"], 1)).sum() + (ga * inp["rg"]).sum()
        out_ = {"shard": sh, "gather": ga, **grads(loss, [("xf", xf), ("xs", xs)])}
        res.update({f"seq_shard/{tag}/{k}": v for k, v in out_.items()})

        col = Dense(cfg["k"], cfg["fa"], tp_role="column")
        row = Dense(cfg["k"], cfg["fa"], tp_role="row")
        pc = {"w": leaf(own(inp["dw"], 1)), "b": leaf(own(inp["db"], 0))}
        pr = {"w": leaf(own(inp["dw"], 0)), "b": leaf(inp["db"])}
        xd, xr = leaf(own(inp["xd"], 1)), leaf(own(inp["xd"], 2))
        yc, yr = col(pc, xd), row(pr, xr)
        loss = (yc * own(inp["rd"], 2)).sum() + (yr * own(inp["rd"], 1)).sum()
        out_ = {"yc": yc, "yr": yr, **grads(loss, [("xd", xd), ("xr", xr), ("cw", pc["w"]),
                                                   ("cb", pc["b"]), ("rw", pr["w"]),
                                                   ("rb", pr["b"])])}
        res.update({f"dense/{tag}/{k}": v for k, v in out_.items()})
np.savez(f"{out}/rank{d}.npz", **{k: v.detach().numpy() for k, v in res.items()})
json.dump(coll.STATS["calls"], open(f"{out}/calls{d}.json", "w"))
'''

#: How a rank's piece of each saved value lies in the whole: the dim it is
#: a chunk of, "sum" (a partial sum over the ranks) or None (whole on
#: every rank, which the test checks).
LAYOUT = {
    "all_gather_matmul": {"ya": 2, "yb": 2, "x": 1, "wa": 1, "wb": 1},
    "matmul_reduce_scatter": {"y": 1, "xc": 2, "w2": 0, "b2": None},
    "qkv_fused_views": {"v0": 1, "v1": 1, "v2": 1, "v3": 0, "v4": 0, "v5": 0, "wqkv": 1,
                        "bqkv": 0},
    "embed_lookup_sharded": {"e": 1, "table": 0},
    "seq_shard": {"shard": 1, "gather": None, "xf": None, "xs": 1},
    "dense": {"yc": 2, "yr": 1, "xd": 1, "xr": 2, "cw": 1, "cb": 0, "rw": 0, "rb": "sum"},
}


def _inputs():
    rng = np.random.default_rng(20)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    w_all = HW + 2 * KVW
    inp = {"x": f(B, T, K), "wa": f(K, FA), "wb": f(K, FB), "ra": f(B, T, FA), "rb": f(B, T, FB),
           "xc": f(B, T, K), "w2": f(K, D), "b2": f(D), "ry": f(B, T, D),
           "wqkv": f(K, w_all), "bqkv": f(w_all), "table": f(V, D), "re": f(B, T, D),
           "tokens": rng.integers(0, V, (B, T)).astype(np.int64),
           "xf": f(B, T, D), "rs": f(B, T, D), "rg": f(B, T, D),
           "dw": f(K, FA), "db": f(FA), "xd": f(B, T, K), "rd": f(B, T, FA)}
    # The views' cotangents, in the reference's global head-aligned layout.
    inp.update({"rv0": f(K, HW), "rv1": f(K, KVW), "rv2": f(K, KVW), "rv3": f(HW),
                "rv4": f(KVW), "rv5": f(KVW)})
    return inp


def _reference(inp, n, mode, wire):
    """The reference's outputs and gradients, keyed as the worker's."""
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    spec = jcoll.OverlapSpec(mesh=mesh, axis="model", mode=mode, wire=wire)
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    def run(args):
        x, wa, wb, xc, w2, b2, wqkv, bqkv, table, xf, xs = args
        ya, yb = jcoll.all_gather_matmul(spec, x, (wa, wb))
        y = jcoll.matmul_reduce_scatter(spec, xc, w2, bias=b2)
        views = jcoll.qkv_fused_views(spec, wqkv, bqkv, HW, KVW)
        e = jcoll.embed_lookup_sharded(spec, table, j["tokens"])
        sh, ga = jcoll.seq_shard(spec, xf), jcoll.seq_all_gather(spec, xs)
        loss = ((ya * j["ra"]).sum() + (yb * j["rb"]).sum() + (y * j["ry"]).sum()
                + sum((c + 1) * (v * j[f"rv{c}"]).sum() for c, v in enumerate(views))
                + (e * j["re"]).sum() + (sh * j["rs"]).sum() + (ga * j["rg"]).sum())
        return loss, (ya, yb, y, views, e, sh, ga)

    names = ("x", "wa", "wb", "xc", "w2", "b2", "wqkv", "bqkv", "table", "xf", "xs")
    args = tuple(j[k if k != "xs" else "xf"] for k in names)
    with mesh:
        (_, (ya, yb, y, views, e, sh, ga)), g = jax.jit(jax.value_and_grad(
            run, has_aux=True))(args)
    g = dict(zip(names, g))
    ref = {"all_gather_matmul": {"ya": ya, "yb": yb, "x": g["x"], "wa": g["wa"], "wb": g["wb"]},
           "matmul_reduce_scatter": {"y": y, "xc": g["xc"], "w2": g["w2"], "b2": g["b2"]},
           "qkv_fused_views": {**{f"v{c}": v for c, v in enumerate(views)},
                               "wqkv": g["wqkv"], "bqkv": g["bqkv"]},
           "embed_lookup_sharded": {"e": e, "table": g["table"]},
           "seq_shard": {"shard": sh, "gather": ga, "xf": g["xf"], "xs": g["xs"]}}
    # Dense(tp_role=) against the plain Dense: y = x @ w + b.

    def dense(dw, db, xd, xr):
        yc, yr = xd @ dw + db, xr @ dw + db
        return (yc * j["rd"]).sum() + (yr * j["rd"]).sum(), (yc, yr)

    (_, (yc, yr)), gd = jax.value_and_grad(dense, argnums=(0, 1, 2, 3), has_aux=True)(
        j["dw"], j["db"], j["xd"], j["xd"])
    ref["dense"] = {"yc": yc, "yr": yr, "xd": gd[2], "xr": gd[3]}
    # The row layer's input cotangent and both layers' weight and bias
    # gradients are split by term: only their sum over the layers is one
    # reference gradient, so they are held per layer below.
    ref["dense"]["_col"] = jax.grad(lambda w, b: (((j["xd"] @ w + b) * j["rd"]).sum()),
                                    argnums=(0, 1))(j["dw"], j["db"])
    ref["dense"]["_row"] = jax.grad(lambda w, b: (((j["xd"] @ w + b) * j["rd"]).sum()),
                                    argnums=(0, 1))(j["dw"], j["db"])
    ref["dense"].update({"cw": ref["dense"]["_col"][0], "cb": ref["dense"]["_col"][1],
                         "rw": ref["dense"]["_row"][0], "rb": ref["dense"]["_row"][1]})
    return {name: {k: np.asarray(v) for k, v in vals.items() if not k.startswith("_")}
            for name, vals in ref.items()}


def _whole(ranks, key, layout):
    parts = [r[key] for r in ranks]
    if layout == "sum":
        return np.sum(parts, axis=0)
    if layout is None:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0], err_msg=f"{key} differs across ranks")
        return parts[0]
    return np.concatenate(parts, axis=layout)


@pytest.fixture(scope="module", params=[2, 4], ids=["m2", "m4"])
def collectives_run(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"tp_coll{n}")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    run_ranks(tmp, WORKER, n, {"n": n, "modes": MODES, "hw": HW, "kvw": KVW, "k": K, "fa": FA},
              timeout=240)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]
    calls = json.loads((tmp / "calls0.json").read_text())
    refs = {(mode, wire): _reference(inp, n, mode, wire) for mode, wire in MODES}
    return n, ranks, refs, calls


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_collectives_match_the_reference_forward_and_backward(collectives_run, name):
    n, ranks, refs, _ = collectives_run
    for mode, wire in MODES:
        ref = refs[(mode, wire)][name]
        for key, layout in LAYOUT[name].items():
            got = _whole(ranks, f"{name}/{mode}-{wire}/{key}", layout)
            want = ref[key]
            assert got.shape == want.shape, (name, key)
            scale = float(np.abs(want).max())
            # Outputs never cross narrow; gradients do at the bf16 wire.
            is_grad = not key.startswith(("y", "v", "e", "shard", "gather"))
            tol = 2.0 ** -7 if (is_grad and wire) else 1e-5
            err = float(np.abs(got - want).max())
            assert err <= tol * scale, (name, key, mode, wire, err, scale)


def test_ring_and_bulk_modes_were_both_taken(collectives_run):
    """The collective matmuls and the gradient gathers ran both ways (the
    ring by ``batch_isend_irecv`` hops); the two modes' outputs differ only
    by the products' rounding."""
    n, ranks, _, calls = collectives_run
    for name in ("all_gather_matmul", "all_gather_matmul.bwd", "matmul_reduce_scatter",
                 "matmul_reduce_scatter.bwd", "embed_lookup_sharded.bwd"):
        assert calls[name]["ring"] > 0 and calls[name]["bulk"] > 0, (name, calls[name])
    for key in ranks[0]:
        if key.startswith("all_gather_matmul/bulk-None/"):
            other = key.replace("bulk-None", "ring-None")
            np.testing.assert_allclose(ranks[0][key], ranks[0][other], rtol=0,
                                       atol=1e-5 * float(np.abs(ranks[0][key]).max()))


# -- the dropout masks of a shard ------------------------------------------------------


@pytest.mark.parametrize("split_dim,shape", [(1, (4, 16, 8)), (2, (4, 16, 6, 4))],
                         ids=["sequence", "heads"])
@pytest.mark.parametrize("data_ranks", [1, 2])
def test_shard_masks_are_the_one_rank_masks(split_dim, shape, data_ranks):
    """Two model ranks (and two data ranks) together draw exactly the
    masks of the one-rank run of the global array, bitwise."""
    from rocket_tpu_torch.nn import keys

    whole = keys.dropout_mask(1234, 0.9, shape, "cpu")
    rows = shape[0] // data_ranks
    for di in range(data_ranks):
        with keys.data_shard(di):
            local = list(shape)
            local[0] = rows
            local[split_dim] //= 2
            parts = [keys.dropout_mask(1234, 0.9, local, "cpu", split=(split_dim, mi, 2))
                     for mi in range(2)]
        got = np.concatenate([p.numpy() for p in parts], axis=split_dim)
        np.testing.assert_array_equal(got, whole[di * rows:(di + 1) * rows].numpy())


# -- the mesh and the refusals ----------------------------------------------------------------


@pytest.mark.parametrize("axis,item", [("pipe", "item 3"), ("seq", "item 4"),
                                       ("expert", "item 5")])
def test_unported_axes_still_refuse_naming_their_items(axis, item):
    """The pipe, seq and expert axes (items 3, 4 and 5) are ported, so one
    process cannot hold a two-rank one, and a leaf's spec over the pipe or
    the expert axis lays out as a dim shard."""
    from rocket_tpu_torch.parallel import grad_sync as tgs
    from rocket_tpu_torch.runtime import Runtime

    leaf = np.zeros((4, 4), np.float32)
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 1, axis: 2})
    if axis in ("pipe", "expert"):
        assert tgs.shard_layout([(("w",), leaf)], lambda p, l: (axis, None),
                                {"data": 1, axis: 2}) == [tgs.Layout(0, axis)]


def test_shard_layout_reads_both_axes_and_refuses_two_on_one_leaf():
    from rocket_tpu_torch.parallel import grad_sync as tgs
    from rocket_tpu_torch.parallel import sharding as ts

    leaves = [(("blocks", "0", "attn", "qkv", "w"), np.zeros((8, 24))),
              (("blocks", "0", "attn", "proj", "w"), np.zeros((8, 8))),
              (("wte", "table"), np.zeros((251, 8))), (("ln_f", "scale"), np.zeros(8))]
    mesh = {"data": 2, "model": 2}
    assert tgs.shard_layout(leaves, ts.gpt2_tp_rules(), mesh) == [
        tgs.Layout(1, "model"), tgs.Layout(0, "model"), None,
        None]  # 251 rows do not divide: replicated
    with pytest.raises(NotImplementedError, match="one axis"):
        tgs.shard_layout(leaves[:1], lambda p, l: ("data", "model"), mesh)
    # dp x tp x pp: a layer's leaf on its stage, its own dim over the model
    # axis (pipeline_over); the shared leaves follow the inner rule.
    mesh = {"data": 2, "model": 2, "pipe": 2}
    staged = leaves + [(("blocks", "1", "attn", "qkv", "w"), np.zeros((8, 24))),
                       (("blocks", "1", "ln1", "scale"), np.zeros(8))]
    assert tgs.shard_layout(staged, ts.pipeline_over(ts.gpt2_tp_rules()), mesh) == [
        tgs.Layout(1, "model", 0, "pipe"), tgs.Layout(0, "model", 0, "pipe"), None, None,
        tgs.Layout(1, "model", 1, "pipe"), tgs.Layout(stage=1, pipe_axis="pipe")]


MOE_TP_WORKER = r'''
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from rocket_tpu_torch import bridge
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules
from rocket_tpu_torch.runtime import Runtime

cfg = json.load(open(sys.argv[1]))
runtime = Runtime(device="cpu", mesh_shape={"data": 1, "model": 2})
model = tt.TransformerLM(tt.TransformerConfig(**cfg["model"]))
params = bridge.local_params(model.init(torch.Generator().manual_seed(0), device="cpu"),
                             gpt2_tp_rules(), runtime)
tokens = torch.from_numpy(np.array(cfg["tokens"]))
with coll.tp_overlap(runtime), torch.no_grad():
    out = model.apply(params, {"tokens": tokens}, mode="eval")
np.save(sys.argv[2] + f"/logits{runtime.process_index}.npy", out["logits"].numpy())
'''


def test_moe_under_tensor_parallelism_refuses_naming_item_5(tmp_path):
    """MoE under tensor parallelism is ported (item 5): the TP forward of an
    MoE LM over two model ranks gives the one-process logits on both; a
    model axis beside an expert axis is item 8's pair (``tests/
    test_torch_mesh.py``): one process cannot hold it."""
    import torch

    from rocket_tpu_torch.models import transformer as tt
    from rocket_tpu_torch.runtime import Runtime

    cfg = dict(vocab_size=32, max_seq_len=8, dim=32, num_layers=1, num_heads=2, num_experts=2)
    tokens = np.random.default_rng(0).integers(0, 32, (2, 8)).tolist()
    run_ranks(tmp_path, MOE_TP_WORKER, 2, {"model": cfg, "tokens": tokens})
    model = tt.TransformerLM(tt.TransformerConfig(**cfg))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        want = model.apply(params, {"tokens": torch.tensor(tokens)}, mode="eval")["logits"]
    for rank in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"logits{rank}.npy"), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 1, "model": 2, "expert": 2})


def test_overlap_settings_read_the_environment(monkeypatch):
    from rocket_tpu_torch.parallel import collectives as coll

    monkeypatch.delenv("ROCKET_TPU_OVERLAP", raising=False)
    assert coll.overlap_enabled() and coll.overlap_mode() == "auto"
    for value, mode in (("ring", "ring"), ("bulk", "bulk"), ("0", "bulk")):
        monkeypatch.setenv("ROCKET_TPU_OVERLAP", value)
        assert coll.overlap_mode() == mode
    assert not coll.overlap_enabled()
    for value, want in (("fp32", None), ("off", None), ("bfloat16", "bfloat16")):
        monkeypatch.setenv("ROCKET_TPU_OVERLAP_WIRE", value)
        got = coll.grad_wire_dtype()
        ref = jcoll.grad_wire_dtype()
        assert (None if got is None else str(got).replace("torch.", "")) == want
        assert (None if ref is None else str(ref)) == want
    assert json.dumps(coll.STATS, default=str)  # the counters serialise for chip_smoke
