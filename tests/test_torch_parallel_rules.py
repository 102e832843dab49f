"""The data-parallel slice's pure parts against the reference, in one
process: every rule builder of ``parallel/sharding.py`` gives the
reference's spec on GPT-2's param paths (per-layer and scanned, and the
MoE tree's), ``ShardingRuleError`` included; ``bucket_plan`` gives the
reference's buckets on the same leaves; the port's ``DataLoader`` stripes
are ``rocket_tpu.data.DataLoader``'s at 2 and 4 processes, wrap padding
and fast-forward included; ``shard_dims`` refuses an axis its data-only
mesh lacks and falls back to replicated on an uneven dim; the Runtime
refuses a mesh with an unported axis or more ranks than it has, and
``examples.gpt2`` a mesh that is not its world size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.data.loader import DataLoader as JLoader
from rocket_tpu.models import transformer as jt
from rocket_tpu.parallel import grad_sync as jgs
from rocket_tpu.parallel import sharding as js
from rocket_tpu.utils.pytree import key_path_names
from rocket_tpu_torch.data.loader import DataLoader
from rocket_tpu_torch.parallel import grad_sync as tgs
from rocket_tpu_torch.parallel import sharding as ts
from rocket_tpu_torch.runtime import Runtime

_CFG = jt.TransformerConfig(vocab_size=512, max_seq_len=64, dim=128, num_layers=2, num_heads=4,
                            dropout=0.0)


def _tree(**over):
    """(path, numpy leaf, torch leaf) of a JAX TransformerLM's params."""
    model = jt.TransformerLM(dataclasses.replace(_CFG, **over))
    shapes = jax.eval_shape(model.init, jax.random.key(0))["params"]
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        arr = np.zeros(leaf.shape, dtype=np.float32)
        out.append((key_path_names(path), arr, torch.from_numpy(arr)))
    return out


TREES = {"gpt2": {}, "scanned": {"scan_layers": True},
         "moe": {"num_experts": 4, "expert_top_k": 2}}

RULES = {
    "make_rules": lambda m: m.make_rules([("*/attn/qkv/w", ("data", None)),
                                          ("wte/table", (None, "data")),
                                          ("*/mlp/*/b", ("data",))]),
    "gpt2_tp_rules": lambda m: m.gpt2_tp_rules(),
    "fsdp_rules": lambda m: m.fsdp_rules(),
    "fsdp_rules_small": lambda m: m.fsdp_rules(min_size=256),
    "moe_rules": lambda m: m.moe_rules(),
    "pipeline_rules": lambda m: m.pipeline_rules(),
    "pipeline_over_tp": lambda m: m.pipeline_over(m.gpt2_tp_rules()),
    "combine_moe_tp": lambda m: m.combine_rules(m.moe_rules(), m.gpt2_tp_rules()),
}


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_builders_give_the_references_specs(tree, rule):
    ref, port = RULES[rule](js), RULES[rule](ts)
    for path, arr, tensor in _tree(**TREES[tree]):
        assert port(path, tensor) == ref(path, arr), path
    if hasattr(ref, "fsdp_axis"):
        assert (port.fsdp_axis, port.fsdp_min_size) == (ref.fsdp_axis, ref.fsdp_min_size)
    if hasattr(ref, "patterns"):
        assert port.patterns == ref.patterns


def test_an_over_long_spec_raises_the_references_error():
    table = [("*/ln1/scale", ("data", None))]
    path, arr, tensor = next(item for item in _tree() if item[0][-2:] == ("ln1", "scale"))
    with pytest.raises(js.ShardingRuleError) as want:
        js.make_rules(table)(path, arr)
    with pytest.raises(ts.ShardingRuleError) as got:
        ts.make_rules(table)(path, tensor)
    assert str(got.value) == str(want.value)
    assert (got.value.pattern, got.value.path, got.value.spec, got.value.shape) == (
        want.value.pattern, want.value.path, want.value.spec, want.value.shape)


def test_bucket_plan_edges_match_the_reference():
    """The reference's own cases (tests/test_collectives.py)."""
    sizes = [(100, "float32"), (100, "float32"), (1000, "float32"), (10, "bfloat16"),
             (10, "bfloat16")]
    jleaves = [(i, jax.ShapeDtypeStruct((n,), getattr(jnp, d))) for i, (n, d) in enumerate(sizes)]
    tleaves = [(i, torch.zeros(n, dtype=getattr(torch, d))) for i, (n, d) in enumerate(sizes)]
    assert tgs.bucket_plan(tleaves, 900) == jgs.bucket_plan(jleaves, 900) == [[0, 1], [2], [3, 4]]
    assert tgs.bucket_plan(tleaves[2:3], 1) == jgs.bucket_plan(jleaves[2:3], 1) == [[2]]


@pytest.mark.parametrize("bucket_bytes", [1, 4096, 1 << 16, 4 << 20])
def test_bucket_plan_matches_the_reference_on_gpt2_leaves(bucket_bytes):
    """Reverse param order, as both steps plan their replicated leaves."""
    leaves = _tree()
    order = list(reversed(range(len(leaves))))
    want = jgs.bucket_plan([(i, jax.ShapeDtypeStruct(leaves[i][1].shape, jnp.float32))
                            for i in order], bucket_bytes)
    assert tgs.bucket_plan([(i, leaves[i][2]) for i in order], bucket_bytes) == want


def _samples(n):
    return [{"x": np.full((3,), i, dtype=np.float32), "y": np.int32(i)} for i in range(n)]


class _Stream:
    def __init__(self, n):
        self._n = n

    def __iter__(self):
        yield from _samples(self._n)


def _batches(loader, epoch, skip=0):
    loader.set_epoch(epoch)
    if skip:
        loader.skip(skip)
    return [(np.asarray(b.data["y"]).tolist(), b.size, b.index) for b in loader]


@pytest.mark.parametrize("procs", [2, 4])
@pytest.mark.parametrize("n,batch,drop_last,shuffle", [
    (37, 8, False, True), (37, 8, True, False), (5, 8, False, True), (64, 16, False, False)])
def test_loader_stripes_match_the_reference(procs, n, batch, drop_last, shuffle):
    data = _samples(n)
    for rank in range(procs):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=3,
                  process_index=rank, process_count=procs)
        port, ref = DataLoader(data, **kw), JLoader(data, **kw)
        for epoch, skip in ((0, 0), (1, 0), (1, 2)):
            got, want = _batches(port, epoch, skip), _batches(ref, epoch, skip)
            assert got == want, (rank, epoch, skip)
            assert all(len(ys) == batch // procs for ys, _, _ in got)


@pytest.mark.parametrize("procs", [1, 2, 4])
def test_iterable_stripes_match_the_reference(procs):
    for rank in range(procs):
        kw = dict(batch_size=8, process_index=rank, process_count=procs)
        got = _batches(DataLoader(_Stream(21), **kw), 0, 1)
        assert got == _batches(JLoader(_Stream(21), **kw), 0, 1)


def test_loader_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(_samples(8), batch_size=6, process_index=0, process_count=4)


def test_shard_dims_refuse_a_non_data_axis_and_replicate_uneven_dims():
    leaves = [(path, t) for path, _, t in _tree()]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 6"):
        tgs.shard_dims(leaves, ts.gpt2_tp_rules(), 2)
    dims = tgs.shard_dims(leaves, ts.fsdp_rules(min_size=256), 5)
    for (path, t), dim in zip(leaves, dims):
        # No dim of the tree (64, 128, 384, 512) divides by 5.
        assert dim is None, path
    dims = tgs.shard_dims(leaves, ts.fsdp_rules(min_size=256), 2)
    assert {"/".join(path) for (path, _), d in zip(leaves, dims) if d is not None} == {
        "/".join(path) for path, _, t in _tree() if t.numel() >= 256}


def test_runtime_refuses_a_model_axis_and_keeps_a_data_mesh():
    # The model axis is ported: one process cannot hold a two-rank one.
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 1, "model": 2})
    # The pipe and expert axes are ported too; the two together refuse.
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 1, "pipe": 2})
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 1, "expert": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 6 item 8"):
        Runtime(device="cpu", mesh_shape={"data": 1, "pipe": 2, "expert": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 6 item 8"):
        Runtime(device="cpu", mesh_shape={"data": 1, "seq": 2, "pipe": 2})
    # The other pairs are ported (item 8): one process cannot hold them.
    for pair in (("model", "pipe"), ("model", "seq"), ("model", "expert"), ("seq", "expert")):
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            Runtime(device="cpu", mesh_shape={"data": 1, pair[0]: 2, pair[1]: 2})
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        Runtime(device="cpu", mesh_shape={"data": 2})
    runtime = Runtime(device="cpu", mesh_shape={"data": 1, "model": 1})
    assert (runtime.mesh, runtime.data_axis_size, runtime.process_index,
            runtime.process_count, runtime.is_main_process, runtime.device_mesh) == (
        {"data": 1, "model": 1}, 1, 0, 1, True, None)
    runtime.wait_for_everyone()
    assert runtime.broadcast_int(7) == 7


@pytest.mark.parametrize("flag,match", [("--data-axis", "is the world size"),
                                        ("--model-axis", "does not divide the world size")])
def test_gpt2_example_takes_the_data_axis_of_its_world(flag, match):
    """The mesh ``--data-axis`` x ``--model-axis`` must cover the world
    (one process here)."""
    from rocket_tpu_torch.examples import gpt2

    with pytest.raises(SystemExit, match=match):
        gpt2.main(["--small", "--device", "cpu", flag, "2"])
