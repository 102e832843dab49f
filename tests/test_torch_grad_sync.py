"""The bucketed gradient reduction (``parallel/grad_sync.py``) over a gloo
group of spawned CPU processes, against the reference's
``value_and_grad_sharded`` on the virtual CPU mesh (modelled on
``tests/test_collectives.py``) and against a plain f32 all-reduce of the
same local gradients.

The model is the reference test's: ``w1`` and ``w2`` sharded on dim 0
over the data axis, ``b1`` and ``scale`` (7 elements) replicated, and a
``u`` leaf of 6 rows whose spec does not divide over 4 ranks (replicated
there, as the reference falls back). Under ``wire_dtype=None`` every
reduced gradient is bitwise the f32 all-reduce's (two ranks: a sum of two
is one rounding, whatever the collective), and within the reference
test's 5e-6 of the largest element of the reference's; under the bf16
wire within 2^-7 of it (two bf16 roundings and the correction's shift)
and within one bf16 ulp (2^-8) of the reference's own bucketed result
(a last-bit difference in a local gradient may flip a wire rounding), and
each
replicated bucket's sum is the f32 sum to f32 precision (the bucket-sum
correction). With leaves that retire in a
rank-dependent order, both ranks issue their collectives in the plan's
order and the results are still bitwise the all-reduce's.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from rocket_tpu.parallel import grad_sync as jgs

REPO = str(Path(__file__).resolve().parents[1])
NAMES = ("w1", "b1", "w2", "scale", "u")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, source: str, world: int, config: dict, timeout: float = 120.0) -> list:
    """Run ``source`` as ``world`` ranks (``python worker.py config out``),
    each opening the gloo group through the Runtime from the launcher's
    environment variables; returns each rank's output."""
    (tmp_path / "worker.py").write_text(source)
    (tmp_path / "config.json").write_text(json.dumps(config))
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"),
                               str(tmp_path / "config.json"), str(tmp_path)],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{out[-4000:]}"
    return outs


WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from rocket_tpu_torch.parallel.grad_sync import GradSync
from rocket_tpu_torch.runtime import Runtime

cfg = json.load(open(sys.argv[1]))
out = sys.argv[2]
runtime = Runtime(device="cpu")  # opens the gloo group from the environment
rank, world = runtime.process_index, runtime.process_count
data = np.load(out + "/inputs.npz")
names = cfg["names"]
dims = [0 if k in ("w1", "w2", "u") and data[k].shape[0] % world == 0 else None for k in names]
leaves = [torch.from_numpy(data[k]).requires_grad_(True) for k in names]
sync = GradSync([t.shape for t in leaves], [t.dtype for t in leaves], dims, world,
                bucket_bytes=cfg["bucket_bytes"], wire_dtype=cfg["wire"])
x = torch.from_numpy(data["x"]).chunk(world)[rank]
y = torch.from_numpy(data["y"]).chunk(world)[rank]
issued, retired = [], []
issue = sync._issue
sync._issue = lambda k: (issued.append(k), issue(k))
hooks = [t.register_hook(lambda g, i=i: retired.append(i)) for i, t in enumerate(leaves)]
sync.begin(leaves)
p = dict(zip(names, leaves))
if cfg["chain"]:
    # Leaves retire in reverse of a rank-dependent order of use.
    h = x
    for k in (names if rank == 0 else names[::-1]):
        h = torch.tanh(h @ p[k])
    loss = (h ** 2).mean()
else:
    hidden = torch.tanh(x @ p["w1"] + p["b1"]) + (x[:, :6] @ p["u"]).sum(-1, keepdim=True)
    pred = (hidden @ p["w2"]) * p["scale"][:4].sum()
    loss = ((pred - y) ** 2).mean()
grads = torch.autograd.grad(loss, leaves)
reduced, mean_loss = sync.finish(grads, loss.detach())
plain = []
for g in grads:
    t = g / world
    dist.all_reduce(t)
    plain.append(t)
np.savez(f"{out}/rank{rank}.npz", loss=mean_loss.numpy(),
         dims=np.array([-1 if d is None else d for d in dims]),
         issued=np.array(issued), retired=np.array(retired),
         units=np.array([u[0] for u in sync.units]),
         **{f"g_{k}": g.numpy() for k, g in zip(names, reduced)},
         **{f"plain_{k}": g.numpy() for k, g in zip(names, plain)})
'''


def _inputs(tmp_path):
    rng = np.random.default_rng(9)
    d, h = 32, 64
    inputs = {
        "w1": rng.normal(size=(d, h)).astype(np.float32),
        "b1": np.full((h,), 0.1, np.float32),
        "w2": rng.normal(size=(h, 4)).astype(np.float32) * 0.1,
        "scale": np.ones((7,), np.float32),
        "u": rng.normal(size=(6, 1)).astype(np.float32),
        "x": rng.normal(size=(32, d)).astype(np.float32),
        "y": rng.normal(size=(32, 4)).astype(np.float32),
    }
    np.savez(tmp_path / "inputs.npz", **inputs)
    return inputs


def _loss_fn(p, b):
    hidden = jnp.tanh(b["x"] @ p["w1"] + p["b1"]) + (b["x"][:, :6] @ p["u"]).sum(-1,
                                                                                  keepdims=True)
    pred = (hidden @ p["w2"]) * p["scale"][:4].sum()
    return jnp.mean((pred - b["y"]) ** 2)


def _reference(inputs, world, wire):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    params = {k: jnp.asarray(inputs[k]) for k in NAMES}
    batch = {k: jnp.asarray(inputs[k]) for k in ("x", "y")}

    def spec_fn(path, leaf):
        return ("data", None) if path[-1] in ("w1", "w2", "u") else None

    placed = {k: jax.device_put(v, NamedSharding(
        mesh, P("data") if spec_fn((k,), v) and v.shape[0] % world == 0 else P()))
        for k, v in params.items()}
    with mesh:
        (loss, _), grads = jax.jit(lambda p, b: jgs.value_and_grad_sharded(
            _loss_fn, p, b, mesh=mesh, spec_fn=spec_fn, wire_dtype=wire, bucket_bytes=64,
        ))(placed, batch)
    plain_l, plain_g = jax.value_and_grad(_loss_fn)(params, batch)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()}, float(plain_l),
            {k: np.asarray(v) for k, v in plain_g.items()})


def _whole(ranks, name):
    """A reduced gradient as one array: sharded leaves laid end to end."""
    if ranks[0]["dims"][NAMES.index(name)] < 0:
        return ranks[0][f"g_{name}"]
    return np.concatenate([r[f"g_{name}"] for r in ranks], axis=0)


@pytest.fixture(scope="module", params=[(2, None), (2, "bfloat16"), (4, None)],
                ids=["2ranks-f32", "2ranks-bf16", "4ranks-f32"])
def synced(request, tmp_path_factory):
    world, wire = request.param
    tmp = tmp_path_factory.mktemp(f"sync{world}{wire}")
    inputs = _inputs(tmp)
    run_ranks(tmp, WORKER, world, {"names": list(NAMES), "wire": wire, "bucket_bytes": 64,
                                   "chain": False})
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    return world, wire, ranks, _reference(inputs, world, wire)


def test_reduced_grads_match_the_references_value_and_grad_sharded(synced):
    world, wire, ranks, (loss, grads, plain_loss, plain_grads) = synced
    # mean of local means reassociates the mean: relative, not bitwise.
    assert abs(float(ranks[0]["loss"]) - plain_loss) / abs(plain_loss) < 1e-5
    # Master precision: the reference test's 5e-6. The bf16 wire: two
    # roundings of 2^-9 and the correction's shift, 2^-7 of the largest
    # element; the same algorithm as the reference's to f32 precision.
    tol = 5e-6 if wire is None else 2.0 ** -7
    for k in NAMES:
        got = _whole(ranks, k)
        scale = float(np.abs(plain_grads[k]).max()) + 1e-9
        assert float(np.abs(got - plain_grads[k]).max()) <= tol * scale, k
        # A last-bit difference in a local gradient may flip one wire
        # rounding: one bf16 ulp, 2^-8.
        assert float(np.abs(got - grads[k]).max()) <= (
            1e-5 if wire is None else 2.0 ** -8) * scale, k
    # The uneven leaf falls back to replicated at 4 ranks, as there.
    assert [int(d) for d in ranks[0]["dims"]] == [0, -1, 0, -1, 0 if world == 2 else -1]


def test_reduced_grads_against_the_f32_all_reduce(synced):
    """Master precision: bitwise the all-reduce's. The bf16 wire: rounded,
    with each replicated bucket's sum the f32 sum (the correction)."""
    world, wire, ranks, (_, grads, _, _) = synced
    if wire is None:
        for k in NAMES:
            d = int(ranks[0]["dims"][NAMES.index(k)])
            want = ranks[0][f"plain_{k}"]
            if world > 2:
                # Four ranks sum in the collectives' own orders.
                np.testing.assert_allclose(_whole(ranks, k), want, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(_whole(ranks, k), want)
        return
    for k in ("b1", "scale"):  # one replicated bucket each at 64 bytes
        got, want = ranks[0][f"g_{k}"], ranks[0][f"plain_{k}"]
        mass = float(np.abs(want).sum())
        assert abs(float(got.astype(np.float64).sum() - want.astype(np.float64).sum())) <= (
            1e-6 * mass + 1e-7), k
        # The reference's own bound on its corrected buckets.
        assert abs(float(got.sum() - grads[k].sum())) < 1e-3, k
    assert not np.array_equal(ranks[0]["g_b1"], ranks[0]["plain_b1"])  # the wire rounded


def test_replicated_grads_and_the_loss_agree_across_ranks(synced):
    world, wire, ranks, _ = synced
    for r in ranks[1:]:
        assert float(r["loss"]) == float(ranks[0]["loss"])
        for k in NAMES:
            if int(ranks[0]["dims"][NAMES.index(k)]) < 0:
                np.testing.assert_array_equal(r[f"g_{k}"], ranks[0][f"g_{k}"])


def test_collectives_issue_in_plan_order_when_leaves_retire_out_of_order(tmp_path):
    rng = np.random.default_rng(3)
    names = ["a", "b", "c", "d"]
    np.savez(tmp_path / "inputs.npz", x=rng.normal(size=(8, 8)).astype(np.float32),
             y=np.zeros((8, 1), np.float32),
             **{k: (rng.normal(size=(8, 8)) * 0.5).astype(np.float32) for k in names})
    run_ranks(tmp_path, WORKER, 2, {"names": names, "wire": None, "bucket_bytes": 1,
                                    "chain": True})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert list(ranks[0]["retired"]) != list(ranks[1]["retired"])
    for r in ranks:
        assert list(r["issued"]) == list(range(len(names)))
        assert list(r["units"]) == [3, 2, 1, 0]
        for k in names:
            np.testing.assert_array_equal(r[f"g_{k}"], r[f"plain_{k}"])
