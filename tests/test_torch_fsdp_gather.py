"""The FSDP step-entry gathers in buckets (``parallel/grad_sync.
gather_buckets``, used by ``core/module.Module._full_params`` and by the
audits' copy of the step, ``analysis/sched_audit._parallel_lm_parts``).

* the audit LM's FSDP rank issues exactly ``len(bucket_plan(...))``
  step-entry all-gathers, one a 4 MiB bucket of its data-sharded leaves
  (their whole sizes, in param order, one dtype a bucket), moving the
  bytes the per-leaf gathers moved (the reference's 3,110,478 B a step
  with the reductions), and ``sched --target fsdp_1x8`` is clean at the
  reference's convoy gate (6) with no override;
* over a gloo group of two spawned ranks, the bucketed gather of leaves
  sharded on different dims, in two dtypes, one over the bucket bound, is
  bitwise each leaf's own ``gather_full``, in as many
  ``all_gather_into_tensor`` calls as the plan has buckets.
"""

from __future__ import annotations

import json

import torch

from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis.sched_audit import SCHED_TARGETS, _parallel_lm_parts
from rocket_tpu_torch.ops._launch import CommFact, record_launches
from rocket_tpu_torch.parallel import grad_sync as gs
from rocket_tpu_torch.parallel.sharding import fsdp_rules
from test_torch_grad_sync import run_ranks

torch.set_num_threads(1)


def test_the_fsdp_rank_gathers_once_a_bucket():
    step, args = _parallel_lm_parts({"data": 8}, fsdp_rules(axis="data", min_size=4096))
    with record_launches() as facts:
        step(*args)
    gathers = [f for f in facts if isinstance(f, CommFact) and f.kind == "all_gather"]
    # The plan over the data-sharded leaves' whole sizes, in param order.
    from rocket_tpu_torch import optim
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _meta_params
    from rocket_tpu_torch.models.transformer import TransformerLM

    local = optim.param_leaves(args[0])
    whole = _meta_params(TransformerLM(_lm_config()))[1]
    sharded = [(i, w) for i, (t, w) in enumerate(zip(local, whole)) if t.shape != w.shape]
    plan = gs.bucket_plan(sharded, 4 << 20)
    assert len(gathers) == len(plan) == 1 < len(sharded) == 12
    # The bucket moves what the leaves' own gathers would: (n - 1) shards each.
    assert sum(f.bytes for f in gathers) == sum(7 * local[i].numel() * local[i].element_size()
                                                for i, _ in sharded)


def test_fsdp_schedule_is_clean_at_the_reference_convoy_gate():
    assert "convoy_min" not in SCHED_TARGETS["fsdp_1x8"].overrides
    assert cli.main(["sched", "--target", "fsdp_1x8"]) == 0


WORKER = r'''
import json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo")
from rocket_tpu_torch.parallel import grad_sync as gs

rank, world = dist.get_rank(), dist.get_world_size()
gen = torch.Generator().manual_seed(7)
# (whole shape, shard dim, dtype): dims 0 and 1, two dtypes (a bucket
# each), one leaf past the 4 MiB bound (a bucket of its own).
specs = [((8, 6), 0, torch.float32), ((4, 10), 1, torch.float32),
         ((6,), 0, torch.float32), ((4, 4), 0, torch.bfloat16),
         ((1200, 1000), 0, torch.float32), ((2, 8), 1, torch.float32)]
wholes = [torch.randn(s, generator=gen).to(dt) for s, _, dt in specs]
shards = [(i, w.chunk(world, d)[rank].contiguous(), d) for i, (w, (_, d, _)) in
          enumerate(zip(wholes, specs))]
calls = []
real = dist.all_gather_into_tensor

def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)

dist.all_gather_into_tensor = counted
got = dict(gs.gathered(gs.gather_buckets(shards, world)))
n_bucketed = len(calls)
dist.all_gather_into_tensor = real
same = []
for i, shard, d in shards:
    whole, work = gs.gather_full(shard, d, world, async_op=True)
    work.wait()
    same.append(bool(got[i].shape == whole.shape and torch.equal(got[i], whole)
                     and torch.equal(whole, wholes[i])))
plan = gs.bucket_plan([(i, w) for i, w in enumerate(wholes)], 4 << 20)
print("RESULT " + json.dumps({"same": same, "calls": n_bucketed, "plan": len(plan)}))
dist.destroy_process_group()
'''


def test_bucketed_gathers_are_bitwise_the_leaf_gathers(tmp_path):
    outs = run_ranks(tmp_path, WORKER, 2, {})
    for out in outs:
        line = next(x for x in out.splitlines() if x.startswith("RESULT "))
        result = json.loads(line.removeprefix("RESULT "))
        assert all(result["same"]), result
        assert result["calls"] == result["plan"] == 4, result
