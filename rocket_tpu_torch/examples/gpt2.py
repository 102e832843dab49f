"""GPT-2 124M pretraining (counterpart of ``examples/gpt2.py``).

GPT-2 124M (or ``--small``: dim 128, 2 layers) on the byte-level synthetic
corpus, bf16 compute over f32 masters, the whole forward under remat,
AdamW (weight decay 0.1) under warmup-cosine from 6e-4, gradient
accumulation (``--accum``), a ``Checkpointer`` every 1000 steps keeping
the last three (``--resume`` restarts from the newest), the ``Profiler``
(steps/s and MFU; ``--trace-at`` opens a trace window) and a jsonl
``Tracker`` (``runs/gpt2.jsonl``). Over the processes of ``python -m
rocket_tpu_torch.launch`` the mesh is ``{"data": d, "model": m}``, as in
the reference: ``--model-axis`` m (default 1) trains tensor parallel
under ``gpt2_tp_rules()`` (each rank holds its column or row shard of the
blocks' projections, the residual stream sequence-sharded), and the data
axis ``--data-axis`` (default: the world size over m) splits the global
batch ``--batch`` into stripes; ``d * m`` must equal the world size.

    python -m rocket_tpu_torch.examples.gpt2                       # on the GPU
    PYTHONPATH=. python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/gpt2.py
    PYTHONPATH=. python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/gpt2.py \
        --small --seq-len 64 --device cpu --model-axis 2
    python -m rocket_tpu_torch.examples.gpt2 --small --seq-len 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, synthetic_corpus
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss
from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules


def corpus(seq_len: int, vocab_size: int, num_chars: int = 2_000_000) -> TokenDataset:
    """The example's data: character ids of the synthetic text, mod the
    vocabulary, in ``seq_len`` windows (a stand-in for a tokenised corpus)."""
    text = synthetic_corpus(num_chars=num_chars)
    return TokenDataset(CharTokenizer(text).encode(text) % vocab_size, seq_len=seq_len)


def flops_per_sample(config: TransformerConfig, seq_len: int) -> float:
    """Training FLOPs of one sequence: 6 per analytic parameter (the
    embeddings and 12 D^2 a block) and token, plus attention's 12 L D T^2."""
    d, layers = config.dim, config.num_layers
    n_params = config.vocab_size * d + config.max_seq_len * d + layers * 12 * d * d
    return 6.0 * n_params * seq_len + 12.0 * layers * d * seq_len ** 2


def build(config: TransformerConfig, data, *, batch_size: int, runtime, num_epochs: int = 1,
          steps=None, remat: bool = True, record: bool = True, out_dir: str = "checkpoints/gpt2",
          resume: bool = False, trace_at=None, capsules=(), return_outputs: str = "eval",
          param_sharding=None, grad_sync: str = "auto",
          grad_wire_dtype="bfloat16") -> dict:
    """The example's capsule tree over ``data``. ``steps`` fixes the Looper's
    iterations and the schedule's length (default: ``num_epochs`` passes
    over ``data``); ``record=False`` leaves out the Checkpointer, Profiler,
    Tracker and progress bar (a timed run); ``capsules`` join the Looper
    after the Module; ``param_sharding`` goes to the Module
    (``parallel.sharding.fsdp_rules()`` or ``gpt2_tp_rules()``), ``grad_sync`` and
    ``grad_wire_dtype`` to the Optimizer capsule. Returns
    ``{"launcher", "model", "module", "dataset", "total_steps"}``."""
    model = TransformerLM(config)
    total = steps or max(1, len(data) // batch_size * num_epochs)
    module = rt.Module(model, [
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.adamw(weight_decay=0.1), grad_sync=grad_sync,
                     grad_wire_dtype=grad_wire_dtype),
        rt.Scheduler(optim.warmup_cosine_lr(6e-4, warmup_steps=max(1, total // 50),
                                            decay_steps=total)),
    ], compute_dtype=torch.bfloat16, remat=remat, return_outputs=return_outputs,
        param_sharding=param_sharding)
    dataset = rt.Dataset(data, batch_size=batch_size, shuffle=True, drop_last=True)
    tree = [dataset, module, *capsules]
    if record:
        tree += [rt.Checkpointer(output_dir=out_dir, save_every=1000, keep_last=3,
                                 resume_from="latest" if resume else None),
                 rt.Profiler(trace_start=trace_at,
                             flops_per_sample=flops_per_sample(config, data.seq_len)),
                 rt.Tracker(backend="jsonl", project="gpt2")]
    launcher = rt.Launcher([rt.Looper(tree, tag="train", repeats=steps, progress=record)],
                           num_epochs=num_epochs, statefull=True, runtime=runtime)
    return {"launcher": launcher, "model": model, "module": module, "dataset": dataset,
            "total_steps": total}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.examples.gpt2")
    parser.add_argument("--data-axis", type=int, default=None)
    parser.add_argument("--model-axis", type=int, default=1)
    parser.add_argument("--batch", type=int, default=8, help="global batch (sequences)")
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--accum", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many steps (default: the epochs' batches)")
    parser.add_argument("--small", action="store_true", help="tiny dims for smoke runs")
    parser.add_argument("--trace-at", type=int, default=None,
                        help="open a profiler trace window of 3 steps at this step")
    parser.add_argument("--scan-layers", action="store_true",
                        help="per-block remat (the scanned JAX tree's layout on load)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint")
    parser.add_argument("--device", default=None, help="default: the GPU")
    args = parser.parse_args(argv)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1")) if os.environ.get("MASTER_ADDR") else 1
    if world % args.model_axis:
        raise SystemExit(f"--model-axis {args.model_axis} does not divide the world size, "
                         f"{world} here (one device a rank; start the ranks with python -m "
                         "rocket_tpu_torch.launch -n N)")
    data_axis = args.data_axis or world // args.model_axis
    if data_axis * args.model_axis != world:
        raise SystemExit(f"--data-axis {data_axis} x --model-axis {args.model_axis}: the "
                         f"mesh's size is the world size, {world} here (one device a rank; "
                         "start the ranks with python -m rocket_tpu_torch.launch -n N)")
    runtime = rt.Runtime(seed=0, gradient_accumulation_steps=args.accum, device=args.device,
                         mesh_shape={"data": data_axis, "model": args.model_axis})
    if args.small:
        config = TransformerConfig(vocab_size=512, max_seq_len=args.seq_len, dim=128,
                                   num_layers=2, num_heads=4, dropout=0.0)
    else:
        config = TransformerConfig.gpt2_124m(max_seq_len=args.seq_len)
    if args.scan_layers:
        config = dataclasses.replace(config, scan_layers=True)
    run = build(config, corpus(args.seq_len, config.vocab_size), batch_size=args.batch,
                runtime=runtime, num_epochs=args.epochs, steps=args.steps, remat=not args.small,
                resume=args.resume, trace_at=args.trace_at,
                param_sharding=gpt2_tp_rules() if args.model_axis > 1 else None)
    print(run["launcher"])
    run["launcher"].launch()
    return run


if __name__ == "__main__":
    main()
