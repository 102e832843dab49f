"""Long-context LM training with ring-attention sequence parallelism
(counterpart of ``examples/long_context.py``).

Sequences longer than one card holds are sharded over a 'seq' mesh axis:
each rank keeps T/n tokens of every activation, and attention passes K/V
blocks around the ring (``impl="ring"``, ``parallel/ring_attention.py``)
instead of materializing the full (T, T) score matrix anywhere. The flags,
defaults and tree are the reference's; its devices are the port's ranks,
one process each:

    python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/long_context.py

(``ROCKET_TPU_DIST_BACKEND=gloo`` lets the ranks share one card; ``--device
cpu`` runs them on the CPU.)
"""

from __future__ import annotations

import argparse
import os

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, synthetic_corpus
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss


def world_size() -> int:
    """The ranks of the run: the open process group's, else the
    launcher's ``WORLD_SIZE``, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1")) if os.environ.get("MASTER_ADDR") else 1


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.examples.long_context")
    parser.add_argument("--seq-devices", type=int, default=None,
                        help="ranks on the 'seq' axis (default: all)")
    parser.add_argument("--seq-len", type=int, default=4096)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--device", default=None, help="default: the GPU")
    args = parser.parse_args(argv)

    n_dev = world_size()
    seq_devices = args.seq_devices or n_dev
    if n_dev % seq_devices or n_dev < seq_devices:
        raise SystemExit(f"--seq-devices {seq_devices} must divide the {n_dev} ranks (one "
                         "device a rank; start them with python -m rocket_tpu_torch.launch -n N)")
    data_devices = n_dev // seq_devices
    if args.seq_len % seq_devices:
        raise SystemExit(f"--seq-len must divide over {seq_devices} seq devices")

    # The 'seq' mesh axis turns on sequence sharding in Runtime.shard_batch
    # (each rank keeps its block of the tokens) and is what impl="ring"
    # rotates K/V around.
    runtime = rt.Runtime(mesh_shape={"data": data_devices, "seq": seq_devices}, seed=0,
                         device=args.device)
    config = TransformerConfig(
        vocab_size=256, max_seq_len=args.seq_len, dim=args.dim, num_layers=args.layers,
        num_heads=max(4, args.dim // 64), dropout=0.0, attention_impl="ring",
        activation_dtype="bfloat16",
    )
    model = TransformerLM(config)
    text = synthetic_corpus(num_chars=max(4 * args.seq_len * args.batch, 200_000))
    tok = CharTokenizer(text)
    data = TokenDataset(tok.encode(text) % config.vocab_size, seq_len=args.seq_len)
    losses: list = []

    class Spy(rt.Capsule):
        def __init__(self):
            super().__init__(priority=500)

        def launch(self, attrs=None):
            if attrs.looper.state.loss is not None:
                losses.append(attrs.looper.state.loss)

    launcher = rt.Launcher(
        [rt.Looper([
            rt.Dataset(data, batch_size=args.batch, shuffle=True, drop_last=True),
            rt.Module(model, capsules=[rt.Loss(next_token_loss()),
                                       rt.Optimizer(optim.adamw(), learning_rate=3e-4)],
                      remat=True),
            rt.Profiler(), Spy(),
        ], tag="train")],
        num_epochs=args.epochs, runtime=runtime,
    )
    print(launcher)
    launcher.launch()
    return {"launcher": launcher, "losses": [float(v) for v in losses], "runtime": runtime}


if __name__ == "__main__":
    main()
