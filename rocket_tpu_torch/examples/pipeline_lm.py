"""Pipeline-parallel LM training — GPipe or 1F1B over a 'pipe' mesh axis
(counterpart of ``examples/pipeline_lm.py``).

The transformer's layers (``scan_layers=True``) are placed per stage over
the 'pipe' axis (``parallel.sharding.pipeline_rules``), one process a
stage; microbatches cross between the stages point to point
(``parallel/pipeline.py``). Two schedules:

* ``--schedule gpipe`` (default): the microbatches' forward, then autograd
  runs the reverse schedule; per-stage live activations grow with the
  microbatch count;
* ``--schedule 1f1b``: loss and backward run inside the schedule
  (one-forward-one-backward interleave); per-stage live activations are
  O(stages).

The flags, defaults and printed line are the reference's; its devices are
the port's ranks:

    python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/pipeline_lm.py --schedule 1f1b

(``ROCKET_TPU_DIST_BACKEND=gloo`` lets the ranks share one card; ``--device
cpu`` runs them on the CPU.)
"""

from __future__ import annotations

import argparse

import numpy as np

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, synthetic_corpus
from rocket_tpu_torch.examples.long_context import world_size
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss
from rocket_tpu_torch.parallel.sharding import pipeline_rules


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.examples.pipeline_lm")
    parser.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe")
    parser.add_argument("--pipe-devices", type=int, default=None,
                        help="pipeline stages (default: half the ranks, at least 2)")
    parser.add_argument("--microbatches", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--device", default=None, help="default: the GPU")
    args = parser.parse_args(argv)

    n = world_size()
    pipe = args.pipe_devices or max(2, n // 2)
    if n % pipe or pipe < 2:
        raise SystemExit(f"--pipe-devices {pipe} must be >= 2 and divide the {n} ranks (one "
                         "device a rank; start them with python -m rocket_tpu_torch.launch -n N)")
    data_par = n // pipe
    runtime = rt.Runtime(mesh_shape={"data": data_par, "pipe": pipe}, seed=0, device=args.device)

    corpus = synthetic_corpus(num_chars=60_000)
    tok = CharTokenizer(corpus)
    seq_len = 64
    data = TokenDataset(tok.encode(corpus), seq_len=seq_len)
    config = TransformerConfig(
        vocab_size=tok.vocab_size, max_seq_len=seq_len, dim=64, num_layers=2 * pipe,
        num_heads=4, dropout=0.0, scan_layers=True, pipeline_axis="pipe",
        pipeline_microbatches=args.microbatches, pipeline_schedule=args.schedule,
        loss_chunk=32,
    )
    module = rt.Module(TransformerLM(config),
                       capsules=[rt.Loss(next_token_loss()),
                                 rt.Optimizer(optim.adamw(), learning_rate=3e-3)],
                       param_sharding=pipeline_rules())
    losses: list = []

    class Spy(rt.Capsule):
        def __init__(self):
            super().__init__(priority=500)

        def launch(self, attrs=None):
            if attrs.looper.state.loss is not None:
                # A device scalar, read once after the run (a read here
                # would hold the pipeline every step).
                losses.append(attrs.looper.state.loss)

    batch_size = 8 * data_par * args.microbatches
    if batch_size > len(data):
        raise SystemExit(f"batch size {batch_size} exceeds the {len(data)}-sequence dataset; "
                         "lower --microbatches.")
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=batch_size, drop_last=True,
                                       shuffle=True), module, Spy()],
                           tag="train", progress=False)],
                num_epochs=args.epochs, runtime=runtime).launch()
    first, last = float(np.asarray(losses[0].cpu())), float(np.asarray(losses[-1].cpu()))
    print(f"{args.schedule} over {pipe} stages x {data_par} data shards: "
          f"loss {first:.3f} -> {last:.3f} ({len(losses)} steps)")
    assert last < first, "loss did not improve"
    return {"losses": [float(v) for v in losses], "first": first, "last": last}


if __name__ == "__main__":
    main()
