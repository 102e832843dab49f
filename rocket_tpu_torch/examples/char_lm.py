"""Char-transformer on TinyShakespeare (counterpart of ``examples/char_lm.py``).

The canonical LM tree: ``Dataset`` over the token windows, ``Module(Loss,
Optimizer(AdamW, wd 0.1), Scheduler(warmup-cosine from 3e-4))``, a
``Checkpointer`` at every epoch boundary (keeping the last two) and a
jsonl ``Tracker`` (``runs/char_lm.jsonl``), under a stateful
``Launcher``; the architecture goes to ``<out_dir>/config.json`` (the
same JSON as the JAX example's), and a closing sample is drawn from the
trained params. Without ``data/tinyshakespeare.txt`` (or ``$TEXT_ROOT``)
the corpus is the deterministic synthetic one.

    python -m rocket_tpu_torch.examples.char_lm      # on the GPU

``ROCKET_TPU_BLOCK_ATTN=fused`` runs each block's attention half through
the fused kernel (``ops/fused_block.py``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, tiny_shakespeare
from rocket_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    generate,
    next_token_loss,
)


def build(train_data, config: TransformerConfig, *, batch_size: int, num_epochs: int,
          out_dir: str, runtime, resume_from=None) -> dict:
    """The example's capsule tree over ``train_data``. Returns ``{"launcher",
    "model", "module", "checkpointer", "trained", "total_steps"}``;
    ``trained["params"]`` holds the live params once a step ran."""
    model = TransformerLM(config)
    steps_per_epoch = len(train_data) // batch_size
    total_steps = max(1, steps_per_epoch * num_epochs)
    module = rt.Module(model, capsules=[
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.adamw(weight_decay=0.1)),
        rt.Scheduler(optim.warmup_cosine_lr(3e-4, warmup_steps=max(1, total_steps // 20),
                                            decay_steps=total_steps)),
    ])
    # A handle on the trained params past destroy (for the sample).
    trained: dict = {}

    class Keep(rt.Capsule):
        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["params"] = module.state["params"]

    # Save at every epoch boundary: generate.py samples from the newest.
    checkpointer = rt.Checkpointer(output_dir=out_dir, save_every=steps_per_epoch, keep_last=2,
                                   resume_from=resume_from)
    launcher = rt.Launcher([rt.Looper([
        rt.Dataset(train_data, batch_size=batch_size, shuffle=True, drop_last=True),
        module,
        Keep(),
        checkpointer,
        rt.Tracker(backend="jsonl", project="char_lm"),
    ], tag="train")], num_epochs=num_epochs, statefull=True, runtime=runtime)
    return {"launcher": launcher, "model": model, "module": module,
            "checkpointer": checkpointer, "trained": trained, "total_steps": total_steps}


def main(num_epochs: int = 2, batch_size: int = 128, seq_len: int = 256,
         out_dir: str = "checkpoints/char_lm", device=None) -> dict:
    """Train, checkpoint into ``out_dir`` and sample; ``device`` defaults to
    the GPU. Returns :func:`build`'s dict plus ``"sample"``."""
    text = tiny_shakespeare()
    tok = CharTokenizer(text)
    tokens = tok.encode(text)
    train_data = TokenDataset(tokens[:int(len(tokens) * 0.95)], seq_len=seq_len)

    runtime = rt.Runtime(seed=0, device=device)
    config = TransformerConfig.char_lm(vocab_size=tok.vocab_size, max_seq_len=seq_len)
    # The architecture beside the checkpoints: param shapes do not depend
    # on the head count, so generate.py reads it back instead of guessing.
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=1)

    run = build(train_data, config, batch_size=batch_size, num_epochs=num_epochs,
                out_dir=out_dir, runtime=runtime)
    run["launcher"].launch()
    print(f"vocab={tok.vocab_size} steps={run['total_steps']}")

    prompt = tok.encode("the ")[None, :]
    max_new = min(64, config.max_seq_len - prompt.shape[1])
    out = generate(run["model"], run["trained"]["params"], prompt, max_new,
                   generator=torch.Generator().manual_seed(0), temperature=0.8, top_k=20,
                   device=runtime.device)
    run["sample"] = tok.decode(out[0].cpu().numpy())
    print("sample:", run["sample"])
    return run


if __name__ == "__main__":
    main()
