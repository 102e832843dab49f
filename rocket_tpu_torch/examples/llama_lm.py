"""Llama-family char-LM (counterpart of ``examples/llama_lm.py``).

The char-LM's tree with the Llama recipe: RoPE positions, RMSNorm, SwiGLU
FFN, grouped-query attention (8 query heads over 4 K/V heads, head dim 32:
half the KV cache in decoding), an untied head, bf16 activations, the
chunked head + cross-entropy in 64-token chunks, AdamW (weight decay 0.1)
clipped at 1.0 under warmup-cosine from 3e-4, a ``Checkpointer`` every 500
steps, and at the end nucleus sampling (temperature 0.8, top-p 0.9) through
``generate()``'s GQA KV cache. Without ``data/tinyshakespeare.txt`` (or
``$TEXT_ROOT``) the corpus is the deterministic synthetic one.

    python -m rocket_tpu_torch.examples.llama_lm      # on the GPU
"""

from __future__ import annotations

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


def config_for(vocab_size: int, seq_len: int) -> TransformerConfig:
    """The example's model: dim 256, 6 layers, 8 heads over 4 K/V heads."""
    config = TransformerConfig.llama_style(vocab_size=vocab_size, max_seq_len=seq_len, dim=256,
                                           num_layers=6, num_heads=8, num_kv_heads=4)
    config.loss_chunk = 64
    return config


def build(train_data, config: TransformerConfig, *, batch_size: int, num_epochs: int,
          out_dir: str, runtime, capsules=()) -> dict:
    """The example's capsule tree over ``train_data``; ``capsules`` join the
    Looper after the Module (a step clock). Returns ``{"launcher",
    "model", "module", "dataset", "trained", "total_steps"}``;
    ``trained["params"]`` holds the live params and ``trained["losses"]``
    each step's loss (device scalars) once a step ran."""
    model = TransformerLM(config)
    total_steps = max(1, len(train_data) // batch_size * num_epochs)
    module = rt.Module(model, capsules=[
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.adamw(weight_decay=0.1), clip_norm=1.0),
        rt.Scheduler(optim.warmup_cosine_lr(3e-4, warmup_steps=max(1, total_steps // 20),
                                            decay_steps=total_steps)),
    ])
    trained: dict = {"losses": []}

    class Keep(rt.Capsule):
        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["params"] = module.state["params"]
            trained["losses"].append(attrs.step_metrics["loss"])

    dataset = rt.Dataset(train_data, batch_size=batch_size, shuffle=True, drop_last=True)
    launcher = rt.Launcher([rt.Looper([
        dataset, module, *capsules, Keep(), rt.Checkpointer(output_dir=out_dir, save_every=500),
    ], tag="train")], num_epochs=num_epochs, statefull=True, runtime=runtime)
    return {"launcher": launcher, "model": model, "module": module, "dataset": dataset,
            "trained": trained, "total_steps": total_steps}


def sample(model, params, tok: CharTokenizer, device, max_new: int = 64) -> torch.Tensor:
    """Nucleus sampling from the prompt "the " through the GQA KV cache:
    ``(1, 4 + n)`` tokens, n = ``max_new`` or what ``max_seq_len`` leaves."""
    prompt = tok.encode("the ")[None, :]
    max_new = min(max_new, model.config.max_seq_len - prompt.shape[1])
    return generate(model, params, prompt, max_new, generator=torch.Generator().manual_seed(0),
                    temperature=0.8, top_p=0.9, device=device)


def main(num_epochs: int = 2, batch_size: int = 128, seq_len: int = 256,
         out_dir: str = "checkpoints/llama_lm", device=None) -> dict:
    """Train, checkpoint into ``out_dir`` and sample; ``device`` defaults to
    the GPU. Returns :func:`build`'s dict plus ``"sample"``."""
    text = tiny_shakespeare()
    tok = CharTokenizer(text)
    runtime = rt.Runtime(seed=0, device=device)
    run = build(TokenDataset(tok.encode(text), seq_len=seq_len),
                config_for(tok.vocab_size, seq_len), batch_size=batch_size,
                num_epochs=num_epochs, out_dir=out_dir, runtime=runtime)
    run["launcher"].launch()
    print(f"vocab={tok.vocab_size} steps={run['total_steps']}")
    out = sample(run["model"], run["trained"]["params"], tok, runtime.device)
    run["sample"] = tok.decode(out[0].cpu().numpy())
    print("sample:", run["sample"])
    return run


if __name__ == "__main__":
    main()
