"""Sample text from a trained char-LM checkpoint (counterpart of
``examples/generate.py``).

Loads the newest complete checkpoint under ``--ckpt`` (training a one-epoch
run first when there is none) with the architecture from its
``config.json``, then :func:`generate`: one batched prefill, then one S = 1
decode step per token through per-layer KV caches (on the GPU: the
``decode_attention`` kernel). Checkpoints written by the JAX package load
too (a scanned tree is unstacked).

    python -m rocket_tpu_torch.examples.char_lm            # train + checkpoint
    python -m rocket_tpu_torch.examples.generate --prompt "KING: " --tokens 200
    python -m rocket_tpu_torch.examples.generate --greedy
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.checkpoint import Checkpointer
from rocket_tpu_torch.data.text import CharTokenizer, tiny_shakespeare
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, generate
from rocket_tpu_torch.runtime import checkpoint_io, resolve_device

SEQ_LEN = 256  # char_lm.py's training length


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def load_params(model: TransformerLM, ckpt_dir: str, device=None):
    """The params of the newest complete checkpoint under ``ckpt_dir`` on
    ``device`` (default: the GPU), or None when there is none. Raises when
    the stored params do not have the model's leaves and shapes."""
    latest = Checkpointer(output_dir=ckpt_dir, resume_from="latest")._resolve_resume_path("latest")
    if latest is None:
        return None
    flat = checkpoint_io.load_pytree(os.path.join(latest, "model_0"))
    params = params_from_jax(checkpoint_io.unflatten(flat)["params"], resolve_device(device))
    got, want = _shapes(params), _shapes(model.init(device="cpu"))
    diff = {k: (got.get(k), want.get(k)) for k in sorted(got.keys() | want.keys())
            if got.get(k) != want.get(k)}
    if diff:
        raise ValueError(f"checkpoint {latest}: params do not match the model, "
                         f"(stored, model) shapes: {diff}")
    print(f"loaded params from {latest}")
    return params


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", default="checkpoints/char_lm",
                        help="checkpoint dir written by char_lm.py")
    parser.add_argument("--prompt", default="the ")
    parser.add_argument("--tokens", type=int, default=128, help="tokens to generate")
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top-k", type=int, default=20)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--greedy", action="store_true",
                        help="argmax decode (ignores temperature/top-k/p)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bench", action="store_true",
                        help="also report decode throughput (tok/s) over a second, timed "
                        "generation")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # The tokenizer is a pure function of the corpus.
    tok = CharTokenizer(tiny_shakespeare())
    cfg_path = os.path.join(args.ckpt, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = TransformerConfig(**json.load(f))
        print(f"using architecture from {cfg_path} (heads={config.num_heads}, dim={config.dim})")
    else:
        config = TransformerConfig.char_lm(vocab_size=tok.vocab_size, max_seq_len=SEQ_LEN)
        print("no config.json next to the checkpoints — assuming the current char_lm preset "
              f"(heads={config.num_heads}); checkpoints of another preset will sample garbage")
    model = TransformerLM(config)

    params = load_params(model, args.ckpt, device)
    if params is None:
        print(f"no checkpoint under {args.ckpt!r} — training one first (char_lm, 1 epoch)...")
        from rocket_tpu_torch.examples import char_lm

        char_lm.main(num_epochs=1, out_dir=args.ckpt, device=device)
        params = load_params(model, args.ckpt, device)
        if params is None:
            raise SystemExit(f"char_lm finished but left no complete checkpoint under "
                             f"{args.ckpt!r}")

    prompt = tok.encode(args.prompt)[None, :]
    max_new = min(args.tokens, config.max_seq_len - prompt.shape[1])
    if max_new < args.tokens:
        print(f"clamping to {max_new} tokens (max_seq_len={config.max_seq_len})")
    sampling = dict(temperature=0.0 if args.greedy else args.temperature,
                    top_k=None if args.greedy else args.top_k,
                    top_p=None if args.greedy else args.top_p, device=device)
    out = generate(model, params, prompt, max_new,
                   generator=torch.Generator().manual_seed(args.seed), **sampling)
    text = tok.decode(out[0].cpu().numpy())
    print("-" * 60)
    print(text)

    if args.bench:
        # The first call above warmed up; time a second one.
        _sync(device)
        t0 = time.perf_counter()
        generate(model, params, prompt, max_new,
                 generator=torch.Generator().manual_seed(args.seed + 1), **sampling)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"decode: {max_new} tokens in {dt * 1e3:.0f} ms = {max_new / dt:,.0f} tok/s "
              "(B=1, KV-cached incremental decode)")
    return text


if __name__ == "__main__":
    main()
