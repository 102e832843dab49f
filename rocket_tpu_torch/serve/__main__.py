"""``python -m rocket_tpu_torch.serve run`` — serve a checkpoint or
random weights.

Builds a model (``--config tiny`` or ``charlm``) with the params of the
newest complete checkpoint under ``--checkpoint`` (the loader of
``examples/generate.py``), or random params from ``--seed`` when no
checkpoint is given or none is complete (with a warning), serves
``--requests`` random prompts (or prompts from stdin with ``--stdin``,
charlm only) through :class:`ServeEngine`, streams the first ``--show``
requests and prints the report as JSON. Runs on the GPU unless
``--device cpu`` is given.

Examples::

    python -m rocket_tpu_torch.serve run --requests 20 --max-new-tokens 24
    python -m rocket_tpu_torch.serve run --config charlm --checkpoint checkpoints/char_lm --stdin

The reference's export, SLO and trace flags (``--export``,
``--export-interval``, ``--metrics-port``, ``--slo``, ``--no-reqtrace``,
``--trace-steps``, ``--trace-dir``) are accepted and raise: they come with
the serve engine's telemetry and request tracing (ROADMAP Queue A 7b item
4), as does the ``report`` subcommand.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _build_model(args):
    """(model, params, tokenizer) for the requested config."""
    from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    tokenizer = None
    if args.config == "tiny":
        config = TransformerConfig(
            vocab_size=128, max_seq_len=128, dim=64, num_layers=2, num_heads=4,
        )
    else:
        from rocket_tpu_torch.data.text import CharTokenizer, tiny_shakespeare

        tokenizer = CharTokenizer(tiny_shakespeare())
        config = TransformerConfig.char_lm(vocab_size=tokenizer.vocab_size, max_seq_len=256)
    model = TransformerLM(config)
    params = None
    if args.checkpoint:
        from rocket_tpu_torch.examples.generate import load_params

        params = load_params(model, args.checkpoint, device=args.device)
        if params is None:
            print(f"serve: no complete checkpoint under {args.checkpoint!r} — using random-init "
                  "params", file=sys.stderr)
    if params is None:
        params = model.init(torch.Generator().manual_seed(args.seed), device=args.device)
    return model, params, tokenizer


def _workload(args, model, tokenizer):
    """(prompt, max_new_tokens) pairs: stdin lines or random prompts."""
    if args.stdin:
        if tokenizer is None:
            raise SystemExit("--stdin needs a tokenized config (--config charlm)")
        for line in sys.stdin:
            line = line.rstrip("\n")
            if line:
                yield line, args.max_new_tokens
        return
    rng = np.random.default_rng(args.seed)
    vocab = model.config.vocab_size
    for _ in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        yield (rng.integers(0, vocab, size=plen).astype(np.int32),
               int(rng.integers(1, args.max_new_tokens + 1)))


def _run(args) -> int:
    from rocket_tpu_torch.serve.api import ServeConfig, ServeEngine

    model, params, tokenizer = _build_model(args)
    engine = ServeEngine(
        model, params,
        ServeConfig(
            max_slots=args.max_slots,
            block_len=args.block_len,
            num_blocks=args.num_blocks,
            max_model_len=args.max_model_len,
            prefill_chunk=args.prefill_chunk,
            decode_waves_per_dispatch=args.waves_per_dispatch,
        ),
        tokenizer=tokenizer,
        generator=torch.Generator().manual_seed(args.seed),
        device=args.device,
    )
    rids = [
        engine.submit(prompt, max_new_tokens=mnt, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, eos_token_id=args.eos_token_id)
        for prompt, mnt in _workload(args, model, tokenizer)
    ]
    if not rids:
        raise SystemExit("serve: empty workload")
    for rid in rids[: args.show]:
        print(f"--- request {rid} ---")
        for piece in engine.stream(rid):
            print(piece if isinstance(piece, str) else f" {piece}", end="", flush=True)
        print()
    engine.drain()
    report = engine.report()
    print(json.dumps({"serve_report": report}, indent=1, sort_keys=True))
    if report["requests"]["completed"] != len(rids):
        print("serve: not all requests completed", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.serve")
    sub = parser.add_subparsers(dest="cmd")
    run = sub.add_parser("run", help="serve a workload (default)")
    for p in (parser, run):
        p.add_argument("--config", default="tiny", choices=["tiny", "charlm"])
        p.add_argument("--device", default=None, help="default: cuda")
        p.add_argument("--checkpoint", default=None,
                       help="serve the newest complete checkpoint under this directory")
        p.add_argument("--requests", type=int, default=16)
        p.add_argument("--prompt-len", type=int, default=12, help="max synthetic prompt length")
        p.add_argument("--max-new-tokens", type=int, default=16)
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=None)
        p.add_argument("--top-p", type=float, default=None)
        p.add_argument("--eos-token-id", type=int, default=None)
        p.add_argument("--max-slots", type=int, default=4)
        p.add_argument("--block-len", type=int, default=16)
        p.add_argument("--num-blocks", type=int, default=None)
        p.add_argument("--max-model-len", type=int, default=None)
        p.add_argument("--prefill-chunk", type=int, default=16)
        p.add_argument("--waves-per-dispatch", type=int, default=1,
                       help="decode waves per dispatch (k): one host transfer per k tokens")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--show", type=int, default=2, help="stream the first N requests")
        p.add_argument("--stdin", action="store_true",
                       help="read prompts from stdin (one per line)")
        for flag, kw in _QUEUED_FLAGS.items():
            p.add_argument(flag, **kw, help="not ported yet (ROADMAP Queue A 7b item 4)")
    args = parser.parse_args(argv)
    asked = [flag for flag in _QUEUED_FLAGS
             if getattr(args, flag[2:].replace("-", "_")) not in (None, False)]
    if asked:
        raise NotImplementedError(f"serve: {', '.join(asked)}: the serve engine's export, SLO "
                                  "and request-trace plane is not ported yet (ROADMAP Queue A 7b "
                                  "item 4)")
    return _run(args)


#: The reference CLI's export, SLO and trace flags, accepted to raise.
_QUEUED_FLAGS = {"--export": {"action": "store_true"}, "--export-interval": {"type": float},
                 "--metrics-port": {"type": int}, "--slo": {"default": None},
                 "--no-reqtrace": {"action": "store_true"}, "--trace-steps": {"default": None},
                 "--trace-dir": {"default": None}}


if __name__ == "__main__":
    sys.exit(main())
