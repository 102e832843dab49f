"""``python -m rocket_tpu_torch.serve`` — serve a checkpoint or random
weights, and render what a serve run wrote (counterpart of
``rocket_tpu/serve/__main__.py``).

``run`` (the default) builds a model (``--config tiny`` or ``charlm``) with the params of the
newest complete checkpoint under ``--checkpoint`` (the loader of
``examples/generate.py``), or random params from ``--seed`` when no
checkpoint is given or none is complete (with a warning), serves
``--requests`` random prompts (or prompts from stdin with ``--stdin``,
charlm only) through :class:`ServeEngine`, streams the first ``--show``
requests and prints the report as JSON, with an enabled Telemetry
whose ``telemetry.json`` (the serve gauges, histograms and request spans)
lands under ``--out-dir`` at the end, and the request timelines under
``<out-dir>/telemetry/``. ``--export`` streams registry shards,
``--metrics-port`` mounts ``/metrics``, ``--slo`` evaluates a spec
(``default:serve``) every export window, ``--trace-steps A:B`` captures a
``torch.profiler`` window over engine ticks [A, B) into ``--trace-dir``
(default ``<out-dir>/traces``; a malformed window exits 2 at parse time),
``--no-reqtrace`` turns the request tracer off. Runs on the GPU unless
``--device cpu`` is given. ``report <telemetry.json | run dir>`` renders
the serve section of a written ``telemetry.json``.

Examples::

    python -m rocket_tpu_torch.serve run --requests 20 --max-new-tokens 24
    python -m rocket_tpu_torch.serve run --config charlm --checkpoint checkpoints/char_lm --stdin
    python -m rocket_tpu_torch.serve run --export --metrics-port 0 --slo default:serve \
        --trace-steps 4:8 --out-dir runs/serve
    python -m rocket_tpu_torch.serve report runs/serve
"""

from __future__ import annotations

import argparse
import json
import os
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
    from rocket_tpu_torch.obs.export import ExportConfig
    from rocket_tpu_torch.obs.telemetry import Telemetry
    from rocket_tpu_torch.serve.api import ServeConfig, ServeEngine

    model, params, tokenizer = _build_model(args)
    telemetry = Telemetry(enabled=True, out_dir=args.out_dir)
    telemetry.start()
    telemetry.start_export(
        ExportConfig.from_env(enabled=args.export or None, interval_s=args.export_interval,
                              metrics_port=args.metrics_port, slo_path=args.slo),
        default_dir=args.out_dir,
    )
    exporter = telemetry.exporter
    if exporter is not None and exporter.server is not None:
        print(f"serve: /metrics on http://{exporter.server.host}:{exporter.server.port}",
              file=sys.stderr)
    engine = ServeEngine(
        model, params,
        ServeConfig(
            max_slots=args.max_slots,
            block_len=args.block_len,
            num_blocks=args.num_blocks,
            max_model_len=args.max_model_len,
            prefill_chunk=args.prefill_chunk,
            decode_waves_per_dispatch=args.waves_per_dispatch,
            reqtrace=not args.no_reqtrace,
        ),
        tokenizer=tokenizer,
        telemetry=telemetry,
        generator=torch.Generator().manual_seed(args.seed),
        device=args.device,
    )
    if args.trace_steps:
        engine.capture_trace(args.trace_steps,
                             args.trace_dir or os.path.join(args.out_dir, "traces"))
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
    trace_file = engine.finish_trace()
    if args.trace_steps:
        if trace_file:
            print(f"serve: device trace written to {trace_file}; render with "
                  "`python -m rocket_tpu_torch.obs prof`", file=sys.stderr)
        else:
            print("serve: --trace-steps window captured no trace (window past the last tick?)",
                  file=sys.stderr)
    if engine.tracer is not None:
        # The last request-timeline window, flushed even without a live
        # exporter, so the run dir always renders with `obs timeline`.
        engine.tracer.flush(telemetry.resolve_out_dir(args.out_dir))
        print(f"serve: request timelines under {os.path.join(args.out_dir, 'telemetry')}; "
              f"render with `python -m rocket_tpu_torch.obs timeline {args.out_dir} "
              "--slowest 3`", file=sys.stderr)
    report = engine.report()
    print(json.dumps({"serve_report": report}, indent=1, sort_keys=True))
    out_dir = telemetry.flush()
    print(f"serve: telemetry written to {out_dir}", file=sys.stderr)
    telemetry.close(write=False)
    compiled = report["compiled"]
    if compiled["decode_traces"] != 1 or compiled["prefill_traces"] != 1:
        print(f"serve: step functions rebuilt: {compiled}", file=sys.stderr)
        return 1
    if report["requests"]["completed"] != len(rids):
        print("serve: not all requests completed", file=sys.stderr)
        return 1
    return 0


def _report(args) -> int:
    """The serve section of a ``telemetry.json``: every ``serve/*`` gauge
    and each ``serve/*`` histogram's count, mean and max (the reference's
    rendering)."""
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.json")
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"error: cannot read {path}: {exc}", file=sys.stderr)
        return 2
    gauges = doc.get("metrics", {}).get("gauges", {})
    histograms = doc.get("metrics", {}).get("histograms", {})
    serve_gauges = {k: v for k, v in gauges.items() if k.startswith("serve/")}
    if not serve_gauges:
        print(f"{path}: no serve/* gauges — not a serve run?")
        return 1
    print(f"serve report — {path}")
    for name in sorted(serve_gauges):
        print(f"  {name:32s} {serve_gauges[name]:g}")
    for name in sorted(h for h in histograms if h.startswith("serve/")):
        h = histograms[name]
        mean = h.get("mean")
        print(f"  {name:32s} count={h.get('count')} "
              f"mean={mean if mean is None else round(mean, 6)} max={h.get('max')}")
    return 0


def _trace_window_arg(text: str) -> str:
    """``--trace-steps`` checked at parse time (exit 2 before the model
    builds)."""
    from rocket_tpu_torch.obs.prof import parse_step_window

    try:
        parse_step_window(text)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(str(exc)) from exc
    return text


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
        p.add_argument("--trace-steps", default=None, metavar="A:B", type=_trace_window_arg,
                       help="capture a torch.profiler window over engine ticks [A, B) "
                            "(render with `python -m rocket_tpu_torch.obs prof`)")
        p.add_argument("--trace-dir", default=None,
                       help="trace output dir (default <out-dir>/traces)")
        p.add_argument("--out-dir", default=os.path.join("runs", "serve"))
        p.add_argument("--metrics-port", type=int, default=None,
                       help="mount a Prometheus /metrics endpoint on this port (0 = ephemeral; "
                            "env ROCKET_TPU_METRICS_PORT)")
        p.add_argument("--export", action="store_true",
                       help="stream registry snapshots as JSONL shards to "
                            "<out-dir>/telemetry/rank<k>.jsonl (env ROCKET_TPU_EXPORT)")
        p.add_argument("--export-interval", type=float, default=None, metavar="SECS",
                       help="exporter tick cadence (default 10)")
        p.add_argument("--slo", default=None, metavar="SPEC",
                       help="SLO spec file, or default:serve (env ROCKET_TPU_SLO)")
        p.add_argument("--no-reqtrace", action="store_true",
                       help="disable per-request timeline tracing (obs/reqtrace.py)")
    rep = sub.add_parser("report", help="render a serve telemetry.json")
    rep.add_argument("path", help="telemetry.json or the run dir holding it")
    args = parser.parse_args(argv)
    if args.cmd == "report":
        return _report(args)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
