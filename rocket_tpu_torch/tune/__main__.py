"""CLI: ``python -m rocket_tpu_torch.tune`` — sweep, validate, update
(counterpart of ``rocket_tpu/tune/__main__.py``).

Exit codes: 0 clean, 1 findings or failure, 2 usage error.

* no flags: sweep every builtin case on the card and print each case's
  default, winner and speedup — nothing is written;
* ``--update-table``: also write the winners into the tables
  (``rocket_tpu_torch/tune/configs/`` or ``--table-dir``). Refused on the
  CPU;
* ``--check`` / ``--check-table``: the table gate (schema, legality of
  every entry against its TuneSpace, stale structural winners, unknown
  device names). Runs anywhere;
* ``--list``: the kernel and case catalog, structural axes marked ``*``;
* ``--allow-cpu``: without a card, run the small smoke cases through the
  plain versions (the loop only; timings mean nothing, no table writes).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.tune",
        description="offline kernel tuner (sweep + parity check + config tables)",
    )
    parser.add_argument("--list", action="store_true",
                        help="print the kernel/case catalog and exit")
    parser.add_argument("--check-table", "--check", action="store_true", dest="check_table",
                        help="validate the tables (schema, legality, stale structural "
                             "winners, known device names) and exit")
    parser.add_argument("--kernel", action="append", help="sweep only these kernels")
    parser.add_argument("--case", action="append", help="sweep only these named cases")
    parser.add_argument("--update-table", action="store_true",
                        help="write winning configs into the table dir")
    parser.add_argument("--table-dir", default=None,
                        help="table directory (default: rocket_tpu_torch/tune/configs)")
    parser.add_argument("--min-speedup", type=float, default=1.02,
                        help="least tuned/default speedup recorded (default 1.02)")
    parser.add_argument("--iters", type=int, default=20, help="timed calls per candidate")
    parser.add_argument("--allow-cpu", action="store_true",
                        help="without a card, run the smoke cases through the plain "
                             "versions (no table writes)")
    parser.add_argument("--json", action="store_true", help="print a JSON summary line")
    args = parser.parse_args(argv)

    from rocket_tpu_torch.tune.table import validate_tables

    if args.check_table:
        problems = validate_tables(args.table_dir)
        for problem in problems:
            print(f"tune-table: {problem}", file=sys.stderr)
        if args.json:
            print(json.dumps({"problems": problems}))
        elif not problems:
            print("tune tables OK")
        return 1 if problems else 0

    from rocket_tpu_torch.tune.tuner import load_cases, run_cases, update_tables

    if args.list:
        from rocket_tpu_torch.tune.space import TUNE_SPACES

        for name, space in sorted(TUNE_SPACES.items()):
            axes = ", ".join(f"{k}{'*' if k in space.structural else ''}={list(v)}"
                             for k, v in sorted(space.axes.items()))
            print(f"{name:18s} {axes}")
            if space.structural:
                print(f"{'':18s} structural axes (each value a different program): "
                      f"{', '.join(space.structural)}")
        print()
        for name, case in sorted(load_cases().items()):
            tag = "  [smoke]" if case.smoke else ""
            print(f"{name:22s} kernel={case.kernel} shape={dict(case.shape)} {case.dtype}{tag}")
        return 0

    import torch

    from rocket_tpu_torch.tune.table import _local_kind

    on_cpu = not torch.cuda.is_available()
    if on_cpu and not args.allow_cpu:
        print("tune: no CUDA device — the wrappers would run their plain versions and every "
              "timing would be meaningless. Run on the card, or pass --allow-cpu for the "
              "smoke cases (no table writes).", file=sys.stderr)
        return 1
    if on_cpu and args.update_table:
        print("tune: --update-table refused on the CPU (no real timings)", file=sys.stderr)
        return 2

    reports = run_cases(names=args.case, kernels=args.kernel, device="cpu" if on_cpu else "cuda",
                        iters=1 if on_cpu else max(1, args.iters),
                        min_speedup=args.min_speedup, smoke_only=on_cpu,
                        log=lambda s: print(f"tune: {s}", file=sys.stderr))
    summary = {
        "device_kind": _local_kind(),
        "cases": {
            r.case.name: {
                "kernel": r.case.kernel,
                "default_config": r.default_config,
                "default_us": r.default_us,
                "winner": None if r.winner is None else {
                    "config": r.winner.config, "tuned_us": r.winner.mean_us,
                    "speedup": r.speedup,
                },
                "candidates": [{"config": res.config, "us": res.mean_us,
                                "parity_ok": res.parity_ok, "max_err": res.max_err,
                                "error": res.error} for res in r.results],
                "rejected_parity": [res.config for res in r.results
                                    if not res.parity_ok and res.error is None],
            }
            for r in reports
        },
    }
    if args.update_table:
        summary["written"] = update_tables(reports, args.table_dir)
    if args.json:
        print(json.dumps(summary))
    else:
        for name, rec in summary["cases"].items():
            win = rec["winner"]
            line = (f"{name}: default {rec['default_us']:.1f} us" if rec["default_us"]
                    else f"{name}: no timing")
            if win:
                line += (f" -> tuned {win['tuned_us']:.1f} us ({win['speedup']:.3f}x) "
                         f"{win['config']}")
            else:
                line += " (no win; default kept)"
            print(line)
        for path in summary.get("written", []):
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
