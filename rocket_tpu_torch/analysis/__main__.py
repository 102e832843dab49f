"""``python -m rocket_tpu_torch.analysis``: the port's static checks on the
CPU (counterpart of ``rocket_tpu/analysis/__main__.py``).

    python -m rocket_tpu_torch.analysis PATH [PATH ...]   # the lint
    python -m rocket_tpu_torch.analysis sched [--target NAME ...]
                                              [--list-targets]
                                              [--device-kind KIND]
    python -m rocket_tpu_torch.analysis --list-rules

Exit codes, the reference's: 0 clean, 1 findings, 2 a usage error. Both
forms take ``--format json`` (a list of ``{rule, path, line, message}``
on stdout). ``sched`` audits every non-demo target unless ``--target``
names some; a demo target (``badpallas``) runs only when named.
"""

from __future__ import annotations

import argparse
import sys

from rocket_tpu_torch.analysis.findings import emit_findings
from rocket_tpu_torch.analysis.rocketlint import lint_paths
from rocket_tpu_torch.analysis.rules import all_rules


def _ids(text):
    return [part.strip() for part in text.split(",") if part.strip()]


def sched_main(argv) -> int:
    from rocket_tpu_torch.analysis.sched_audit import (
        DEFAULT_DEVICE_KIND,
        SCHED_TARGETS,
        run_sched_target,
    )

    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.analysis sched",
        description="kernel-launch audit (RKT504): every hand kernel a target's step launches, "
                    "traced on meta tensors and held to the card's shared memory and tiles",
    )
    parser.add_argument("--target", action="append", choices=sorted(SCHED_TARGETS),
                        help="audit only these targets (default: every non-demo target)")
    parser.add_argument("--list-targets", action="store_true",
                        help="print the target catalog and exit")
    parser.add_argument("--device-kind", default=DEFAULT_DEVICE_KIND,
                        help=f"the card to price against (default: {DEFAULT_DEVICE_KIND})")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    args = parser.parse_args(argv)

    if args.list_targets:
        for name, target in SCHED_TARGETS.items():
            print(f"{name:18s} {target.doc}{'  [demo]' if target.demo else ''}")
        return 0
    names = args.target or [name for name, t in SCHED_TARGETS.items() if not t.demo]
    try:
        findings = [f for name in names
                    for f in run_sched_target(SCHED_TARGETS[name], args.device_kind).findings]
    except ValueError as err:  # an unknown device kind
        parser.error(str(err))
    emit_findings(findings, fmt=args.format)
    return 1 if findings else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sched"]:
        return sched_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.analysis",
        description="rocketlint for the PyTorch port (see also the `sched` subcommand)",
    )
    parser.add_argument("paths", nargs="*", help="files or directories to lint")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--select", default=None, help="comma-separated rule ids to run")
    parser.add_argument("--ignore", default="", help="comma-separated rule ids to skip")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, slug, contract in all_rules():
            print(f"{rule_id}  {slug:22s} {contract}")
        return 0
    if not args.paths:
        parser.error("no paths given (or --list-rules, or the `sched` subcommand)")
    try:
        findings = lint_paths(args.paths, select=_ids(args.select) if args.select else None,
                              ignore=_ids(args.ignore))
    except FileNotFoundError as err:
        parser.error(str(err))
    emit_findings(findings, fmt=args.format)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
