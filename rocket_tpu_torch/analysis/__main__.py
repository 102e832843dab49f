"""``python -m rocket_tpu_torch.analysis``: the port's static checks and
the calibration (counterpart of ``rocket_tpu/analysis/__main__.py``).

    python -m rocket_tpu_torch.analysis PATH [PATH ...]     # the lint
    python -m rocket_tpu_torch.analysis sched [--target NAME ...] [--list-targets]
        [--device-kind KIND] [--budgets-dir DIR | --no-budgets] [--update-budgets]
    python -m rocket_tpu_torch.analysis calib [--target NAME ...] [--list-targets]
        [--device DEV] [--trace-root DIR] [--budgets-dir DIR | --no-budgets]
        [--update-budgets]
    python -m rocket_tpu_torch.analysis shard [--target NAME ...] [--list-targets]
        [--budgets-dir DIR | --no-budgets] [--update-budgets]
    python -m rocket_tpu_torch.analysis mem [--target NAME ...] [--list-targets]
        [--device-kind KIND] [--budgets-dir DIR | --no-budgets] [--update-budgets]
    python -m rocket_tpu_torch.analysis prec [--target NAME ...] [--list-targets]
        [--budgets-dir DIR | --no-budgets] [--update-budgets]
    python -m rocket_tpu_torch.analysis repro [--target NAME ...] [--list-targets]
        [--budgets-dir DIR | --no-budgets] [--update-budgets]
    python -m rocket_tpu_torch.analysis all [PATH ...] [--budgets-dir ROOT]
    python -m rocket_tpu_torch.analysis --list-rules

Exit codes, the reference's: 0 clean, 1 findings, 2 a usage error. Every
form takes ``--format json`` (a list of ``{rule, path, line, message}`` on
stdout) and the audits ``--json-report PATH``.

The audit subcommands are one registry (:data:`AUDIT_SUBCOMMANDS`, the
reference's ``AuditCLI``) sharing one flag set and one budget write/diff
loop (:func:`_sweep_targets`): ``sched`` (``analysis/sched_audit.py``:
the roofline legs RKT501-503/505 and the kernel-launch leg RKT504 of
every target, priced as an H100 by default; RKT506 its budgets) and
``calib`` (``analysis/calib.py``: a measured trace reconciled against
the priced step; RKT702/703, and RKT701 its budgets), ``shard``
(``analysis/shard_audit.py``: a rule set's placement and one rank's
collectives, RKT301-305; RKT306 its budgets) and ``mem``
(``analysis/mem_audit.py``: the liveness of each target's step, its
in-place update, saved set and frontier, RKT801/802/804; RKT803 its
budgets; RKT805 needs the card's measured peak, ``chip_smoke.py``),
``prec`` (``analysis/prec_audit.py``: the dtype flow of each target's
step, RKT401-405; RKT406 its budgets) and ``repro``
(``analysis/repro_audit.py``: key discipline, order-free sums, resume and
wave identity, the replay sentinel, RKT901-905; RKT906 its budgets). Each
diffs its records against the committed
``tests/fixtures/torch_budgets/<family>/`` of the checkout unless
``--no-budgets`` (``--budgets-dir`` another directory;
``--update-budgets`` rewrites them). A demo target runs only when named
and is never budgeted. ``calib``'s default sweep measures the targets
whose device is present and names the others on stderr; a named target
whose card is absent is a usage error, never measured on the CPU instead.
``all`` runs the lint and every family in one process. The trace audit
(RKT2xx) is a library entry, ``trace_audit.audit_step``, as the
reference's is. The reference's other families (serve, fault) are ROADMAP
Queue A 9's remainder: asking for one exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import asdict, dataclass
from typing import Callable

from rocket_tpu_torch.analysis.findings import emit_findings
from rocket_tpu_torch.analysis.rocketlint import lint_paths
from rocket_tpu_torch.analysis.rules import all_rules

#: The checkout the package sits in: its committed budgets are the default.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: The reference's audit families not ported yet (ROADMAP Queue A 9).
UNPORTED = ("serve", "fault")


def _ids(text):
    return [part.strip() for part in text.split(",") if part.strip()]


@dataclass(frozen=True)
class AuditCLI:
    """One audit subcommand: where its targets live, which budget keys
    gate and which rule a regression reports as."""

    name: str
    description: str
    #: () -> (targets dict, run(target, args) -> report), imported lazily.
    load: Callable[[], tuple]
    budgets_dir_attr: str
    gated_keys_attr: str
    budget_rule: str
    family: str
    list_line: Callable[[object], str] = staticmethod(lambda t: "")


def _load_sched():
    from rocket_tpu_torch.analysis.sched_audit import (
        DEFAULT_DEVICE_KIND,
        SCHED_TARGETS,
        render_record,
        run_sched_target,
    )

    def run(target, args):
        report = run_sched_target(target, getattr(args, "device_kind", DEFAULT_DEVICE_KIND))
        if report.record and getattr(args, "format", "text") == "text":
            print(render_record(target.name, report.record), file=sys.stderr)
        return report

    return SCHED_TARGETS, run


def _load_calib():
    from rocket_tpu_torch.analysis.calib import CALIB_TARGETS, render_calib, run_calib_target

    def run(target, args):
        report = run_calib_target(target, trace_root=getattr(args, "trace_root", None),
                                  device=getattr(args, "device", None))
        if report.record and getattr(args, "format", "text") == "text":
            print(render_calib(report.record), file=sys.stderr)
        return report

    return CALIB_TARGETS, run


def _load_shard():
    from rocket_tpu_torch.analysis.shard_audit import BUILTIN_TARGETS, run_target

    def run(target, args):
        report = run_target(target)
        if report.record and getattr(args, "format", "text") == "text":
            record = report.record
            counts = ", ".join(f"{k} {v}" for k, v in sorted(record["collective_counts"].items()))
            print(f"{target.name}: {counts or 'no collectives'}; "
                  f"{record['collective_bytes_per_step']:,} B a step; "
                  f"{record['hbm_per_device_bytes']:,} B a device ({record['hbm']['method']})",
                  file=sys.stderr)
        return report

    return BUILTIN_TARGETS, run


def _load_mem():
    from rocket_tpu_torch.analysis.mem_audit import MEM_TARGETS, render_mem, run_mem_target

    def run(target, args):
        report = run_mem_target(target, getattr(args, "device_kind", None))
        if report.record and getattr(args, "format", "text") == "text":
            print(render_mem(target.name, report.record), file=sys.stderr)
        return report

    return MEM_TARGETS, run


def _load_prec():
    from rocket_tpu_torch.analysis.prec_audit import PREC_TARGETS, render_prec, run_prec_target

    def run(target, args):
        report = run_prec_target(target)
        if report.record and getattr(args, "format", "text") == "text":
            print(render_prec(target.name, report.record), file=sys.stderr)
        return report

    return PREC_TARGETS, run


def _load_repro():
    from rocket_tpu_torch.analysis.repro_audit import (
        REPRO_TARGETS,
        render_repro,
        run_repro_target,
    )

    def run(target, args):
        report = run_repro_target(target)
        if report.record and getattr(args, "format", "text") == "text":
            print(render_repro(target.name, report.record), file=sys.stderr)
        return report

    return REPRO_TARGETS, run


#: The one audit-subcommand registry ``main`` dispatches on.
AUDIT_SUBCOMMANDS = {cli.name: cli for cli in (
    AuditCLI("sched", "roofline cost model of each target's step traced on meta tensors "
             "(predicted step time, its split, exposed communication, MFU: RKT501-503, "
             "RKT505) and the kernel-launch check (RKT504); RKT506 budgets",
             _load_sched, "SCHED_DIR", "SCHED_GATED_KEYS", "RKT506", "sched",
             lambda t: f"mesh={dict(t.mesh_shape)} {t.doc}"),
    AuditCLI("calib", "measured-vs-predicted calibration: capture a trace of the target's "
             "step, join it to the priced ops by (launching op, ordinal), reconcile "
             "(RKT702, RKT703); RKT701 budgets",
             _load_calib, "CALIB_DIR", "CALIB_GATED_KEYS", "RKT701", "calib",
             lambda t: f"device={t.device} priced_for={t.device_kind} {t.doc}"),
    AuditCLI("shard", "SPMD audit of each target's rule set and one rank's step traced on "
             "meta tensors: dead globs, spec ranks, divisibility, replicated params, "
             "collectives over the allowlist (RKT301-305); RKT306 budgets",
             _load_shard, "SHARD_DIR", "GATED_KEYS", "RKT306", "spmd",
             lambda t: f"mesh={dict(t.mesh_shape)} {t.doc}"),
    AuditCLI("mem", "memory audit of each target's step traced on meta tensors: the "
             "liveness peak and its split, the in-place update, the saved set, the OOM "
             "frontier per card (RKT801, RKT802, RKT804); RKT803 budgets",
             _load_mem, "MEM_DIR", "MEM_GATED_KEYS", "RKT803", "mem",
             lambda t: f"mesh={dict(t.mesh_shape)} {t.doc}"),
    AuditCLI("prec", "dtype-flow audit of each target's step traced on meta tensors: "
             "low-precision accumulation, sub-f32 transcendentals, narrowed state and "
             "collectives, cast churn, params never cast (RKT401-405); RKT406 budgets",
             _load_prec, "PREC_DIR", "PREC_GATED_KEYS", "RKT406", "prec",
             lambda t: t.doc),
    AuditCLI("repro", "determinism audit: key reuse and unfolded loop keys, order-free "
             "sums, resume identity through checkpoint_io, one decode-wave body for every "
             "k, the replay sentinel run twice on the CPU (RKT901-905); RKT906 budgets",
             _load_repro, "REPRO_DIR", "REPRO_GATED_KEYS", "RKT906", "repro",
             lambda t: f"kind={t.kind} {t.doc}"),
)}


def _device_present(target) -> bool:
    import torch

    device = getattr(target, "device", "cpu")
    return torch.device(device).type != "cuda" or torch.cuda.is_available()


def _sweep_targets(cli: AuditCLI, args, *, names=None, budgets_dir=None,
                   update_budgets: bool = False, tolerance=None) -> list:
    """The one per-target sweep of ``_audit_main`` and ``all``: demo targets
    only when named, and each non-demo record written (``update_budgets``)
    or diffed against the committed budget."""
    from rocket_tpu_torch.analysis import budgets as budgets_mod

    targets, run_target = cli.load()
    keys = getattr(budgets_mod, cli.gated_keys_attr)
    tolerance = budgets_mod.TOLERANCE if tolerance is None else tolerance
    if names is None:
        names = [name for name, t in targets.items() if not t.demo]
        absent = [name for name in names if not _device_present(targets[name])]
        if absent:
            print(f"{cli.name}: skipping {', '.join(absent)}: no CUDA device here (name a "
                  "target to require it)", file=sys.stderr)
        names = [name for name in names if name not in absent]
    findings = []
    for name in names:
        target = targets[name]
        report = run_target(target, args)
        findings.extend(report.findings)
        if target.demo or not budgets_dir or not report.record:
            continue
        if update_budgets:
            budgets_mod.write_budget(budgets_dir, name, report.record)
        else:
            findings.extend(budgets_mod.diff_budget(
                name, budgets_mod.load_budget(budgets_dir, name), report.record,
                tolerance=tolerance, keys=keys, rule=cli.budget_rule, family=cli.family))
    return findings


def _write_json_report(path: str, findings) -> None:
    """The findings as JSON at ``path``, written whole or not at all."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump([asdict(f) for f in findings], fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)


def _default_budgets(cli: AuditCLI):
    from rocket_tpu_torch.analysis import budgets as budgets_mod

    path = os.path.join(_REPO, getattr(budgets_mod, cli.budgets_dir_attr))
    return path if os.path.isdir(path) else None


def _audit_main(cli: AuditCLI, argv) -> int:
    """One flag set, one sweep, one budget loop for every audit."""
    from rocket_tpu_torch.analysis import budgets as budgets_mod

    targets, _run = cli.load()
    parser = argparse.ArgumentParser(prog=f"python -m rocket_tpu_torch.analysis {cli.name}",
                                     description=cli.description)
    parser.add_argument("--target", action="append", choices=sorted(targets),
                        help="audit only these targets (default: every non-demo target)")
    parser.add_argument("--list-targets", action="store_true",
                        help="print the target catalog and exit")
    parser.add_argument("--budgets-dir", "--budgets", dest="budgets", default=None,
                        metavar="DIR", help="budget directory to diff against (default: the "
                        "checkout's " + getattr(budgets_mod, cli.budgets_dir_attr) + "/)")
    parser.add_argument("--no-budgets", action="store_true", help="findings only, no budget gate")
    parser.add_argument("--update-budgets", action="store_true",
                        help="rewrite the budget files from this run instead of diffing")
    parser.add_argument("--tolerance", type=float, default=budgets_mod.TOLERANCE,
                        help="allowed relative growth before a budget diff fails")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--json-report", default=None, metavar="PATH",
                        help="also write the findings as JSON to PATH")
    if cli.name in ("sched", "mem"):
        from rocket_tpu_torch.analysis.sched_audit import DEFAULT_DEVICE_KIND

        parser.add_argument("--device-kind", default=DEFAULT_DEVICE_KIND,
                            help=f"the card to price against (default: {DEFAULT_DEVICE_KIND})")
    elif cli.name == "calib":
        parser.add_argument("--device", default=None,
                            help="measure on this device (default: the target's own)")
        parser.add_argument("--trace-root", default=None,
                            help="where the captures land (default: runs/prof)")
    args = parser.parse_args(argv)

    if args.list_targets:
        for name, target in targets.items():
            tag = "  [demo]" if target.demo else ""
            print(f"{name:18s} {cli.list_line(target)}{tag}")
        return 0
    budgets_dir = None if args.no_budgets else (args.budgets or _default_budgets(cli))
    if args.update_budgets and not budgets_dir:
        parser.error("--update-budgets needs a budget directory")
    try:
        findings = _sweep_targets(cli, args, names=args.target, budgets_dir=budgets_dir,
                                  update_budgets=args.update_budgets, tolerance=args.tolerance)
    except (ValueError, RuntimeError) as err:  # an unknown card, a card that is absent
        parser.error(str(err))
    if args.json_report:
        _write_json_report(args.json_report, findings)
    emit_findings(findings, fmt=args.format)
    return 1 if findings else 0


def _all_main(argv) -> int:
    """``all``: the lint over the given paths and every ported audit family
    in one process, one merged findings list."""
    from rocket_tpu_torch.analysis import budgets as budgets_mod

    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.analysis all",
        description="the lint plus every ported audit family (" + ", ".join(AUDIT_SUBCOMMANDS)
                    + "); the reference's others are ROADMAP Queue A 9")
    parser.add_argument("paths", nargs="*", help="paths to lint (default: rocket_tpu_torch)")
    parser.add_argument("--budgets-dir", "--budgets", dest="budgets", default=None,
                        metavar="ROOT", help="budgets root (default: the checkout's "
                        "tests/fixtures/torch_budgets): each family diffs its subdirectory")
    parser.add_argument("--no-budgets", action="store_true")
    parser.add_argument("--tolerance", type=float, default=budgets_mod.TOLERANCE)
    parser.add_argument("--calib-tolerance", type=float, default=0.5,
                        help="the calib family's tolerance (measured timings are noisy)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--json-report", default=None, metavar="PATH")
    args = parser.parse_args(argv)

    findings = list(lint_paths(args.paths or [os.path.join(_REPO, "rocket_tpu_torch")]))
    for cli in AUDIT_SUBCOMMANDS.values():
        family_dir = None
        if not args.no_budgets:
            root = args.budgets or os.path.join(_REPO, budgets_mod.DEFAULT_DIR)
            family_dir = os.path.join(root, os.path.basename(
                getattr(budgets_mod, cli.budgets_dir_attr)))
            family_dir = family_dir if os.path.isdir(family_dir) else None
        findings.extend(_sweep_targets(
            cli, args, budgets_dir=family_dir,
            tolerance=args.calib_tolerance if cli.name == "calib" else args.tolerance))
    if args.json_report:
        _write_json_report(args.json_report, findings)
    emit_findings(findings, fmt=args.format)
    return 1 if findings else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in AUDIT_SUBCOMMANDS:
        return _audit_main(AUDIT_SUBCOMMANDS[argv[0]], argv[1:])
    if argv and argv[0] == "all":
        return _all_main(argv[1:])
    if argv and argv[0] in UNPORTED:
        print(f"python -m rocket_tpu_torch.analysis: the {argv[0]!r} audit is not ported yet "
              "(ROADMAP Queue A 9); ported: " + ", ".join(AUDIT_SUBCOMMANDS) + ", all",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.analysis",
        description="rocketlint for the PyTorch port (see also the "
                    + ", ".join(f"`{name}`" for name in AUDIT_SUBCOMMANDS) + " and `all` "
                    "subcommands)",
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
        parser.error("no paths given (or --list-rules, or a subcommand: "
                     + ", ".join(AUDIT_SUBCOMMANDS) + ", all)")
    try:
        findings = lint_paths(args.paths, select=_ids(args.select) if args.select else None,
                              ignore=_ids(args.ignore))
    except FileNotFoundError as err:
        parser.error(str(err))
    emit_findings(findings, fmt=args.format)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
