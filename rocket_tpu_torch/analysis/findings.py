"""Results of the port's checks, and the comments that waive them
(counterpart of ``rocket_tpu/analysis/findings.py``).

Both the lint and the schedule audit return :class:`Finding` records:
the id of the rule that fired, a location (a source path, or
``<sched:TARGET>`` for the audit) with a 1-based line or 0, and a message.
:func:`emit_findings` is the one printer both CLIs use.

A waiver is a comment, spelled as in the reference:

    x = t.item()  # rocketlint: disable=RKT103   (this line, these ids)
    # rocketlint: disable-file=RKT106            (the whole file)

Ids are separated by commas or spaces; ``all`` waives every rule. Each
waiver is a reviewed decision and carries its reason beside it; the port's
self-gate keeps ``rocket_tpu_torch/`` free of unwaived findings.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
from collections import defaultdict

__all__ = ["Finding", "Suppressions", "emit_findings", "parse_suppressions"]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def emit_findings(findings, fmt: str = "text") -> None:
    """Write ``findings`` to stdout, rendered one per line or, with ``fmt``
    ``"json"``, as one list of objects with the four fields. Text mode adds
    a count on stderr, so that stdout carries the findings alone."""
    records = list(findings)
    if fmt == "json":
        print(json.dumps([dataclasses.asdict(r) for r in records], indent=2))
        return
    if records:
        print("\n".join(r.render() for r in records))
        print(f"\n{len(records)} finding(s).", file=sys.stderr)


_WAIVER = re.compile(
    r"#\s*rocketlint:\s*(?P<scope>disable-file|disable)\s*=\s*(?P<ids>[\w,\s-]+)")


class Suppressions:
    """The waivers of one source file."""

    def __init__(self) -> None:
        self.per_line: dict = defaultdict(set)
        self.everywhere: set = set()

    def allows(self, finding: Finding) -> bool:
        """Whether ``finding`` survives the file's waivers."""
        waived = self.everywhere | self.per_line.get(finding.line, set())
        return not waived & {finding.rule, "all"}


def parse_suppressions(source: str) -> Suppressions:
    waivers = Suppressions()
    for lineno, text in enumerate(source.splitlines(), 1):
        found = _WAIVER.search(text)
        if found is None:
            continue
        ids = {token for token in re.split(r"[,\s]+", found["ids"]) if token}
        target = waivers.everywhere if found["scope"] == "disable-file" else \
            waivers.per_line[lineno]
        target.update(ids)
    return waivers
