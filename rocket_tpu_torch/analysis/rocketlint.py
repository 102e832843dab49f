"""The port's source lint (counterpart of ``rocket_tpu/analysis/rocketlint.py``).

It reads Python source, never runs it, and looks for what costs the port
on the card without showing in a test: a host sync in a loop or in a
capsule's per-iteration ``launch`` (each one stalls the eager host loop
until the card drains, the idle share PERF.md measures), capsule
lifecycle overrides that break the dispatch or checkpoint contract, and
``fork`` after CUDA or torch is up.

:class:`FileContext` parses a file once and keeps what the rules ask of
it: each node's parent, the nearest enclosing loop of a node, and the
classes that derive from a capsule base of ``rocket_tpu_torch/core``
(directly, or through classes of the same file). The rules live in
:mod:`rocket_tpu_torch.analysis.rules`; :mod:`.findings` holds the
``Finding`` type and the inline suppressions every lint result honours.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, Optional, Sequence

from rocket_tpu_torch.analysis.findings import Finding, parse_suppressions

__all__ = ["CAPSULE_BASES", "LIFECYCLE_HOOKS", "FileContext", "dotted_name", "lint_source",
           "lint_file", "lint_paths", "python_files"]

#: The capsule classes of ``rocket_tpu_torch/core``: a class that derives
#: from one carries the five-event lifecycle contract.
CAPSULE_BASES = frozenset({
    "Capsule", "Checkpointer", "Dataset", "Dispatcher", "Launcher", "Looper", "Loss", "Meter",
    "Metric", "Module", "Optimizer", "Profiler", "Scheduler", "Tracker",
})

#: The handler names ``Capsule.dispatch`` calls (``core/capsule.Events``).
LIFECYCLE_HOOKS = frozenset({"setup", "set", "launch", "reset", "destroy"})

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for the expression naming it, None for
    anything that is not a chain of attributes on a name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class FileContext:
    """One parsed source file and the facts the rules share."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.suppressions = parse_suppressions(source)
        self.parent = {child: node for node in ast.walk(self.tree)
                       for child in ast.iter_child_nodes(node)}
        classes = {node.name: node for node in ast.walk(self.tree)
                   if isinstance(node, ast.ClassDef)}
        self.capsule_classes = [cls for cls in classes.values()
                                if self._derives_from_capsule(cls, classes, set())]

    @staticmethod
    def _derives_from_capsule(cls: ast.ClassDef, classes: dict, seen: set) -> bool:
        for base in cls.bases:
            name = dotted_name(base)
            if name is None:
                continue
            last = name.split(".")[-1]
            if last in CAPSULE_BASES:
                return True
            local = classes.get(last)
            if local is not None and last not in seen and FileContext._derives_from_capsule(
                    local, classes, seen | {last}):
                return True
        return False

    def calls(self, root: Optional[ast.AST] = None) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree if root is None else root):
            if isinstance(node, ast.Call):
                yield node

    def loop_of(self, node: ast.AST) -> Optional[ast.AST]:
        """The innermost ``for``/``while`` whose iterations run ``node``, in
        its own function (a loop outside the enclosing ``def`` does not
        count), or None. A ``for``'s iterable and a loop's ``else`` run
        once, so they are not inside it; a ``while`` test runs each time."""
        child, up = node, self.parent.get(node)
        while up is not None and not isinstance(up, _SCOPES):
            if isinstance(up, _LOOPS) and (child in up.body or child is getattr(up, "test", None)):
                return up
            child, up = up, self.parent.get(up)
        return None

    def methods(self, cls: ast.ClassDef, names) -> Iterator[ast.FunctionDef]:
        """The methods of ``cls`` (its own body) named in ``names``."""
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name in names:
                yield node


def lint_source(path: str, source: str, select: Optional[Sequence[str]] = None,
                ignore: Sequence[str] = ()) -> list:
    """Every finding of the selected rules in ``source`` that no directive
    silences, ordered by line; a file that does not parse is one RKT100."""
    from rocket_tpu_torch.analysis.rules import AST_RULES

    try:
        ctx = FileContext(path, source)
    except SyntaxError as err:
        return [Finding("RKT100", path, err.lineno or 0, f"syntax error: {err.msg}")]
    found = [finding for rule in AST_RULES
             if (select is None or rule.rule_id in select) and rule.rule_id not in ignore
             for finding in rule.check(ctx)]
    return sorted((f for f in found if ctx.suppressions.allows(f)),
                  key=lambda f: (f.line, f.rule))


def lint_file(path: str, select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> list:
    with open(path, encoding="utf-8") as fh:
        return lint_source(path, fh.read(), select=select, ignore=ignore)


def python_files(paths: Sequence[str]) -> Iterator[str]:
    """The ``.py`` files under ``paths``, directories walked in sorted
    order (hidden ones and caches skipped). A path that does not exist
    raises: a typo must not pass as a clean tree."""
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if not d.startswith(".") and d != "__pycache__")
                yield from (os.path.join(root, f) for f in sorted(files) if f.endswith(".py"))
        else:
            raise FileNotFoundError(f"rocketlint: no such file or directory: {path!r}")


def lint_paths(paths: Sequence[str], select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = ()) -> list:
    return [finding for file in python_files(paths)
            for finding in lint_file(file, select=select, ignore=ignore)]
