"""Host-side rules over all code: a host sync inside a loop (RKT103) and a
``fork`` start method (RKT107). Counterpart of
``rocket_tpu/analysis/rules/host_rules.py``, for torch's forms.

PyTorch on the card is asynchronous: a call enqueues kernels and returns.
These calls instead wait until the card has run everything queued before
them, and copy to the host: ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()`` and a stream's or
event's ``.synchronize()``. In a loop each iteration then waits for the
card, and the card waits for the next iteration's launches: the idle share
PERF.md measures behind the port's eager host loops. The lint cannot see a
tensor's device, so it flags the form wherever it appears; a deliberate
sync says so with ``# rocketlint: disable=RKT103`` and its reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from rocket_tpu_torch.analysis.findings import Finding
from rocket_tpu_torch.analysis.rocketlint import dotted_name

__all__ = ["SyncInLoopRule", "ForkStartMethodRule", "sync_form"]

#: Tensor methods that copy to the host, and so wait for the card.
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
#: Functions that wait for the card.
SYNC_CALLS = frozenset({"torch.cuda.synchronize"})


def _to_cpu(call: ast.Call) -> bool:
    args = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)


def sync_form(call: ast.Call) -> Optional[str]:
    """How ``call`` syncs with the card (``".item()"``, ``"torch.cuda.
    synchronize()"``, ...), or None when it is none of the forms above."""
    name = dotted_name(call.func)
    if name in SYNC_CALLS:
        return f"{name}()"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in SYNC_METHODS:
            return f".{attr}()"
        if attr == "to" and _to_cpu(call):
            return '.to("cpu")'
    return None


class SyncInLoopRule:
    rule_id = "RKT103"
    slug = "sync-in-loop"
    contract = (
        "a host sync (.item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
        "torch.cuda.synchronize()) inside a for/while loop: every iteration "
        "waits for the card to drain, and the card idles until the next "
        "iteration's launches"
    )

    def check(self, ctx) -> Iterable[Finding]:
        for call in ctx.calls():
            form = sync_form(call)
            if form is None or ctx.loop_of(call) is None:
                continue
            yield Finding(self.rule_id, ctx.path, call.lineno,
                          f"{form} inside a loop waits for the card every iteration; keep the "
                          "values on the device and read them once after the loop")


class ForkStartMethodRule:
    rule_id = "RKT107"
    slug = "fork-start-method"
    contract = (
        "os.fork or a 'fork' multiprocessing start method in a process that "
        "may have initialised CUDA or torch's thread pools: a forked child "
        "cannot use CUDA and may deadlock on a lock held by a parent thread"
    )

    def check(self, ctx) -> Iterable[Finding]:
        for call in ctx.calls():
            name = dotted_name(call.func) or ""
            if name in ("os.fork", "os.forkpty"):
                yield Finding(self.rule_id, ctx.path, call.lineno,
                              f"{name}() after CUDA or torch is initialised gives a child that "
                              "cannot use the card and may deadlock; start processes with "
                              "'spawn'")
            elif name.split(".")[-1] in ("get_context", "set_start_method") and any(
                    isinstance(a, ast.Constant) and a.value == "fork" for a in call.args):
                yield Finding(self.rule_id, ctx.path, call.lineno,
                              "start method 'fork' copies a parent whose CUDA context and "
                              "thread locks do not survive the fork; use 'spawn' "
                              "(multiprocessing.get_context('spawn'))")
