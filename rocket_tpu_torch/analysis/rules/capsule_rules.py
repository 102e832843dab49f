"""Rules over capsule classes, the five-event lifecycle contract of
``rocket_tpu_torch/core/capsule.py`` (counterpart of
``rocket_tpu/analysis/rules/capsule_rules.py``).

``Capsule.setup`` and ``destroy`` keep the runtime's checkpoint stack,
pushed and popped in order: an override that skips the base call drops the
capsule from checkpoints or unbalances the stack for every capsule after
it (RKT104). ``dispatch`` calls each handler as ``handler(attrs)``, so a
handler that cannot take exactly that fails with a TypeError only when the
event fires, mid-run (RKT105). ``launch`` runs every iteration: a host sync
there stalls the loop every step (RKT106).
"""

from __future__ import annotations

import ast
from typing import Iterable

from rocket_tpu_torch.analysis.findings import Finding
from rocket_tpu_torch.analysis.rocketlint import LIFECYCLE_HOOKS, dotted_name
from rocket_tpu_torch.analysis.rules.host_rules import sync_form

__all__ = ["CapsuleSuperRule", "HandlerSignatureRule", "LaunchHostSyncRule"]


def _chains_to_base(method: ast.FunctionDef) -> bool:
    """Whether ``method`` calls its base's hook of the same name:
    ``super().<hook>(...)``, or ``Base.<hook>(self, ...)``."""
    for node in ast.walk(method):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == method.name):
            continue
        owner = node.func.value
        if isinstance(owner, ast.Call) and dotted_name(owner.func) == "super":
            return True
        if (isinstance(owner, ast.Name) and node.args and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "self"):
            return True
    return False


class CapsuleSuperRule:
    rule_id = "RKT104"
    slug = "capsule-super"
    contract = (
        "a capsule overrides setup/destroy without calling the base hook: it "
        "drops out of the runtime's checkpoint stack, or unbalances the stack "
        "for every capsule destroyed after it"
    )

    def check(self, ctx) -> Iterable[Finding]:
        for cls in ctx.capsule_classes:
            for method in ctx.methods(cls, ("setup", "destroy")):
                if not _chains_to_base(method):
                    yield Finding(self.rule_id, ctx.path, method.lineno,
                                  f"{cls.name}.{method.name} never calls super()."
                                  f"{method.name}(attrs): the base keeps the runtime's "
                                  "checkpoint stack")


def _dispatchable(args: ast.arguments) -> bool:
    """Whether a method with these parameters can be called as
    ``handler(attrs)``: ``self`` first, at most one more required
    positional, a place for ``attrs`` (a second positional or ``*args``),
    and a default for every keyword-only parameter."""
    positional = [a.arg for a in args.posonlyargs + args.args]
    if not positional or positional[0] != "self":
        return False
    if len(positional) - len(args.defaults) > 2:
        return False
    if len(positional) < 2 and args.vararg is None:
        return False
    return all(default is not None for default in args.kw_defaults)


class HandlerSignatureRule:
    rule_id = "RKT105"
    slug = "handler-signature"
    contract = (
        "a lifecycle handler (setup/set/launch/reset/destroy) cannot be "
        "called as handler(attrs), which is how dispatch() calls it: a "
        "TypeError when the event fires, mid-run"
    )

    def check(self, ctx) -> Iterable[Finding]:
        for cls in ctx.capsule_classes:
            for method in ctx.methods(cls, LIFECYCLE_HOOKS):
                if any(dotted_name(d) == "staticmethod" for d in method.decorator_list):
                    continue
                if _dispatchable(method.args):
                    continue
                params = [a.arg for a in method.args.posonlyargs + method.args.args]
                if method.args.vararg:
                    params.append("*" + method.args.vararg.arg)
                if method.args.kwarg:
                    params.append("**" + method.args.kwarg.arg)
                yield Finding(self.rule_id, ctx.path, method.lineno,
                              f"{cls.name}.{method.name}({', '.join(params)}) cannot take "
                              "dispatch()'s one positional argument, attrs")


#: Calls in ``launch`` that make host values of device ones, beside the
#: sync forms of RKT103: the builtin ``float()`` of a tensor, and numpy's
#: conversions.
_HOST_VALUE_CALLS = frozenset({"np.asarray", "np.array", "numpy.asarray", "numpy.array"})


class LaunchHostSyncRule:
    rule_id = "RKT106"
    slug = "launch-host-sync"
    contract = (
        "a capsule's launch() syncs with the card (float()/.item()/.tolist()/"
        ".cpu()/.numpy()/np.asarray()/torch.cuda.synchronize()): launch runs "
        "every iteration, so the loop waits for the card every step"
    )

    def check(self, ctx) -> Iterable[Finding]:
        for cls in ctx.capsule_classes:
            for method in ctx.methods(cls, ("launch",)):
                for call in ctx.calls(method):
                    name = dotted_name(call.func)
                    form = sync_form(call)
                    if form is None and name in _HOST_VALUE_CALLS:
                        form = f"{name}()"
                    if (form is None and name == "float" and call.args
                            and not isinstance(call.args[0], ast.Constant)):
                        form = "float()"
                    if form is not None:
                        yield Finding(self.rule_id, ctx.path, call.lineno,
                                      f"{form} in {cls.name}.launch waits for the card every "
                                      "iteration; accumulate on the device and read at an "
                                      "epoch or flush boundary")
