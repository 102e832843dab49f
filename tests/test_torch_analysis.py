"""The port's lint (``rocket_tpu_torch/analysis``: RKT103-RKT107 in torch's
forms) against the JAX package's rocketlint.

* Both lints over the reference's fixtures
  (``tests/fixtures/analysis/{bad,good}_*.py`` of the five rules and
  ``suppressed.py``) give the same (rule, line) pairs wherever the
  reference's form applies to torch: every capsule and fork fixture, and
  ``float()`` / ``np.asarray()`` in a launch. ``jax.device_get`` and
  ``block_until_ready`` are not torch's syncs, so the port reads
  ``bad_sync_in_loop.py`` as clean, and its torch translation (the same
  lines, torch's calls) gives the reference's pairs.
* Torch's own forms as inline sources: each sync call, the loop parts that
  run once, nested functions, the port's capsule bases, suppressions.
* The self-gate: ``rocket_tpu_torch/`` is lint-clean, and the CLI's exit
  codes are the reference's (0 clean, 1 findings, 2 usage).
"""

import inspect
from pathlib import Path

import pytest

from rocket_tpu.analysis.rocketlint import lint_file as ref_lint_file
from rocket_tpu_torch import core
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis.rocketlint import CAPSULE_BASES, lint_file, lint_source
from rocket_tpu_torch.core.capsule import Capsule

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
PORTED = ("RKT103", "RKT104", "RKT105", "RKT106", "RKT107")
#: fixture -> whether the reference's forms in it apply to torch.
FIXTURE_FILES = {
    f"{kind}_{name}.py": name != "sync_in_loop"
    for kind in ("bad", "good")
    for name in ("sync_in_loop", "capsule_super", "handler_signature", "launch_host_sync",
                 "fork_start_method")
} | {"suppressed.py": True}


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings if f.rule in PORTED)


@pytest.mark.parametrize("name", sorted(FIXTURE_FILES))
def test_lint_matches_the_reference_on_its_fixtures(name):
    path = str(FIXTURES / name)
    ref = _pairs(ref_lint_file(path))
    port = _pairs(lint_file(path))
    if FIXTURE_FILES[name]:
        assert port == ref
    else:
        assert port == [] and (ref != []) == name.startswith("bad_")
    assert (port != []) == (name.startswith("bad_") and FIXTURE_FILES[name])


def test_sync_in_loop_fixture_in_torch_forms_gives_the_reference_lines():
    source = (FIXTURES / "bad_sync_in_loop.py").read_text()
    torch_source = (source.replace("import jax", "import torch")
                    .replace("jax.device_get(loss)", "loss.item()")
                    .replace("jax.block_until_ready(state)", "torch.cuda.synchronize()"))
    assert torch_source.count("\n") == source.count("\n")
    ref = _pairs(ref_lint_file(str(FIXTURES / "bad_sync_in_loop.py")))
    assert ref == [("RKT103", 9), ("RKT103", 10)]
    assert _pairs(lint_source("bad_sync_in_loop_torch.py", torch_source)) == ref


TORCH_LOOPS = '''
import torch


def drive(step, state, batches, stream, events):
    for batch in batches:
        loss = step(state, batch)
        a = loss.item()
        b = loss.tolist()
        c = loss.cpu()
        d = loss.detach().numpy()
        e = loss.to("cpu")
        f = loss.to(device="cpu")
        torch.cuda.synchronize()
        stream.synchronize()
        g = loss.to("cuda")
    for size in batches.tolist():
        pass
    while state.any().item():
        def later(t):
            return t.item()
    else:
        done = state.item()
    return [x.item() for x in batches]
'''


def test_sync_in_loop_torch_forms():
    lines = [line for rule, line in _pairs(lint_source("loops.py", TORCH_LOOPS))]
    # Lines 8-15: each sync form in the loop body; line 19: a while test
    # runs every iteration. Not: the .to("cuda") (16), the for iterable
    # (17), a nested def (21), the loop's else (23), a comprehension (24).
    assert lines == [8, 9, 10, 11, 12, 13, 14, 15, 19]


TORCH_CAPSULES = '''
import multiprocessing as mp
import numpy as np
import torch
from torch import multiprocessing as tmp
from rocket_tpu_torch.core.meter import Metric
from rocket_tpu_torch.core.loop import Looper


class Accuracy(Metric):
    def launch(self, attrs=None):
        self.total = self.total + attrs.batch["correct"].sum()
        self.seen = float(attrs.batch["n"])
        self.host = attrs.batch["correct"].cpu()
        torch.cuda.synchronize()
        self.count = float(1)

    def setup(self, attrs=None):
        Metric.setup(self, attrs)


class Inner(Accuracy):
    def destroy(self, attrs=None):
        self.total = None

    def reset(self, attrs, extra, *, strict):
        pass


class MyLooper(Looper):
    def set(self, *args):
        super().set(*args)


def pool():
    return tmp.get_context("fork"), mp.get_context("spawn"), np.asarray([1, 2])
'''


def test_capsule_and_fork_rules_torch_forms():
    # Inner.destroy skips the base (23); Inner.reset has a second required
    # parameter and a keyword-only one without default (26); Accuracy.launch
    # syncs through float(), .cpu() and synchronize() (13-15), not through a
    # constant float() (16); a fork context (36). Metric.setup calls its
    # base explicitly; MyLooper.set takes attrs through *args.
    assert _pairs(lint_source("capsules.py", TORCH_CAPSULES)) == [
        ("RKT104", 23), ("RKT105", 26), ("RKT106", 13), ("RKT106", 14), ("RKT106", 15),
        ("RKT107", 36)]


def test_suppressions_by_line_and_by_file():
    source = TORCH_LOOPS.replace("a = loss.item()",
                                 "a = loss.item()  # rocketlint: disable=RKT103")
    lines = [line for _, line in _pairs(lint_source("s.py", source))]
    assert 8 not in lines and 9 in lines
    assert lint_source("s.py", "# rocketlint: disable-file=RKT103\n" + TORCH_LOOPS) == []
    assert lint_source("s.py", TORCH_LOOPS.replace(
        "b = loss.tolist()", "b = loss.tolist()  # rocketlint: disable=all")) != []
    assert lint_source("bad.py", "def f(:\n")[0].rule == "RKT100"


def test_capsule_bases_are_the_ports_capsule_classes():
    classes = {name for name, obj in inspect.getmembers(core, inspect.isclass)
               if issubclass(obj, Capsule)}
    assert classes <= CAPSULE_BASES
    for module in ("meter", "loop", "checkpoint", "profiler", "tracker", "scheduler"):
        mod = __import__(f"rocket_tpu_torch.core.{module}", fromlist=["_"])
        classes |= {name for name, obj in inspect.getmembers(mod, inspect.isclass)
                    if issubclass(obj, Capsule) and obj.__module__ == mod.__name__}
    assert classes == CAPSULE_BASES


def test_the_port_is_lint_clean():
    assert cli.main([str(ROOT / "rocket_tpu_torch")]) == 0


def test_cli_exit_codes(capsys, tmp_path):
    assert cli.main([str(FIXTURES / "bad_capsule_super.py")]) == 1
    assert cli.main([str(FIXTURES / "good_capsule_super.py")]) == 0
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in PORTED + ("RKT504",))
    assert cli.main(["--select", "RKT107", str(FIXTURES / "bad_capsule_super.py")]) == 0
    assert cli.main(["--ignore", "RKT104", str(FIXTURES / "bad_capsule_super.py")]) == 0
    for argv in ([], [str(tmp_path / "missing.py")]):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(argv)
        assert exit_info.value.code == 2
