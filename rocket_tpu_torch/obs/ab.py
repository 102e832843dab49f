"""Time several checkouts of this repository with one yardstick: an A/B of
two commits' kernels on one card.

    python -m rocket_tpu_torch.obs.ab [--phase NAME] ROOT [ROOT ...]

Each ROOT is a checkout: ``.``, or another commit's ``git archive``
unpacked in a directory that ``.gitignore`` lists. They run one after
another in the order given (give ``A B B A`` to see how far the card
drifts between them), each in its own process with its own
``rocket_tpu_torch`` and its own kernel builds. In each, the checkout's
``chip_smoke.py`` is loaded with this checkout's ``Timer`` in place of its
own, so commits whose ``Timer`` differs are timed with one. With
``--phase``, only that phase function of it runs, called as ``phase(Timer(),
torch.Generator().manual_seed(0))`` with TF32 off, and its result is
printed as one JSON line ``{"root": ..., "phase": ..., "result": ...}``
(a tuple key of the result joined by spaces);
without, its whole ``main`` runs. Needs a card; exits with the first
nonzero exit code of its runs.
"""

from __future__ import annotations

import argparse
import ast
import subprocess
import sys
from pathlib import Path

#: The chip_smoke.py whose Timer every run takes.
SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

#: One run, in a process that imports nothing of this checkout: argv is
#: (root, phase or "", the Timer's source).
_RUN = """
import importlib.util, json, sys
import torch
root, phase, timer_source = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("chip_smoke", f"{root}/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = smoke
spec.loader.exec_module(smoke)
exec(timer_source, vars(smoke))
if not phase:
    sys.exit(smoke.main())
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
result = getattr(smoke, phase)(smoke.Timer(), torch.Generator().manual_seed(0))


def keyed(v):  # JSON keys are strings: a phase may key its result by shape tuples
    if isinstance(v, dict):
        return {k if isinstance(k, str) else " ".join(map(str, k)) if isinstance(k, tuple)
                else str(k): keyed(x) for k, x in v.items()}
    return v


print(json.dumps({"root": root, "phase": phase, "result": keyed(result)}, default=str),
      flush=True)
"""


def timer_source(path: Path = SMOKE) -> str:
    """The source of the ``Timer`` class of the chip_smoke.py at ``path``."""
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef) and node.name == "Timer":
            return ast.get_source_segment(text, node)
    raise ValueError(f"{path}: no class Timer")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.obs.ab",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", default="",
                        help="a phase function of chip_smoke.py taking (timer, gen)")
    parser.add_argument("roots", nargs="+", help="checkouts, in the order they run")
    args = parser.parse_args(argv)
    source = timer_source()
    rc = 0
    for root in args.roots:
        root = str(Path(root).resolve())
        # cwd = root: `python -c` puts the working directory first on sys.path.
        proc = subprocess.run([sys.executable, "-c", _RUN, root, args.phase, source], cwd=root)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
