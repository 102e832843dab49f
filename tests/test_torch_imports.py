"""Guards of the port's boundary: ``rocket_tpu_torch`` and ``chip_smoke.py``
never import JAX or the JAX package, importing the port leaves ``jax``
out of ``sys.modules``, and entry points refuse to fall back to the CPU
silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rocket_tpu_torch.runtime import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "rocket_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "rocket_tpu", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    mods = ["rocket_tpu_torch." + m for m in (
        "serve", "serve.__main__", "models.transformer", "bridge", "data.text",
        "ops.paged_attention", "ops.decode_attention",
    )]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'rocket_tpu'))\n"
        + "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_resolve_device_never_falls_back_silently():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
