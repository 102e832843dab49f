"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own for ``sm_90a`` into
``build/kernels/<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the sources and flags, so an edited kernel never loads
a stale library. Nothing builds at import time: :func:`load` builds on a
kernel's first launch and :func:`build` builds several at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["KERNELS", "BUILD_DIR", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: Kernel name -> its source under ``csrc/``.
KERNELS = {
    "paged_decode": "paged_decode.cu",
    "decode_attention": "decode_attention.cu",
}

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("kernel build: nvcc not found (needs the CUDA toolkit)")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.name == KERNELS[name]:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Build the named kernels (default: all) that are not built yet, in
    parallel. Returns ``{name: {"path", "seconds", "ptxas"}}``; ``seconds``
    is 0 and ``ptxas`` empty for a library that was already built. Raises
    with the compiler's output when a build fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result, procs = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            result[name] = {"path": str(target), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, target,
        )
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
        result[name] = {
            "path": str(target), "seconds": time.perf_counter() - t0, "ptxas": out,
        }
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name]["path"])
        _LIBS[name] = lib
    return lib
