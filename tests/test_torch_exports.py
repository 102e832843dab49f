"""Every name the JAX package exports is exported by the port, module by
module, or is on the allow-list below with its ROADMAP label.

Both packages are read with ``ast`` only (no import, so no JAX): each
module's literal ``__all__`` in ``rocket_tpu/`` is held against the
``__all__`` of the module at the same path in ``rocket_tpu_torch/`` (the
port keeps ``runtime/context.py``'s names in ``runtime/__init__.py``). The
allow-list holds two kinds of entry only: what ROADMAP queues for a later
slice (Queue A6, A9), and what exists only for JAX.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE, PORT = ROOT / "rocket_tpu", ROOT / "rocket_tpu_torch"

#: Reference module -> the port module that carries its names.
MODULE_MAP = {"runtime/context.py": "runtime/__init__.py"}

_A6 = "ROADMAP Queue A 6 (multi-device parallelism: the sharded seams)"
_A9 = "ROADMAP Queue A 9 (the remaining legs of the analysis)"
_JAX = "JAX-only (ROADMAP Queue A: not queued, by design)"

#: (reference module, name) -> label; name "*" covers the whole module.
ALLOWED = {
    # Marks a value device-varying for shard_map's vma typing; the port's
    # ranks hold plain local tensors, so there is nothing to mark.
    ("parallel/collectives.py", "pvary_compat"): _JAX,
    ("parallel/grad_sync.py", "*"): _A6, ("parallel/sharding.py", "*"): _A6,
    ("analysis/*", "*"): _A9,
    ("data/device_cache.py", "materialize_marker"): _JAX,
    ("tune/space.py", "sublane_min"): _JAX,
    ("serve/engine.py", "DECODE_DONATE"): _JAX, ("serve/engine.py", "PREFILL_DONATE"): _JAX,
    ("serve/engine.py", "abstract_wave_inputs"): _JAX,
    ("utils/compat.py", "*"): _JAX, ("utils/pytree.py", "*"): _JAX,
}


def _exports(root: Path) -> dict:
    """{relative module path: set of names in its literal ``__all__``}."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text(encoding="utf-8")).body:
            targets = getattr(node, "targets", None) or [getattr(node, "target", None)]
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                out[path.relative_to(root).as_posix()] = set(ast.literal_eval(node.value))
    return out


def _allowed(module: str, name: str):
    for key in ((module, name), (module, "*")):
        if key in ALLOWED:
            return ALLOWED[key]
    if module.startswith("analysis/"):
        return ALLOWED[("analysis/*", "*")]
    return None


def _missing() -> list:
    reference, port = _exports(REFERENCE), _exports(PORT)
    gaps = []
    for module, names in sorted(reference.items()):
        have = port.get(MODULE_MAP.get(module, module), set())
        gaps += [(module, name) for name in sorted(names - have) if not _allowed(module, name)]
    return gaps


def test_every_reference_export_is_ported_or_queued():
    assert _missing() == []


def test_the_allow_list_names_only_queued_or_jax_only_entries():
    for key, label in ALLOWED.items():
        assert label in (_A6, _A9, _JAX), key
        assert label.startswith(("ROADMAP Queue A", "JAX-only (ROADMAP")), key


def test_the_allow_list_holds_nothing_the_port_has():
    """An entry whose name the port now exports is stale: drop it."""
    reference, port = _exports(REFERENCE), _exports(PORT)
    for (module, name), _ in ALLOWED.items():
        if name == "*" or "*" in module:
            continue
        assert name in reference.get(module, set()), (module, name)
        assert name not in port.get(MODULE_MAP.get(module, module), set()), (module, name)


@pytest.mark.parametrize("module", ["nn/__init__.py", "__init__.py", "nn/module.py",
                                    "ops/paged_attention.py", "obs/__init__.py",
                                    "utils/probe.py", "runtime/context.py",
                                    "resilience/__init__.py", "resilience/faults.py",
                                    "resilience/supervisor.py", "launch.py", "obs/export.py",
                                    "obs/slo.py", "obs/reqtrace.py", "obs/prof.py",
                                    "serve/api.py", "serve/__init__.py", "serve/scheduler.py",
                                    "parallel/collectives.py", "ops/ring.py",
                                    "parallel/__init__.py", "parallel/pipeline.py",
                                    "parallel/ring_attention.py", "ops/flash_attention.py",
                                    "ops/flash_native.py"])
def test_the_repaired_modules_export_every_reference_name(module):
    """The Queue C 1 repairs and this slice's modules, each in full."""
    reference, port = _exports(REFERENCE), _exports(PORT)
    have = port.get(MODULE_MAP.get(module, module), set())
    gaps = {n for n in reference[module] - have if not _allowed(module, n)}
    assert gaps == set()


def test_the_repaired_names_import():
    import rocket_tpu_torch as rt
    from rocket_tpu_torch.nn import Dense, Variables  # noqa: F401
    from rocket_tpu_torch.ops.paged_attention import paged_decode_supported

    assert rt.Attributes and rt.Dispatcher and rt.Events and rt.obs.Telemetry
    assert paged_decode_supported(16, 64) and not paged_decode_supported(16, 12)
