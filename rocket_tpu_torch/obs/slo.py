"""Declarative SLOs with burn-rate gates over the live metrics registry
(counterpart of ``rocket_tpu/obs/slo.py``).

An SLO binds one registry metric to an objective and a burn-rate
threshold, evaluated by the :class:`~rocket_tpu_torch.obs.export.
TelemetryExporter` at every tick (a violation becomes ``obs/slo/*``
gauges, a flight-recorder anomaly and exit 1 of ``python -m
rocket_tpu_torch.obs watch --slo``). Spec grammar (``{"version": 1,
"slos": [...]}``), per entry:

* ``name``: the ``obs/slo/<name>/*`` gauge family;
* ``kind``: ``"quantile"`` (a histogram's q-th percentile at or under the
  objective), ``"gauge_max"`` (a gauge at or under it) or ``"gauge_min"``
  (at or above it, e.g. ``goodput_fraction >= 0.8``);
* ``metric``: the registry name (goodput fractions also resolve from the
  goodput report, so shards evaluate the same specs offline);
* ``objective``, or ``objective_from_budget`` (``{"dir", "target",
  "field", "scale", "slack"}``: ``field * scale * slack`` of the budget
  file ``<dir>/<target>.json``);
* ``quantile`` (default 0.99), ``window_s`` (default 300),
  ``burn_threshold`` (default 1.0), ``warmup_s`` (a grace from the first
  observation before a violation can fire, default 0: a just-started
  process's goodput is legitimately 0).

Burn rate, the SRE convention: for a quantile SLO the bad fraction over
the window's histogram bucket deltas divided by ``1 - q``; for a gauge the
violation ratio, ``value / objective`` for a ceiling and ``objective /
value`` for a floor (1.0 at the objective). A spec violates when
``burn_rate >= burn_threshold``.

``default:train`` and ``default:serve`` are the port's own specs
(``slo_specs/train.json``, ``slo_specs/serve.json``): the goodput floor of
the reference and a steps/s floor measured for GPT-2 124M on the H100;
ITL and TTFT p99 ceilings set from GPT-2 124M's serve run on the H100
with slack for host drift, and the reference's queue-depth bound of 64
(the reference derives its latency ceilings from a TPU roofline, which
does not apply to the card). Standard library only, host arithmetic over
registry snapshots.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
from typing import Optional

__all__ = [
    "SLOSpec",
    "SLOStatus",
    "SLOEvaluator",
    "default_slo_path",
    "load_slo_specs",
]

_KINDS = ("quantile", "gauge_max", "gauge_min")

#: Directory of the committed default spec files (serve.json, train.json).
_SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "slo_specs")


def default_slo_path(kind: str) -> str:
    """Path of a committed default spec file (``"serve"`` / ``"train"``)."""
    path = os.path.join(_SPEC_DIR, f"{kind}.json")
    if not os.path.exists(path):
        raise ValueError(
            f"no default SLO spec {kind!r} (have: "
            f"{sorted(os.path.splitext(f)[0] for f in os.listdir(_SPEC_DIR))})"
        )
    return path


@dataclasses.dataclass
class SLOSpec:
    name: str
    kind: str
    metric: str
    objective: float
    quantile: float = 0.99
    window_s: float = 300.0
    burn_threshold: float = 1.0
    #: Grace period from the first observation before a violation can
    #: fire — a just-started run's goodput_fraction is legitimately 0.0
    #: until the first wave completes, which must not page anyone.
    warmup_s: float = 0.0
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"SLO {self.name!r}: kind must be one of {_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.kind == "quantile" and not 0.0 < self.quantile < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: quantile must be in (0, 1), "
                f"got {self.quantile}"
            )
        if not (isinstance(self.objective, (int, float))
                and math.isfinite(self.objective)):
            raise ValueError(
                f"SLO {self.name!r}: objective must be a finite number, "
                f"got {self.objective!r}"
            )
        if self.kind == "gauge_min" and self.objective <= 0:
            raise ValueError(
                f"SLO {self.name!r}: a gauge_min objective must be > 0 "
                "(the burn ratio divides by it)"
            )


@dataclasses.dataclass
class SLOStatus:
    """One spec's verdict at one evaluation instant."""

    name: str
    kind: str
    metric: str
    objective: float
    #: The evaluated quantity: the windowed quantile estimate, or the
    #: gauge value. None when the metric has no data yet.
    value: Optional[float]
    burn_rate: float
    violated: bool
    #: True only on the healthy -> violated transition (the edge that
    #: increments the violation counter and notes the flight anomaly).
    newly_violated: bool = False
    #: Tail forensics, attached by the exporter on violation when a
    #: request tracer is wired: the offending window's slowest request
    #: ids per dimension (``{"ttft": [...], "itl_gap": [...]}``) —
    #: ``obs timeline --request <id>`` renders their waterfalls.
    exemplars: Optional[dict] = None


def _resolve_objective(entry: dict, base_dir: Optional[str]) -> float:
    if "objective" in entry:
        return float(entry["objective"])
    source = entry.get("objective_from_budget")
    if not isinstance(source, dict):
        raise ValueError(
            f"SLO {entry.get('name')!r}: needs objective or "
            "objective_from_budget"
        )
    budget_dir = source.get("dir", "")
    candidates = [budget_dir]
    if base_dir and not os.path.isabs(budget_dir):
        # Budget dirs in committed specs are repo-relative; also try
        # them relative to the spec file so specs work from any cwd.
        candidates.append(os.path.join(base_dir, budget_dir))
    path = None
    for candidate in candidates:
        probe = os.path.join(candidate, f"{source.get('target', '')}.json")
        if os.path.exists(probe):
            path = probe
            break
    if path is None:
        raise ValueError(
            f"SLO {entry.get('name')!r}: budget "
            f"{source.get('target')!r} not found under {candidates}"
        )
    with open(path, "r", encoding="utf-8") as f:
        budget = json.load(f)
    value = budget.get(source.get("field"))
    if not isinstance(value, (int, float)):
        raise ValueError(
            f"SLO {entry.get('name')!r}: budget field "
            f"{source.get('field')!r} in {path} is not a number"
        )
    return float(value) * float(source.get("scale", 1.0)) * float(
        source.get("slack", 1.0)
    )


def load_slo_specs(path: str) -> list[SLOSpec]:
    """Parse a spec file; ``default:train`` resolves to the committed
    default (``default:serve`` raises NotImplementedError). Raises ``ValueError`` on a malformed
    file (the CLI maps that to its usage-error exit)."""
    if path.startswith("default:"):
        path = default_slo_path(path.split(":", 1)[1])
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("slos"), list):
        raise ValueError(f"{path}: not an SLO spec file (need a 'slos' list)")
    base_dir = os.path.dirname(os.path.abspath(path))
    specs = []
    for entry in doc["slos"]:
        if not isinstance(entry, dict) or "name" not in entry:
            raise ValueError(f"{path}: every SLO entry needs a name")
        specs.append(SLOSpec(
            name=str(entry["name"]),
            kind=str(entry.get("kind", "gauge_max")),
            metric=str(entry.get("metric", "")),
            objective=_resolve_objective(entry, base_dir),
            quantile=float(entry.get("quantile", 0.99)),
            window_s=float(entry.get("window_s", 300.0)),
            burn_threshold=float(entry.get("burn_threshold", 1.0)),
            warmup_s=float(entry.get("warmup_s", 0.0)),
            description=str(entry.get("description", "")),
        ))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate SLO names")
    return specs


def _bucket_edges(hist: dict) -> list[tuple[float, int]]:
    return sorted(
        (float(key[3:]), int(count))
        for key, count in (hist.get("buckets") or {}).items()
        if key.startswith("le_")
    )


def _bad_fraction(edges: list[tuple[float, int]], ceiling: float) -> float:
    """Fraction of observations above ``ceiling`` in a pow2 bucket set.

    Each bucket ``le_U`` covers ``(U/2, U]``; the straddling bucket's
    share above the ceiling interpolates geometrically (log-uniform
    within the bucket — the same honest assumption
    ``registry.estimate_quantiles`` makes)."""
    total = sum(count for _, count in edges)
    if total <= 0:
        return 0.0
    bad = 0.0
    for upper, count in edges:
        if upper <= ceiling:
            continue
        lower = upper / 2.0
        if lower >= ceiling or lower <= 0:
            bad += count
        else:
            bad += count * min(1.0, math.log2(upper / ceiling))
    return bad / total


class SLOEvaluator:
    """Sliding-window burn-rate evaluation over registry snapshots.

    Feed it ``observe(t, snapshot, goodput_report)`` at exporter cadence
    (or over one process's shard records, for the offline ``obs watch``
    path: the same math either way)."""

    def __init__(self, specs: list[SLOSpec]) -> None:
        self.specs = list(specs)
        # Per quantile-spec: (t, cumulative bucket state) history for
        # windowed deltas.
        self._history: dict[str, collections.deque] = {
            s.name: collections.deque() for s in self.specs
        }
        self._violated: dict[str, bool] = {s.name: False for s in self.specs}
        self._t_first: dict[str, float] = {}

    def observe(self, t: float, snapshot: dict,
                goodput: Optional[dict] = None) -> list[SLOStatus]:
        return [
            self._observe_one(spec, t, snapshot, goodput or {})
            for spec in self.specs
        ]

    def _observe_one(self, spec: SLOSpec, t: float, snapshot: dict,
                     goodput: dict) -> SLOStatus:
        if spec.kind == "quantile":
            value, burn = self._quantile_burn(spec, t, snapshot)
        else:
            value = self._gauge_value(spec, snapshot, goodput)
            if value is None:
                burn = 0.0
            elif spec.kind == "gauge_max":
                burn = max(0.0, value / spec.objective) \
                    if spec.objective > 0 else (math.inf if value > 0 else 0.0)
            else:  # gauge_min
                burn = spec.objective / value if value > 0 else math.inf
        t_first = self._t_first.setdefault(spec.name, t)
        violated = burn >= spec.burn_threshold
        if violated and t - t_first < spec.warmup_s:
            # Warmup grace: the burn is reported (the gauge shows it)
            # but cannot page — cold-start zeros are not incidents.
            violated = False
        newly = violated and not self._violated[spec.name]
        self._violated[spec.name] = violated
        return SLOStatus(
            name=spec.name, kind=spec.kind, metric=spec.metric,
            objective=spec.objective, value=value,
            burn_rate=round(burn, 6) if math.isfinite(burn) else burn,
            violated=violated, newly_violated=newly,
        )

    def _gauge_value(self, spec: SLOSpec, snapshot: dict,
                     goodput: dict) -> Optional[float]:
        value = (snapshot.get("gauges") or {}).get(spec.metric)
        if isinstance(value, (int, float)) and math.isfinite(value):
            return float(value)
        # Goodput-report fallback: shards carry the report whether or
        # not scalars_snapshot() ever mirrored it into gauges.
        if spec.metric.startswith("goodput/"):
            key = spec.metric.split("/", 1)[1]
            if key == "goodput_fraction":
                value = goodput.get("goodput_fraction")
            else:
                value = (goodput.get("fractions") or {}).get(
                    key.removesuffix("_fraction")
                )
            if isinstance(value, (int, float)) and math.isfinite(value):
                return float(value)
        return None

    def _quantile_burn(self, spec: SLOSpec, t: float,
                       snapshot: dict) -> tuple[Optional[float], float]:
        hist = (snapshot.get("histograms") or {}).get(spec.metric) or {}
        edges = dict(_bucket_edges(hist))
        history = self._history[spec.name]
        history.append((t, edges))
        # Slide: drop an entry only when the NEXT one is also outside
        # the window — the newest out-of-window state stays as the
        # delta baseline, so a long quiet period evaluates an empty
        # delta rather than collapsing to one entry and re-evaluating
        # the full history (which would resurrect the aged-out tail).
        while len(history) > 2 and t - history[1][0] > spec.window_s:
            history.popleft()
        # Window delta: newest cumulative state minus the oldest inside
        # the window (per-bucket counts are themselves cumulative over
        # the run, so the difference is the window's observations). A
        # single-entry history (first tick) evaluates the full history —
        # everything seen so far IS the window.
        oldest = history[0][1] if len(history) > 1 else {}
        delta = [
            (upper, count - oldest.get(upper, 0))
            for upper, count in sorted(edges.items())
            if count - oldest.get(upper, 0) > 0
        ]
        if not delta:
            return None, 0.0
        bad = _bad_fraction(delta, spec.objective)
        burn = bad / max(1e-9, 1.0 - spec.quantile)
        from rocket_tpu_torch.obs.registry import estimate_quantiles

        window_count = sum(count for _, count in delta)
        estimate = estimate_quantiles(
            {"count": window_count,
             "buckets": {f"le_{u:g}": c for u, c in delta}},
            qs=(spec.quantile,),
        )
        value = next(iter(estimate.values()), None)
        return value, burn
