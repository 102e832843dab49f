"""Per-request tail-latency tracing: waterfalls, tail exemplars,
forensics (counterpart of ``rocket_tpu/obs/reqtrace.py``).

The SLO plane (``obs/slo.py``) says *that* ``serve/itl_s`` p99 is
burning; this module says *which* requests were slow and *where* their
time went. Every request served by :class:`~rocket_tpu_torch.serve.
ServeEngine` carries a bounded event timeline (submit, admit, per-chunk
prefill, per-dispatch decode participation, eviction and resume,
finish, detokenize), recorded by the :class:`RequestTracer` that the
scheduler's and the engine's tick boundaries feed.

Cost model, O(waves + requests), never O(waves x slots):

* one :meth:`shared wave record <RequestTracer.on_dispatch>` per
  dispatch carries the dispatch and harvest timestamps, the batch
  occupancy and (while a ``capture_trace`` window is open) the step id
  of the tick's ``torch.profiler.record_function`` annotation, shared by
  every slot that ran it; per-request wave events are (seq, n)
  participation stubs joined against it at record time;
* per-request phase and ITL accounting is incremental (O(1) per
  harvest), so the bounded event list can compact coalescible events
  (wave spans, prefill spans) without losing the phase breakdown or the
  worst-gap attribution;
* every timestamp is a ``time.perf_counter()`` value taken at an existing
  tick boundary: no ``.item()``, no ``.cpu()``, no
  ``torch.cuda.synchronize()``; strict mode stays silent over a traced
  serve loop.

Persistence follows the shard discipline of ``obs/export.py``: finished
timelines append to ``<run dir>/telemetry/reqtrace.jsonl`` and each
window's slowest-k requests (by TTFT and by worst ITL gap) append with an
``exemplar`` tag to ``<run dir>/telemetry/exemplars.jsonl``, both
crash-readable JSONL compacted by temp file and rename. ``python -m
rocket_tpu_torch.obs timeline <run dir>`` renders the waterfalls; an SLO
violation carries the ``last_window`` exemplar request ids into its
flight anomaly (``TelemetryExporter._evaluate_slos``).

Stdlib-only and torch-free, like ``export.py`` and ``slo.py``: the tests
drive the tracer with synthetic clocks and no device. Records, renders
and files are the reference's, byte for byte on the same events.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Optional

__all__ = [
    "RequestTracer",
    "EXEMPLARS_FILE",
    "REQTRACE_FILE",
    "TIMELINE_VERSION",
    "aggregate_phases",
    "read_timeline_dir",
    "render_aggregate",
    "render_waterfall",
    "timeline_segments",
]

#: Rolling log of finished request timelines under ``<run>/telemetry/``.
REQTRACE_FILE = "reqtrace.jsonl"

#: Curated slowest-k timelines per export window, exemplar-tagged.
EXEMPLARS_FILE = "exemplars.jsonl"

#: Timeline record schema version.
TIMELINE_VERSION = 1

#: Events that may be coalesced when a timeline hits its event cap.
_COALESCIBLE = ("wave", "wave_span", "prefill", "prefill_span")

#: Phase -> waterfall glyph (ASCII only — CI logs and dumb terminals).
_PHASE_CHARS = {"queue": ".", "prefill": "#", "decode": "=",
                "preempted": "x"}


def _compact_events(events: list[dict]) -> list[dict]:
    """Merge runs of adjacent coalescible events into span events —
    the bounded-timeline escape hatch for very long generations. Phase
    and ITL accounting is incremental on the tracer, so nothing the
    renderer needs beyond span boundaries is lost."""
    out: list[dict] = []
    for ev in events:
        kind = ev.get("ev")
        if out and kind in _COALESCIBLE:
            prev = out[-1]
            prev_kind = prev.get("ev")
            same = (
                prev_kind in ("wave", "wave_span")
                and kind in ("wave", "wave_span")
            ) or (
                prev_kind in ("prefill", "prefill_span")
                and kind in ("prefill", "prefill_span")
            )
            if same:
                span = "wave_span" if kind in ("wave", "wave_span") \
                    else "prefill_span"
                merged = {
                    "ev": span,
                    "t": prev["t"],
                    "t1": ev.get("t1", ev["t"]),
                    "n": prev.get("n", 0) + ev.get("n", 0),
                }
                for bound, source in (("seq0", prev), ("seq1", ev)):
                    seq = source.get(bound, source.get("seq"))
                    if seq is not None:
                        merged[bound] = seq
                occ = max(prev.get("occ") or 0, ev.get("occ") or 0)
                if occ:
                    merged["occ"] = occ
                out[-1] = merged
                continue
        out.append(ev)
    return out


class _Timeline:
    """One request's bounded event list + incremental phase accounting.

    The phase accumulators partition ``[submit, finish]`` exactly:
    ``queue`` (submit → first admit), ``preempted`` (evict → re-admit),
    and per residency ``prefill`` (admit → first harvested wave) and
    ``decode`` (first wave → evict/finish) — so the rendered waterfall's
    durations sum to the request's measured wall time by construction.
    """

    __slots__ = (
        "rid", "t_submit", "prompt_len", "max_new_tokens", "max_events",
        "events", "dropped", "tokens", "preemptions",
        "_admit_t", "_first_wave_t", "_evict_t", "_last_emit_t",
        "_desched", "queue_s", "prefill_s", "decode_s", "preempted_s",
        "ttft_s", "worst_gap_s", "worst_gap_kind", "gap_desched_s",
        "gap_wait_s",
    )

    def __init__(self, rid: int, t_submit: float, prompt_len: int,
                 max_new_tokens: int, max_events: int) -> None:
        self.rid = rid
        self.t_submit = t_submit
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.max_events = max_events
        self.events: list[dict] = [{"ev": "submit", "t": t_submit}]
        self.dropped = 0
        self.tokens = 0
        self.preemptions = 0
        self._admit_t: Optional[float] = None
        self._first_wave_t: Optional[float] = None
        self._evict_t: Optional[float] = None
        self._last_emit_t: Optional[float] = None
        self._desched = False
        self.queue_s = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.preempted_s = 0.0
        self.ttft_s: Optional[float] = None
        self.worst_gap_s: Optional[float] = None
        self.worst_gap_kind: Optional[str] = None
        self.gap_desched_s = 0.0
        self.gap_wait_s = 0.0

    def add(self, event: dict) -> None:
        self.events.append(event)
        if len(self.events) > self.max_events:
            self.events = _compact_events(self.events)
        while len(self.events) > self.max_events:
            # Pathological alternation survived compaction: drop the
            # oldest coalescible event and say so (lifecycle boundary
            # events — admit/evict/finish — are never dropped).
            for i, ev in enumerate(self.events):
                if ev.get("ev") in _COALESCIBLE:
                    del self.events[i]
                    self.dropped += 1
                    break
            else:
                break

    # -- incremental phase accounting --------------------------------------

    def admit(self, t: float) -> None:
        if self._admit_t is None and self._evict_t is None \
                and self.queue_s == 0.0:
            self.queue_s = max(0.0, t - self.t_submit)
        elif self._evict_t is not None:
            self.preempted_s += max(0.0, t - self._evict_t)
            self._evict_t = None
        self._admit_t = t
        self._first_wave_t = None

    def wave(self, t: float, n: int) -> None:
        if self._first_wave_t is None and self._admit_t is not None:
            self._first_wave_t = t
            self.prefill_s += max(0.0, t - self._admit_t)
        if self.ttft_s is None:
            self.ttft_s = max(0.0, t - self.t_submit)
        elif self._last_emit_t is not None:
            gap = max(0.0, t - self._last_emit_t)
            kind = "descheduled" if self._desched else "waiting"
            if kind == "descheduled":
                self.gap_desched_s += gap
            else:
                self.gap_wait_s += gap
            if self.worst_gap_s is None or gap > self.worst_gap_s:
                self.worst_gap_s = gap
                self.worst_gap_kind = kind
        self._last_emit_t = t
        self._desched = False
        self.tokens += n

    def _end_residency(self, t: float) -> None:
        if self._first_wave_t is not None:
            self.decode_s += max(0.0, t - self._first_wave_t)
        elif self._admit_t is not None:
            self.prefill_s += max(0.0, t - self._admit_t)
        self._admit_t = None
        self._first_wave_t = None

    def evict(self, t: float) -> None:
        self._end_residency(t)
        self._evict_t = t
        self._desched = True
        self.preemptions += 1

    def finish(self, t: float) -> dict:
        self._end_residency(t)
        if self._evict_t is not None:  # evicted, finished while queued?
            self.preempted_s += max(0.0, t - self._evict_t)
            self._evict_t = None
        total = max(0.0, t - self.t_submit)
        return self.record(t_finish=t, total_s=total, final=True)

    def record(self, t_finish: Optional[float] = None,
               total_s: Optional[float] = None, final: bool = False) -> dict:
        """Serialize — event times shifted relative to submit so records
        are meaningful across processes (``t0`` keeps the raw
        perf_counter origin for same-run correlation)."""
        events = []
        for ev in self.events:
            shifted = dict(ev)
            shifted["t"] = round(ev["t"] - self.t_submit, 6)
            if "t1" in ev:
                shifted["t1"] = round(ev["t1"] - self.t_submit, 6)
            events.append(shifted)
        return {
            "version": TIMELINE_VERSION,
            "rid": self.rid,
            "t_unix": time.time(),
            "t0": self.t_submit,
            "final": bool(final),
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "tokens": self.tokens,
            "preemptions": self.preemptions,
            "ttft_s": None if self.ttft_s is None else round(self.ttft_s, 6),
            "total_s": None if total_s is None else round(total_s, 6),
            "phases": {
                "queue_s": round(self.queue_s, 6),
                "prefill_s": round(self.prefill_s, 6),
                "decode_s": round(self.decode_s, 6),
                "preempted_s": round(self.preempted_s, 6),
            },
            "itl": {
                "worst_gap_s": (
                    None if self.worst_gap_s is None
                    else round(self.worst_gap_s, 6)
                ),
                "worst_gap_kind": self.worst_gap_kind,
                "descheduled_s": round(self.gap_desched_s, 6),
                "waiting_s": round(self.gap_wait_s, 6),
            },
            "events": events,
            "dropped": self.dropped,
        }


class RequestTracer:
    """The serve stack's timeline recorder.

    Hooked by ``serve/scheduler.py`` (submit/admit/prefill/harvest/
    evict/finish), ``serve/engine.py`` (dispatch/harvest timestamps) and
    ``serve/api.py`` (release/detokenize, trace-step id). All methods
    are O(1) host dict/list work under the tracer's own lock — safe from
    the engine lock or from stream() reader threads.

    Memory is bounded everywhere: live timelines cap their event lists
    (``max_events``), finished records live in an LRU of ``max_records``
    (``ServeEngine.release()``/retirement evict eagerly), the pending
    persistence queue and the exemplar window pool are deques with
    ``maxlen``, and the wave-record ring keeps the newest
    ``wave_ring`` dispatches.
    """

    def __init__(self, max_events: int = 256, exemplar_k: int = 3,
                 max_records: int = 4096, wave_ring: int = 1024,
                 retention_lines: int = 2048) -> None:
        self._lock = threading.Lock()
        self.max_events = int(max_events)
        self.exemplar_k = int(exemplar_k)
        self.retention_lines = int(retention_lines)
        self._live: dict[int, _Timeline] = {}
        self._done: collections.OrderedDict[int, dict] = \
            collections.OrderedDict()
        self._max_records = int(max_records)
        self._pending: collections.deque = collections.deque(
            maxlen=self._max_records
        )
        self._window: collections.deque = collections.deque(
            maxlen=self._max_records
        )
        self._waves: collections.OrderedDict[int, dict] = \
            collections.OrderedDict()
        self._wave_ring = int(wave_ring)
        self._seq = 0
        #: Set by ``ServeEngine.step()`` before each tick while a
        #: ``capture_trace`` window is open: the step id of the tick's
        #: ``record_function`` annotation, joining a wave record to its
        #: measured device window.
        self.trace_step: Optional[int] = None
        #: The last flushed window's exemplar request ids — what an SLO
        #: violation carries into its flight anomaly.
        self.last_window: dict = {"ttft": [], "itl_gap": []}
        self.finished_total = 0
        self.persisted_total = 0
        self.write_errors = 0
        self._writers: dict[str, object] = {}

    # -- scheduler/engine hooks --------------------------------------------

    def on_submit(self, rid: int, t: float, prompt_len: int = 0,
                  max_new_tokens: int = 0) -> None:
        with self._lock:
            self._live[rid] = _Timeline(
                rid, t, int(prompt_len), int(max_new_tokens),
                self.max_events,
            )

    def on_admit(self, rid: int, t: float, slot: int, ctx_len: int = 0,
                 resumed: bool = False) -> None:
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.admit(t)
            ev = {"ev": "admit", "t": t, "slot": int(slot),
                  "ctx_len": int(ctx_len)}
            if resumed:
                ev["resumed"] = True
            tl.add(ev)

    def on_prefill(self, rid: int, t: float, start: int, valid: int) -> None:
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.add({"ev": "prefill", "t": t, "start": int(start),
                    "n": int(valid)})

    def on_dispatch(self, occupancy: int, t: float, waves: int = 1) -> int:
        """One shared wave record per k-wave dispatch; returns its seq
        (the scheduler pairs it with the pending handle)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._waves[seq] = {
                "seq": seq, "t_dispatch": t, "t_harvest": None,
                "occ": int(occupancy), "waves": int(waves),
                "step": self.trace_step,
            }
            while len(self._waves) > self._wave_ring:
                self._waves.popitem(last=False)
            return seq

    def on_harvest(self, seq: int, t: float) -> None:
        with self._lock:
            wave = self._waves.get(seq)
            if wave is not None:
                wave["t_harvest"] = t

    def on_tokens(self, rid: int, seq: Optional[int], n: int,
                  t: float) -> None:
        """Request ``rid`` received ``n`` tokens from dispatch ``seq``
        at harvest time ``t`` — ONE participation event per dispatch per
        request, joined against the shared wave record."""
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            ev = {"ev": "wave", "t": t, "n": int(n)}
            wave = None if seq is None else self._waves.get(seq)
            if wave is not None:
                ev["seq"] = wave["seq"]
                ev["occ"] = wave["occ"]
                ev["lat"] = round(t - wave["t_dispatch"], 6)
                if wave["step"] is not None:
                    ev["step"] = wave["step"]
            tl.wave(t, int(n))
            tl.add(ev)

    def on_evict(self, rid: int, t: float) -> None:
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.evict(t)
            tl.add({"ev": "evict", "t": t})

    def on_finish(self, rid: int, t: float) -> None:
        with self._lock:
            tl = self._live.pop(rid, None)
            if tl is None:
                return
            tl.add({"ev": "finish", "t": t})
            record = tl.finish(t)
            self._done[rid] = record
            while len(self._done) > self._max_records:
                self._done.popitem(last=False)
            self._pending.append(record)
            self._window.append(record)
            self.finished_total += 1

    def on_detokenize(self, rid: int, t: float) -> None:
        """Best effort: annotate a retained finished record with the
        stream-consumption instant (after finish — not a phase)."""
        with self._lock:
            record = self._done.get(rid)
            if record is None:
                return
            events = record.get("events")
            if isinstance(events, list) and not any(
                ev.get("ev") == "detok" for ev in events
            ):
                events.append(
                    {"ev": "detok", "t": round(t - record["t0"], 6)}
                )

    # -- retention ----------------------------------------------------------

    def release(self, rid: int) -> None:
        """Drop every retained trace for ``rid`` — wired into
        ``ServeEngine.release()`` and completed-request retirement so a
        week-long server's timeline memory stays bounded."""
        with self._lock:
            self._live.pop(rid, None)
            self._done.pop(rid, None)

    # -- reads --------------------------------------------------------------

    def timeline(self, rid: int) -> Optional[dict]:
        """The retained record for ``rid`` — finished (full phases) or
        live (partial, ``final: false``); None once released."""
        with self._lock:
            record = self._done.get(rid)
            if record is not None:
                return record
            tl = self._live.get(rid)
            return None if tl is None else tl.record()

    def phases(self, rid: int) -> Optional[dict]:
        with self._lock:
            record = self._done.get(rid)
            return None if record is None else record.get("phases")

    def aggregate(self) -> Optional[dict]:
        """Aggregate phase fractions over retained finished records —
        ``ServeEngine.report()['phases']`` / the serve bench record."""
        with self._lock:
            records = list(self._done.values())
        return aggregate_phases(records)

    # -- persistence + exemplar windows ------------------------------------

    def _writer_locked(self, out_dir: str, name: str):
        from rocket_tpu_torch.obs.export import SHARD_DIR, ShardWriter

        path = os.path.join(out_dir, SHARD_DIR, name)
        writer = self._writers.get(path)
        if writer is None:
            writer = self._writers[path] = ShardWriter(
                path, retention_lines=self.retention_lines
            )
        return writer

    def flush(self, out_dir: str) -> dict:
        """Close the current exemplar window and persist.

        Appends every finished-since-last-flush timeline to
        ``telemetry/reqtrace.jsonl``, the window's slowest-k by TTFT and
        by worst ITL gap (exemplar-tagged, full timelines) to
        ``telemetry/exemplars.jsonl``, updates :attr:`last_window`, and
        returns the window summary the exporter folds into its shard
        record. Never raises on IO — persistence must not kill the
        exporter loop (failures count in :attr:`write_errors`)."""
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
            window = list(self._window)
            self._window.clear()
            k = self.exemplar_k
            by_ttft = sorted(
                (r for r in window if r.get("ttft_s") is not None),
                key=lambda r: -r["ttft_s"],
            )[:k]
            by_gap = sorted(
                (r for r in window
                 if (r.get("itl") or {}).get("worst_gap_s") is not None),
                key=lambda r: -r["itl"]["worst_gap_s"],
            )[:k]
            self.last_window = {
                "ttft": [r["rid"] for r in by_ttft],
                "itl_gap": [r["rid"] for r in by_gap],
            }
            appended = 0
            try:
                writer = self._writer_locked(out_dir, REQTRACE_FILE)
                for record in pending:
                    writer.append(record)
                    appended += 1
                if by_ttft or by_gap:
                    ex_writer = self._writer_locked(out_dir, EXEMPLARS_FILE)
                    for kind, records in (("ttft", by_ttft),
                                          ("itl_gap", by_gap)):
                        for rank, record in enumerate(records):
                            ex_writer.append(dict(
                                record,
                                exemplar={"by": kind, "rank": rank},
                            ))
            except OSError:
                self.write_errors += 1
            self.persisted_total += appended
            return {
                "finished": len(window),
                "persisted": appended,
                "exemplars": dict(self.last_window),
            }


# -- readers + renderers (the `obs timeline` CLI) -----------------------------


def read_timeline_dir(path: str) -> list[dict]:
    """Every retained timeline record under a run dir (its
    ``telemetry/`` shard dir, or a jsonl file directly), deduped by
    request id — exemplar tags from ``exemplars.jsonl`` fold into the
    record's ``exemplar_by`` list. Oldest-finished first."""
    from rocket_tpu_torch.obs.export import SHARD_DIR, read_shard_file

    candidates: list[str] = []
    if os.path.isfile(path):
        candidates.append(path)
    else:
        seen: set[str] = set()
        for base in (os.path.join(path, SHARD_DIR), path):
            for name in (REQTRACE_FILE, EXEMPLARS_FILE):
                candidate = os.path.realpath(os.path.join(base, name))
                if candidate not in seen and os.path.exists(candidate):
                    seen.add(candidate)
                    candidates.append(candidate)
    by_rid: dict[int, dict] = {}
    for candidate in candidates:
        for record in read_shard_file(candidate):
            rid = record.get("rid")
            if rid is None or not isinstance(record.get("events"), list):
                continue
            tag = (record.get("exemplar") or {}).get("by")
            kept = by_rid.get(rid)
            if kept is None:
                kept = by_rid[rid] = dict(record)
                kept["exemplar_by"] = []
                kept.pop("exemplar", None)
            if tag and tag not in kept["exemplar_by"]:
                kept["exemplar_by"].append(tag)
    return sorted(
        by_rid.values(), key=lambda r: (r.get("t_unix") or 0, r["rid"])
    )


def timeline_segments(record: dict) -> list[tuple[str, float, float]]:
    """``[(phase, t0, t1)]`` over a record's event stream — the
    waterfall's drawable form. Times are relative to submit; segments
    partition ``[0, total_s]`` for a finished record."""
    segments: list[tuple[str, float, float]] = []
    idle_start = 0.0
    idle_kind = "queue"
    admit_t: Optional[float] = None
    first_wave_t: Optional[float] = None
    for ev in record.get("events") or []:
        kind = ev.get("ev")
        t = float(ev.get("t", 0.0))
        if kind == "admit":
            segments.append((idle_kind, idle_start, t))
            admit_t, first_wave_t = t, None
        elif kind in ("wave", "wave_span"):
            if first_wave_t is None and admit_t is not None:
                first_wave_t = t
                segments.append(("prefill", admit_t, t))
        elif kind == "evict":
            if first_wave_t is not None:
                segments.append(("decode", first_wave_t, t))
            elif admit_t is not None:
                segments.append(("prefill", admit_t, t))
            admit_t, first_wave_t = None, None
            idle_start, idle_kind = t, "preempted"
        elif kind == "finish":
            if first_wave_t is not None:
                segments.append(("decode", first_wave_t, t))
            elif admit_t is not None:
                segments.append(("prefill", admit_t, t))
            else:
                segments.append((idle_kind, idle_start, t))
    return [s for s in segments if s[2] > s[1]]


def _ms(value: Optional[float]) -> str:
    return "-" if value is None else f"{value * 1e3:.1f}ms"


def render_waterfall(record: dict, width: int = 60) -> str:
    """One request's ASCII waterfall + phase durations."""
    total = record.get("total_s") or 0.0
    header = (
        f"request {record.get('rid')}  total {_ms(record.get('total_s'))}"
        f"  ttft {_ms(record.get('ttft_s'))}"
        f"  tokens {record.get('tokens', 0)}"
        f"  preemptions {record.get('preemptions', 0)}"
    )
    itl = record.get("itl") or {}
    if itl.get("worst_gap_s") is not None:
        header += (
            f"  worst gap {_ms(itl['worst_gap_s'])}"
            f" ({itl.get('worst_gap_kind')})"
        )
    if record.get("exemplar_by"):
        header += f"  [exemplar: {', '.join(record['exemplar_by'])}]"
    lines = [header]
    if total > 0:
        bar = [" "] * width
        for phase, t0, t1 in timeline_segments(record):
            glyph = _PHASE_CHARS.get(phase, "?")
            i0 = min(width - 1, int(t0 / total * width))
            i1 = max(i0 + 1, min(width, round(t1 / total * width)))
            for i in range(i0, i1):
                bar[i] = glyph
        lines.append("  |" + "".join(bar) + "|")
    phases = record.get("phases") or {}
    lines.append(
        "  queue " + _ms(phases.get("queue_s"))
        + "  prefill " + _ms(phases.get("prefill_s"))
        + "  decode " + _ms(phases.get("decode_s"))
        + "  preempted " + _ms(phases.get("preempted_s"))
        + (f"  ({record['dropped']} event(s) compacted away)"
           if record.get("dropped") else "")
    )
    return "\n".join(lines)


def aggregate_phases(records: list[dict]) -> Optional[dict]:
    """Fleet-of-requests phase breakdown: each phase's fraction of total
    request wall time, plus the ITL-gap attribution split (descheduled
    vs waiting-on-wave). None when no finished records."""
    finished = [r for r in records if r.get("total_s")]
    if not finished:
        return None
    sums = {"queue_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
            "preempted_s": 0.0}
    total = 0.0
    desched = waiting = 0.0
    worst: Optional[tuple[float, str, int]] = None
    for record in finished:
        total += record["total_s"]
        phases = record.get("phases") or {}
        for key in sums:
            sums[key] += phases.get(key) or 0.0
        itl = record.get("itl") or {}
        desched += itl.get("descheduled_s") or 0.0
        waiting += itl.get("waiting_s") or 0.0
        gap = itl.get("worst_gap_s")
        if gap is not None and (worst is None or gap > worst[0]):
            worst = (gap, itl.get("worst_gap_kind") or "?", record["rid"])
    out = {
        "requests": len(finished),
        "total_s": round(total, 6),
        "itl_descheduled_s": round(desched, 6),
        "itl_waiting_s": round(waiting, 6),
    }
    for key, value in sums.items():
        out[key.replace("_s", "_frac")] = (
            round(value / total, 4) if total > 0 else 0.0
        )
    if worst is not None:
        out["worst_gap_s"] = round(worst[0], 6)
        out["worst_gap_kind"] = worst[1]
        out["worst_gap_rid"] = worst[2]
    return out


def render_aggregate(records: list[dict]) -> str:
    """The aggregate phase-breakdown footer of ``obs timeline``."""
    agg = aggregate_phases(records)
    if agg is None:
        return "aggregate: no finished timelines"
    lines = [
        f"aggregate — {agg['requests']} request(s): "
        f"queue {agg['queue_frac']:.1%}  prefill {agg['prefill_frac']:.1%}"
        f"  decode {agg['decode_frac']:.1%}"
        f"  preempted {agg['preempted_frac']:.1%}"
    ]
    gap_total = agg["itl_descheduled_s"] + agg["itl_waiting_s"]
    if gap_total > 0:
        lines.append(
            f"itl gaps: descheduled {agg['itl_descheduled_s']:.4f}s "
            f"({agg['itl_descheduled_s'] / gap_total:.0%})  "
            f"waiting-on-wave {agg['itl_waiting_s']:.4f}s "
            f"({agg['itl_waiting_s'] / gap_total:.0%})"
            + (
                f"   worst {_ms(agg['worst_gap_s'])} "
                f"({agg['worst_gap_kind']}, request {agg['worst_gap_rid']})"
                if "worst_gap_s" in agg else ""
            )
        )
    return "\n".join(lines)
