"""The flight recorder: a ring of the last steps' health records and the
forensic bundle written when a run fails (counterpart of
``rocket_tpu/obs/flight.py``).

The ring holds the decoded health word of each of the last
``blackbox_steps`` steps with its context (phase tag, epoch, batch index).
:meth:`FlightRecorder.dump` writes a bundle under ``<telemetry
dir>/blackbox/<reason>/``, in the reference's layout so that either
package's ``obs blackbox`` renders the other's:

* ``blackbox.json``: the manifest (reason, anomaly timeline, the ring,
  the last good step, a registry snapshot, the tail of the span stream,
  the seed state, the process identity);
* ``checkpoint/``: an emergency checkpoint of every prepared model through
  the Checkpointer, when the tree has one. Under a gated anomaly action
  the state is the last finite one, so ``resume_from=<bundle>/checkpoint``
  restores it.

A bundle is written on an anomaly under ``dump_and_halt``, on an exception
escaping a Looper, and on a watchdog escalation; only the main process
writes, at most ``max_dumps`` a run. Render one with ``python -m
rocket_tpu_torch.obs blackbox <dir>``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

__all__ = ["FlightRecorder", "BLACKBOX_FILE"]

BLACKBOX_FILE = "blackbox.json"


def _jsonable(value):
    """``value`` if JSON takes it, else its repr: a dump must not fail on
    its context."""
    try:
        json.dumps(value)
    except (TypeError, ValueError):
        return repr(value)
    return value


class FlightRecorder:
    """``max_steps``: the ring's length (``Runtime(blackbox_steps=)``).
    ``telemetry`` gives the output directory, the span tail and the
    registry; ``runtime`` the process identity, the seed state and the
    main-process gate."""

    def __init__(self, max_steps: int = 256, telemetry=None, runtime=None, logger=None,
                 max_dumps: int = 8, spans_tail: int = 200) -> None:
        if max_steps < 1:
            raise ValueError(f"blackbox_steps must be >= 1, got {max_steps}")
        self.max_steps = int(max_steps)
        self._telemetry, self._runtime, self._logger = telemetry, runtime, logger
        self._max_dumps, self._spans_tail = int(max_dumps), int(spans_tail)
        self._ring: collections.deque = collections.deque(maxlen=self.max_steps)
        self._anomalies: list = []
        self._checkpointer = None
        self._guard = threading.Lock()
        #: Directories of the bundles written (``telemetry.json`` lists them).
        self.dumped: list = []

    def attach_checkpointer(self, checkpointer) -> None:
        """The Checkpointer's setup; the first one stays (one emergency
        writer is enough)."""
        with self._guard:
            if self._checkpointer is None:
                self._checkpointer = checkpointer

    def detach_checkpointer(self, checkpointer) -> None:
        with self._guard:
            if self._checkpointer is checkpointer:
                self._checkpointer = None

    def record(self, entry: dict) -> None:
        with self._guard:
            self._ring.append(entry)

    def note_anomaly(self, entry: dict) -> None:
        with self._guard:
            self._anomalies = (self._anomalies + [entry])[-64:]

    def anomalies(self) -> list:
        with self._guard:
            return list(self._anomalies)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def last_good_step(self) -> Optional[int]:
        with self._guard:
            good = [e.get("step") for e in self._ring if not e.get("flag_names")]
        return good[-1] if good else None

    def _root(self) -> str:
        fallback = None
        if self._runtime is not None:
            fallback = os.path.join(getattr(self._runtime, "project_dir", "."), "runs",
                                    "telemetry")
        if self._telemetry is not None:
            base = self._telemetry.resolve_out_dir(fallback)
        else:
            base = fallback or os.path.join("runs", "telemetry")
        return os.path.join(base, "blackbox")

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write one bundle and return its directory; None on a process that
        is not the main one, past the budget, or when writing failed (a dump
        never raises: it must not hide the failure it records)."""
        if self._runtime is not None and not self._runtime.is_main_process:
            return None
        try:
            return self._write(reason, extra)
        except Exception as exc:  # noqa: BLE001
            if self._logger is not None:
                self._logger.error("flight recorder: dump failed: %r", exc)
            return None

    def _bundle_dir(self, reason: str) -> str:
        safe = "".join(ch if ch.isalnum() or ch in "-_." else "_" for ch in reason)[:80] or "dump"
        root = self._root()
        path, k = os.path.join(root, safe), 1
        while os.path.exists(path):
            path, k = os.path.join(root, f"{safe}.{k}"), k + 1
        os.makedirs(path, exist_ok=True)
        return path

    def _write(self, reason: str, extra: Optional[dict]) -> Optional[str]:
        with self._guard:
            if len(self.dumped) >= self._max_dumps:
                if self._logger is not None:
                    self._logger.warning("flight recorder: bundle budget (%d) spent — skipping "
                                         "dump %r", self._max_dumps, reason)
                return None
            history, anomalies = list(self._ring), list(self._anomalies)
        bundle = self._bundle_dir(reason)
        manifest = {"version": 1, "reason": reason, "created_unix": time.time(),
                    "last_good_step": self.last_good_step, "steps_recorded": len(history),
                    "sentinel_history": history, "anomalies": anomalies,
                    "extra": None if extra is None else _jsonable(extra)}
        runtime, telemetry = self._runtime, self._telemetry
        if runtime is not None:
            from rocket_tpu_torch.obs.export import host_identity

            who = host_identity(runtime.process_index)
            manifest["process"] = {"index": runtime.process_index,
                                   "count": runtime.process_count, "rank": who["rank"],
                                   "hostname": who["hostname"], "pid": os.getpid()}
            manifest["rng"] = runtime.rng_state_dict()
        if telemetry is not None:
            manifest["metrics"] = telemetry.registry.snapshot()
            t0 = telemetry.spans.t0
            manifest["spans_tail"] = [
                {"name": name, "cat": cat, "t": round(t - t0, 6), "dur": round(dur, 6),
                 "tid": tid}
                for name, cat, t, dur, tid in telemetry.spans.events()[-self._spans_tail:]]
            if telemetry.health is not None:
                manifest["health"] = telemetry.health.summary()
        manifest["checkpoint"] = None
        if self._checkpointer is not None:
            try:
                self._checkpointer.save_emergency(os.path.join(bundle, "checkpoint"))
                manifest["checkpoint"] = "checkpoint"
            except Exception as exc:  # noqa: BLE001 — a bundle without it beats none
                manifest["checkpoint_error"] = repr(exc)
        # NaN floats stay as they are (json's default): the anomaly's own
        # record holds them, and the CLI that reads the file is Python's.
        tmp = os.path.join(bundle, BLACKBOX_FILE + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, os.path.join(bundle, BLACKBOX_FILE))
        with self._guard:
            self.dumped.append(bundle)
        if self._logger is not None:
            self._logger.error("flight recorder: wrote black-box bundle %s (reason: %s)",
                               bundle, reason)
        return bundle
