"""The elastic supervisor, the restarting and draining side of
``python -m rocket_tpu_torch.launch --supervise`` (counterpart of
``rocket_tpu/resilience/supervisor.py``).

Any worker exit is an event, not a verdict:

* a **crash** (non-zero exit, a signal, an injected fault) reaps the whole
  generation, waits out a capped exponential backoff, re-resolves the
  worker count (after ``degrade_after`` no-progress failures it shrinks
  toward ``min_procs``) and spawns the next generation, which resumes from
  the last complete checkpoint through ``Checkpointer(resume_from=
  "latest")``;
* a **drain** (SIGTERM to the supervisor, forwarded to the workers, which
  finish the wave in flight, checkpoint and exit
  :data:`~rocket_tpu_torch.resilience.faults.EXIT_DRAINED`) is a clean
  stop: exit 0;
* a **crash loop** (``crash_loop_threshold`` generations in a row without
  progress) or a spent ``max_restarts`` budget stops the run with the
  failing generation's output tail in ``supervisor.json``.

Progress is read from outside, in the checkpoint directory: the newest
*complete* step advancing during a generation resets the crash-loop count
and timestamps the salvage point for the goodput account.
``supervisor.json`` (written atomically after every generation) holds each
generation's record and ``goodput_fraction`` = productive wall-clock over
total wall-clock, a crashed generation counting as productive up to its
last observed checkpoint advance.

The completeness scan (:func:`is_complete_checkpoint`,
:func:`newest_complete_step`) is the one definition of "restorable" that
the Checkpointer's ``resume_from="latest"`` and the progress probe share.
Standard library only at module level: the parent process never touches a
device, so it stays signal-safe and cheap to restart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Callable, Optional

from rocket_tpu_torch.resilience.faults import (
    EXIT_DRAINED,
    EXIT_WEDGED,
    GENERATION_ENV,
    SUPERVISED_ENV,
)

__all__ = ["RestartPolicy", "GenerationRecord", "GenEvent", "LoopState", "Decision", "decide",
           "Supervisor", "SUPERVISOR_FILE", "is_complete_checkpoint", "newest_complete_step"]

SUPERVISOR_FILE = "supervisor.json"

#: The variable the supervisor sets to the restart count so far.
RESTARTS_ENV = "ROCKET_TPU_RESTARTS"


# -- checkpoint-completeness scan ----------------------------------------------


def is_complete_checkpoint(candidate: str) -> bool:
    """A step directory is complete when its last artifact (``rng.json``)
    exists and every shard file that each ``model_*`` index names is on
    disk; a torn write fails one of the two."""
    if not os.path.exists(os.path.join(candidate, "rng.json")):
        return False
    try:
        entries = os.listdir(candidate)
    except OSError:
        return False
    for entry in entries:
        model_dir = os.path.join(candidate, entry)
        if not (entry.startswith("model_") and os.path.isdir(model_dir)):
            continue
        index_path = os.path.join(model_dir, "index.json")
        if not os.path.exists(index_path):
            return False
        try:
            with open(index_path, "r", encoding="utf-8") as f:
                index = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        files = {chunk["file"] for meta in index.values() if meta.get("kind") == "array"
                 for chunk in meta["chunks"]}
        if any(not os.path.exists(os.path.join(model_dir, name)) for name in files):
            return False
    return True


def newest_complete_step(output_dir: Optional[str]) -> Optional[int]:
    """The newest step directory under ``output_dir`` that passes
    :func:`is_complete_checkpoint`, or None."""
    if not output_dir or not os.path.isdir(output_dir):
        return None
    steps = sorted((int(d) for d in os.listdir(output_dir) if d.isdigit()), reverse=True)
    for step in steps:
        if is_complete_checkpoint(os.path.join(output_dir, str(step))):
            return step
    return None


# -- policy ------------------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """Knobs of the supervision loop (CLI flags map 1:1 onto these)."""

    #: Total restart budget across the whole run; exhausted -> give up.
    max_restarts: int = 16
    #: Capped exponential backoff between generations.
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    #: Consecutive NO-PROGRESS failed generations before refusing to thrash.
    crash_loop_threshold: int = 3
    #: Topology re-resolution: after this many consecutive no-progress
    #: failures at one worker count, retry with one fewer process...
    degrade_after: int = 2
    #: ...but never below this floor.
    min_procs: int = 1
    #: A generation surviving at least this long counts as progress even
    #: without a checkpoint advance (covers scripts that do not
    #: checkpoint). Only consulted when no ``ckpt_dir`` probe is
    #: configured — with a probe, durable checkpoint advance is the sole
    #: progress evidence, so a deterministic crasher whose startup
    #: outlives the grace cannot evade the crash-loop detector.
    progress_grace_s: float = 5.0

    def backoff_s(self, consecutive_failures: int) -> float:
        n = max(1, consecutive_failures)
        return min(
            self.backoff_max_s,
            self.backoff_base_s * self.backoff_factor ** (n - 1),
        )


@dataclasses.dataclass
class GenerationRecord:
    gen: int
    nproc: int
    started_unix: float
    duration_s: float = 0.0
    productive_s: float = 0.0
    rc: Optional[int] = None
    exit_codes: list = dataclasses.field(default_factory=list)
    outcome: str = "running"
    progressed: bool = False
    coord_error: bool = False
    ckpt_step: Optional[int] = None
    backoff_s: float = 0.0
    output_tail: Optional[dict] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _classify(rc: int) -> str:
    if rc == 0:
        return "completed"
    if rc == EXIT_DRAINED:
        return "drained"
    if rc == EXIT_WEDGED:
        return "wedged"
    return "crashed"


# -- the pure transition function --------------------------------------------
#
# The restart/degrade/crash-loop control flow is a state machine over
# generation outcomes, kept as a pure function: the live loop
# (Supervisor.run) and the tests drive one implementation, and the port's
# decisions can be held to the reference's state by state.


@dataclasses.dataclass(frozen=True)
class GenEvent:
    """What one finished generation looked like from the outside."""

    #: ``completed`` / ``drained`` / ``wedged`` / ``crashed`` (see
    #: :func:`_classify`).
    outcome: str
    #: Durable progress observed (checkpoint advance, or the duration
    #: heuristic when no probe is configured).
    progressed: bool = False
    #: Coordinator bind/connect failure — infrastructure noise.
    coord_error: bool = False
    #: A drain was requested (signal or API) before/while the
    #: generation exited with a non-drained code.
    drain_requested: bool = False
    #: The checkpoint probe sees at least one complete checkpoint.
    complete_ckpt: bool = False
    #: A checkpoint probe (``ckpt_dir``) is configured at all.
    probe: bool = True


@dataclasses.dataclass(frozen=True)
class LoopState:
    """The supervision loop's entire mutable decision state."""

    nproc: int
    restarts: int = 0
    consecutive_failures: int = 0
    failures_at_nproc: int = 0


@dataclasses.dataclass(frozen=True)
class Decision:
    """What :func:`decide` resolved for one generation outcome."""

    #: Successor state (the state to run the next generation under when
    #: ``stop`` is false; the final counter values when it is true).
    state: LoopState
    #: Terminal verdict reached — the run ends now.
    stop: bool
    #: Terminal outcome name (``""`` while the loop continues).
    outcome: str = ""
    #: Terminal exit code is 0 (clean stop); otherwise the generation rc.
    rc_zero: bool = False
    #: This decision shrank the topology by one worker.
    degraded: bool = False
    #: Failure count feeding the backoff for the next generation.
    backoff_failures: int = 0


def decide(state: LoopState, policy: RestartPolicy,
           event: GenEvent) -> Decision:
    """One supervision step: generation outcome -> restart / stop.

    Order matters and is load-bearing: drained-without-checkpoint is
    refused before anything else, a pending drain turns any crash into
    ``drain_failed``, the restart budget is checked before degrade,
    degrade (which resets BOTH failure counters — the re-resolution is
    itself the recovery action) before the crash-loop verdict."""
    if event.outcome == "completed":
        return Decision(state=state, stop=True, outcome="completed",
                        rc_zero=True)
    if event.outcome == "drained":
        if event.probe and not event.complete_ckpt:
            # Workers exited the drained code but the probe sees NO
            # durable checkpoint to resume from — rc 0 would tell an
            # orchestrator state was saved.
            return Decision(state=state, stop=True, outcome="drain_failed")
        return Decision(state=state, stop=True, outcome="drained",
                        rc_zero=True)
    if event.drain_requested:
        # Workers died (or were force-killed after the drain grace)
        # instead of draining — honored, but not a certified clean stop.
        return Decision(state=state, stop=True, outcome="drain_failed")

    # A crashed/wedged generation: decide whether to restart.
    nproc = state.nproc
    cf = state.consecutive_failures
    fa = state.failures_at_nproc
    if event.progressed:
        cf = 0
        fa = 0
    elif not event.coord_error:
        cf += 1
        fa += 1

    if state.restarts >= policy.max_restarts:
        return Decision(
            state=dataclasses.replace(
                state, consecutive_failures=cf, failures_at_nproc=fa),
            stop=True, outcome="restart_budget_exhausted")
    degraded = False
    if fa >= policy.degrade_after and nproc > policy.min_procs:
        nproc -= 1
        fa = 0
        cf = 0
        degraded = True
    if cf >= policy.crash_loop_threshold:
        return Decision(
            state=LoopState(nproc, state.restarts, cf, fa),
            stop=True, outcome="crash_loop", degraded=degraded)
    return Decision(
        state=LoopState(nproc, state.restarts + 1, cf, fa),
        stop=False, degraded=degraded, backoff_failures=cf)


# -- the supervisor ----------------------------------------------------------


class _DrainFlag:
    """Async-signal-safe drain latch with the ``threading.Event`` API
    surface the generation runners and tests rely on.

    ``set``/``is_set``/``clear`` are plain attribute operations — safe
    inside a signal handler, unlike ``threading.Event.set`` which
    acquires a ``Condition`` lock and can deadlock if the signal lands
    while the main thread holds it (the RKT1005 contract of the reference's lint). ``wait``
    polls at 20 ms granularity, which is ample for backoff sleeps."""

    __slots__ = ("_set",)

    def __init__(self) -> None:
        self._set = False

    def set(self) -> None:
        self._set = True

    def clear(self) -> None:
        self._set = False

    def is_set(self) -> bool:
        return self._set

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._set:
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        return self._set


class Supervisor:
    """One supervised run = a sequence of worker generations.

    Parameters
    ----------
    nproc:
        Initial worker count per generation.
    script, script_args:
        The training script (resumes itself via
        ``Checkpointer(resume_from="latest")``).
    policy:
        :class:`RestartPolicy`; default knobs suit CI-scale runs.
    state_dir:
        Where ``supervisor.json`` lands (atomically, after every
        generation).
    ckpt_dir:
        The training script's checkpoint ``output_dir`` — the progress
        probe. When set, durable checkpoint advance is the ONLY progress
        evidence the crash-loop/degrade counters accept. Optional;
        without it progress falls back to the ``progress_grace_s``
        duration heuristic and crashed generations salvage nothing in
        the goodput accounting.
    run_generation:
        Injectable generation runner ``(gen, nproc, drain_event,
        on_poll) -> (rc, exit_codes, output_tail[, coord_error])`` —
        unit tests script failures without spawning processes; the
        default drives :class:`rocket_tpu_torch.launch.WorkerGroup`. The
        optional fourth element marks a coordinator bind/connect
        failure (see :attr:`WorkerGroup.coord_error`): an
        infrastructure fault, not the workload's.
    """

    def __init__(
        self,
        nproc: int,
        script: str,
        script_args: Optional[list] = None,
        policy: Optional[RestartPolicy] = None,
        state_dir: str = os.path.join("runs", "supervised"),
        ckpt_dir: Optional[str] = None,
        coordinator_port: Optional[int] = None,
        term_grace_s: float = 10.0,
        drain_grace_s: float = 60.0,
        metrics_port: Optional[int] = None,
        extra_env: Optional[dict] = None,
        run_generation: Optional[Callable] = None,
        sleep: Callable[[float], None] = None,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
    ) -> None:
        if nproc < 1:
            raise ValueError(f"Supervisor: nproc must be >= 1, got {nproc}")
        self.nproc = int(nproc)
        self.script = script
        self.script_args = list(script_args or [])
        self.policy = policy or RestartPolicy()
        self.state_dir = state_dir
        self.ckpt_dir = ckpt_dir
        self.coordinator_port = coordinator_port
        self.term_grace_s = float(term_grace_s)
        self.drain_grace_s = float(drain_grace_s)
        #: Mount the supervisor's own Prometheus /metrics endpoint on
        #: this port (0 = ephemeral): per-generation goodput, restart
        #: and outcome counters survive worker death — the workers' own
        #: endpoints die with them, this one doesn't.
        self.metrics_port = metrics_port
        self.registry = None
        self._metrics_server = None
        self._published_gens = 0
        self.extra_env = dict(extra_env or {})
        self._run_generation = run_generation or self._run_generation_default
        self._clock = clock
        self._drain_event = _DrainFlag()
        self._pending_drain_reason: Optional[str] = None
        # Drain-interruptible sleep by default: a SIGTERM during backoff
        # must stop the run now, not after the backoff expires.
        self._sleep = sleep or (lambda s: self._drain_event.wait(s))
        self._logger = logger

        self.generations: list[GenerationRecord] = []
        self.restarts = 0
        self.drain_signals = 0
        self.outcome = "running"
        self.rc: Optional[int] = None
        self._t0 = self._clock()
        self._started_unix = time.time()
        # Progress probe state (fed by on_poll during a generation).
        self._last_ckpt_step = newest_complete_step(self.ckpt_dir)
        self._last_progress_rel: Optional[float] = None
        self._last_probe = 0.0

    # -- signals -----------------------------------------------------------

    def _note_drain(self, reason: str = "signal") -> None:
        """Async-signal-safe drain notation: attribute writes and a
        plain-bool flag set, nothing else — no logging, no allocation
        the interpreter doesn't already do for the call itself, no lock
        acquisition (RKT1005). The log line is deferred to
        :meth:`_flush_drain_log`, which the run loop calls at its next
        observation point."""
        self.drain_signals += 1
        self._pending_drain_reason = reason
        self._drain_event.set()

    def _flush_drain_log(self) -> None:
        reason, self._pending_drain_reason = self._pending_drain_reason, None
        if reason is not None:
            self._log(f"drain requested ({reason}) — forwarding to workers")

    def request_drain(self, reason: str = "signal") -> None:
        """Programmatic drain request (NOT for signal handlers — those
        go through :meth:`_note_drain` so the handler stays
        async-signal-safe)."""
        self._note_drain(reason)
        self._flush_drain_log()

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> drain (main thread only; the CLI path).

        The handlers are flag-set-only (:meth:`_note_drain`): no
        logging, no locks — a signal landing while the main thread
        holds the logging-module lock must not deadlock the supervisor.

        The first Ctrl-C requests the drain and restores the previous
        SIGINT disposition, so a second Ctrl-C interrupts hard instead
        of being swallowed while wedged workers sit out the drain grace
        — the same contract the worker-side
        :func:`~rocket_tpu_torch.resilience.faults.install_signal_drain`
        implements."""
        if threading.current_thread() is not threading.main_thread():
            return

        def term_handler(signum, frame):
            self._note_drain(signal.Signals(signum).name)

        previous_int = signal.getsignal(signal.SIGINT)

        def int_handler(signum, frame):
            self._note_drain("SIGINT")
            signal.signal(signal.SIGINT, previous_int)

        signal.signal(signal.SIGTERM, term_handler)
        signal.signal(signal.SIGINT, int_handler)

    # -- progress probe ----------------------------------------------------

    def _observe_progress(self, force: bool = False) -> None:
        """Poll the checkpoint dir (>=1s apart — one listdir) and
        timestamp the newest complete-step advance: the salvage point of
        a generation that later crashes. ``force`` bypasses the throttle
        for the post-generation sweep — a fast worker's final checkpoints
        all land inside one probe interval and must still be credited."""
        now = self._clock()
        if not force and now - self._last_probe < 1.0:
            return
        self._last_probe = now
        step = newest_complete_step(self.ckpt_dir)
        if step is not None and step != self._last_ckpt_step:
            self._last_ckpt_step = step
            self._last_progress_rel = now - self._t0

    # -- the default generation runner ------------------------------------

    def _run_generation_default(self, gen: int, nproc: int, drain_event,
                                on_poll):
        from rocket_tpu_torch import launch as launch_mod

        port = self.coordinator_port or launch_mod._free_port()
        env = dict(os.environ)
        env.update(self.extra_env)
        env[SUPERVISED_ENV] = "1"
        env[GENERATION_ENV] = str(gen)
        env[RESTARTS_ENV] = str(self.restarts)
        group = launch_mod.WorkerGroup(
            nproc, self.script, self.script_args, port, env=env,
            term_grace_s=self.term_grace_s,
        )
        group.spawn()
        rc, codes = group.wait(
            drain_event=drain_event,
            drain_grace_s=self.drain_grace_s,
            on_poll=on_poll,
        )
        return rc, codes, group.output_tail(), group.coord_error.is_set()

    # -- the supervisor's own metrics plane --------------------------------

    def _start_metrics(self) -> None:
        """Mount /metrics when asked. The registry + server come from
        the port's obs package (registry.py and export.py are
        standard library only at module level), so the supervisor
        touches no device and stays signal-safe."""
        if self.metrics_port is None or self._metrics_server is not None:
            return
        from rocket_tpu_torch.obs.export import PrometheusServer
        from rocket_tpu_torch.obs.registry import MetricsRegistry

        self.registry = MetricsRegistry()
        try:
            self._metrics_server = PrometheusServer(
                self.registry.snapshot, self.metrics_port,
                labels={"role": "supervisor"},
            )
            self._metrics_server.start()
            self._log(
                f"/metrics on http://{self._metrics_server.host}:"
                f"{self._metrics_server.port}"
            )
        except OSError as exc:
            self._metrics_server = None
            self._log(f"could not bind /metrics port "
                      f"{self.metrics_port}: {exc!r}")

    def _stop_metrics(self) -> None:
        server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.stop()

    def _publish_metrics(self) -> None:
        """Re-export the supervision state the scrape plane can watch:
        restart/drain/outcome counts, the current topology, and the
        headline goodput fraction. Idempotent per generation — outcome
        counters advance only over generations not yet published."""
        registry = self.registry
        if registry is None:
            return
        doc = self.summary()
        registry.gauge("supervisor/restarts").set(self.restarts)
        registry.gauge("supervisor/drain_events").set(self.drain_signals)
        registry.gauge("supervisor/generations").set(len(self.generations))
        registry.gauge("supervisor/goodput_fraction").set(
            doc["goodput_fraction"]
        )
        registry.gauge("supervisor/total_wall_s").set(doc["total_wall_s"])
        registry.gauge("supervisor/productive_wall_s").set(
            doc["productive_wall_s"]
        )
        if self.generations:
            registry.gauge("supervisor/nproc").set(self.generations[-1].nproc)
        if self._last_ckpt_step is not None:
            registry.gauge("supervisor/last_ckpt_step").set(
                self._last_ckpt_step
            )
        for record in self.generations[self._published_gens:]:
            if record.outcome:
                registry.counter(
                    f"supervisor/outcomes/{record.outcome}"
                ).inc()
        self._published_gens = len(self.generations)

    # -- the loop ----------------------------------------------------------

    def run(self) -> int:
        policy = self.policy
        state = LoopState(nproc=self.nproc)
        gen = 0
        self._start_metrics()

        while True:
            record = GenerationRecord(
                gen=gen, nproc=state.nproc, started_unix=time.time()
            )
            self.generations.append(record)
            start = self._clock()
            step_before = self._last_ckpt_step
            self._log(
                f"generation {gen}: launching {state.nproc} worker(s) "
                f"(restarts so far: {self.restarts})"
            )
            result = self._run_generation(
                gen, state.nproc, self._drain_event, self._observe_progress
            )
            rc, codes, tail = result[:3]
            coord_error = len(result) > 3 and bool(result[3])
            self._observe_progress(force=True)  # catch a final-save advance
            self._flush_drain_log()
            end = self._clock()

            record.duration_s = end - start
            record.rc = rc
            record.exit_codes = list(codes)
            record.outcome = _classify(rc)
            record.coord_error = coord_error
            ckpt_progress = (
                self._last_ckpt_step is not None
                and self._last_ckpt_step != step_before
            )
            record.ckpt_step = self._last_ckpt_step
            # With a checkpoint probe, durable advance is the ONLY
            # progress evidence; the duration heuristic is the fallback
            # for scripts that do not checkpoint (no ckpt_dir).
            record.progressed = ckpt_progress or (
                self.ckpt_dir is None
                and record.duration_s >= policy.progress_grace_s
            )
            if record.outcome in ("completed", "drained"):
                record.productive_s = record.duration_s
            elif ckpt_progress and self._last_progress_rel is not None:
                # Salvage: work up to the last durable checkpoint survived.
                record.productive_s = max(
                    0.0, min(record.duration_s,
                             self._last_progress_rel - (start - self._t0))
                )
            if record.outcome not in ("completed", "drained"):
                record.output_tail = tail or None

            event = GenEvent(
                outcome=record.outcome,
                progressed=record.progressed,
                coord_error=coord_error,
                drain_requested=self._drain_event.is_set(),
                complete_ckpt=self._last_ckpt_step is not None,
                probe=self.ckpt_dir is not None,
            )
            decision = decide(state, policy, event)

            # Narrate the decision (the pure function stays log-free).
            crash_branch = (
                event.outcome in ("crashed", "wedged")
                and not event.drain_requested
            )
            if decision.outcome == "drain_failed" and \
                    record.outcome == "drained":
                self._log(
                    "workers drained but no complete checkpoint "
                    f"exists under {self.ckpt_dir!r} — not a "
                    "certified clean stop"
                )
            if crash_branch and event.coord_error and not event.progressed:
                # Coordinator bind/connect failure at startup (a pinned
                # --coordinator-port still in TIME_WAIT after the reap) —
                # infrastructure noise, not the workload: retry on backoff
                # without feeding the degrade/crash-loop counters. The
                # restart budget still bounds a permanently-taken port.
                self._log(
                    "coordinator startup failure — not counted against "
                    "the crash-loop/degrade thresholds"
                )
            if decision.outcome == "restart_budget_exhausted":
                self._log(
                    f"restart budget exhausted ({policy.max_restarts}) — "
                    "giving up"
                )
            if decision.degraded:
                # Re-resolve the surviving topology: the same count keeps
                # dying before making progress, so assume a worker's slot
                # is gone and restart smaller; the resharding restore
                # handles the process-count change (see decide()).
                self._log(
                    f"degrading to {decision.state.nproc} worker(s) after "
                    "repeated no-progress failures (elastic restart)"
                )
            if decision.outcome == "crash_loop":
                self._log(
                    f"crash loop: {decision.state.consecutive_failures} "
                    "consecutive generations without progress — refusing "
                    "to thrash"
                )

            if decision.stop:
                return self._finish(
                    decision.outcome, 0 if decision.rc_zero else (rc or 1)
                )

            record.backoff_s = policy.backoff_s(decision.backoff_failures)
            self._write_state()
            self._log(
                f"generation {gen} {record.outcome} (rc={rc}); restarting "
                f"in {record.backoff_s:.2f}s"
            )
            self._sleep(record.backoff_s)
            self._flush_drain_log()
            if self._drain_event.is_set():
                # The drain request interrupted the backoff: the run ends
                # on a CRASHED generation with no drain checkpoint, so the
                # stop is honored but not certified clean — same verdict
                # as workers dying mid-drain. Exit 0 / "drained" is
                # reserved for a generation that actually drained.
                return self._finish("drain_failed", rc or 1)
            state = decision.state
            self.restarts = state.restarts
            gen += 1

    # -- bookkeeping -------------------------------------------------------

    def _finish(self, outcome: str, rc: int) -> int:
        self.outcome = outcome
        self.rc = rc
        self._write_state()
        self._stop_metrics()
        self._log(f"supervisor: {outcome} (rc={rc})")
        return rc

    def summary(self) -> dict:
        total = max(1e-9, self._clock() - self._t0)
        productive = sum(g.productive_s for g in self.generations)
        return {
            "version": 1,
            "script": self.script,
            "script_args": self.script_args,
            "nproc_initial": self.nproc,
            "policy": dataclasses.asdict(self.policy),
            "started_unix": self._started_unix,
            "outcome": self.outcome,
            "rc": self.rc,
            "restarts": self.restarts,
            "drain_events": self.drain_signals,
            "generations": [g.to_json() for g in self.generations],
            "total_wall_s": round(total, 3),
            "productive_wall_s": round(productive, 3),
            "goodput_fraction": round(productive / total, 4),
            "last_ckpt_step": self._last_ckpt_step,
        }

    def _write_state(self) -> None:
        self._publish_metrics()
        try:
            os.makedirs(self.state_dir, exist_ok=True)
            path = os.path.join(self.state_dir, SUPERVISOR_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.summary(), f, indent=1, sort_keys=True)
                f.write("\n")
                # fsync before the rename: a host crash mid-generation
                # must not commit a truncated record that poisons the
                # next goodput computation.
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:  # state file is evidence, not control flow
            self._log(f"supervisor: could not write {SUPERVISOR_FILE}: {exc!r}")

    def _log(self, message: str) -> None:
        if self._logger is not None:
            self._logger.info("%s", message)
        else:
            print(f"[supervisor] {message}", flush=True)
