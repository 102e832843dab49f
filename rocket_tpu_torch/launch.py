"""Single-node multi-process launcher (counterpart of ``rocket_tpu/launch.py``).

``python -m rocket_tpu_torch.launch -n 4 train.py [args...]`` spawns N
copies of the script with torch.distributed's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) pointing at a localhost rendezvous port. Each worker's
output is prefixed with its rank; the launcher exits non-zero if any
worker does, terminating the stragglers (SIGTERM, then SIGKILL after a
bounded grace). The launcher itself opens no process group: each
worker's ``Runtime`` opens it from that environment (NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU), one card a rank.

``--supervise`` makes it the elastic supervisor
(``rocket_tpu_torch.resilience``): a lost worker restarts the generation
from the last complete checkpoint with capped backoff, SIGTERM to the
launcher drains the workers (the wave in flight finished, a drain
checkpoint written, exit code ``EXIT_DRAINED`` read as clean), and
``supervisor.json`` records generations, restarts and goodput.

The parent never creates a CUDA context: each generation is spawned after
the last one is reaped, so the card's memory is free again, and each
worker loads the kernels ``ops/_build.py`` already built (keyed by the
digest of their sources) instead of rebuilding them.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

__all__ = ["main", "WorkerGroup"]


def _free_port() -> int:
    """A currently-free localhost port. Inherently racy: the probe socket
    closes before the rank-0 worker's store binds it, so another process
    may take it in between; ``main`` retries a fast startup failure on a
    fresh port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: A non-zero exit this early into a run MAY be a rendezvous-port race, but
#: elapsed time alone is not evidence (a script that fails fast on its own
#: must not run again, repeating its side effects): the retry also needs a
#: rendezvous error signature in the worker output (matched below).
_STARTUP_WINDOW_S = 15.0
_MAX_PORT_RETRIES = 2

#: Worker-output signatures of a rendezvous bind or connect FAILURE in
#: torch.distributed's TCPStore (c10d): the bind's "address already in use"
#: (EADDRINUSE), ``DistNetworkError`` and ``DistStoreError``, a client
#: socket that failed to connect or timed out, a store that timed out
#: waiting for its clients. Failure phrases only: benign progress lines
#: ("Rendezvous complete", "The server socket has started to listen",
#: "Added key: store_based_barrier_key") must not match, or a script that
#: fails fast for its own reasons would be run again.
_COORDINATOR_ERROR_RE = re.compile(
    r"address already in use"
    r"|EADDRINUSE"
    r"|failed to (?:bind|listen)"
    r"|DistNetworkError"
    r"|DistStoreError"
    r"|client socket has (?:failed to connect|timed out)"
    r"|(?:TCPStore|c10d|rendezvous)[^\n]*"
    r"\b(?:error|failed|failure|timed? ?out|refused|unreachable)\b"
    r"|(?:unable to|failed to|cannot|can'?t|couldn'?t) connect[^\n]*(?:store|master|rendezvous)"
    r"|connect\(\) timed out"
    r"|timed out after [\d.]+ seconds waiting for clients",
    re.IGNORECASE,
)


class WorkerGroup:
    """One generation of N coordinated worker processes.

    Owns spawn, rank-prefixed output streaming (with a bounded per-rank
    tail kept for post-mortems), the polling wait loop, SIGTERM drain
    forwarding, and the bounded TERM -> grace -> KILL teardown. Shared by
    the plain launcher (one group per attempt) and the supervisor (one
    group per generation).
    """

    def __init__(
        self,
        nproc: int,
        script: str,
        script_args: Optional[list] = None,
        port: Optional[int] = None,
        env: Optional[dict] = None,
        term_grace_s: float = 10.0,
        tail_lines: int = 40,
    ) -> None:
        self.nproc = int(nproc)
        self.script = script
        self.script_args = list(script_args or [])
        self.port = port if port is not None else _free_port()
        self._base_env = dict(os.environ if env is None else env)
        self.term_grace_s = float(term_grace_s)
        self._tail_lines = int(tail_lines)
        self.procs: list[subprocess.Popen] = []
        self._threads: list[threading.Thread] = []
        self._tails: list[collections.deque] = []
        self.coord_error = threading.Event()

    # -- spawn -------------------------------------------------------------

    def spawn(self) -> None:
        try:
            for rank in range(self.nproc):
                env = dict(self._base_env)
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(self.port),
                           WORLD_SIZE=str(self.nproc), RANK=str(rank), LOCAL_RANK=str(rank))
                proc = subprocess.Popen(
                    [sys.executable, self.script, *self.script_args],
                    env=env,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                )
                self.procs.append(proc)
                tail: collections.deque = collections.deque(
                    maxlen=self._tail_lines
                )
                self._tails.append(tail)
                thread = threading.Thread(
                    target=self._stream, args=(proc, rank, tail), daemon=True
                )
                thread.start()
                self._threads.append(thread)
        except BaseException:
            # A failed fork at rank k still tears down ranks 0..k-1 (they
            # would wait for the missing peers forever).
            self.teardown()
            raise

    def _stream(self, proc: subprocess.Popen, rank: int, tail) -> None:
        for line in proc.stdout:
            text = line.decode(errors="replace")
            tail.append(text.rstrip("\n")[:500])
            if not self.coord_error.is_set() and _COORDINATOR_ERROR_RE.search(
                text
            ):
                self.coord_error.set()
            sys.stdout.write(f"[rank {rank}] {text}")
            sys.stdout.flush()

    def output_tail(self) -> dict:
        """Last lines of each rank's merged stdout/stderr — the evidence a
        supervisor records for a failed generation."""
        return {
            str(rank): list(tail) for rank, tail in enumerate(self._tails)
        }

    # -- wait --------------------------------------------------------------

    def wait(
        self,
        drain_event: Optional[threading.Event] = None,
        drain_grace_s: float = 60.0,
        on_poll=None,
    ) -> tuple[int, list]:
        """Poll ALL workers until the generation resolves.

        The classic failure mode is one rank dying while the rest block in
        a collective waiting for it — a sequential ``wait()`` on rank 0
        would hang forever. As soon as any worker exits with a non-zero,
        non-drained code, the stragglers are torn down (TERM, then KILL
        after ``term_grace_s``).

        ``drain_event`` (supervisor SIGTERM) forwards SIGTERM to every
        live worker exactly once and starts the ``drain_grace_s`` clock;
        workers that honor the drain exit ``EXIT_DRAINED`` (counted as
        clean), workers still alive at the deadline are torn down. A
        worker exiting ``EXIT_DRAINED`` on its own (a per-rank preemption
        notice) triggers the same forward + deadline for its peers.

        Returns ``(rc, exit_codes)``: rc is the first non-zero non-drained
        code, else ``EXIT_DRAINED`` if any worker drained, else 0.
        """
        from rocket_tpu_torch.resilience.faults import EXIT_DRAINED

        live = set(range(self.nproc))
        codes: list = [None] * self.nproc
        failure_rc = 0
        drained = False
        drain_forwarded = False
        drain_deadline = None
        while live:
            if on_poll is not None:
                try:
                    on_poll()
                except Exception:  # the probe must never kill the wait loop
                    pass
            # Poll worker exits FIRST: workers that drained inside the
            # final poll interval must be harvested before the deadline
            # verdict, or a drain that succeeded within the grace period
            # is misreported as a drain failure.
            progressed = False
            for rank in sorted(live):
                code = self.procs[rank].poll()
                if code is None:
                    continue
                progressed = True
                live.discard(rank)
                codes[rank] = code
                if code == EXIT_DRAINED:
                    drained = True
                elif code != 0:
                    failure_rc = failure_rc or code
            if not live:
                break
            if failure_rc:
                break  # teardown below reaps the stragglers
            # A drain starts at the supervisor (drain_event) OR inside a
            # worker (one rank exits EXIT_DRAINED — a per-rank preemption
            # notice): either way the rest of the generation gets SIGTERM
            # and the drain-grace clock, so peers blocked in a collective
            # waiting for the drained rank cannot hang this loop forever.
            if (
                (drained or (drain_event is not None and drain_event.is_set()))
                and not drain_forwarded
            ):
                drain_forwarded = True
                drain_deadline = time.monotonic() + drain_grace_s
                for rank in sorted(live):
                    if self.procs[rank].poll() is None:
                        try:
                            self.procs[rank].send_signal(signal.SIGTERM)
                        except OSError:
                            pass
            if drain_deadline is not None and time.monotonic() > drain_deadline:
                failure_rc = failure_rc or 1  # drain grace expired
                break
            if not progressed:
                time.sleep(0.2)
        self.teardown()
        for rank, proc in enumerate(self.procs):
            if codes[rank] is None:
                codes[rank] = proc.poll()
        rc = failure_rc or (EXIT_DRAINED if drained else 0)
        return rc, codes

    # -- teardown ----------------------------------------------------------

    def terminate(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass

    def teardown(self) -> None:
        """Bounded straggler teardown: SIGTERM every live worker, give the
        group ``term_grace_s`` to exit, SIGKILL the survivors, and reap.
        A worker that installed a SIGTERM handler and never exits (or is
        wedged in a collective) is killed, not waited on forever."""
        self.terminate()
        deadline = time.monotonic() + self.term_grace_s
        for proc in self.procs:
            if proc.poll() is None:
                remaining = max(0.0, deadline - time.monotonic())
                try:
                    proc.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    pass
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:  # pragma: no cover - kernel
                    pass
        for thread in self._threads:
            thread.join(timeout=2)


# -- the plain (non-supervised) path -----------------------------------------


def _run_once(args, port: int) -> tuple[int, bool]:
    """Returns (exit code, saw-coordinator-error-signature)."""
    group = WorkerGroup(
        args.nproc, args.script, args.script_args, port,
        term_grace_s=args.term_grace,
    )
    rc = 1
    try:
        group.spawn()
        rc, _codes = group.wait(drain_grace_s=args.drain_grace)
    except KeyboardInterrupt:
        rc = 128 + signal.SIGINT
    finally:
        # Idempotent; runs on EVERY exit path — an unexpected exception
        # out of wait() (or a second Ctrl-C mid-unwind) must not leak
        # live worker processes.
        group.teardown()
    return rc, group.coord_error.is_set()


def _add_supervise_args(parser: argparse.ArgumentParser) -> None:
    sup = parser.add_argument_group(
        "supervision (--supervise)"
    )
    sup.add_argument("--supervise", action="store_true",
                     help="restart crashed worker generations from the last "
                     "good checkpoint; honor SIGTERM as a graceful drain")
    sup.add_argument("--max-restarts", type=int, default=16,
                     help="total restart budget (default: 16)")
    sup.add_argument("--backoff", type=float, default=0.5,
                     help="base backoff seconds between generations")
    sup.add_argument("--backoff-max", type=float, default=30.0,
                     help="backoff cap in seconds")
    sup.add_argument("--crash-loop", type=int, default=3,
                     help="consecutive no-progress failures before giving up")
    sup.add_argument("--min-procs", type=int, default=1,
                     help="floor for elastic degradation of -n")
    sup.add_argument("--degrade-after", type=int, default=2,
                     help="no-progress failures at one worker count before "
                     "retrying with one fewer process")
    sup.add_argument("--progress-grace", type=float, default=5.0,
                     help="a generation surviving this long counts as "
                     "progress even without a checkpoint advance")
    sup.add_argument("--drain-grace", type=float, default=60.0,
                     help="seconds workers get to drain after SIGTERM before "
                     "being killed (honored in plain mode too when a worker "
                     "drains on its own)")
    sup.add_argument("--ckpt-dir", default=None,
                     help="the training script's checkpoint output_dir — "
                     "the supervisor's progress/goodput probe")
    sup.add_argument("--state-dir", default=os.path.join("runs", "supervised"),
                     help="where supervisor.json is written "
                     "(default: runs/supervised)")
    sup.add_argument("--metrics-port", type=int, default=None,
                     help="mount the supervisor's own Prometheus /metrics "
                     "endpoint on this port (0 = ephemeral): restart and "
                     "per-generation goodput counters that survive worker "
                     "death")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rocket_tpu_torch.launch",
        description="Run a training script as N coordinated processes on "
        "this machine.",
    )
    parser.add_argument("-n", "--nproc", type=int, required=True,
                        help="number of processes")
    parser.add_argument("--coordinator-port", type=int, default=None,
                        help="default: a free localhost port")
    parser.add_argument("--term-grace", type=float, default=10.0,
                        help="seconds between SIGTERM and SIGKILL when "
                        "tearing down stragglers (default: 10)")
    _add_supervise_args(parser)
    parser.add_argument("script", help="python script to run")
    parser.add_argument("script_args", nargs=argparse.REMAINDER,
                        help="arguments passed through to the script")
    args = parser.parse_args(argv)
    if args.nproc < 1:
        parser.error("--nproc must be >= 1")

    if args.supervise:
        from rocket_tpu_torch.resilience.supervisor import RestartPolicy, Supervisor

        supervisor = Supervisor(
            args.nproc,
            args.script,
            args.script_args,
            policy=RestartPolicy(
                max_restarts=args.max_restarts,
                backoff_base_s=args.backoff,
                backoff_max_s=args.backoff_max,
                crash_loop_threshold=args.crash_loop,
                min_procs=args.min_procs,
                degrade_after=args.degrade_after,
                progress_grace_s=args.progress_grace,
            ),
            state_dir=args.state_dir,
            ckpt_dir=args.ckpt_dir,
            coordinator_port=args.coordinator_port,
            term_grace_s=args.term_grace,
            drain_grace_s=args.drain_grace,
            metrics_port=args.metrics_port,
        )
        supervisor.install_signal_handlers()
        return supervisor.run()

    for attempt in range(_MAX_PORT_RETRIES + 1):
        port = args.coordinator_port or _free_port()
        started = time.monotonic()
        rc, coord_error = _run_once(args, port)
        fast_failure = rc != 0 and time.monotonic() - started < _STARTUP_WINDOW_S
        if rc == 128 + signal.SIGINT or rc < 0:
            # User interrupt / signal-killed worker (segfault, OOM kill):
            # never a coordinator-port race — don't re-run.
            break
        if rc == 0 or args.coordinator_port or not fast_failure or not coord_error:
            # Re-running is only safe when the failure is OURS: a fast exit
            # WITH a coordinator bind/connect signature in the output. A
            # deterministic user failure (import error, assertion) must not
            # be executed again — it would repeat its side effects.
            if rc != 0 and fast_failure and not coord_error:
                # A missed signature stays diagnosable: if this was a port
                # race whose text the regex does not know, the operator
                # sees why no retry happened.
                sys.stderr.write(
                    "launch: fast failure without a coordinator-error "
                    "signature in worker output — not retrying (pass "
                    "--coordinator-port to pin, or report the failure "
                    "text if this was a port race)\n"
                )
            break
        if attempt < _MAX_PORT_RETRIES:
            sys.stderr.write(
                f"launch: coordinator startup failure on port {port} "
                f"within {_STARTUP_WINDOW_S:.0f}s — retrying on a new port\n"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
