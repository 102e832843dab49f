"""Checkpointer capsule — periodic save, resume, selective capsule restore
(counterpart of ``rocket_tpu/core/checkpoint.py``).

* priority ``PRIORITY_CHECKPOINT`` (100): near-last in the iteration wave;
* ``setup()`` resumes from ``resume_from`` — a step directory, or
  ``"latest"``: the newest complete step under ``output_dir`` (torn steps
  are skipped with a warning; none at all starts fresh);
  ``resume_capsules=False`` restores the model state only;
* ``launch()`` counts iterations and saves every ``save_every`` into
  ``output_dir/<iter_idx>/``; ``keep_last`` prunes the oldest step
  directories inside the write job, after the new step is on disk;
  ``overwrite=False`` refuses an existing step directory;
* state: ``iter_idx`` and ``saved_steps``.

Layout per step, the reference's: ``model_{k}/`` for each prepared model
(``checkpoint_io``: ``index.json`` + ``shard_p{rank}.npz`` of
``PreparedModule.checkpoint_state()``), ``capsules.pkl`` (the stateful
capsules' states in setup order) and ``rng.json`` (the runtime's seed
counter), written last: its presence marks a complete step
(``resilience.supervisor.is_complete_checkpoint``, which also wants
every shard file the index names).

Over several processes every rank runs the save path: each writes the
chunks it owns (the shards of a sharded layout; process 0 the whole
tensors), and only the main process writes the index, ``capsules.pkl``,
``rng.json`` and ``drain.json`` and prunes; the barriers before a
snapshot and at ``destroy`` are global. ``resume_from="latest"`` resumes
the step the main process chose, broadcast to every rank (a stale view
of the directory elsewhere cannot pick another). A restore reads every
chunk and each rank keeps its part (any process count reads any
other's). The emergency and drain saves stay barrier-free, one shard
file per rank.

Saves are non-blocking: the device-to-host snapshot is synchronous, the
file writes run on a background thread, drained by the next save and by
``destroy``. Each save's times, and the array bytes this rank wrote, are
kept in :attr:`Checkpointer.save_times`.
``capsules.pkl`` is pickle: resume only from checkpoints you wrote.

With the health sentinels on, the Checkpointer attaches itself to the
flight recorder at ``setup`` (and detaches at ``destroy``): a black-box
bundle then carries an emergency checkpoint (:meth:`Checkpointer.
save_emergency`) that ``resume_from=<bundle>/checkpoint`` restores. With
telemetry on, saves, the async writer's drain and loads are ``checkpoint``
spans. A snapshot reads the card on the host by design, so it runs through
the explicit-transfer helper (legal under strict mode).

The drain save (:meth:`Checkpointer.save_drain`) is what a Looper writes
when it honours a SIGTERM: synchronous and barrier-free, capsule states
included, into the numbered step layout (so ``resume_from="latest"``
finds it) with a ``drain.json`` marker. Every live Checkpointer is in the
runtime's ``checkpointers`` registry from ``setup`` to ``destroy``, so a
drain in a phase without one saves through another phase's.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Optional

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import PRIORITY_CHECKPOINT, Capsule
from rocket_tpu_torch.resilience.supervisor import is_complete_checkpoint, newest_complete_step
from rocket_tpu_torch.runtime import checkpoint_io, explicit_transfer

__all__ = ["Checkpointer"]


class Checkpointer(Capsule):
    def __init__(self, output_dir: str = "checkpoints", save_every: int = 1000,
                 resume_from: Optional[str] = None, resume_capsules: bool = True,
                 keep_last: Optional[int] = None, overwrite: bool = True,
                 statefull: bool = True, priority: int = PRIORITY_CHECKPOINT,
                 runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        self._output_dir = output_dir
        self._save_every = save_every
        self._resume_from = resume_from
        self._resume_capsules = resume_capsules
        self._keep_last = keep_last
        self._overwrite = overwrite
        self._iter_idx = 0
        self._saved_steps: list[int] = []
        self._writer = checkpoint_io.AsyncWriter()
        #: One dict per save: ``step``, ``snapshot_s`` (the synchronous
        #: device-to-host pull) and, once the write job ends, ``write_s``.
        self.save_times: list[dict] = []

    # -- events ------------------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        registry = getattr(self._runtime, "checkpointers", None)
        if registry is not None and not any(c is self for c in registry):
            registry.append(self)  # the drain path's Runtime-wide view
        flight = getattr(self._runtime, "flight", None)
        if flight is not None:
            flight.attach_checkpointer(self)  # the black box's emergency writer
        if self._resume_from:
            path = self._resolve_resume_path(self._resume_from)
            if path is not None:
                with self._runtime.telemetry.span("checkpoint/load", cat="checkpoint"):
                    self._load(path)

    def _resolve_resume_path(self, path: str) -> Optional[str]:
        """``"latest"``: the newest complete step under ``output_dir``, or
        None (a fresh start, logged) when there is none; any other path is
        returned as given."""
        if path != "latest":
            return path
        step = newest_complete_step(self._output_dir)
        chosen = -1 if step is None else step
        if os.path.isdir(self._output_dir):
            for skipped in sorted((int(d) for d in os.listdir(self._output_dir) if d.isdigit()),
                                  reverse=True):
                if skipped <= chosen:
                    break
                self.log_warning("skipping incomplete checkpoint "
                                 f"{os.path.join(self._output_dir, str(skipped))}")
        if self._runtime is not None:  # every rank restores the main process's choice
            chosen = self._runtime.broadcast_int(chosen)
        if chosen < 0:
            self.log_info(f"resume_from='latest': no complete checkpoint under "
                          f"{self._output_dir!r} — starting fresh.")
            return None
        return os.path.join(self._output_dir, str(chosen))

    def launch(self, attrs: Attributes | None = None) -> None:
        self._iter_idx += 1
        if self._iter_idx % self._save_every != 0:
            return
        self.save()

    # -- save --------------------------------------------------------------

    def save(self, step: Optional[int] = None) -> str:
        """Write one checkpoint directory (asynchronously); returns its path."""
        step = self._iter_idx if step is None else step
        with self._runtime.telemetry.span(f"checkpoint/save[{step}]", cat="checkpoint"):
            return self._save(step)

    def _save(self, step: int) -> str:
        runtime = self._runtime
        path = os.path.join(self._output_dir, str(step))
        if not self._overwrite and os.path.exists(path):
            raise RuntimeError(f"Checkpointer: overwrite is set to False. {path}")
        # Backpressure: one write in flight, and the previous step is on
        # disk before this one starts, so keep_last prunes safely.
        self._writer.wait()
        # Recorded before the capsule states are taken, so this step's own
        # entry survives a resume and is pruned later.
        self._saved_steps.append(step)
        runtime.wait_for_everyone()
        main = runtime.is_main_process
        t0 = time.perf_counter()
        with explicit_transfer():
            plans = [checkpoint_io.snapshot(prepared.checkpoint_state(), runtime.process_index)
                     for prepared in runtime.models.values()]
            capsule_states = ([obj.state_dict() for obj in runtime.checkpoint_stack]
                              if main else None)
        rng_state = runtime.rng_state_dict()
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0,
                  "shard_bytes": sum(a.nbytes for plan in plans for a in plan["local"].values())}
        self.save_times.append(timing)
        prune = []
        if self._keep_last is not None:
            while len(self._saved_steps) > self._keep_last:
                old = os.path.join(self._output_dir, str(self._saved_steps.pop(0)))
                if main:
                    prune.append(old)

        def write():
            t1 = time.perf_counter()
            for k, plan in enumerate(plans):
                checkpoint_io.write_snapshot(os.path.join(path, f"model_{k}"), plan)
            if main:
                checkpoint_io.atomic_write(os.path.join(path, "capsules.pkl"),
                                           pickle.dumps(capsule_states))
                checkpoint_io.atomic_write(os.path.join(path, "rng.json"),
                                           json.dumps(rng_state).encode("utf-8"))
            for old in prune:
                shutil.rmtree(old, ignore_errors=True)
            timing["write_s"] = time.perf_counter() - t1

        self._writer.submit(write)
        self.log_info(f"saving checkpoint at {path} (async)")
        return path

    def destroy(self, attrs: Attributes | None = None) -> None:
        """Drain the async writer, detach from the flight recorder, then the
        usual teardown."""
        runtime = self._runtime
        if runtime is not None:
            registry = getattr(runtime, "checkpointers", None)
            if registry is not None and any(c is self for c in registry):
                registry.remove(self)
            flight = getattr(runtime, "flight", None)
            if flight is not None:
                flight.detach_checkpointer(self)
            with runtime.telemetry.span("checkpoint/drain", cat="checkpoint"):
                self._writer.wait()
            runtime.wait_for_everyone()
        else:
            self._writer.wait()
        super().destroy(attrs)

    def save_emergency(self, path: str, include_capsules: bool = False) -> str:
        """A synchronous dump of every prepared model's state into ``path``
        (the flight recorder's bundle), in the step layout ``resume_from``
        reads: ``model_{k}/`` then ``rng.json``, its completeness marker. Not
        :meth:`save`: no barrier, no background writer (the process may be
        about to die), no pruning. ``include_capsules`` (the drain, between
        waves, where the host state is consistent) also writes
        ``capsules.pkl``, so the loop's position resumes exactly; a crash
        dump leaves it out. Under a gated anomaly action the state is the
        last finite one: the anomalous update was held."""
        runtime = self._runtime
        main = runtime.is_main_process
        with explicit_transfer():
            plans = [checkpoint_io.snapshot(prepared.checkpoint_state(), runtime.process_index)
                     for prepared in runtime.models.values()]
            capsule_states = ([obj.state_dict() for obj in runtime.checkpoint_stack]
                              if include_capsules and main else None)
        for k, plan in enumerate(plans):
            checkpoint_io.write_snapshot(os.path.join(path, f"model_{k}"), plan)
        if capsule_states is not None:
            checkpoint_io.atomic_write(os.path.join(path, "capsules.pkl"),
                                       pickle.dumps(capsule_states))
        if main:
            checkpoint_io.atomic_write(os.path.join(path, "rng.json"),
                                       json.dumps(runtime.rng_state_dict()).encode("utf-8"))
        return path

    def save_drain(self) -> str:
        """The drain checkpoint (reference ``checkpoint.py:301-340``): the
        Looper's call at a wave boundary after a drain request. Synchronous
        and barrier-free, capsule states included, into the numbered step
        directory of this iteration, so ``resume_from="latest"`` finds it.
        The step joins ``saved_steps`` before the capsule states are taken,
        so a resumed run's ``keep_last`` rotation prunes it like a periodic
        save. A step a complete periodic save already holds is not written
        again, but ``drain.json`` is written either way: it is the record
        that a drain happened there. Returns the step directory."""
        step = self._iter_idx
        path = os.path.join(self._output_dir, str(step))
        self._writer.wait()  # no interleaving with a periodic save's writes
        if step not in self._saved_steps:
            self._saved_steps.append(step)
        t0 = time.perf_counter()
        if not is_complete_checkpoint(path):
            with self._runtime.telemetry.span(f"checkpoint/drain[{step}]", cat="checkpoint"):
                self.save_emergency(path, include_capsules=True)
            self.log_info(f"drain checkpoint written at {path}")
        self.save_times.append({"step": step, "drain_s": time.perf_counter() - t0})
        if self._runtime.is_main_process:
            checkpoint_io.atomic_write(os.path.join(path, "drain.json"), json.dumps(
                {"reason": "drain", "step": step, "unix": time.time()}).encode("utf-8"))
        return path

    # -- restore -----------------------------------------------------------

    def _load(self, path: str) -> None:
        runtime = self._runtime
        if not os.path.isdir(path):
            raise RuntimeError(f"Checkpointer: resume_from {path!r} does not exist.")
        for k, prepared in enumerate(runtime.models.values()):
            model_path = os.path.join(path, f"model_{k}")
            if os.path.isdir(model_path):
                flat = checkpoint_io.load_pytree(model_path)
                if "ema_params" in prepared.state:
                    flat = checkpoint_io.seed_optional(flat, model_path)
                prepared.load_checkpoint_state(checkpoint_io.unflatten(flat))
            else:
                self.log_warning(f"checkpoint {path} has no model_{k} — model state NOT "
                                 "restored.")
        rng_path = os.path.join(path, "rng.json")
        if os.path.exists(rng_path):
            with open(rng_path, "r", encoding="utf-8") as f:
                runtime.load_rng_state_dict(json.load(f))
        if self._resume_capsules:
            capsule_path = os.path.join(path, "capsules.pkl")
            if os.path.exists(capsule_path):
                with open(capsule_path, "rb") as f:
                    capsule_states = pickle.load(f)
                stack = runtime.checkpoint_stack
                if len(capsule_states) != len(stack):
                    self.log_warning(f"capsule count mismatch: checkpoint has "
                                     f"{len(capsule_states)}, tree has {len(stack)}; restoring "
                                     "the common prefix.")
                for obj, state in zip(stack, capsule_states):
                    obj.load_state_dict(state)
        self.log_info(f"resumed from {path}")

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"iter_idx": self._iter_idx, "saved_steps": list(self._saved_steps)}

    def load_state_dict(self, state: dict) -> None:
        self._iter_idx = int(state["iter_idx"])
        self._saved_steps = [int(s) for s in state.get("saved_steps", [])]
