"""ServeEngine — the user-facing serving facade (counterpart of
``rocket_tpu/serve/api.py``).

``submit()`` enqueues a request (token ids, or text with a tokenizer),
``step()`` advances the engine one scheduling round, ``stream()`` yields a
request's output incrementally (detokenized when possible) and
``report()`` summarises latency and throughput.

The serve half of the ops plane: an attached
:class:`~rocket_tpu_torch.obs.telemetry.Telemetry` gets the ``serve/*``
gauges (slots, pool, queue depth, the step functions built once) and
histograms (``serve/ttft_s``, ``serve/itl_s``, the per-request phases)
in its registry and one span per finished request (category ``serve``);
the per-request :class:`~rocket_tpu_torch.obs.reqtrace.RequestTracer`
(``ServeConfig.reqtrace``, on by default) records every request's
timeline, exposed as ``telemetry.reqtrace`` for the exporter to flush;
:meth:`ServeEngine.capture_trace` opens a windowed ``torch.profiler``
trace over engine ticks, each traced tick under a ``serve_tick#N``
``record_function`` range (``obs/prof.py`` parses it). None of it adds a
host sync to a tick.

Sizing defaults: the pool holds ``max_slots`` full-length sequences plus
the reserved trash block, so the engine never preempts unless
``num_blocks`` is set smaller.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Union

import numpy as np
import torch

from rocket_tpu_torch.models.sampling import seed_from
from rocket_tpu_torch.serve.engine import SlotEngine
from rocket_tpu_torch.serve.kv_pool import BlockAllocator, KVPoolSpec
from rocket_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "ServeEngine", "StreamDetokenizer"]


@dataclass
class ServeConfig:
    """Engine sizing. ``None`` fields derive from the model config."""

    max_slots: int = 8
    block_len: int = 16
    #: Pool blocks INCLUDING the reserved trash block 0. Default: every
    #: slot at full context; set smaller to exercise eviction.
    num_blocks: Optional[int] = None
    #: Longest context (prompt + generation) of one request; default the
    #: model's max_seq_len.
    max_model_len: Optional[int] = None
    prefill_chunk: int = 16
    #: Pool dtype; default the model's activation dtype (or float32).
    dtype: Optional[str] = None
    #: Decode waves per dispatch (k): one host transfer per k tokens per
    #: slot, at the cost of up to k-1 wave times of TTFT.
    decode_waves_per_dispatch: int = 1
    #: Finished Request records kept for ``result()``/``stream()``; the
    #: oldest beyond this are dropped (``release()`` drops one eagerly).
    max_completed_requests: int = 4096
    #: Per-request timeline tracing (``obs/reqtrace.py``): on by default;
    #: host dict work at existing tick boundaries, no device sync.
    reqtrace: bool = True

    def resolve(self, model_config) -> tuple:
        """``(pool_spec, max_blocks_per_seq, num_blocks, waves_per_dispatch)``."""
        mc = model_config
        max_len = self.max_model_len or mc.max_seq_len
        if max_len > mc.max_seq_len:
            raise ValueError(
                f"ServeConfig.max_model_len {max_len} exceeds the model's "
                f"max_seq_len {mc.max_seq_len}"
            )
        waves = int(self.decode_waves_per_dispatch)
        if waves < 1:
            raise ValueError(f"ServeConfig.decode_waves_per_dispatch {waves} < 1")
        mb = -(-max_len // self.block_len)
        num_blocks = self.num_blocks or (1 + self.max_slots * mb)
        spec = KVPoolSpec(
            num_layers=mc.num_layers,
            num_blocks=num_blocks,
            block_len=self.block_len,
            num_kv_heads=mc.num_kv_heads or mc.num_heads,
            head_dim=mc.dim // mc.num_heads,
            dtype=self.dtype or mc.activation_dtype or "float32",
        )
        return spec, mb, num_blocks, waves


class StreamDetokenizer:
    """Incremental detokenization for one stream: push token ids, get the
    NEW text suffix (re-decodes the running list; decoders may merge
    across token boundaries)."""

    def __init__(self, tokenizer) -> None:
        self._tokenizer = tokenizer
        self._tokens: list = []
        self._emitted = 0

    def push(self, token: int) -> str:
        self._tokens.append(int(token))
        text = self._tokenizer.decode(self._tokens)
        out = text[self._emitted:]
        self._emitted = len(text)
        return out


def _percentiles(values: list, qs=(0.5, 0.9, 0.99)) -> Optional[dict]:
    if not values:
        return None
    arr = np.sort(np.asarray(values, np.float64))
    out = {f"p{int(q * 100)}": float(np.quantile(arr, q)) for q in qs}
    out["mean"] = float(arr.mean())
    out["count"] = int(arr.size)
    return out


class ServeEngine:
    """Continuous-batching serving of one model and param tree.

    ``device`` defaults to the GPU (``runtime.resolve_device``);
    ``generator`` (a ``torch.Generator``) seeds the sampling draws (seed 0
    when None). ``telemetry``: an enabled Telemetry gets the serve gauges,
    histograms and request spans; None keeps the engine obs-free. The
    engine never writes the telemetry's files: its caller decides when."""

    def __init__(self, model, params, config: Optional[ServeConfig] = None, *,
                 tokenizer=None, telemetry=None, generator: Optional[torch.Generator] = None,
                 device=None) -> None:
        cfg = config or ServeConfig()
        spec, mb, num_blocks, waves = cfg.resolve(model.config)
        self.config = cfg
        self.engine = SlotEngine(
            model, params, spec,
            max_slots=cfg.max_slots,
            max_blocks_per_seq=mb,
            prefill_chunk=cfg.prefill_chunk,
            waves_per_dispatch=waves,
            seed=seed_from(generator) if generator is not None else 0,
            device=device,
        )
        self.scheduler = Scheduler(self.engine, BlockAllocator(num_blocks))
        self.tokenizer = tokenizer
        self.telemetry = telemetry
        #: The per-request timeline recorder (None with ``reqtrace`` off),
        #: also ``telemetry.reqtrace`` so the exporter flushes it.
        self.tracer = None
        if cfg.reqtrace:
            from rocket_tpu_torch.obs.reqtrace import RequestTracer

            self.tracer = RequestTracer(max_records=max(cfg.max_completed_requests, 1))
            self.scheduler.tracer = self.tracer
            if telemetry is not None and telemetry.enabled:
                telemetry.reqtrace = self.tracer
        #: Serialises submit/step/release/report: concurrent ``stream()``
        #: readers each drive ``step()``, and the host mirrors must never
        #: interleave with a dispatch in flight.
        self._lock = threading.Lock()
        self.requests: dict = {}
        self._finished_order: list = []
        self._ttft: list = []
        self._itl: list = []
        self._latency_cap = 200_000
        self._last_emit: dict = {}
        self._first_wave_at: Optional[float] = None
        self._last_event_at: Optional[float] = None
        self._occupancy_sum = 0
        self._ticks = 0
        # Host time inside step() on ticks that harvested, vs the part of it
        # blocked on the device: their difference overlapped the device.
        self._step_wall_s = 0.0
        self._base_harvest_wait_s = 0.0
        self._base_device_gets = 0
        self._base_dispatches = 0
        # The windowed device trace (obs/prof.TraceSession), armed by
        # capture_trace() and driven tick by tick inside step().
        self._trace_window: Optional[tuple] = None
        self._trace_session = None
        #: The last closed window's Chrome trace (``python -m
        #: rocket_tpu_torch.obs prof`` renders it).
        self.trace_file: Optional[str] = None

    # -- intake ------------------------------------------------------------

    def submit(self, prompt: Union[str, np.ndarray, list], *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, eos_token_id: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. Refusals count in
        ``report()["requests"]["rejected"]`` before re-raising."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                with self._lock:
                    self._reject_locked()
                raise ValueError("ServeEngine.submit: text prompt needs a tokenizer")
            prompt = self.tokenizer.encode(prompt)
        req = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_token_id=eos_token_id,
        )
        with self._lock:
            try:
                rid = self.scheduler.submit(req)
            except ValueError:
                self._reject_locked()
                raise
            self.requests[rid] = req
            # Queue depth at submit granularity: a burst between ticks is
            # visible to a scrape.
            self._publish_queue_locked()
        return rid

    def _reject_locked(self) -> None:
        self.scheduler.rejected += 1
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.registry.counter("serve/rejected_requests").inc()
            self._publish_queue_locked()

    def _publish_queue_locked(self) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.registry.gauge("serve/queue_depth").set(self.scheduler.queue_depth)

    # -- stepping ----------------------------------------------------------

    def step(self) -> list:
        """One scheduling round, recording latency metrics.

        With ``decode_waves_per_dispatch`` > 1 a request's k tokens of one
        dispatch land in one harvest, so inter-token latency is amortised:
        each of the n tokens a request receives this step contributes
        ``(now - previous emit) / n``; a request's first batch contributes
        only its TTFT."""
        with self._lock:
            self._trace_poll_locked()
            t0 = time.perf_counter()
            gets_before = self.engine.device_gets
            traced = self._trace_session is not None and self._trace_session.active
            if self.tracer is not None:
                # While a window is open the tick's wave record carries its
                # annotation's step id (the join to its device slices).
                self.tracer.trace_step = self._ticks if traced else None
            if traced:
                with torch.profiler.record_function(f"serve_tick#{self._ticks}"):
                    events = self.scheduler.tick()
            else:
                events = self.scheduler.tick()
            self._ticks += 1
            self._occupancy_sum += self.scheduler.active_slots
            now = time.perf_counter()
            if self.engine.device_gets > gets_before:
                self._step_wall_s += now - t0
            if events:
                if self._first_wave_at is None:
                    self._first_wave_at = now
                self._last_event_at = now
            batch: dict = {}
            for ev in events:
                batch[ev.request.id] = batch.get(ev.request.id, 0) + 1
            seen: dict = {}
            for ev in events:
                req = ev.request
                prev = self._last_emit.get(req.id)
                first_of_batch = req.id not in seen
                seen[req.id] = seen.get(req.id, 0) + 1
                if prev is None:
                    if first_of_batch:
                        self._ttft.append(req.first_token_at - req.submitted_at)
                else:
                    itl = (now - prev) / batch[req.id]
                    self._itl.append(itl)
                    if self.telemetry is not None and self.telemetry.enabled:
                        # What /metrics and the ITL p99 SLO watch live.
                        self.telemetry.registry.histogram("serve/itl_s", base=1e-6).observe(itl)
                if ev.finished:
                    self._last_emit.pop(req.id, None)
                    self._finish_span(req)
                    self._retire_locked(req.id)
                elif seen[req.id] == batch[req.id]:
                    self._last_emit[req.id] = now
            del self._ttft[:-self._latency_cap]
            del self._itl[:-self._latency_cap]
            self._publish()
            return events

    def _retire_locked(self, rid: int) -> None:
        """Keep the newest ``max_completed_requests`` finished records."""
        self._finished_order.append(rid)
        cap = max(self.config.max_completed_requests, 0)
        while len(self._finished_order) > cap:
            old = self._finished_order.pop(0)
            self.requests.pop(old, None)
            if self.tracer is not None:
                # The finished record was queued for persistence at finish;
                # only the in-memory copy goes.
                self.tracer.release(old)

    def release(self, rid: int) -> None:
        """Drop a finished request's record eagerly."""
        with self._lock:
            req = self.requests.get(rid)
            if req is not None and not req.finished:
                raise ValueError(f"ServeEngine.release: request {rid} still live")
            self.requests.pop(rid, None)
            if rid in self._finished_order:
                self._finished_order.remove(rid)
            if self.tracer is not None:
                self.tracer.release(rid)

    # -- windowed device-trace capture -------------------------------------

    def capture_trace(self, window, trace_dir: str) -> None:
        """Arm a windowed device trace over engine ticks: ``window`` is
        ``(start, stop)`` tick indices (or ``"A:B"``); the ``torch.profiler``
        window opens before tick ``start`` and closes before tick
        ``stop`` (or at :meth:`finish_trace`), each traced tick inside a
        ``serve_tick#N`` range."""
        from rocket_tpu_torch.obs.prof import TraceSession, parse_step_window

        if isinstance(window, str):
            window = parse_step_window(window)
        start, stop = int(window[0]), int(window[1])
        if start < 0 or stop <= start:
            raise ValueError(f"capture_trace: window {window!r} needs 0 <= start < stop")
        with self._lock:
            self._trace_window = (start, stop)
            self._trace_session = TraceSession(trace_dir)

    @property
    def trace_session(self):
        """The armed :class:`~rocket_tpu_torch.obs.prof.TraceSession`, or None."""
        return self._trace_session

    def _trace_poll_locked(self) -> None:
        """Open or close the armed window for the tick about to run."""
        if self._trace_session is None:
            return
        start, stop = self._trace_window
        if self._trace_session.active:
            if self._ticks >= stop:
                self.trace_file = self._trace_session.stop()
        elif start <= self._ticks < stop:
            self._trace_session.start()

    def finish_trace(self) -> Optional[str]:
        """Close a still-open window (the engine drained before its stop
        tick); returns the trace file."""
        with self._lock:
            if self._trace_session is not None and self._trace_session.active:
                self.trace_file = self._trace_session.stop()
            return self.trace_file

    def drain(self, max_ticks: int = 100_000) -> list:
        """Step until every submitted request completed."""
        events = []
        for _ in range(max_ticks):
            if self.scheduler.idle:
                self.finish_trace()
                return events
            events.extend(self.step())
        raise RuntimeError(f"ServeEngine.drain: not idle after {max_ticks} ticks")

    def stream(self, rid: int, max_ticks: int = 100_000) -> Iterator:
        """Yield request ``rid``'s output incrementally — text pieces with a
        tokenizer, token ids without — stepping the engine while it runs."""
        req = self.requests[rid]
        detok = StreamDetokenizer(self.tokenizer) if self.tokenizer is not None else None
        emitted = 0
        for _ in range(max_ticks):
            while emitted < len(req.tokens):
                tok = req.tokens[emitted]
                emitted += 1
                yield detok.push(tok) if detok is not None else tok
            if req.finished:
                if self.tracer is not None:
                    self.tracer.on_detokenize(rid, time.perf_counter())
                return
            if self.scheduler.idle:
                raise RuntimeError(f"ServeEngine.stream: engine idle but request {rid} unfinished")
            self.step()
        raise RuntimeError(f"ServeEngine.stream: no finish in {max_ticks} ticks")

    def result(self, rid: int) -> Request:
        return self.requests[rid]

    def text(self, rid: int) -> str:
        if self.tokenizer is None:
            raise ValueError("ServeEngine.text: no tokenizer attached")
        return self.tokenizer.decode(self.requests[rid].tokens)

    # -- observability -----------------------------------------------------

    def _finish_span(self, req: Request) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.spans.add(f"serve/request[{req.id}]", "serve", req.submitted_at,
                      req.finished_at - req.submitted_at)
        reg = tel.registry
        reg.histogram("serve/ttft_s", base=1e-4).observe(req.first_token_at - req.submitted_at)
        if self.tracer is not None:
            phases = self.tracer.phases(req.id)
            if phases is not None:
                # Where request wall time went, fleet-wide.
                reg.histogram("serve/queue_wait_s", base=1e-6).observe(phases["queue_s"])
                reg.histogram("serve/prefill_s", base=1e-6).observe(phases["prefill_s"])
                reg.histogram("serve/decode_s", base=1e-6).observe(phases["decode_s"])
                if phases["preempted_s"] > 0:
                    reg.histogram("serve/preempted_s", base=1e-6).observe(phases["preempted_s"])

    def _publish(self) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        reg, sched, eng = tel.registry, self.scheduler, self.engine
        reg.gauge("serve/slots_active").set(sched.active_slots)
        reg.gauge("serve/queue_depth").set(sched.queue_depth)
        reg.gauge("serve/blocks_free_fraction").set(sched.allocator.free_fraction)
        reg.gauge("serve/kv_pool_bytes").set(eng.spec.pool_bytes)
        reg.gauge("serve/tokens_generated").set(sched.tokens_generated)
        reg.gauge("serve/requests_completed").set(sched.completed)
        reg.gauge("serve/preemptions").set(sched.preemptions)
        # The step functions built once for the engine's lifetime.
        reg.gauge("serve/decode_traces").set(eng.decode_traces)
        reg.gauge("serve/prefill_traces").set(eng.prefill_traces)
        reg.gauge("serve/decode_dispatches").set(eng.decode_dispatches)
        reg.gauge("serve/device_gets").set(eng.device_gets)

    # -- metrics -----------------------------------------------------------

    def reset_metrics(self) -> None:
        """Zero the latency/throughput aggregates (e.g. after a warmup
        ``drain()``) so the report describes the steady state; the
        registry's ``serve/*`` metrics are windowed alike. Call while
        idle."""
        with self._lock:
            self._ttft.clear()
            self._itl.clear()
            if self.telemetry is not None and self.telemetry.enabled:
                self.telemetry.registry.reset("serve/")
            self._first_wave_at = None
            self._last_event_at = None
            self._occupancy_sum = 0
            self._ticks = 0
            self._step_wall_s = 0.0
            self._base_harvest_wait_s = self.engine.harvest_wait_s
            self._base_device_gets = self.engine.device_gets
            self._base_dispatches = self.engine.decode_dispatches
            sched = self.scheduler
            sched.submitted = sched.queue_depth + sched.active_slots
            sched.completed = 0
            sched.preemptions = 0
            sched.tokens_generated = 0
            sched.rejected = 0

    def report(self) -> dict:
        """Latency/throughput summary since construction or the last
        :meth:`reset_metrics`."""
        with self._lock:
            eng, sched = self.engine, self.scheduler
            busy = None
            if self._first_wave_at is not None and self._last_event_at is not None:
                busy = max(self._last_event_at - self._first_wave_at, 1e-9)
            dispatches = eng.decode_dispatches - self._base_dispatches
            wait = eng.harvest_wait_s - self._base_harvest_wait_s
            return {
                "requests": {
                    "submitted": sched.submitted,
                    "completed": sched.completed,
                    "queued": sched.queue_depth,
                    "preemptions": sched.preemptions,
                    "rejected": sched.rejected,
                },
                "tokens_generated": sched.tokens_generated,
                "tokens_per_sec": None if busy is None else sched.tokens_generated / busy,
                "time_to_first_token_s": _percentiles(self._ttft),
                "inter_token_latency_s": _percentiles(self._itl),
                "compiled": {
                    "decode_traces": eng.decode_traces,
                    "prefill_traces": eng.prefill_traces,
                    "decode_waves": eng.decode_waves,
                    "prefill_chunks": eng.prefill_chunks,
                },
                "dispatch": {
                    "waves_per_dispatch": eng.waves_per_dispatch,
                    "decode_dispatches": dispatches,
                    "device_get_count": eng.device_gets - self._base_device_gets,
                    "tokens_per_dispatch": (
                        round(sched.tokens_generated / dispatches, 3) if dispatches else None
                    ),
                    "harvest_wait_s": round(wait, 6),
                    "host_overlap_fraction": (
                        round(max(0.0, 1.0 - wait / self._step_wall_s), 4)
                        if self._step_wall_s > 0 else None
                    ),
                },
                # The retained requests' phase breakdown and ITL-gap
                # attribution (None with reqtrace off or nothing finished).
                "phases": self.tracer.aggregate() if self.tracer is not None else None,
                "pool": {
                    "num_blocks": eng.spec.num_blocks,
                    "block_len": eng.spec.block_len,
                    "block_bytes": eng.spec.block_bytes,
                    "kv_pool_bytes": eng.spec.pool_bytes,
                    "free_fraction": sched.allocator.free_fraction,
                },
                "slots": {
                    "max_slots": eng.max_slots,
                    "occupancy_mean": self._occupancy_sum / self._ticks if self._ticks else 0.0,
                },
                "device": str(eng.device),
            }
