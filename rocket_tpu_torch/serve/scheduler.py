"""Continuous-batching request scheduler — the host-side policy half
(counterpart of ``rocket_tpu/serve/scheduler.py``; host numpy only).

Every ``tick()`` is one serving step, pipelined against the in-flight
device dispatch:

1. **admit** queued requests into free slots while the block pool covers
   their prompts (all-or-nothing);
2. **prefill** one fixed-size chunk of the oldest still-prefilling slot
   (chunked prefill interleaves with decode and never stalls it);
3. **harvest** the PREVIOUS tick's decode dispatch (the one host transfer
   per dispatch): emitted tokens stream out, finished slots free their
   blocks;
4. **grow** each decode-ready slot's block table to cover the next k
   tokens; when the pool is exhausted the YOUNGEST active request is
   evicted — its blocks return to the pool and it re-queues at the FRONT
   with its generated tokens folded into the prompt, resuming where it
   stopped after re-prefill. Eviction runs after harvest, so no evicted
   slot has tokens in flight;
5. **dispatch** the next k-wave decode and return step 3's events.

The scheduler owns fixed-shape numpy mirrors of every per-slot input of
the decode step; between a dispatch and its harvest it only touches slots
the dispatch did not run.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rocket_tpu_torch.serve.engine import SlotEngine
from rocket_tpu_torch.serve.kv_pool import BlockAllocator

__all__ = ["Request", "TickEvent", "Scheduler"]


@dataclass
class Request:
    """One generation request plus its lifecycle record."""

    prompt: np.ndarray                       # (P,) int32, P >= 1
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: Optional[int] = None              # None/0 = off
    top_p: Optional[float] = None            # None/1.0 = off
    eos_token_id: Optional[int] = None       # None = no EOS
    id: int = -1                             # assigned at submit()
    tokens: list = field(default_factory=list)   # generated so far
    preemptions: int = 0
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.finished_at is not None


@dataclass(frozen=True)
class TickEvent:
    """One emitted token (``finished`` marks the request's last)."""

    request: Request
    token: int
    finished: bool


class _Slot:
    """Per-slot bookkeeping while a request occupies the wave."""

    __slots__ = ("req", "blocks", "ctx", "prefill_pos", "admit_order")

    def __init__(self, req: Request, blocks: list, ctx: np.ndarray, admit_order: int) -> None:
        self.req = req
        self.blocks = blocks
        #: Prompt + tokens generated before a preemption: what (re-)prefills.
        self.ctx = ctx
        self.prefill_pos = 0
        self.admit_order = admit_order

    @property
    def prefill_done(self) -> bool:
        # Prefill covers [0, P-1); the LAST context token goes through the
        # decode wave, which writes its KV row and yields the next logits.
        return self.prefill_pos >= len(self.ctx) - 1


class Scheduler:
    def __init__(self, engine: SlotEngine, allocator: Optional[BlockAllocator] = None) -> None:
        self.engine = engine
        self.allocator = allocator or BlockAllocator(engine.spec.num_blocks)
        s, mb = engine.max_slots, engine.max_blocks_per_seq
        self.block_len = engine.spec.block_len
        self.max_context = mb * self.block_len
        # Host mirrors of the wave inputs — fixed shape and dtype.
        self.block_table = np.zeros((s, mb), np.int32)
        self.lengths = np.zeros((s,), np.int32)
        self.last_tok = np.zeros((s,), np.int32)
        self.limits = np.zeros((s,), np.int32)
        self.temp = np.zeros((s,), np.float32)
        self.top_k = np.zeros((s,), np.int32)
        self.top_p = np.ones((s,), np.float32)
        self.eos = np.full((s,), -1, np.int32)
        self.seeds = np.zeros((s,), np.int32)
        self.slots: list = [None] * s
        self.queue: deque = deque()
        #: The in-flight decode dispatch, harvested at the next tick.
        self.pending = None
        self._next_id = 0
        self._admit_seq = 0
        self.submitted = 0
        self.completed = 0
        self.preemptions = 0
        self.tokens_generated = 0
        self.rejected = 0

    # -- intake ------------------------------------------------------------

    def submit(self, req: Request) -> int:
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("Scheduler.submit: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("Scheduler.submit: max_new_tokens must be >= 1")
        if req.top_p is not None and not 0.0 < req.top_p <= 1.0:
            # top_p <= 0 would mask every token to -inf.
            raise ValueError(f"Scheduler.submit: top_p must be in (0, 1], got {req.top_p}")
        total = prompt.size + req.max_new_tokens
        if total > self.max_context:
            raise ValueError(
                f"Scheduler.submit: prompt {prompt.size} + {req.max_new_tokens} new tokens "
                f"exceed the per-slot context {self.max_context} (max_blocks_per_seq * block_len)"
            )
        max_len = self.engine.model.config.max_seq_len
        if total > max_len:
            raise ValueError(
                f"Scheduler.submit: request needs {total} positions > model max_seq_len {max_len}"
            )
        need = -(-total // self.block_len)
        if need > self.allocator.capacity:
            raise ValueError(
                f"Scheduler.submit: request needs {need} blocks but the pool only has "
                f"{self.allocator.capacity}; no eviction can make room for it"
            )
        req.prompt = prompt
        req.id = self._next_id
        self._next_id += 1
        req.submitted_at = time.perf_counter()
        self.queue.append(req)
        self.submitted += 1
        return req.id

    # -- the serving step --------------------------------------------------

    def tick(self) -> list:
        """Admit / prefill one chunk / harvest the in-flight dispatch / grow
        tables (evicting on exhaustion) / dispatch the next k waves. Returns
        the HARVESTED dispatch's tokens (one tick behind the device)."""
        self._admit()
        self._prefill_one()
        events = self._harvest_pending()
        run = self._grow_tables()
        if run.any():
            self.pending = self.engine.decode_dispatch(
                self.block_table, self.lengths, self.last_tok, run, self.limits,
                self.temp, self.top_k, self.top_p, self.eos, self.seeds,
            )
        return events

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots) and self.pending is None

    # -- phases ------------------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        while self.queue and free:
            req = self.queue[0]
            ctx = (np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
                   if req.tokens else req.prompt)
            need = -(-len(ctx) // self.block_len)
            blocks = self.allocator.alloc(need)
            if blocks is None:
                return  # back-pressure: wait for running requests to free blocks
            self.queue.popleft()
            slot = free.pop(0)
            self.slots[slot] = _Slot(req, blocks, ctx, self._admit_seq)
            self._admit_seq += 1
            self.block_table[slot] = 0
            self.block_table[slot, :need] = blocks
            self.lengths[slot] = 0
            self.last_tok[slot] = ctx[-1]
            # Absolute row limit in ORIGINAL-prompt terms: rows written when
            # the g-th generated token lands = (P - 1) + g.
            self.limits[slot] = len(req.prompt) - 1 + req.max_new_tokens
            self.temp[slot] = req.temperature
            self.top_k[slot] = req.top_k or 0
            self.top_p[slot] = 1.0 if req.top_p is None else req.top_p
            self.eos[slot] = -1 if req.eos_token_id is None else req.eos_token_id
            self.seeds[slot] = req.id % (2**31 - 1)

    def _prefill_one(self) -> None:
        """One chunk of the OLDEST still-prefilling slot (FIFO keeps TTFT fair)."""
        pending = [
            (st.admit_order, i) for i, st in enumerate(self.slots)
            if st is not None and not st.prefill_done
        ]
        if not pending:
            return
        _, slot = min(pending)
        st = self.slots[slot]
        c = self.engine.prefill_chunk
        start = st.prefill_pos
        chunk = st.ctx[start:min(start + c, len(st.ctx) - 1)]
        valid = len(chunk)
        if valid < c:
            chunk = np.pad(chunk, (0, c - valid))
        self.engine.prefill(
            self.block_table[slot:slot + 1],
            chunk[None, :].astype(np.int32),
            np.asarray([start], np.int32),
            np.asarray([valid], np.int32),
        )
        st.prefill_pos = start + valid
        self.lengths[slot] = st.prefill_pos

    def _grow_tables(self) -> np.ndarray:
        """Cover every position the next dispatch may write (up to k tokens
        per decode-ready slot, capped at its limit), evicting the youngest
        active request on pool exhaustion. Returns the run mask."""
        k = self.engine.waves_per_dispatch
        run = np.zeros((self.engine.max_slots,), bool)
        for slot, st in enumerate(self.slots):
            if st is None or not st.prefill_done:
                continue
            # The k-th token lands at lengths + k - 1; the last token ever
            # lands at limits - 1.
            last_pos = min(
                int(self.lengths[slot]) + k - 1,
                max(int(self.limits[slot]) - 1, int(self.lengths[slot])),
            )
            need_idx = last_pos // self.block_len
            while need_idx >= len(st.blocks):
                got = self.allocator.alloc(1)
                if got is None:
                    victim = self._youngest_active()
                    self._evict(victim)
                    run[victim] = False  # it may have been approved earlier in this sweep
                    if victim == slot:
                        break
                    continue
                self.block_table[slot, len(st.blocks)] = got[0]
                st.blocks.extend(got)
            if self.slots[slot] is st:  # not evicted above
                run[slot] = True
        return run

    def _youngest_active(self) -> int:
        return max((st.admit_order, i) for i, st in enumerate(self.slots) if st is not None)[1]

    def _evict(self, slot: int) -> None:
        """Preempt: blocks back to the pool, the request to the FRONT of the
        queue with its progress folded into the context."""
        st = self.slots[slot]
        self.allocator.free(st.blocks)
        st.req.preemptions += 1
        self.preemptions += 1
        self.queue.appendleft(st.req)
        self._clear(slot)

    def _harvest_pending(self) -> list:
        """Fetch the in-flight dispatch and replay the device's per-wave
        bookkeeping onto the mirrors: each emitted token appends to its
        request and advances the slot; a finished slot frees its blocks."""
        if self.pending is None:
            return []
        handle, self.pending = self.pending, None
        toks, done, emitted = self.engine.harvest(handle)
        now = time.perf_counter()
        events = []
        for wave in range(toks.shape[0]):
            for slot in np.nonzero(emitted[wave])[0]:
                slot = int(slot)
                st = self.slots[slot]
                tok = int(toks[wave, slot])
                st.req.tokens.append(tok)
                if st.req.first_token_at is None:
                    st.req.first_token_at = now
                st.req.last_token_at = now
                self.tokens_generated += 1
                self.lengths[slot] += 1
                self.last_tok[slot] = tok
                finished = bool(done[wave, slot])
                if finished:
                    st.req.finished_at = now
                    self.completed += 1
                    self.allocator.free(st.blocks)
                    self._clear(slot)
                events.append(TickEvent(st.req, tok, finished))
        return events

    def _clear(self, slot: int) -> None:
        self.slots[slot] = None
        self.block_table[slot] = 0
        self.lengths[slot] = 0
        self.last_tok[slot] = 0
        self.limits[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.eos[slot] = -1
        self.seeds[slot] = 0

    # -- introspection -----------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)
