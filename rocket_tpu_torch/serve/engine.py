"""SlotEngine — the fixed-shape step family over a slot pool (counterpart
of ``rocket_tpu/serve/engine.py``).

Two step functions serve the whole request lifecycle:

* the **decode dispatch**: ``waves_per_dispatch`` (k) decode waves, a
  Python loop where the JAX package has a ``lax.scan``. Each wave is one
  token for every slot in ``[0, max_slots)``: paged attention against the
  shared pool, per-slot sampling with the knobs (temperature / top-k /
  top-p / EOS / length limit) as device tensors, and a carried run mask
  that freezes a slot the wave after it emits EOS or hits its limit;
* the **prefill chunk**: a ``(1, prefill_chunk)`` prompt slice through the
  same ``decode_step_paged``, tail-padded and masked.

Admitting, evicting and refilling requests only changes tensor VALUES
(block tables, masks, sampling vectors), never shapes or dtypes. The pool
is updated in place by every step — the JAX programs donate the pool
buffers; here the in-place update is the donation.

:meth:`SlotEngine.decode_dispatch` enqueues the k waves and returns device
tensors WITHOUT synchronising (no ``.item()``, no ``.cpu()``);
:meth:`SlotEngine.harvest` makes the one ``.cpu()`` transfer per
dispatch, so the scheduler admits, prefills and detokenizes wave N-1's
results while wave N runs on the device.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from rocket_tpu_torch.models.sampling import freeze_after_eos, sample_tokens
from rocket_tpu_torch.models.transformer import decode_params
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.runtime import resolve_device
from rocket_tpu_torch.serve.kv_pool import KVPoolSpec

__all__ = ["SlotEngine", "WaveHandle", "build_decode_wave", "build_prefill_step"]


class WaveHandle(NamedTuple):
    """An in-flight k-wave dispatch: device tensors, each ``(k, S)`` — the
    sampled token per wave, the finished flag the wave raised, and whether
    the slot ran that wave (a slot frozen mid-dispatch stops emitting)."""

    tokens: torch.Tensor   # int32
    done: torch.Tensor     # bool
    emitted: torch.Tensor  # bool


def build_decode_wave(model, waves: int = 1) -> Callable:
    """The k-wave decode step for ``model``, pure in its arguments except
    for the pool, which it updates in place. Signature::

        decode_wave(params, k_pages, v_pages, block_table, lengths,
                    last_tok, run_mask, limits, temp, top_k, top_p,
                    eos, seeds, seed) -> WaveHandle

    The per-slot sampling salt ``seeds * 1000003 + lengths`` is computed
    on the device each wave in int32 (wrapping), so k waves in one
    dispatch sample exactly as k dispatches of one wave would."""
    k = int(waves)
    if k < 1:
        raise ValueError(f"build_decode_wave: waves {k} < 1")

    def decode_wave(params, k_pages, v_pages, block_table, lengths, last_tok, run_mask,
                    limits, temp, top_k, top_p, eos, seeds, seed):
        run = run_mask
        toks, dones, emitted = [], [], []
        for _ in range(k):
            valid = run.to(torch.int32)
            logits, k_pages, v_pages = model.decode_step_paged(
                params, last_tok[:, None], k_pages, v_pages, block_table, lengths, valid,
            )
            salts = seeds * 1000003 + lengths
            nxt = sample_tokens(logits, seed, salts, temp, top_k, top_p).to(torch.int32)
            nxt, done = freeze_after_eos(nxt, torch.zeros_like(run), eos)
            done = done | (lengths + valid >= limits)
            # Frozen slots hold their token and emit nothing this wave.
            nxt = torch.where(run, nxt, last_tok)
            done = done & run
            toks.append(nxt)
            dones.append(done)
            emitted.append(run)
            lengths = lengths + valid
            last_tok = nxt
            run = run & ~done
        return WaveHandle(torch.stack(toks), torch.stack(dones), torch.stack(emitted))

    return decode_wave


def build_prefill_step(model) -> Callable:
    """The prefill-chunk step: ``(params, k_pages, v_pages, block_table_row,
    tokens, positions, valid)``; writes the chunk's K/V rows into the pool."""

    def prefill_chunk_fn(params, k_pages, v_pages, block_table, tokens, positions, valid):
        model.decode_step_paged(params, tokens, k_pages, v_pages, block_table, positions, valid)

    return prefill_chunk_fn


class SlotEngine:
    """Owns the device pool and the two step functions.

    ``params`` float leaves are moved to ``device`` and cast ONCE to the
    model's activation dtype; ``waves_per_dispatch`` (k) sets how many
    decode waves one dispatch runs; ``seed`` keys the sampling draws."""

    def __init__(
        self,
        model,
        params,
        spec: KVPoolSpec,
        *,
        max_slots: int,
        max_blocks_per_seq: int,
        prefill_chunk: int,
        waves_per_dispatch: int = 1,
        seed: int = 0,
        device=None,
    ) -> None:
        if max_slots < 1 or max_blocks_per_seq < 1 or prefill_chunk < 1:
            raise ValueError(
                "SlotEngine: max_slots, max_blocks_per_seq and prefill_chunk must all be >= 1"
            )
        if waves_per_dispatch < 1:
            raise ValueError(f"SlotEngine: waves_per_dispatch {waves_per_dispatch} < 1")
        self.device = resolve_device(device)
        self.model = model
        self.spec = spec
        self.max_slots = int(max_slots)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.prefill_chunk = int(prefill_chunk)
        self.waves_per_dispatch = int(waves_per_dispatch)
        self.seed = int(seed)
        self._params = decode_params(
            map_params(lambda t: t.to(self.device), params), model.config.activation_dtype
        )
        self.k_pages, self.v_pages = spec.init_pages(self.device)
        self._decode = build_decode_wave(model, self.waves_per_dispatch)
        self._prefill = build_prefill_step(model)
        #: Step functions built: 1 each for the engine's lifetime (the
        #: JAX engine counts traces; eager PyTorch builds each step once).
        self.decode_traces = 1
        self.prefill_traces = 1
        #: ``decode_waves`` counts waves (k per dispatch); ``device_gets``
        #: counts host syncs, one per dispatch.
        self.decode_waves = 0
        self.decode_dispatches = 0
        self.device_gets = 0
        self.prefill_chunks = 0
        #: Seconds :meth:`harvest` spent blocked on the device.
        self.harvest_wait_s = 0.0

    def _upload(self, ints: list, floats: list) -> tuple:
        """Host mirrors -> device in two copies (one int32, one float32).
        The mirrors are copied at call time, so the scheduler may mutate
        them while the dispatch runs."""
        flat_i = np.concatenate([np.asarray(a).astype(np.int32).reshape(-1) for a in ints])
        dev_i = torch.from_numpy(flat_i).to(self.device)
        out, at = [], 0
        for a in ints:
            n = int(np.size(a))
            out.append(dev_i[at:at + n].reshape(np.shape(a)))
            at += n
        if floats:
            dev_f = torch.from_numpy(np.stack(floats).astype(np.float32)).to(self.device)
            out.extend(dev_f.unbind(0))
        return tuple(out)

    def decode_dispatch(self, block_table, lengths, last_tok, run_mask, limits, temp, top_k,
                        top_p, eos, seeds) -> WaveHandle:
        """Enqueue one k-wave decode dispatch over every slot. Inputs are the
        scheduler's host arrays ``(max_slots, ...)``; returns device tensors
        without synchronising — :meth:`harvest` fetches them."""
        self.decode_dispatches += 1
        self.decode_waves += self.waves_per_dispatch
        table, lengths, last_tok, run, limits, top_k, eos, seeds, temp, top_p = self._upload(
            [block_table, lengths, last_tok, run_mask, limits, top_k, eos, seeds],
            [temp, top_p],
        )
        with torch.no_grad():
            return self._decode(
                self._params, self.k_pages, self.v_pages, table, lengths, last_tok,
                run.bool(), limits, temp, top_k, top_p, eos, seeds, self.seed,
            )

    def harvest(self, handle: WaveHandle):
        """The one host transfer per dispatch: ``(tokens, done, emitted)``
        as ``(k, S)`` numpy arrays."""
        self.device_gets += 1
        t0 = time.perf_counter()
        packed = torch.stack(
            [handle.tokens, handle.done.to(torch.int32), handle.emitted.to(torch.int32)]
        ).cpu().numpy()
        self.harvest_wait_s += time.perf_counter() - t0
        return packed[0], packed[1].astype(bool), packed[2].astype(bool)

    def prefill(self, block_table_row, tokens, position, valid) -> None:
        """One prefill chunk for ONE slot: ``block_table_row`` ``(1, MB)``,
        ``tokens`` ``(1, prefill_chunk)`` (tail-padded), ``position`` /
        ``valid`` ``(1,)``. Nothing is fetched back."""
        self.prefill_chunks += 1
        table, tokens, position, valid = self._upload(
            [block_table_row, tokens, position, valid], []
        )
        with torch.no_grad():
            self._prefill(self._params, self.k_pages, self.v_pages, table, tokens, position, valid)
