#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rocket_tpu_torch/csrc`` with
``nvcc`` (into ``build/kernels/``, first use, all in parallel), audits
their launches (every non-demo target of ``python -m rocket_tpu_torch.
analysis sched``, ``shard`` and ``mem`` clean on this card, and every
kernel's declared grid, threads and shared memory equal to its library's
query), holds
each against its plain PyTorch version at its path's shapes (the paged
decode kernel also at a 4096-row context, the dense-cache decode kernel
over three cache lengths, two head counts and three head dims at positions
around its 64-row splits, both two calls bitwise; every flash
kernel two launches bitwise), times the fused flash backward also without
dq at T=1024 and 2048, and the whole backward under both dq strategies
(f32 partials, or the separate accumulating dq kernel) at T=1024 and
2048; the first-generation flash
kernels on the stacked (3, B, H, T, D) operand at GPT-2's attention width,
every tile they compile. Then the tuner (``python -m rocket_tpu_torch.
tune``) sweeps five cases into a temporary table directory, must reject a
seeded wrong-but-fast variant, and the first-generation flash kernels run
through the tables it wrote (their launches counted there: no model path
reaches them). Then the
main paths, each with the kernel launch counts zeroed just before it and
read just after: serving GPT-2 124M (random weights from a fixed seed,
bf16) through ``ServeEngine``; the same requests again under the serve
half of the ops plane (telemetry, the request tracer, the exporter with
``/metrics`` and ``default:serve``, a ``torch.profiler`` window over ten
ticks parsed by correlation id; the tokens bitwise the first run's, strict
mode on every tick outside the window) and the serve CLI with its export,
SLO and trace flags, ``serve report``, ``obs timeline`` and ``obs prof``;
``generate()`` with the KV cache; training
GPT-2 124M through ``examples.gpt2``'s capsule tree (the flash forward and
fused backward; every train path below reads its batches from the
device-resident cache), with a ``torch.profiler`` window over its last steps; a
longer-context run whose dq partial buffer passes the byte bound (the
accumulating dq kernel); saving and restoring that GPT-2 train state
(in the JAX package's layout: optax's ``opt_state``, int32 step, uint32[2]
key data); the memory audit's liveness peak of that step held to the
caching allocator's measured peak at B=8 and at half the predicted H100
frontier (``mem``).
Then the char-LM slice with ``ROCKET_TPU_BLOCK_ATTN=fused``, in a temporary
directory: ``examples.char_lm`` trains one epoch and checkpoints (the
fused-block kernel, separate epilogue), a resumed run against an
uninterrupted one, one eval forward (fused epilogue) against the unforced
chain (flash kernels), ``examples.generate`` and ``serve --checkpoint``
from the checkpoint. Then the CIFAR-10 ResNet-18 slice with
``ROCKET_TPU_FUSED_CONV=pallas``, cuDNN deterministic: ``examples.
cifar_resnet.main`` trains three epochs at B=512 with eval and a
checkpoint at step 200 (the fused BatchNorm two-pass kernel), a fresh tree
resumed from that checkpoint against the uninterrupted run (bitwise, under
``torch.profiler``), ten steps with tune table entries pinning the
``stats_xla`` schedule (the normalise kernel), and one train step of the
card against the CPU (no host-to-device copy inside the profiled steps).
Then the examples of the data-stack slice: ``examples.vit_cifar`` (ViT-Ti,
non-causal flash attention at 65 tokens) for two epochs, a profiled
window and a card-against-CPU train step; ``examples.mnist`` (LeNet) for
one epoch; ``examples.llama_lm`` (GQA 8/4 at head dim 32) for one epoch
with its nucleus sample through the decode kernel, and a profiled window
of its tree (rows 2-4 are held to their plain versions at these shapes
among the parity phases). Then the MoE LM slice (GPT-2 widths, 4 experts,
top-2, dropless; ``ROCKET_TPU_MOE_GMM=fused`` where it says so): the
gather_gmm, gmm and tgmm kernels against their plain versions at the main
path's shapes and ragged ones (then row 12, the schedule audit's seeded-bad
demo: exactly its two RKT504 findings, its step on the card launching once
and refused at the 64 MiB block, bitwise parity, 2 * x timed in (7, 100)
and (8, 128) blocks); 12 train steps through the ``Launcher``
with the ``Profiler`` capsule (forced fused), 3 unforced (``impl="gmm"``);
``ServeEngine`` and ``generate()`` (greedy tokens equal in f32); and
``examples.moe_lm`` (einsum dispatch, head dim 32). Head dim 128: rows
3-7 at the attention widths of Llama-3-8B, Llama-2-7B, Phi-3-mini and
Phi-2 (the last two on heads zero-padded to 128) against their plain
versions and timed beside SDPA (among the parity phases); the Llama-style
recipe at Llama-3-8B's attention widths, depth 2, trained 8 steps with Lion
and an EMA shadow and serving 4 requests through ``Scheduler.
run_until_idle``; ViT-Ti with mixup, soft cross-entropy, Lion and an EMA
eval (a bitwise mid-epoch resume, a pre-EMA checkpoint seeding the shadow);
a byte-level BPE language model with its val perplexity, serving text.
Last, the whole GPT-2
model on the card against the CPU, for decoding and for one training
forward and backward, the same for a 2-layer MoE LM with its routing, and
the head-dim-128 Llama-style model's forward (depth 1). Then the ops
plane's training half: GPT-2 124M through ``examples.gpt2.build`` under
``Runtime(strict=True, telemetry=True, health=True,
anomaly_action="skip_step", watchdog_secs=60)`` with a NaN loss at one
step (the held step bitwise, the next lr at the applied count, the
telemetry files read back, the step time beside ``train``'s and a
profiled window's idle share); the char-LM under ``dump_and_halt`` (the
black-box bundle's checkpoint restores the last good state bitwise); a
host read inside the wave raising under strict mode only; a stalled loop
reported by the watchdog with the CUDA allocator's line. Then resilience
and the live export plane: GPT-2 124M trained through ``python -m
rocket_tpu_torch.launch --supervise`` while a fault plan kills, wedges and
preempts its generations (each resuming from the last complete checkpoint,
the last draining on SIGTERM), exporting metric shards and ``/metrics``
judged by ``default:train``, then resumed to its last step: params and
both moments bitwise those of an uninterrupted run, which traces a window
of three steps into its telemetry's ``obs/prof/*`` gauges; and LeNet under strict
mode and ``skip_step`` with one batch poisoned on the card. Then the
data-parallel slice: GPT-2 124M trained by two ranks sharing the card over
a gloo group their worker opens (global B=8, the bucketed reduction on its
bf16 wire), against one rank at B=8 in a process of its own: per-step
losses, the step-1 gradients at the f32 wire, the ranks' end params
bitwise, rows 3-4 on every rank (``dp_train``); a one-rank run resumed
from the two ranks' per-rank checkpoint shards (``dp_checkpoint``); the
same tree under ``fsdp_rules`` (``dp_fsdp``: two ranks where gloo takes
the FSDP collectives on CUDA, else NCCL at world size 1); and ``python -m
rocket_tpu_torch.launch -n 1`` on ``examples/gpt2.py`` over NCCL under
strict mode (``dp_launch``). The same workers run the sync-BN, ring and pipeline jobs: GPT-2 124M
over two pipeline stages under GPipe and 1F1B against one rank's
unpipelined run (losses, the step-1 gradients at f32, the dropout masks
bitwise, the hops' bytes and waits, the peak memory at 4 and 8
microbatches; ``pp_train``) and resumed on one rank from the stages'
shards (``pp_checkpoint``); GPT-2 widths at T = 4096 over two seq ranks with
ring attention against one rank's flash run (rows 3-5), its step 1 at f32
against one rank's plain attention (``ring_train``);
ResNet-18 with sync-BN over two ranks against one (no fused BN launch on
the two; ``dp_cifar``); the MoE LM (``moe_gpt2_e4`` at 6 layers) over two
expert ranks, dropless with the fused kernels forced and einsum, against
one rank (routing, losses, the f32 step-1 gradients, rows 11, ``gmm`` and
``tgmm`` on each rank's two experts, the routed rows, the expert group's
waits and bytes; ``ep_train``), resumed on one rank from the expert
shards (``ep_checkpoint``), and at 2 layers and f32 under the model, seq
and pipe axes against one rank (``moe_par``); ring's job with the flash
kernels on the seq-sharded batch, each attention gathering the sequence
(rows 3-5 on both ranks; ``seq_flash``); ViT-Ti under ``gpt2_tp_rules()``
over two model ranks, replicated (``tp_fallback``); in a four-rank world,
GPT-2 124M over ``{"data": 1, "model": 2, "pipe": 2}`` under both
schedules against one rank (``tp_pp_train``), resumed on one rank from its
four writers' shards (``tp_pp_checkpoint``), and the MoE LM at the other
pairs of split axes (``mesh_pairs``); and
``examples/pipeline_lm.py --schedule 1f1b``, ``examples/long_context.py``
and ``examples/moe_lm.py --expert-axis 2`` as two ranks each, beside
``dp_launch`` (``examples_par``). Last, rows 9-10
against their plain versions at f16, C = 3, C = 12 and C = 4096 (two
channel chunks).

Each phase prints one JSON line; the last three lines are the per-kernel
summary, the card's name and power limit as ``nvidia-smi`` reports them,
and ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 2 and prints no result. The full
record is also written to ``chiprun_out/chip_smoke.json``."""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim, tune
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.augment import mixup, soft_cross_entropy
from rocket_tpu_torch.data.text import (
    BPETokenizer,
    CharTokenizer,
    TokenDataset,
    synthetic_corpus,
    tiny_shakespeare,
)
from rocket_tpu_torch.examples import (
    char_lm,
    cifar_resnet,
    gpt2,
    llama_lm,
    mnist,
    moe_lm,
    vit_cifar,
)
from rocket_tpu_torch.examples import generate as char_generate
from rocket_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    generate,
    next_token_loss,
)
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.models.resnet import resnet18
from rocket_tpu_torch.models.vit import ViT
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.nn.moe import MoE
from rocket_tpu_torch.obs.__main__ import main as obs_main
from rocket_tpu_torch.obs.export import read_telemetry_dir
from rocket_tpu_torch.obs.spans import load_chrome_trace
from rocket_tpu_torch.analysis.mem_audit import MEM_TARGETS, run_mem_target
from rocket_tpu_torch.analysis import repro_audit
from rocket_tpu_torch.analysis.repro_audit import REPRO_TARGETS
from rocket_tpu_torch.analysis.sched_audit import SCHED_TARGETS, run_sched_target
from rocket_tpu_torch.analysis.shard_audit import BUILTIN_TARGETS as SHARD_TARGETS
from rocket_tpu_torch.analysis.shard_audit import run_target as run_shard_target
from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops import accuracy
from rocket_tpu_torch.ops import badpallas as bp
from rocket_tpu_torch.ops import decode_attention as da
from rocket_tpu_torch.ops import flash_attention as fqa
from rocket_tpu_torch.ops import flash_native as fa
from rocket_tpu_torch.ops import fused_block as fb
from rocket_tpu_torch.ops import fused_conv as fc
from rocket_tpu_torch.ops import gather_gmm as gg
from rocket_tpu_torch.ops import grouped_matmul as gm
from rocket_tpu_torch.ops import paged_attention as pa
from rocket_tpu_torch.resilience.supervisor import newest_complete_step
from rocket_tpu_torch.runtime import checkpoint_io
from rocket_tpu_torch.serve import ServeConfig, ServeEngine
from rocket_tpu_torch.serve import __main__ as serve_cli
from rocket_tpu_torch.tune.space import TUNE_SPACES, TuneSpace
from rocket_tpu_torch.tune.tuner import TuneCase, sweep_case
from rocket_tpu_torch.utils.metrics import Perplexity
from rocket_tpu_torch.utils.perf import device_spec

ROOT = Path(__file__).resolve().parent
#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: Kernel vs plain version on the same CUDA tensors: the decode kernels'
#: max abs error, the flash kernels' every element as
#: ``|got - want| <= tol * (1 + |want|)`` (``assert_close`` with atol =
#: rtol = tol). f32: the same math in another order (and TF32 off). bf16:
#: the decode plain versions round the attention weights to bf16 before the
#: PV product where the decode kernels keep them in f32; the flash kernels
#: and their plain versions both round p and ds to bf16, but from f32
#: scores summed in another order, so a rounding can flip by one bf16 step.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: decode_step_paged on the card vs the CPU, f32 logits of order one.
MODEL_TOL = 1e-3
#: One train forward + backward on the card (flash kernels) vs the CPU
#: (plain path), f32: the loss absolutely, each gradient relative to its
#: largest element (sums over 1024 tokens in another order).
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3}
#: Train phases: GPT-2 124M at B=8, T=1024; the profiled window is the
#: last PROFILE_STEPS steps; step times are taken after WARM_STEPS.
TRAIN_STEPS, PROFILE_STEPS, WARM_STEPS = 20, 3, 3
RECORD: dict = {}
#: Every kernel wrapper, whose launch count is zeroed before each main path.
COUNTED = (pa.paged_decode, da.decode_attention, fa.flash_fwd, fa.flash_bwd, fa.flash_dq,
           fb.fused_block, fc.bn_twopass, fc.bn_normalize, gg.gather_gmm_fwd, gm.gmm, gm.tgmm,
           fqa.flash_qkv_fwd, fqa.flash_qkv_bwd, bp.bad_scale)
#: char-LM resume: a resumed run against an uninterrupted one on the card,
#: losses and each final param leaf relative to its largest element.
RESUME_TOL = 1e-5
#: The fused BatchNorm kernels vs their plain versions: the reference's own
#: bound for this kernel (rocket_tpu/tune/space.py:536, its moments are
#: reassociated f32 sums), f32 |got - want| <= 5e-5 + 5e-5 * |want| for y
#: and the stats; bf16 y within 2e-2 * (1 + |want|) (one bf16 rounding).
BN_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}
#: ResNet-18 one train forward + backward on the card (fused kernels, TF32
#: off) vs the CPU: logits, loss and the new BN state relative to their
#: largest element (20 BatchNorm layers of f32 sums in another order). The
#: gradients are held relative to their norm within the larger of CIFAR_TOL
#: and CIFAR_GRAD_FLOOR times the CPU's own gap when the same batch is fed
#: in another order: at initialisation the BN biases' and scales' gradients
#: are sums that nearly cancel (each BN backward subtracts per-channel
#: means), so reordering the f32 sums alone moves them by ~0.5% of their
#: norm on the CPU.
CIFAR_TOL, CIFAR_GRAD_FLOOR = 1e-3, 3.0
#: ResNet-18 CIFAR: BatchNorm layers per train step, epochs of the train
#: phase, the step the Checkpointer saves, and the train images per step.
CIFAR_BN_LAYERS, CIFAR_EPOCHS, CIFAR_SAVE_STEP, CIFAR_BATCH = 20, 3, 200, 512


#: The run's clock: each phase line carries the seconds since the start.
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    fields["elapsed_s"] = time.perf_counter() - T_START
    RECORD.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


#: The synthetic texts the phases read, made once a run: a million
#: characters is seconds of host work, and eight phases read them.
_TEXTS: dict = {}


def _text(num_chars: int = 1_000_000) -> str:
    if num_chars not in _TEXTS:
        _TEXTS[num_chars] = synthetic_corpus(num_chars=num_chars)
    return _TEXTS[num_chars]


def _gpt2_corpus(seq_len: int, vocab_size: int) -> TokenDataset:
    """``examples.gpt2.corpus`` over the run's one copy of its text."""
    text = _text(2_000_000)
    return TokenDataset(CharTokenizer(text).encode(text) % vocab_size, seq_len=seq_len)


def _kernel_name(sym: str) -> str:
    """``kernel<args>`` of a mangled kernel symbol: the length-prefixed name
    ending in ``kernel`` followed by its template arguments."""
    for i in range(len(sym)):
        digits = re.match(r"\d+", sym[i:])
        if not digits:
            continue
        start = i + digits.end()
        name = sym[start:start + int(digits.group())]
        if name.endswith("kernel") and sym[start + len(name):].startswith("I"):
            tail = sym[start + len(name) + 1:].split("EEv")[0] + "E"
            kind = "bf16" if tail.startswith("13__nv_bfloat16") else (
                "f32" if tail.startswith("f") else "")
            return f"{name}<{','.join(([kind] if kind else []) + re.findall(r'Li(\d+)E', tail))}>"
    return sym[:60]


def ptxas_entries(log: str) -> dict:
    """``nvcc -Xptxas -v``'s report, one entry per kernel instantiation:
    ``{"flash_bwd_tc_kernel<128>": "255 registers, 0/0 bytes spill
    stores/loads"}``. The name is the kernel's and its template arguments
    read from the mangled symbol (``f`` float, ``13__nv_bfloat16`` bf16,
    ``Li<n>E`` an int)."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
            continue
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if stores:
            spill = f"{stores.group(1)}/{stores.group(2)} bytes spill stores/loads"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            key, n = name, 1
            while key in out:   # instantiations whose arguments are not ints
                n += 1
                key = f"{name}#{n}"
            out[key] = f"{used.group(1)} registers, {spill}"
            name, spill = None, ""
    return out


def zero_launches() -> None:
    for fn in COUNTED:
        fn.launches = 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the serving path finds its pages cold). Between the flush and
    the start event the card spins for PREROLL_CYCLES, so the host has
    queued the timed launch before the card reaches it: a launch whose host
    side outlasts the flush (SDPA's autograd backward) otherwise timed the
    host, and moved between phases and runs by up to 4x. The card
    is first kept busy for a second: from idle, the first phase's short
    kernels timed up to 2.5x slower than the same kernels a phase later
    (row 1's first case). Then one timing of nothing is thrown away: a
    run's first timing read row 1's kernel slower than its next ones."""

    #: ~0.5 ms at the H100's boost clock: longer than any timed launch's
    #: host side.
    PREROLL_CYCLES = 1_000_000

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        end = time.perf_counter() + 1.0
        while time.perf_counter() < end:
            for _ in range(8):
                a @ a
            torch.cuda.synchronize()
        self.ms(lambda: None)

    def launches_ms(self, fn, iters: int = 30, warmup: int = 3) -> list:
        """The time of each of ``iters`` launches of ``fn``, after
        ``warmup`` untimed ones."""
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            self.flush.zero_()
            torch.cuda._sleep(self.PREROLL_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        return sum(self.launches_ms(fn, iters, warmup)) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# -- phase 2b: every kernel's declared launch against its library ------------

def _declared_launches() -> list:
    """(kernel, shapes, declared LaunchFact, the built library's query) for
    every kernel at its main path's shapes: the serve wave (row 1's split and
    combine, also at the long-context table) and generate() (row 2's split
    and combine), GPT-2 train at T=1024 and 2048 (rows 3-5, bf16 and f32, and
    the D=32 bf16 forward), row 6 at both square tiles and row 7 at all
    four tile pairs (bf16), the char-LM fused block under both epilogues,
    bf16 and f32 (row 8), row 9's one launch and row 10's at ResNet-18
    CIFAR's four f32 shapes and the tuner's two bf16 ones, the MoE
    in-projection's gather-GMM and both grouped products of the in- and
    out-projection in bf16 and f32 (row 11, gmm, tgmm; in bf16 all three on
    the persistent wgmma grid, one CTA per SM of this card), bf16 gmm at
    moe_serve's decode rows in both modes, row 12's two launches, and rows 3-4
    at the ViT and Llama examples' shapes with row 2's split and combine at
    the Llama example's decode: 57; then rows 3-5 at head dim 128 (the
    Llama-3-8B shape, bf16 and f32), rows 3-4 at Phi-3-mini's D=96 padded to
    128, and rows 6-7 at D=128's 64 x 64 pair in both dtypes: 69 in all. The
    BN grids are sized by a meta
    tensor priced as this card, as the audit sizes them."""
    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for mb in (64, 256):
        for fact, built in zip(pa.paged_decode_launches(8, 12, 12, 64, 1 + 8 * mb, 16, mb, bf16),
                               pa.launch_info(8, 12, 12, 64, mb, 16, bf16)):
            rows.append((fact.name, f"S=8 MB={mb} BL=16 Hq=Hkv=12 D=64 bf16", fact, built))
    for fact, built in zip(da.decode_attention_launches(4, 12, 12, 192, 64, bf16),
                           da.launch_info(4, 12, 12, 192, 64, bf16)):
        rows.append((fact.name, "B=4 T=192 Hq=Hkv=12 D=64 bf16", fact, built))
    for kind, t in (("flash_fwd", 1024), ("flash_bwd", 1024), ("flash_dq", 2048)):
        for dtype in (bf16, f32):
            name = str(dtype).removeprefix("torch.")
            rows.append((kind, f"B=8 T={t} H=12 D=64 {name} fused qkv",
                         fa.flash_launch(kind, 8, t, 12, 12, 64, dtype, 2304, 2304),
                         fa.launch_info(kind, 8, t, 12, 12, 64, dtype)))
    rows.append(("flash_fwd", "B=64 T=128 H=4 D=32 bf16 fused qkv",
                 fa.flash_launch("flash_fwd", 64, 128, 4, 4, 32, bf16, 384, 384),
                 fa.launch_info("flash_fwd", 64, 128, 4, 4, 32, bf16)))
    for name, (b, t, hq, h_kv, d, causal, fused) in EXAMPLE_FLASH.items():
        fq, fk = (3 * hq * d,) * 2 if fused else (hq * d, h_kv * d)
        for kind in ("flash_fwd", "flash_bwd"):
            rows.append((kind, f"{name}: B={b} T={t} Hq={hq} Hkv={h_kv} D={d} bf16",
                         fa.flash_launch(kind, b, t, hq, h_kv, d, bf16, fq, fk),
                         fa.launch_info(kind, b, t, hq, h_kv, d, bf16)))
    c = LLAMA_DECODE
    for fact, built in zip(da.decode_attention_launches(c["b"], c["hq"], c["hkv"], c["t"], c["d"],
                                                        bf16),
                           da.launch_info(c["b"], c["hq"], c["hkv"], c["t"], c["d"], bf16)):
        rows.append((fact.name, "llama: B=1 T=68 Hq=8 Hkv=4 D=32 bf16", fact, built))
    for kind, pairs in (("fwd", [(blk, blk) for blk in fqa.TILES]),
                        ("bwd", [(bq, bk) for bq in fqa.TILES for bk in fqa.TILES])):
        for bq, bk in pairs:
            rows.append((f"flash_qkv_{kind}", f"(3, 8, 12, 1024, 64) bf16 {bq}x{bk}",
                         fqa.qkv_launch(kind, 8, 12, 1024, 64, bf16, bq, bk),
                         fqa.launch_info(kind, 8, 12, 1024, 64, bf16, bq, bk)))
    # Head dim 128: rows 3-5 at the Llama-3-8B bthd shape in both dtypes,
    # rows 3-4 as Phi-3-mini's D=96 fused operand declares them (padded to
    # 128, the padded feature widths), rows 6-7 at their one D=128 pair.
    for kind in ("flash_fwd", "flash_bwd", "flash_dq"):
        for dtype in (bf16, f32):
            name = str(dtype).removeprefix("torch.")
            rows.append((kind, f"llama3_8b: B=2 T=2048 Hq=32 Hkv=8 D=128 {name}",
                         fa.flash_launch(kind, 2, 2048, 32, 8, 128, dtype, 4096, 1024),
                         fa.launch_info(kind, 2, 2048, 32, 8, 128, dtype)))
    for kind in ("flash_fwd", "flash_bwd"):
        rows.append((kind, "phi3_mini: B=1 T=2048 H=32 D=96 padded to 128 bf16",
                     fa.flash_launch(kind, 1, 2048, 32, 32, 128, bf16, 4096, 4096),
                     fa.launch_info(kind, 1, 2048, 32, 32, 128, bf16)))
    for kind in ("fwd", "bwd"):
        for dtype in (bf16, f32):
            name = str(dtype).removeprefix("torch.")
            rows.append((f"flash_qkv_{kind}", f"(3, 2, 32, 2048, 128) {name} 64x64",
                         fqa.qkv_launch(kind, 2, 32, 2048, 128, dtype, 64, 64),
                         fqa.launch_info(kind, 2, 32, 2048, 128, dtype, 64, 64)))
    for epilogue in ("separate", "fused"):
        for dtype in (bf16, f32):
            name = str(dtype).removeprefix("torch.")
            rows.append(("fused_block", f"B=128 T=256 D=256 H=4 {name} {epilogue}",
                         fb.fused_block_launch(128, 256, 256, 4, dtype, epilogue),
                         fb.launch_info(128, 256, 4, epilogue, dtype)))
    with tune.priced_device_kind(torch.cuda.get_device_name(0)):
        for n, c, dtype in BN_SHAPES:
            grid, norm_grid = fc._grids(torch.empty((n, c), dtype=dtype, device="meta"))
            for kind, ctas in (("twopass", grid), ("normalize", norm_grid)):
                for fact in fc.bn_launches(kind, n, c, dtype, grid, norm_grid, sms):
                    name = str(dtype).removeprefix("torch.")
                    rows.append((fact.name, f"N={n} C={c} {name}", fact,
                                 fc.launch_info(fact.name, n, c, ctas, True, dtype)))
    for dtype in (bf16, f32):
        name = str(dtype).removeprefix("torch.")
        rows.append(("gather_gmm", f"M=18432 K=768 N=3072 E=4 src=8192 {name}",
                     gg.gather_gmm_launch(18432, 768, 3072, 4, dtype, 8192, sms),
                     gg.launch_info(18432, 3072, 4, dtype)))
        shapes = [(18432, 768, 3072, False), (18432, 3072, 768, False), (18432, 3072, 768, True)]
        if dtype == bf16:  # moe_serve's decode rows, both modes
            shapes += [(16, 3072, 768, False), (16, 3072, 768, True)]
        for m, k, n, trans in shapes:
            rows.append(("gmm", f"M={m} K={k} N={n} E=4 {name}{' transposed' if trans else ''}",
                         gm.gmm_launch(m, k, n, 4, dtype, trans, sms=sms),
                         gm.launch_info("gmm", m, k, n, 4, dtype, trans)))
        for k, n in ((768, 3072), (3072, 768)):
            rows.append(("tgmm", f"M=18432 K={k} N={n} E=4 {name}",
                         gm.tgmm_launch(18432, k, n, 4, dtype, sms),
                         gm.launch_info("tgmm", 18432, k, n, 4, dtype)))
    for block, grid in (((7, 100), (4,)), ((4096, 4096), ())):
        rows.append(("bad_scale", f"(4096, 4096) f32 block {block} grid {grid}",
                     bp.bad_scale_launch((4096, 4096), block, grid), bp.launch_info(block, grid)))
    return rows


#: The precision and determinism audits of every non-demo target (meta
#: traces and the CPU replay sentinel: no card), run in a process of their
#: own beside the schedule audit's tracing, their records written as JSON.
NUMERICS_AUDITS = r'''
import json, sys, time
t0 = time.perf_counter()
from rocket_tpu_torch.analysis.prec_audit import PREC_TARGETS, run_prec_target
from rocket_tpu_torch.analysis.repro_audit import REPRO_TARGETS, run_repro_target
out = {"prec": {}, "repro": {}}
for family, targets, run in (("prec", PREC_TARGETS, run_prec_target),
                             ("repro", REPRO_TARGETS, run_repro_target)):
    for name, target in targets.items():
        if target.demo:
            continue
        report = run(target)
        rec = dict(report.record, findings=[f.message for f in report.findings])
        if family == "repro":
            rec["order_free_sites"] = sorted({f"{op}@{site}" for op, site, _ in report.nondet})
        out[family][name] = rec
out["seconds"] = time.perf_counter() - t0
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
'''


def _start_numerics() -> tuple:
    """Start :data:`NUMERICS_AUDITS` in a child process that sees no card."""
    path = Path(tempfile.mkdtemp()) / "numerics.json"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, "-c", NUMERICS_AUDITS, str(path)], env=env,
                            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, path


def _join_numerics(started) -> dict:
    proc, path = started
    try:
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"launch_audit: the prec/repro audits exited "
            f"{proc.returncode}: {log[-3000:]}")
    out = json.loads(path.read_text())
    shutil.rmtree(path.parent, ignore_errors=True)
    return out


def launch_audit_phase(card):
    """The kernel-launch audit on this card: every non-demo schedule target
    traced on meta tensors and priced as this card must report nothing, the
    SM count the meta launches size grids with must be this card's, and
    every kernel's declared (grid, threads, dynamic, static shared memory)
    must equal its library's query, with each launch's headroom under the
    card's shared-memory opt-in printed. Then every non-demo target of the
    SPMD and memory audits (``shard``, ``mem``; meta traces on the host)
    must report nothing priced as this card, and every non-demo target of
    the precision and determinism audits (``prec``, ``repro``: meta
    traces, and the replay sentinel on the host's CPU, in a child process
    beside the schedule audit) must report nothing;
    each kernel's declared accumulator (f32, in a fixed order) is printed
    beside its geometry. The memory record of ``train_flash`` is returned
    for the ``mem`` phase."""
    kind = torch.cuda.get_device_name(0)
    spec = device_spec(kind)
    require(spec is not None, f"launch_audit: no DeviceSpec for {kind!r}")
    require(spec.sms == torch.cuda.get_device_properties(0).multi_processor_count,
            f"launch_audit: DeviceSpec.sms {spec.sms} is not this card's")
    numerics = _start_numerics()
    t_sched = time.perf_counter()
    targets = {}
    for name, target in SCHED_TARGETS.items():
        if target.demo:
            continue
        report = run_sched_target(target, kind)
        require(report.clean, f"launch_audit: {name}: " + "; ".join(
            f.message for f in report.findings))
        targets[name] = {"launches": len(report.launches),
                         "kernels": sorted({f.name for f in report.launches}),
                         **{k: report.record[k] for k in (
                             "predicted_step_time_us", "compute_us", "memory_us",
                             "exposed_comm_us", "predicted_mfu", "n_ops", "n_collectives")}}
    kernels = []
    for name, shapes, fact, built in _declared_launches():
        grid, threads, dynamic, static = built
        require(fact.geometry == built, f"launch_audit: {name} {shapes}: declared "
                f"{fact.geometry}, library {built}")
        # Every launch declares its work; a combine writes its output and
        # does no arithmetic.
        require(fact.bytes > 0 and (fact.flops > 0 or "combine" in name),
                f"launch_audit: {name} {shapes}: no work declared ({fact.bytes} B, "
                f"{fact.flops} flops)")
        require((fact.acc_dtype, fact.acc_order) == ("float32", "fixed"),
                f"launch_audit: {name} {shapes}: declares accumulation {fact.acc_dtype} in "
                f"{fact.acc_order} order")
        kernels.append({"kernel": name, "shapes": shapes, "grid": list(grid), "threads": threads,
                        "dynamic_smem": dynamic, "static_smem": static,
                        "headroom_bytes": spec.smem_bytes - dynamic - static,
                        "acc_dtype": fact.acc_dtype, "acc_order": fact.acc_order,
                        "bytes": fact.bytes, "flops": fact.flops})
    # The bound helpers' work is the launch facts' own, at the main paths'
    # shapes: GPT-2's rows 3-5 and 6, the char-LM block.
    work = {}
    gpt2 = (8, 1024, 12, 12, 64, torch.bfloat16)
    for kernel, bound, fact in (
            ("flash_fwd", flash_bounds(*gpt2, True)[0],
             fa.flash_launch("flash_fwd", *gpt2, 768, 768)),
            ("flash_bwd", flash_bounds(*gpt2, True)[1],
             fa.flash_launch("flash_bwd", *gpt2, 768, 768)),
            ("flash_dq", flash_bounds(8, 2048, 12, 12, 64, torch.bfloat16, True)[2],
             fa.flash_launch("flash_dq", 8, 2048, 12, 12, 64, torch.bfloat16, 768, 768)),
            ("flash_qkv_fwd", qkv_bounds(8, 12, 1024, 64, torch.bfloat16, True, 128)[0],
             fqa.qkv_launch("fwd", 8, 12, 1024, 64, torch.bfloat16, 128, 128)),
            ("fused_block", block_bounds(128, 256, 256, 4, torch.bfloat16, "separate"),
             fb.fused_block_launch(128, 256, 256, 4, torch.bfloat16, "separate"))):
        require(fact.bytes > 0 and bound == fact_bound(fact),
                f"launch_audit: {kernel}: bound {bound} is not its fact's {fact_bound(fact)}")
        work[kernel] = {"bytes": fact.bytes, "flops": fact.flops, "bound_ms": bound[0]}
    t_shard = time.perf_counter()
    shard = {}
    for name, target in SHARD_TARGETS.items():
        if target.demo:
            continue
        report = run_shard_target(target, kind)
        require(report.clean, f"launch_audit: shard {name}: " + "; ".join(
            f.message for f in report.findings))
        shard[name] = {k: report.record[k] for k in (
            "collective_counts", "collective_bytes_per_step", "hbm_per_device_bytes")}
    t_mem = time.perf_counter()
    mem = {}
    for name, target in MEM_TARGETS.items():
        if target.demo:
            continue
        report = run_mem_target(target, kind)
        require(report.clean, f"launch_audit: mem {name}: " + "; ".join(
            f.message for f in report.findings))
        mem[name] = report.record
    t_numerics = time.perf_counter()
    numerics = _join_numerics(numerics)
    for family in ("prec", "repro"):
        for name, rec in numerics[family].items():
            require(not rec["findings"], f"launch_audit: {family} {name}: "
                    + "; ".join(rec["findings"]))
    emit("launch_audit", device_kind=kind, smem_opt_in=spec.smem_bytes, targets=targets,
         kernels=kernels, work=work, shard=shard,
         mem={name: {k: r[k] for k in ("predicted_peak_bytes", "saved_activation_bytes",
                                         "peak_breakdown", "oom_frontier")}
              for name, r in mem.items()},
         prec=numerics["prec"], repro=numerics["repro"], sched_s=t_shard - t_sched,
         shard_s=t_mem - t_shard, mem_s=t_numerics - t_mem,
         numerics_s=numerics["seconds"], numerics_wait_s=time.perf_counter() - t_numerics,
         card=card)
    return mem["train_flash"]


# -- phase 3: kernels against their plain versions -------------------------

#: Row 1's cases: the serve path's decode wave (MB=64 pages of BL=16, slot
#: positions at 0, page boundaries and 1023) and a long context (MB=256,
#: positions spread to 4095), S=8, D=64, Hq=12.
PAGED_POSITIONS = {64: [0, 15, 16, 17, 255, 511, 700, 1023],
                   256: [0, 63, 64, 700, 1500, 2600, 3500, 4095]}


def paged_case(dtype, h_kv, gen, mb=64):
    """Operands of one decode wave over ``mb`` pages of 16 rows per slot
    (pages past each slot's live length point at the trash block 0), and
    its bytes and flops as its launch facts declare them at these
    positions (``paged_attention.paged_decode_work``: the live K and V rows
    read once, q read and out written once, the live table entries and the
    positions)."""
    s, bl, d, hq = 8, 16, 64, 12
    nb = 1 + s * mb
    positions = torch.tensor(PAGED_POSITIONS[mb], dtype=torch.int32)
    table = torch.zeros((s, mb), dtype=torch.int32)
    for i, p in enumerate(positions.tolist()):
        live = p // bl + 1
        table[i, :live] = 1 + i * mb + torch.randperm(mb, generator=gen)[:live].to(torch.int32)
    mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
    ops = dict(q=mk(s, hq, d), k_pages=mk(nb, bl, h_kv, d), v_pages=mk(nb, bl, h_kv, d),
               block_table=table.cuda(), positions=positions.cuda())
    rows = (positions + 1).double()
    facts = pa.paged_decode_launches(s, hq, h_kv, d, nb, bl, mb, dtype, int(rows.sum()),
                                     int((rows / bl).ceil().sum()))
    return ops, sum(f.bytes for f in facts), sum(f.flops for f in facts)


def check_paged(timer, gen):
    """Row 1 against its plain version (max abs error) at the serve wave in
    both dtypes, MHA and GQA, and at the long context in bf16; two calls
    bitwise; each timed beside the plain version, SDPA over the gathered
    context (the gather untimed) and its bound. Returns the serve wave's
    bf16 MHA row, with the long context's under ``"long_context"``."""
    entry = long_row = None
    for mb, dtype, h_kv in ((64, torch.bfloat16, 12), (64, torch.bfloat16, 4),
                            (64, torch.float32, 12), (64, torch.float32, 4),
                            (256, torch.bfloat16, 12)):
        ops, nbytes, flops = paged_case(dtype, h_kv, gen, mb)
        got = pa.paged_decode(**ops)
        again = pa.paged_decode(**ops)
        want = pa.paged_decode_plain(**ops)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(math.isfinite(err) and err <= TOL[dtype],
                f"paged_decode {dtype} Hkv={h_kv} MB={mb}: max abs err {err} > {TOL[dtype]}")
        require(torch.equal(got, again), f"paged_decode {dtype} Hkv={h_kv} MB={mb}: "
                "two calls differ")
        s, hq, d = ops["q"].shape
        k = pa.paged_gather(ops["k_pages"], ops["block_table"]).transpose(1, 2)
        v = pa.paged_gather(ops["v_pages"], ops["block_table"]).transpose(1, 2)
        k = k.repeat_interleave(hq // h_kv, 1).contiguous()
        v = v.repeat_interleave(hq // h_kv, 1).contiguous()
        mask = (torch.arange(k.shape[2], device="cuda")[None, :]
                <= ops["positions"][:, None].long())[:, None, None, :]
        q4 = ops["q"][:, :, None, :]
        row = {
            "dtype": str(dtype).removeprefix("torch."), "s": s, "mb": mb, "bl": 16, "hq": hq,
            "hkv": h_kv, "d": d, "n_split": pa.num_splits(mb, 16),
            "positions": PAGED_POSITIONS[mb], "max_abs_err": err, "tol": TOL[dtype],
            "deterministic": True,
            "ms": timer.ms(lambda: pa.paged_decode(**ops)),
            "plain_ms": timer.ms(lambda: pa.paged_decode_plain(**ops)),
            "library_ms": timer.ms(
                lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
        emit("parity_paged_decode", **row)
        if (mb, dtype, h_kv) == (64, torch.bfloat16, 12):  # GPT-2's serving shape
            entry = row
        elif mb == 256:
            long_row = row
        del ops, k, v, got, again, want
    entry["long_context"] = {key: long_row[key] for key in (
        "mb", "n_split", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    return entry


#: Row 2's parity grid: cache lengths (one not a multiple of 64), kv heads
#: (MHA and GQA g = 3), head dims, and positions at the first row, around
#: the first 64-row split boundary, at generate()'s last row and at the
#: cache's last row (those inside the cache).
DECODE_T, DECODE_HKV, DECODE_D, DECODE_POS = (100, 192, 1024), (12, 4), (32, 64, 128), \
    (0, 63, 64, 191, -1)
#: Row 2's timed shapes: generate()'s (B=4, a 192-row cache, its last
#: position) and a long prompt's (B=8, T=1024).
DECODE_TIMED = ((4, 192, 191), (8, 1024, 1023))


def check_decode_attention(timer, gen):
    """Row 2 against its plain version (max abs error) over the parity grid
    in bf16 and f32, B=8, Hq=12: the written cache rows bitwise, two calls
    bitwise. Then timed at both DECODE_TIMED shapes in bf16 beside the plain
    version, SDPA over the visible rows and its bound. Returns generate()'s
    row, with the long prompt's under ``"long_context"``."""
    def case(b, t_max, h_kv, d, dtype, pos):
        mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
        ops = dict(q=mk(b, 12, d), k_new=mk(b, h_kv, d), v_new=mk(b, h_kv, d),
                   k_cache=mk(b, h_kv, t_max, d), v_cache=mk(b, h_kv, t_max, d), pos=pos)
        twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        return ops, twin

    for dtype in (torch.bfloat16, torch.float32):
        worst, checked = 0.0, 0
        for t_max in DECODE_T:
            for h_kv in DECODE_HKV:
                for d in DECODE_D:
                    positions = sorted({p % t_max for p in DECODE_POS if p < t_max})
                    ops, twin = case(8, t_max, h_kv, d, dtype, 0)
                    for pos in positions:
                        ops["pos"] = twin["pos"] = pos
                        got = da.decode_attention(**ops)[0]
                        again = da.decode_attention(**ops)[0]
                        want = da.decode_attention_plain(**twin)[0]
                        torch.cuda.synchronize()
                        what = f"decode_attention {dtype} T={t_max} Hkv={h_kv} D={d} pos={pos}"
                        err = (got.float() - want.float()).abs().max().item()
                        require(math.isfinite(err) and err <= TOL[dtype], f"{what}: err {err}")
                        require(torch.equal(got, again), f"{what}: two calls differ")
                        require(torch.equal(ops["k_cache"], twin["k_cache"])
                                and torch.equal(ops["v_cache"], twin["v_cache"]),
                                f"{what}: cache rows differ")
                        worst, checked = max(worst, err), checked + 1
        emit("parity_decode_attention", dtype=str(dtype).removeprefix("torch."), b=8, hq=12,
             t=list(DECODE_T), hkv=list(DECODE_HKV), d=list(DECODE_D), cases=checked,
             max_abs_err=worst, tol=TOL[dtype], deterministic=True)
    rows = []
    for b, t_max, pos in DECODE_TIMED:
        dtype = torch.bfloat16
        ops, twin = case(b, t_max, 12, 64, dtype, pos)
        err = (da.decode_attention(**ops)[0].float()
               - da.decode_attention_plain(**twin)[0].float()).abs().max().item()
        require(err <= TOL[dtype], f"decode_attention timing case B={b} T={t_max}: err {err}")
        q4 = ops["q"][:, :, None, :]
        kc, vc = ops["k_cache"][:, :, :pos + 1], ops["v_cache"][:, :, :pos + 1]
        # The launch facts' work at this position (cache rows [0, pos) of K
        # and V read; q, out, k_new, v_new and the written K/V row once).
        facts = da.decode_attention_launches(b, 12, 12, t_max, 64, dtype, pos)
        row = {
            "dtype": "bfloat16", "b": b, "t": t_max, "pos": pos, "hq": 12, "hkv": 12, "d": 64,
            "n_split": da.num_splits(t_max), "max_abs_err": err, "tol": TOL[dtype],
            "ms": timer.ms(lambda: da.decode_attention(**ops)),
            "plain_ms": timer.ms(lambda: da.decode_attention_plain(**twin)),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(q4, kc, vc)),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(sum(f.bytes for f in facts),
                                                    sum(f.flops for f in facts), dtype)
        emit("timing_decode_attention", **row)
        rows.append(row)
    entry, long_row = rows
    entry["long_context"] = {key: long_row[key] for key in (
        "b", "t", "n_split", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err")}
    return entry


# -- phase 3b: the flash kernels against their plain versions ---------------

def _flash_operands(gen, dtype, b, t, hq, h_kv, d, fused):
    """((q_arr, k_arr, v_arr), offsets): the fused (B, T, 3HD) projection
    output read at its q/k/v offsets, or three bthd operands."""
    mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
    if fused:
        arr = mk(b, t, 3 * hq * d)
        return (arr, arr, arr), (0, hq * d, 2 * hq * d)
    return (mk(b, t, hq * d), mk(b, t, h_kv * d), mk(b, t, h_kv * d)), (0, 0, 0)


def _flash_err(got, want, dtype, what):
    """Max abs error; every element is held to ``TOL * (1 + |want|)``, so
    small outputs are held as tightly as large ones."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = TOL[dtype]
    excess = (diff - tol * (1.0 + want.abs())).max().item()
    require(math.isfinite(excess) and excess <= 0.0,
            f"{what}: an element is off by {excess} more than {tol} * (1 + |want|)")
    return diff.max().item()


def fact_bound(*facts) -> tuple:
    """The least time of the work the launch facts declare (their summed
    ``bytes`` and ``flops``, at the first one's ``flop_dtype`` rate)."""
    dtype = getattr(torch, facts[0].flop_dtype)
    return bound_ms(sum(f.bytes for f in facts), sum(f.flops for f in facts), dtype)


def flash_bounds(b, t, hq, h_kv, d, dtype, causal):
    """(fwd, bwd, dq, bwd without dq) least times of the functions, from
    their launch facts' work (``flash_native.flash_work``: each input read
    once, each output written once, 2*D flops per visible (query, key)
    pair and product; the f32 dq partials are the kernel's design, not the
    function's, so they are left out, :func:`dq_partial_bytes`)."""
    def fact(kind, with_dq=True):
        return fa.flash_launch(kind, b, t, hq, h_kv, d, dtype, hq * d, h_kv * d, with_dq,
                               causal=causal)

    return (fact_bound(fact("flash_fwd")), fact_bound(fact("flash_bwd")),
            fact_bound(fact("flash_dq")), fact_bound(fact("flash_bwd", False)))


def sdpa_backward_ms(timer, q, k, v, dout, causal):
    """The yardstick of the flash backward kernels (rows 4, 5 and 7): one
    PyTorch call's autograd backward of SDPA on (B, H, T, D) leaves, the
    flash backend pinned so the yardstick does not move between backends;
    timed only, never used by the port. Three timings, each the median of
    10 launches (a launch that waits on the allocator or the host then
    moves no timing): returns (their median, [min, max])."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        fn = lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)  # noqa: E731
        times = sorted(float(np.median(timer.launches_ms(fn, iters=10, warmup=2)))
                       for _ in range(3))
    return times[1], [times[0], times[2]]


def dq_partial_bytes(b, t, hq, d):
    """The f32 dq partial buffer of ``flash_bwd``: one (B, T, Hq*D) copy per
    TILE-row k-tile."""
    return -(-t // fa.TILE) * b * t * hq * d * 4


def flash_case(timer, gen, b, t, hq, h_kv, d, dtype, causal, fused, time_it=False):
    """flash_fwd / flash_bwd / flash_dq against _fwd_plain / _bwd_plain /
    _dq_plain on the same CUDA tensors, and two launches of each bitwise
    (the backward also without dq, its dk and dv equal to those with it);
    with ``time_it`` also the kernel, plain and SDPA times and the bounds,
    and the backward without dq beside its own bound."""
    (q, k, v), offs = _flash_operands(gen, dtype, b, t, hq, h_kv, d, fused)
    geo = (hq, h_kv, d, offs, causal)
    what = (f"flash {'fused' if fused else 'bthd'} B={b} T={t} Hq={hq} Hkv={h_kv} {dtype} "
            f"causal={causal}")
    out, lse = fa.flash_fwd(q, k, v, *geo)
    out2, lse2 = fa.flash_fwd(q, k, v, *geo)
    require(torch.equal(out, out2) and torch.equal(lse, lse2), f"{what}: two launches differ")
    del out2, lse2
    out_p, lse_p = fa._fwd_plain(q, k, v, *geo)
    err = {"fwd": max(_flash_err(out, out_p, dtype, what + " out"),
                      _flash_err(lse, lse_p, dtype, what + " lse"))}
    del out_p, lse_p
    dout = torch.randn(b, t, hq * d, generator=gen).to(dtype).cuda()
    delta = (dout.float() * out.float()).reshape(b, t, hq, d).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, *geo)
    dqp, dk, dv = fa.flash_bwd(*args)
    dqp2, dk2, dv2 = fa.flash_bwd(*args)
    require(torch.equal(dqp, dqp2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
            f"{what}: two backward launches differ")
    none, dk2, dv2 = fa.flash_bwd(*args, with_dq=False)
    require(none is None and torch.equal(dk, dk2) and torch.equal(dv, dv2),
            f"{what}: dk/dv differ without dq")
    del dqp2, dk2, dv2
    dqp_p, dk_p, dv_p = fa._bwd_plain(*args)
    err["bwd_nodq"] = max(_flash_err(dk, dk_p, dtype, what + " dk"),
                          _flash_err(dv, dv_p, dtype, what + " dv"))
    err["bwd"] = max(err["bwd_nodq"],
                     _flash_err(dqp.sum(0), dqp_p.sum(0), dtype, what + " bwd dq"))
    del dqp, dqp_p, dk_p, dv_p
    dq = fa.flash_dq(*args)
    require(torch.equal(dq, fa.flash_dq(*args)), f"{what}: two dq launches differ")
    err["dq"] = _flash_err(dq, fa._dq_plain(*args), dtype, what + " dq")
    del dq
    torch.cuda.synchronize()
    row = {"layout": "fused" if fused else "bthd", "dtype": str(dtype).removeprefix("torch."),
           "b": b, "t": t, "hq": hq, "hkv": h_kv, "d": d, "causal": causal,
           "max_abs_err": err, "tol": TOL[dtype], "deterministic": True,
           "tensor_cores": {kind: fa.tensor_cores(kind, dtype)
                            for kind in ("flash_fwd", "flash_bwd", "flash_dq")}}
    if not time_it:
        return row
    # The yardsticks take (B, H, T, D) leaves; GQA's K/V heads are repeated
    # to the query heads first (untimed), which SDPA's flash backward needs.
    heads = lambda a, off, n: a[..., off:off + n * d].reshape(b, t, n, d).transpose(1, 2)  # noqa
    qh, kh, vh = (heads(a, o, n).repeat_interleave(hq // n, 1).contiguous().requires_grad_()
                  for a, o, n in ((q, offs[0], hq), (k, offs[1], h_kv), (v, offs[2], h_kv)))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)  # noqa: E731
    dout_h = dout.reshape(b, t, hq, d).transpose(1, 2)
    ms = lambda fn: timer.ms(fn, iters=10, warmup=2)  # noqa: E731
    bounds = flash_bounds(b, t, hq, h_kv, d, dtype, causal)
    lib_bwd = sdpa_backward_ms(timer, qh, kh, vh, dout_h, causal)
    for name, kernel, plain, library, bound in (
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v, *geo),
         lambda: fa._fwd_plain(q, k, v, *geo), (ms(sdpa), None), bounds[0]),
        ("flash_bwd", lambda: fa.flash_bwd(*args), lambda: fa._bwd_plain(*args), lib_bwd,
         bounds[1]),
        ("flash_dq", lambda: fa.flash_dq(*args), lambda: fa._dq_plain(*args), lib_bwd,
         bounds[2]),
        ("flash_bwd_nodq", lambda: fa.flash_bwd(*args, with_dq=False),
         lambda: fa._bwd_plain(*args, with_dq=False), lib_bwd, bounds[3]),
    ):
        row[name] = {"ms": ms(kernel), "plain_ms": ms(plain), "library_ms": library[0],
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "max_abs_err": err[name.removeprefix("flash_")]}
        if library[1] is not None:
            row[name]["library_spread_ms"] = library[1]
    # The design cost of the partials: writing them once at the HBM rate.
    partials = dq_partial_bytes(b, t, hq, d)
    row["flash_bwd"].update(dq_partial_bytes=partials,
                            dq_partial_write_ms=partials / HBM_BYTES_PER_S * 1e3)
    return row


def time_dq_strategies(timer, gen):
    """The backward's two dq strategies end to end — delta, the kernels
    and, for the partials, their f32 sum — on one fused MHA bf16 causal
    operand at B=8, H=12, D=64, T=1024 and 2048: ``flash_bwd`` with dq
    partials (``dq_split=False``) against ``flash_bwd`` without dq plus
    ``flash_dq`` (``dq_split=True``). Both must give the same dq, dk, dv."""
    b, hq, d, dtype = 8, 12, 64, torch.bfloat16
    rows = []
    for t in (1024, 2048):
        (q, k, v), offs = _flash_operands(gen, dtype, b, t, hq, hq, d, True)
        out, lse = fa.flash_fwd(q, k, v, hq, hq, d, offs, True)
        dout = torch.randn(b, t, hq * d, generator=gen).to(dtype).cuda()
        run = lambda split: fa._backward(q, k, v, out, lse, dout, hq, hq, d, offs,  # noqa: E731
                                         True, split)
        (dq_p, dk_p, dv_p), (dq_s, dk_s, dv_s) = run(False), run(True)
        require(torch.equal(dk_p, dk_s) and torch.equal(dv_p, dv_s),
                f"dq strategies T={t}: dk/dv differ")
        err = _flash_err(dq_p, dq_s, dtype, f"dq strategies T={t}: dq")
        del dq_p, dk_p, dv_p, dq_s, dk_s, dv_s
        ms = lambda split: timer.ms(lambda: run(split), iters=10, warmup=2)  # noqa: E731
        partials = dq_partial_bytes(b, t, hq, d)
        row = {"b": b, "t": t, "hq": hq, "d": d, "dtype": "bfloat16", "causal": True,
               "partials_ms": ms(False), "split_ms": ms(True), "dq_max_abs_err": err,
               "dq_partial_bytes": partials,
               "auto": "split" if partials > fa.DQ_PARTIALS_MAX_BYTES else "partials"}
        emit("dq_strategies", **row)
        rows.append(row)
    return rows


def check_flash(timer, gen):
    """GPT-2 shapes (B=8, T=1024, H=12, D=64): the fused MHA operand the
    train phase feeds the kernels (timed in bf16), and GQA bthd operands
    (Hq=12, Hkv=4), causal and not, bf16 and f32; then head dim 32 at the
    moe_lm example's shape."""
    timed = None
    for fused, h_kv, causal, dtype in (
        (True, 12, True, torch.bfloat16), (True, 12, True, torch.float32),
        (False, 4, True, torch.bfloat16), (False, 4, False, torch.bfloat16),
        (False, 4, True, torch.float32), (False, 4, False, torch.float32),
    ):
        time_it = timed is None
        row = flash_case(timer, gen, 8, 1024, 12, h_kv, 64, dtype, causal, fused, time_it)
        emit("parity_flash", **row)
        if time_it:
            timed = row
    # Head dim 32: the moe_lm example's attention (B=64, T=128, dim 128 in
    # 4 heads), f32 as the example runs and bf16.
    for dtype in (torch.float32, torch.bfloat16):
        emit("parity_flash", **flash_case(timer, gen, 64, 128, 4, 4, 32, dtype, True, True))
    prec_flash_bwd(gen)
    return timed


def require_f32_accumulation(what: str, errs: dict) -> None:
    """A kernel declaring an f32 accumulator must beat the same sum carried
    in bf16 across its K tiles (``ops/accuracy.py``)."""
    require(errs["kernel"] < errs["bf16_tiles"],
            f"{what}: error {errs['kernel']} against the f64 sum is not below the "
            f"bf16 tile-wise sum's {errs['bf16_tiles']} over {errs['contraction']}")


def prec_flash_bwd(gen) -> dict:
    """Row 4's dk and dv over GPT-2's T=1024 queries (B=2, H=12, D=64,
    bf16, causal, the fused operand): the kernel's error against the f64
    sums of the plain version's p and ds, beside the same sums carried in
    bf16 one TILE of queries at a time (``ops/accuracy.py``)."""
    b, t, h, d, dtype = 2, 1024, 12, 64, torch.bfloat16
    (q, k, v), offs = _flash_operands(gen, dtype, b, t, h, h, d, True)
    geo = (h, h, d, offs, True)
    out, lse = fa.flash_fwd(q, k, v, *geo)
    dout = torch.randn(b, t, h * d, generator=gen).to(dtype).cuda()
    delta = (dout.float() * out.float()).reshape(b, t, h, d).sum(-1).transpose(1, 2).contiguous()
    _, dk, dv = fa.flash_bwd(q, k, v, dout, lse, delta, *geo, with_dq=False)
    p, ds, qf, _kf, do = fa._probs_and_ds(q, k, v, dout, lse, delta, h, h, d, offs, True)
    errs = accuracy.flash_bwd_errors(p, ds, qf, do, dk, dv, fa.TILE)
    emit("parity_prec", kernel="flash_bwd", b=b, t=t, h=h, d=d, tile=fa.TILE, **errs)
    for name, e in errs.items():
        require_f32_accumulation(f"flash_bwd {name}", e)
    return errs


#: Rows 3-4 at the examples' main-path shapes: vit_cifar's vit_tiny (B=512,
#: T=65, 3 heads of 64, non-causal, the fused (512, 65, 576) qkv operand)
#: and llama_lm's (B=128, T=256, 8 query heads over 4 K/V heads of 32,
#: causal, bthd). Row 2 at llama_lm's nucleus sample: B=1, 8 query heads
#: over 4 K/V heads of 32, a 68-row cache, positions around the first
#: 64-row split and its last row (timed there).
EXAMPLE_FLASH = {"vit": (512, 65, 3, 3, 64, False, True),
                 "llama": (128, 256, 8, 4, 32, True, False)}
LLAMA_DECODE = {"b": 1, "hq": 8, "hkv": 4, "d": 32, "t": 68, "positions": (0, 63, 64, 67)}


def check_flash_examples(timer, gen):
    """Rows 3-4 at the ViT and Llama examples' shapes in bf16 (and row 5,
    which flash_case also holds), each against its plain version, two
    launches bitwise, timed beside its bound and SDPA (non-causal for ViT;
    the backward's yardstick SDPA's autograd backward with the flash backend
    pinned); then row 2 at the Llama example's decode shape against its
    plain version, two calls bitwise, the written cache rows bitwise, timed
    at the last row beside SDPA over the visible rows. Returns
    ``{"vit": row, "llama": row, "llama_decode": row}``."""
    rows = {}
    for name, (b, t, hq, h_kv, d, causal, fused) in EXAMPLE_FLASH.items():
        row = flash_case(timer, gen, b, t, hq, h_kv, d, torch.bfloat16, causal, fused,
                         time_it=True)
        emit("parity_flash_vit", example=name, **row)
        rows[name] = row
    c = LLAMA_DECODE
    b, hq, h_kv, d, t_max = c["b"], c["hq"], c["hkv"], c["d"], c["t"]
    dtype = torch.bfloat16
    mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
    ops = dict(q=mk(b, hq, d), k_new=mk(b, h_kv, d), v_new=mk(b, h_kv, d),
               k_cache=mk(b, h_kv, t_max, d), v_cache=mk(b, h_kv, t_max, d), pos=0)
    twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
    worst = 0.0
    for pos in c["positions"]:
        ops["pos"] = twin["pos"] = pos
        got = da.decode_attention(**ops)[0]
        again = da.decode_attention(**ops)[0]
        want = da.decode_attention_plain(**twin)[0]
        torch.cuda.synchronize()
        what = f"decode_attention llama B={b} Hq={hq} Hkv={h_kv} D={d} pos={pos}"
        err = (got.float() - want.float()).abs().max().item()
        require(math.isfinite(err) and err <= TOL[dtype], f"{what}: err {err}")
        require(torch.equal(got, again), f"{what}: two calls differ")
        require(torch.equal(ops["k_cache"], twin["k_cache"])
                and torch.equal(ops["v_cache"], twin["v_cache"]), f"{what}: cache rows differ")
        worst = max(worst, err)
    pos = c["positions"][-1]
    q4 = ops["q"][:, :, None, :]
    kc, vc = ops["k_cache"][:, :, :pos + 1], ops["v_cache"][:, :, :pos + 1]
    # The launch facts' work at this position (cache rows [0, pos) of K and
    # V read; q and out, k_new and v_new, and the written K/V row once).
    facts = da.decode_attention_launches(b, hq, h_kv, t_max, d, dtype, pos)
    row = {"example": "llama", "dtype": "bfloat16", **c, "n_split": da.num_splits(t_max),
           "max_abs_err": worst, "tol": TOL[dtype], "deterministic": True,
           "ms": timer.ms(lambda: da.decode_attention(**ops)),
           "plain_ms": timer.ms(lambda: da.decode_attention_plain(**twin)),
           "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                                         enable_gqa=True))}
    row["bound_ms"], row["bound_by"] = bound_ms(sum(f.bytes for f in facts),
                                                sum(f.flops for f in facts), dtype)
    emit("parity_flash_vit", **row)
    rows["llama_decode"] = row
    return rows


def check_flash_long(timer, gen):
    """The train_long phase's shape (B=8, T=2048, fused MHA, bf16, causal),
    where the dq partial buffer passes DQ_PARTIALS_MAX_BYTES: all three
    kernels held to their plain versions there, timed for flash_dq."""
    row = flash_case(timer, gen, 8, 2048, 12, 12, 64, torch.bfloat16, True, True, time_it=True)
    emit("parity_flash", **row)
    return row


# -- phase 3c: the fused attention half against its plain version ----------

#: Rows 6-7 (``ops/flash_attention.py``, the stacked (3, B, H, T, D) operand)
#: against their plain versions: (B, H, T, D, dtype, causal, block_q,
#: block_k). GPT-2 124M's attention width in both dtypes and both compiled
#: tiles, a non-causal asymmetric pair, T=2048, and D=32 once.
QKV_CASES = [
    (8, 12, 1024, 64, torch.bfloat16, True, 128, 128),
    (8, 12, 1024, 64, torch.bfloat16, True, 64, 64),
    (8, 12, 1024, 64, torch.float32, True, 128, 128),
    (8, 12, 1024, 64, torch.float32, True, 64, 64),
    (8, 12, 1024, 64, torch.bfloat16, False, 128, 64),
    (8, 12, 1024, 64, torch.float32, False, 128, 64),
    (8, 12, 2048, 64, torch.bfloat16, True, 128, 128),
    (8, 12, 1024, 32, torch.bfloat16, True, 128, 128),
]


def qkv_bounds(b, h, t, d, dtype, causal, block_k):
    """Least times of rows 6-7 as the kernels define them, from their launch
    facts' work (``flash_attention.qkv_work``: the forward reads the stacked
    qkv and writes out and lse; the backward reads qkv, dout, lse and delta
    and writes its dq partials, one (B, H, T, D) copy per block_k key rows,
    dk and dv). Returns (fwd, bwd, bwd with dq written once instead of the
    partials, the partials' bytes)."""
    fwd, bwd = (fqa.qkv_launch(kind, b, h, t, d, dtype, block_k, block_k, causal)
                for kind in ("fwd", "bwd"))
    act = b * h * t * d * torch.empty((), dtype=dtype).element_size()
    partials = (t // block_k) * act
    return (fact_bound(fwd), fact_bound(bwd),
            bound_ms(bwd.bytes - partials + act, bwd.flops, dtype), partials)


def qkv_case(timer, gen, b, h, t, d, dtype, causal, bq, bk, time_it=False):
    """Rows 6-7 against their plain versions on the same CUDA tensors: the
    forward (out, lse) and the whole backward (dq through its partials' f32
    sum, dk, dv), every element within ``TOL * (1 + |want|)``, two launches
    bitwise; with ``time_it`` also timed with the L2 flushed, beside the
    plain versions and SDPA's forward and autograd backward (yardsticks
    only) and the bounds."""
    name = str(dtype).removeprefix("torch.")
    what = f"flash_qkv B={b} H={h} T={t} D={d} {name} causal={causal} tiles {bq}/{bk}"
    qkv = torch.randn(3, b, h, t, d, generator=gen).to(dtype).cuda()
    dout = torch.randn(b, h, t, d, generator=gen).to(dtype).cuda()
    out, lse = fqa.flash_qkv_fwd(qkv, causal, bq, bk)
    out2, lse2 = fqa.flash_qkv_fwd(qkv, causal, bq, bk)
    delta = (out.float() * dout.float()).sum(-1).unsqueeze(2)
    args = (qkv, out, lse, dout, delta, causal, bq, bk)
    dqp, dk, dv = fqa.flash_qkv_bwd(*args)
    again = fqa.flash_qkv_bwd(*args)
    torch.cuda.synchronize()
    require(torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip((dqp, dk, dv), again)),
            f"{what}: two launches differ")
    del out2, lse2, again
    out_p, lse_p = fqa._fwd_plain(qkv, causal, bq, bk)
    err = {"fwd": max(_flash_err(out, out_p, dtype, what + " out"),
                      _flash_err(lse, lse_p, dtype, what + " lse"))}
    del out_p, lse_p
    dqp_p, dk_p, dv_p = fqa._bwd_plain(*args)
    err["bwd"] = max(_flash_err(dqp.float().sum(0), dqp_p.float().sum(0), dtype, what + " dq"),
                     _flash_err(dk, dk_p, dtype, what + " dk"),
                     _flash_err(dv, dv_p, dtype, what + " dv"))
    del dqp, dk, dv, dqp_p, dk_p, dv_p
    row = {"b": b, "h": h, "t": t, "d": d, "dtype": name, "causal": causal,
           "block_q": bq, "block_k": bk, "max_abs_err": err, "tol": TOL[dtype],
           "deterministic": True}
    if time_it:
        q, k, v = (x.detach().requires_grad_() for x in qkv.unbind(0))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa
        lib_bwd = sdpa_backward_ms(timer, q, k, v, dout, causal)
        ms = lambda fn: timer.ms(fn, iters=10, warmup=2)  # noqa: E731
        fwd_b, bwd_b, bwd_dq_once, partials = qkv_bounds(b, h, t, d, dtype, causal, bk)
        row["flash_qkv_fwd"] = {
            "ms": ms(lambda: fqa.flash_qkv_fwd(qkv, causal, bq, bk)),
            "plain_ms": ms(lambda: fqa._fwd_plain(qkv, causal, bq, bk)),
            "library_ms": ms(sdpa), "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
            "max_abs_err": err["fwd"]}
        row["flash_qkv_bwd"] = {
            "ms": ms(lambda: fqa.flash_qkv_bwd(*args)),
            "plain_ms": ms(lambda: fqa._bwd_plain(*args)),
            "library_ms": lib_bwd[0], "library_spread_ms": lib_bwd[1],
            "bound_ms": bwd_b[0], "bound_by": bwd_b[1],
            "max_abs_err": err["bwd"], "dq_partial_bytes": partials,
            "dq_partial_write_ms": partials / HBM_BYTES_PER_S * 1e3,
            "bound_dq_once_ms": bwd_dq_once[0], "bound_dq_once_by": bwd_dq_once[1]}
        row["occupancy"] = {kind: fqa.occupancy(kind, fqa.kernel_dim(d), bq, bk, dtype)
                            for kind in ("fwd", "bwd")}
    return row


def check_flash_qkv(timer, gen):
    """Rows 6-7 at :data:`QKV_CASES` (:func:`qkv_case`); at the GPT-2 bf16
    causal shape both compiled tiles are timed."""
    timed = {}
    for b, h, t, d, dtype, causal, bq, bk in QKV_CASES:
        time_it = (t, d, dtype, causal) == (1024, 64, torch.bfloat16, True)
        row = qkv_case(timer, gen, b, h, t, d, dtype, causal, bq, bk, time_it)
        if time_it:
            timed[(bq, bk)] = row
        emit("parity_flash_qkv", **row)
    return timed


#: The tuner's cases driven on the card by ``tune_phase``.
TUNE_CASES = ["flash_fwd/gpt2", "flash_bwd/gpt2", "gmm/moe_bench", "block_attn/charlm",
              "fused_conv/resnet18"]


def _seeded_bad_sweep():
    """A wrong-but-fast variant in a test-only TuneSpace (the reference's
    ``scripts/tune_structural_smoke.py`` leg 3) on CUDA tensors: the parity
    gate must discard it before timing."""
    space = TuneSpace(kernel="smoke_fake", axes={"impl": ("reference", "wrongfast")},
                      shape_keys=("n",), default=lambda shape: {"impl": "reference"},
                      structural=("impl",),
                      doc="test-only: 'wrongfast' returns a scaled (wrong) output instantly")
    TUNE_SPACES[space.kernel] = space
    try:
        qkv = torch.randn(3, 8, 12, 1024, 64, device="cuda").to(torch.bfloat16)

        def build(device):
            def run(config):
                if config["impl"] == "wrongfast":
                    return qkv[0] * 1.5  # fast AND wrong
                return fqa.flash_attention_qkv(qkv)
            return run

        report = sweep_case(TuneCase(name="fake/seeded_bad", kernel="smoke_fake",
                                     shape={"n": 1024}, dtype="bfloat16", build=build),
                            device="cuda", iters=3, min_speedup=1.0)
    finally:
        del TUNE_SPACES[space.kernel]
    (bad,) = report.results
    require(not bad.parity_ok and bad.mean_us is None and report.winner is None,
            f"tune: the seeded-bad variant was not rejected before timing: {bad}")
    return {"config": bad.config, "parity_ok": bad.parity_ok, "max_err": bad.max_err,
            "timed": bad.mean_us is not None}


@contextlib.contextmanager
def _tune_dir(path):
    """Point the tune lookup at ``path`` for the block."""
    prev = os.environ.get("ROCKET_TPU_TUNE_DIR")
    os.environ["ROCKET_TPU_TUNE_DIR"] = str(path)
    tune.reset_table_cache()
    tune.reset_lookup_log()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("ROCKET_TPU_TUNE_DIR", None)
        else:
            os.environ["ROCKET_TPU_TUNE_DIR"] = prev
        tune.reset_table_cache()


def tune_phase(card):
    """``python -m rocket_tpu_torch.tune`` on the card over :data:`TUNE_CASES`
    into a copy of the shipped (empty) tables: every timed candidate passed
    parity, the written tables validate, a seeded-bad variant is rejected.
    Then rows 6-7 read the written flash tables through
    ``ROCKET_TPU_TUNE_DIR`` on the main path of this slice, GPT-2's
    attention (B=8, H=12, T=1024, D=64, bf16, causal) forward and backward
    three times: each lookup a table hit, each call one launch of each
    kernel. Where the sweep found no flash winner (the default kept), the
    fastest candidate is written in as a stand-in so that the read path is
    still driven; the record says so. Returns the launches of that drive."""
    with tempfile.TemporaryDirectory() as tmp:
        tables = Path(tmp) / "tables"
        shutil.copytree(tune.CONFIGS_DIR, tables)
        cmd = [sys.executable, "-m", "rocket_tpu_torch.tune", *sum((["--case", c]
               for c in TUNE_CASES), []), "--update-table", "--table-dir", str(tables), "--json"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)))
        wall = time.perf_counter() - t0
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "tune_log.txt").write_text(proc.stderr)
        require(proc.returncode == 0, f"tune CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        require(sorted(summary["cases"]) == sorted(TUNE_CASES),
                f"tune: cases {sorted(summary['cases'])}")
        cases = {}
        for name, rec in summary["cases"].items():
            require(rec["default_us"] and rec["candidates"], f"tune {name}: nothing timed")
            for cand in rec["candidates"]:
                # A candidate outside the parity bound is rejected and never
                # timed; every timed one passed it.
                require(cand["error"] is None and (cand["us"] is None) == (not cand["parity_ok"]),
                        f"tune {name}: candidate {cand}")
            win = rec["winner"]
            cases[name] = {"default": rec["default_config"], "default_us": rec["default_us"],
                           "candidates": {json.dumps(c["config"], sort_keys=True): c["us"]
                                          for c in rec["candidates"] if c["parity_ok"]},
                           "rejected_parity": [{"config": c["config"], "max_err": c["max_err"]}
                                               for c in rec["candidates"] if not c["parity_ok"]],
                           "winner": None if win is None else win["config"],
                           "speedup": None if win is None else win["speedup"]}
        problems = tune.validate_tables(str(tables))
        require(not problems, f"tune: the written tables fail the gate: {problems}")
        bad = _seeded_bad_sweep()

        b, h, t, d, dtype = 8, 12, 1024, 64, torch.bfloat16
        shape = {"t": t, "d": d, "h": h, "h_kv": h, "causal": True}
        stand_in = []
        for kernel in ("flash_fwd", "flash_bwd"):
            table = tune.load_table(kernel, str(tables), use_cache=False)
            if not table["entries"]:
                rec = cases[f"{kernel}/gpt2"]
                best = min(rec["candidates"], key=rec["candidates"].get)
                tune.write_table(kernel, [{
                    "device_kind": summary["device_kind"], "dtype": "bfloat16",
                    "shape": shape, "shape_bucket": TUNE_SPACES[kernel].bucket(shape),
                    "config": json.loads(best), "stand_in": True}], str(tables))
                stand_in.append(kernel)
        written = {k: tune.load_table(k, str(tables), use_cache=False)["entries"][0]["config"]
                   for k in ("flash_fwd", "flash_bwd")}
        with _tune_dir(tables):
            blocks = fqa.resolve_tuned_blocks(t, d, h, h, dtype, True, None, None, None, None)
            qkv = torch.randn(3, b, h, t, d, device="cuda").to(dtype).requires_grad_()
            zero_launches()
            for _ in range(3):
                out = fqa.flash_attention_qkv(qkv)
                out.float().square().sum().backward()
            torch.cuda.synchronize()
            launches = {"flash_qkv_fwd": fqa.flash_qkv_fwd.launches,
                        "flash_qkv_bwd": fqa.flash_qkv_bwd.launches}
            log = tune.lookup_log_summary()
        want = (written["flash_fwd"]["block_q"], written["flash_fwd"]["block_k"],
                written["flash_bwd"]["block_q"], written["flash_bwd"]["block_k"])
        require(blocks == want, f"tune: resolved blocks {blocks}, the tables hold {want}")
        require(sorted(r["kernel"] for r in log if r["source"] == "table")
                == ["flash_bwd", "flash_fwd"] and all(r["source"] == "table" for r in log),
                f"tune: lookups {log}")
        require(launches == {"flash_qkv_fwd": 3, "flash_qkv_bwd": 3}, f"tune: launches {launches}")
        require(bool(torch.isfinite(qkv.grad.float()).all()), "tune: non-finite gradient")
    for name, rec in cases.items():
        print(f"tune {name}: default {rec['default_us']:.1f} us, winner {rec['winner']}, "
              f"speedup {rec['speedup']}", flush=True)
    # Row 8's kernel variants (impl "fused") in the block_attn case: which
    # passed the bf16 parity gate and were timed, and which it rejected.
    block = cases["block_attn/charlm"]
    block_kernel = {"timed": {c: us for c, us in block["candidates"].items()
                              if json.loads(c)["impl"] == "fused"},
                    "rejected_parity": [r for r in block["rejected_parity"]
                                        if r["config"]["impl"] == "fused"]}
    print(f"tune block_attn/charlm kernel variants: {len(block_kernel['timed'])} timed, "
          f"{len(block_kernel['rejected_parity'])} rejected by the parity gate", flush=True)
    emit("tune", cases=cases, seeded_bad=bad, validate_problems=problems,
         block_attn_kernel_variants=block_kernel,
         written_flash=written, stand_in=stand_in, resolved_blocks=list(blocks),
         lookups=log, launches=launches, cli_wall_s=wall, card=card)
    return launches


def block_bounds(b, t, d, h, dtype, epilogue):
    """Least time of the fused block function, from its launch fact's work
    (``fused_block.fused_block_work``: x read and the output written once,
    the weights it uses read once; the QKV projection, the causal QK^T and
    PV products and, fused, the output projection)."""
    return fact_bound(fb.fused_block_launch(b, t, d, h, dtype, epilogue))


def _block_operands(gen, dtype, b, t, h):
    """x in the dtype; the layer's f32 master params (scale, bias, wqkv,
    bqkv, wproj, bproj) as ``Block`` passes them."""
    d = 64 * h
    mk = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen) * s).cuda()  # noqa: E731
    return [mk(b, t, d, s=0.5).to(dtype), 1.0 + mk(d, s=0.1), mk(d, s=0.1),
            mk(d, 3 * d, s=d ** -0.5), mk(3 * d, s=0.01), mk(d, d, s=d ** -0.5), mk(d, s=0.01)]


def check_fused_block(timer, gen):
    """``block_attn_half``'s forward (the kernel) against
    ``reference_block_attn`` on the same CUDA tensors: the char-LM shape
    (B=128, T=256, D=256, H=4) and a ragged one (B=3, T=100), bf16 and
    f32, both epilogues, ``block_b`` 1 and 2 where B tiles, two launches
    bitwise (bf16 runs on the tensor cores, f32 on the CUDA cores). At the char-LM
    shape in bf16 also the kernel, its plain version and the library
    chain (``F.layer_norm`` -> ``F.linear`` -> SDPA -> ``F.linear``, four
    calls: no single PyTorch call computes this function), timed."""
    timed = {}
    for (b, t, h), dtype, epilogue in [
        (shape, dtype, epilogue) for shape in ((128, 256, 4), (3, 100, 4))
        for dtype in (torch.bfloat16, torch.float32) for epilogue in fb.EPILOGUES
    ]:
        ops = _block_operands(gen, dtype, b, t, h)
        with torch.no_grad():
            want = fb.reference_block_attn(*ops, num_heads=h, epilogue=epilogue)
            errs = {}
            for block_b in (1, 2):
                if b % block_b:
                    continue
                got = fb.block_attn_half(*ops, num_heads=h, epilogue=epilogue, block_b=block_b)
                errs[block_b] = _flash_err(got, want, dtype, f"fused_block {epilogue} B={b} "
                                           f"T={t} {dtype} block_b={block_b}")
            again = fb.block_attn_half(*ops, num_heads=h, epilogue=epilogue)
            require(torch.equal(got, again), f"fused_block {epilogue} B={b} T={t} {dtype}: "
                    "two launches differ")
        torch.cuda.synchronize()
        row = {"dtype": str(dtype).removeprefix("torch."), "epilogue": epilogue, "b": b, "t": t,
               "d": 64 * h, "h": h, "max_abs_err": max(errs.values()),
               "max_abs_err_by_block_b": errs, "tol": TOL[dtype], "deterministic": True,
               "tensor_cores": dtype == torch.bfloat16,
               "occupancy": fb.occupancy(t, epilogue, dtype)}
        if (b, t, dtype) == (128, 256, torch.bfloat16):
            x, ln_s, ln_b, wqkv, bqkv, wproj, bproj = ops
            ln = torch.stack([ln_s, ln_b])
            cast = [w.to(dtype).contiguous() for w in (wqkv, bqkv, wproj, bproj)]
            kw = dict(num_heads=h, epilogue=epilogue)
            wqkv_t, wproj_t = cast[0].t().contiguous(), cast[2].t().contiguous()
            ln_c = [ln_s.to(dtype), ln_b.to(dtype)]

            def chain():
                y = F.linear(F.layer_norm(x, (64 * h,), *ln_c), wqkv_t, cast[1])
                q, k, v = y.reshape(b, t, 3, h, 64).permute(2, 0, 3, 1, 4)
                o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
                o = o.transpose(1, 2).reshape(b, t, 64 * h)
                return F.linear(o, wproj_t, cast[3]) if epilogue == "fused" else o

            with torch.no_grad():
                row.update(ms=timer.ms(lambda: fb.fused_block(x, ln, *cast, **kw), iters=10),
                           plain_ms=timer.ms(lambda: fb.fused_block_plain(x, ln, *cast, **kw),
                                             iters=10),
                           library_ms=timer.ms(chain, iters=10),
                           library="F.layer_norm -> F.linear -> SDPA"
                           + (" -> F.linear" if epilogue == "fused" else ""))
            row["bound_ms"], row["bound_by"] = block_bounds(b, t, 64 * h, h, dtype, epilogue)
            timed[epilogue] = row
        emit("parity_fused_block", **row)
    return timed


# -- phase 3d: the fused BatchNorm epilogue against its plain version -------

#: ResNet-18 CIFAR train shapes at B=512 (stem and stage 1, then stages
#: 2-4) in f32, and the tuner's bf16 shapes (rocket_tpu/tune/tuner.py:737-740).
BN_SHAPES = [(524288, 64, torch.float32), (131072, 128, torch.float32),
             (32768, 256, torch.float32), (8192, 512, torch.float32),
             (262144, 64, torch.bfloat16), (401408, 64, torch.bfloat16)]


def bn_bounds(n, c, dtype):
    """(twopass, normalize) least times, from the work their launch facts
    carry (``fused_conv.bn_work`` over the whole C: x read once and y
    written once, plus scale/bias and stats or the (4, C) rows; 7 and 4
    flops an element at the f32 rate)."""
    return tuple(bound_ms(*fc.bn_work(kind, n, c, dtype), torch.float32)
                 for kind in ("twopass", "normalize"))


def _bn_excess(got, want, dtype):
    """Largest excess of |got - want| over atol + rtol * |want| (<= 0 passes)
    and the max abs error."""
    atol, rtol = BN_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    return (diff - atol - rtol * want.float().abs()).max().item(), diff.max().item()


def check_fused_conv(timer, gen):
    """Both fused BatchNorm kernels against their plain versions on the
    same CUDA tensors, act on and off, at :data:`BN_SHAPES`; two launches
    of the two-pass kernel must give the same bits. At each shape with the
    relu (the main path's epilogue of conv1 of every block) the kernels,
    their plain versions and the library yardstick ``F.batch_norm`` [+
    ``F.relu``] (training mode for row 9, given the statistics for row 10;
    timed only, never called by the port) are timed."""
    timed = {}
    for n, c, dtype in BN_SHAPES:
        x = (torch.randn(n, c, generator=gen) * 2 + 0.5).to(dtype).cuda()
        sc = torch.stack([1 + 0.1 * torch.randn(c, generator=gen),
                          0.1 * torch.randn(c, generator=gen)]).cuda()
        name = str(dtype).removeprefix("torch.")
        for act in (True, False):
            what = f"fused_conv N={n} C={c} {name} act={act}"
            y, stats = fc.bn_twopass(x, sc, eps=1e-5, act=act)
            y2, stats2 = fc.bn_twopass(x, sc, eps=1e-5, act=act)
            want_y, want_stats = fc.bn_twopass_plain(x, sc, eps=1e-5, act=act)
            mi = fc.epilogue_rows(want_stats, sc[0], sc[1], 1e-5).contiguous()
            yn = fc.bn_normalize(x, mi, act=act)
            want_yn = fc.bn_normalize_plain(x, mi, act=act)
            torch.cuda.synchronize()
            require(torch.equal(y, y2) and torch.equal(stats, stats2),
                    f"{what}: two launches differ")
            ex_y, err_y = _bn_excess(y, want_y, dtype)
            ex_s, err_s = _bn_excess(stats, want_stats, torch.float32)
            ex_n, err_n = _bn_excess(yn, want_yn, dtype)
            require(max(ex_y, ex_s, ex_n) <= 0 and math.isfinite(ex_y + ex_s + ex_n),
                    f"{what}: y {ex_y}, stats {ex_s}, normalize {ex_n} past the bound")
            row = {"n": n, "c": c, "dtype": name, "act": act, "tol": BN_TOL[dtype],
                   "twopass": {"max_abs_err": max(err_y, err_s)},
                   "normalize": {"max_abs_err": err_n}, "deterministic": True}
            if act:
                w, b = sc[0], sc[1]
                mean = want_stats[:, 0].contiguous()
                var = torch.clamp(want_stats[:, 1] - mean.square(), min=0.0)
                lib_train = lambda: F.relu(F.batch_norm(  # noqa: E731
                    x, None, None, w, b, training=True, eps=1e-5))
                lib_eval = lambda: F.relu(F.batch_norm(  # noqa: E731
                    x, mean, var, w, b, training=False, eps=1e-5))
                bounds = bn_bounds(n, c, dtype)
                for key, kernel, plain, library, bound in (
                    ("twopass", lambda: fc.bn_twopass(x, sc, eps=1e-5, act=True),
                     lambda: fc.bn_twopass_plain(x, sc, eps=1e-5, act=True), lib_train, bounds[0]),
                    ("normalize", lambda: fc.bn_normalize(x, mi, act=True),
                     lambda: fc.bn_normalize_plain(x, mi, act=True), lib_eval, bounds[1]),
                ):
                    row[key].update(ms=timer.ms(kernel), plain_ms=timer.ms(plain),
                                    library_ms=timer.ms(library), bound_ms=bound[0],
                                    bound_by=bound[1])
                timed[(n, c, name)] = row
            emit("parity_fused_conv", **row)
        del x, y, y2, want_y, yn, want_yn
    return timed


# -- phases 4-6: the main path ---------------------------------------------

def serve_phase(model, params, card):
    engine = ServeEngine(model, params, ServeConfig(max_slots=8, block_len=16, prefill_chunk=64),
                         generator=torch.Generator().manual_seed(0))
    warm = [engine.submit(np.arange(40, dtype=np.int32), max_new_tokens=4) for _ in range(2)]
    engine.drain()
    require(all(engine.result(r).finished for r in warm), "serve warmup did not finish")
    engine.reset_metrics()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=16)]
    waves0 = engine.engine.decode_waves
    zero_launches()
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=64, temperature=0.0) for p in prompts]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode.launches
    waves = engine.engine.decode_waves - waves0
    rep = engine.report()
    require(rep["requests"]["completed"] == 16, f"serve completed {rep['requests']}")
    for r in rids:
        toks = engine.result(r).tokens
        require(len(toks) == 64 and all(0 <= t < model.config.vocab_size for t in toks),
                f"request {r} produced {len(toks)} tokens")
    require(launches == model.config.num_layers * waves,
            f"paged_decode launched {launches} times over {waves} waves")
    ttft, itl = rep["time_to_first_token_s"], rep["inter_token_latency_s"]
    emit("serve", model="gpt2_124m", dtype="bfloat16", requests=16, new_tokens=64,
         prompt_lens=[len(p) for p in prompts], decode_waves=waves,
         prefill_chunks=rep["compiled"]["prefill_chunks"], paged_decode_launches=launches,
         tokens_per_s=rep["tokens_per_sec"], wall_s=wall,
         ttft_p50_s=ttft["p50"], ttft_p99_s=ttft["p99"],
         itl_p50_s=itl["p50"], itl_p99_s=itl["p99"], card=card)
    SERVE_RUN.update(tokens=[list(engine.result(r).tokens) for r in rids], report=rep)
    profile_serve(engine, model.config.vocab_size, card)
    return launches


#: The ``serve`` phase's greedy tokens and report, which ``serve_obs`` holds
#: its run against.
SERVE_RUN: dict = {}
#: ``serve_obs``'s trace window over engine ticks (after the warmup's reset).
SERVE_OBS_WINDOW = (40, 50)


def serve_obs_phase(model, params, card):
    """GPT-2 124M at ``serve``'s shapes (8 slots, the same 16 greedy
    requests, 64 new tokens, the same warmup) under the serve half of the
    ops plane: an enabled Telemetry, the request tracer, the exporter
    ticking every 0.5 s with ``/metrics`` on an ephemeral port and
    ``default:serve`` evaluated, and a ``capture_trace`` window over ticks
    :data:`SERVE_OBS_WINDOW`. Every tick outside the window runs under
    strict mode. Holds: the tokens bitwise ``serve``'s; 16 timelines in
    ``reqtrace.jsonl`` whose phases sum to their end-to-end time within 1%,
    exemplars written; a live scrape's ``rocket_tpu_serve_itl_s`` count
    equal to the tokens after each request's first; ``obs watch --slo
    default:serve`` exits 0; the window's ``paged_decode`` launches as
    parsed from its trace equal to the launch counter's change over it (12
    a wave), and its device total within 1% of the profiler's own."""
    import urllib.request

    from rocket_tpu_torch.obs import prof as prof_lib
    from rocket_tpu_torch.obs.export import ExportConfig
    from rocket_tpu_torch.obs.telemetry import Telemetry
    from rocket_tpu_torch.runtime import StrictMode

    root = Path(tempfile.mkdtemp(prefix="serve_obs_"))
    tel = Telemetry(enabled=True, out_dir=str(root))
    tel.start()
    tel.start_export(ExportConfig(enabled=True, interval_s=0.5, metrics_port=0,
                                  slo_path="default:serve"), default_dir=str(root))
    try:
        engine = ServeEngine(model, params, ServeConfig(max_slots=8, block_len=16,
                                                        prefill_chunk=64),
                             telemetry=tel, generator=torch.Generator().manual_seed(0))
        warm = [engine.submit(np.arange(40, dtype=np.int32), max_new_tokens=4) for _ in range(2)]
        engine.drain()
        require(all(engine.result(r).finished for r in warm), "serve_obs warmup did not finish")
        engine.reset_metrics()
        start, stop = SERVE_OBS_WINDOW
        engine.capture_trace((start, stop), str(root / "traces"))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, model.config.vocab_size, size=int(n)).astype(np.int32)
                   for n in rng.integers(32, 513, size=16)]
        zero_launches()
        strict = StrictMode()
        rids = [engine.submit(p, max_new_tokens=64, temperature=0.0) for p in prompts]
        tick_ms = {"outside": [], "window": []}
        marks = {}
        t0 = time.perf_counter()
        while not engine.scheduler.idle:
            tick = engine._ticks
            if tick in (start, stop):
                marks[tick] = (pa.paged_decode.launches, engine.engine.decode_waves)
            inside = start <= tick <= stop  # the ticks that open and close the window too
            if not inside:
                strict.activate()
            t1 = time.perf_counter()
            try:
                engine.step()
            finally:
                strict.deactivate()
            tick_ms["window" if inside else "outside"].append((time.perf_counter() - t1) * 1e3)
        engine.finish_trace()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(engine.trace_file is not None and set(marks) == {start, stop},
                f"serve_obs: the trace window did not open and close ({marks})")
        tokens = [list(engine.result(r).tokens) for r in rids]
        require(tokens == SERVE_RUN["tokens"], "serve_obs: the ops plane changed the tokens: "
                f"{sum(a != b for a, b in zip(tokens, SERVE_RUN['tokens']))} requests differ")
        rep = engine.report()
        after_first = sum(len(t) - 1 for t in tokens)
        port = tel.exporter.server.port
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        count = [line for line in body.decode().splitlines()
                 if line.startswith("rocket_tpu_serve_itl_s_count")]
        require(count and float(count[0].split()[-1]) == after_first,
                f"serve_obs: scraped {count}, want {after_first} ITL samples")
        launches = pa.paged_decode.launches
    finally:
        tel.close()
    session = engine.trace_session
    summary = prof_lib.parse_trace(prof_lib.load_trace_events(engine.trace_file))
    window_launches = marks[stop][0] - marks[start][0]
    window_waves = marks[stop][1] - marks[start][1]
    parsed = summary.step_launches("paged_decode")
    layers = model.config.num_layers
    require(parsed == window_launches == layers * window_waves and window_waves > 0,
            f"serve_obs: parsed {parsed} paged_decode launches, counter {window_launches}, "
            f"{window_waves} waves in the window")
    own_s = sum(_device_s_by_name(_device_events(session.last_profile)).values())
    parsed_s = summary.device_total_us * 1e-6
    require(own_s > 0 and abs(parsed_s - own_s) <= 0.01 * own_s,
            f"serve_obs: parsed device time {parsed_s} s vs the profiler's {own_s} s")
    lines = [json.loads(x) for x in (root / "telemetry" / "reqtrace.jsonl").read_text()
             .splitlines()]
    mine = [r for r in lines if r["rid"] in set(rids)]
    require(sorted(r["rid"] for r in mine) == sorted(rids),
            f"serve_obs: reqtrace.jsonl holds {sorted(r['rid'] for r in mine)}")
    worst = max(abs(sum(r["phases"].values()) - r["total_s"]) / r["total_s"] for r in mine)
    require(worst <= 0.01, f"serve_obs: phases miss the end-to-end time by {worst:.2%}")
    exemplars = (root / "telemetry" / "exemplars.jsonl").read_text().splitlines()
    require(exemplars, "serve_obs: no exemplars")
    with contextlib.redirect_stdout(io.StringIO()) as watch:
        watch_rc = obs_main(["watch", "--slo", "default:serve", str(root)])
    record = prof_lib.prof_record(summary, top=8)
    base, ttft, itl = SERVE_RUN["report"], rep["time_to_first_token_s"], \
        rep["inter_token_latency_s"]
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    emit("serve_obs", model="gpt2_124m", dtype="bfloat16", requests=16, new_tokens=64,
         tokens_bitwise=True, tokens_per_s=rep["tokens_per_sec"], wall_s=wall,
         ttft_p50_s=ttft["p50"], ttft_p99_s=ttft["p99"], itl_p50_s=itl["p50"],
         itl_p99_s=itl["p99"], serve_tokens_per_s=base["tokens_per_sec"],
         serve_ttft_p50_s=base["time_to_first_token_s"]["p50"],
         serve_ttft_p99_s=base["time_to_first_token_s"]["p99"],
         serve_itl_p50_s=base["inter_token_latency_s"]["p50"],
         serve_itl_p99_s=base["inter_token_latency_s"]["p99"],
         ticks_outside=len(tick_ms["outside"]), tick_ms_outside_median=med(tick_ms["outside"]),
         ticks_window=len(tick_ms["window"]), tick_ms_window_median=med(tick_ms["window"]),
         tick_ms_window=tick_ms["window"], tick_ms_outside_top=sorted(tick_ms["outside"])[-5:],
         cupti_start_s=session.start_s, trace_stop_s=session.stop_s,
         window=list(SERVE_OBS_WINDOW), window_waves=window_waves,
         paged_decode_launches=launches, window_paged_decode_launches=window_launches,
         parsed_paged_decode_launches=parsed, parsed_device_s=parsed_s, profiler_device_s=own_s,
         prof=record, phases=rep["phases"], itl_samples=after_first,
         reqtrace_lines=len(lines), exemplar_lines=len(exemplars), strict_ticks=True,
         obs_watch_rc=watch_rc, obs_watch=watch.getvalue(), card=card)
    shutil.rmtree(root, ignore_errors=True)
    require(watch_rc == 0, f"serve_obs: obs watch exited {watch_rc}: {watch.getvalue()[-600:]}")
    return launches


#: ``serve_obs_cost``'s configurations, in the order they run: the plain
#: engine, then each layer of the serve plane added on top, the plain
#: engine again (the host's drift over the run), the whole plane with a
#: trace window over ticks 40-50 (the process's first ``torch.profiler``
#: session), and the plain engine after it.
SERVE_PLANE_STEPS = ("plain", "tracer", "telemetry", "export", "strict", "plain_again",
                     "window", "plain_after_window")


def _serve_ticks(engine, prompts, strict=None, window=None) -> dict:
    """Serve ``prompts`` (64 greedy tokens each) on a warm engine, each tick
    timed on the host clock (under ``strict`` when given, but for the ticks
    from ``window``'s start to its stop)."""
    rids = [engine.submit(p, max_new_tokens=64, temperature=0.0) for p in prompts]
    ticks, inside = [], []
    t0 = time.perf_counter()
    while not engine.scheduler.idle:
        traced = window is not None and window[0] <= engine._ticks <= window[1]
        t1 = time.perf_counter()
        if strict is not None and not traced:
            strict.activate()
        try:
            engine.step()
        finally:
            if strict is not None:
                strict.deactivate()
        (inside if traced else ticks).append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    rep = engine.report()
    out = {"wall_s": time.perf_counter() - t0, "tick_ms_median": float(np.median(ticks)) * 1e3,
           "tokens_per_s": rep["tokens_per_sec"],
           "itl_p50_s": rep["inter_token_latency_s"]["p50"],
           "itl_p99_s": rep["inter_token_latency_s"]["p99"],
           "ttft_p50_s": rep["time_to_first_token_s"]["p50"],
           "ttft_p99_s": rep["time_to_first_token_s"]["p99"],
           "tokens": [list(engine.result(r).tokens) for r in rids]}
    if window is not None:
        out["tick_ms_window"] = [t * 1e3 for t in inside]
    return out


def serve_obs_cost(timer=None, gen=None):
    """The serve plane's cost on GPT-2 124M at ``serve``'s shapes, layer by
    layer in one process (:data:`SERVE_PLANE_STEPS`): the plain engine
    (``reqtrace=False``), the request tracer, an enabled Telemetry, its
    exporter (0.5 s ticks, ``/metrics``, ``default:serve``), strict mode on
    every tick, the plain engine again, all of it with a trace window
    (:data:`SERVE_OBS_WINDOW`; its ticks apart, CUPTI's cold start and the
    window's close), and the plain engine after it. Not part of ``main``: run it
    with ``python -m rocket_tpu_torch.obs.ab --phase serve_obs_cost .``.
    Returns each step's median tick, tokens/s, ITL and TTFT, and whether
    its tokens equal the plain run's."""
    from rocket_tpu_torch.obs.export import ExportConfig
    from rocket_tpu_torch.obs.telemetry import Telemetry
    from rocket_tpu_torch.runtime import StrictMode

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    model = TransformerLM(TransformerConfig.gpt2_124m())
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=16)]
    out = {}
    for step in SERVE_PLANE_STEPS:
        tel = None
        if step in ("telemetry", "export", "strict", "window"):
            tel = Telemetry(enabled=True, out_dir=tempfile.mkdtemp(prefix="serve_cost_"))
            if step != "telemetry":
                tel.start_export(ExportConfig(enabled=True, interval_s=0.5, metrics_port=0,
                                              slo_path="default:serve"))
        engine = ServeEngine(model, params, ServeConfig(
            max_slots=8, block_len=16, prefill_chunk=64, reqtrace=not step.startswith("plain")),
            telemetry=tel, generator=torch.Generator().manual_seed(0))
        for _ in range(2):
            engine.submit(np.arange(40, dtype=np.int32), max_new_tokens=4)
        engine.drain()
        engine.reset_metrics()
        window = SERVE_OBS_WINDOW if step == "window" else None
        if window is not None:
            engine.capture_trace(window, os.path.join(tel.out_dir, "traces"))
        out[step] = _serve_ticks(engine, prompts,
                                 StrictMode() if step in ("strict", "window") else None, window)
        if window is not None:
            engine.finish_trace()
            session = engine.trace_session
            out[step].update(cupti_start_s=session.start_s, trace_stop_s=session.stop_s)
        if tel is not None:
            tel.close(write=False)
            shutil.rmtree(tel.out_dir, ignore_errors=True)
        del engine
        torch.cuda.empty_cache()
    want = out["plain"].pop("tokens")
    for step in SERVE_PLANE_STEPS[1:]:
        out[step]["tokens_equal"] = out[step].pop("tokens") == want
    emit("serve_obs_cost", model="gpt2_124m", steps=out, card=card)
    return out


#: serve_cli: the requests of the CLI run (cut from 16 to keep the script
#: inside its time limit).
SERVE_CLI_REQUESTS = 8


def serve_cli_phase(card):
    """``python -m rocket_tpu_torch.serve run --config charlm --requests 8
    --export --metrics-port 0 --slo default:serve --trace-steps 4:8
    --out-dir <tmp>`` as a subprocess on the card, then ``serve report``,
    ``obs timeline --slowest 3`` and ``obs prof --format json`` over its
    outputs, each through the ``main`` its ``python -m`` entry point runs,
    in this process (since the script outgrew its time limit: a process
    each cost ~10 s of start-up): all exit 0, and ``prof`` names the
    ``paged_decode`` kernels among its compute ops."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="serve_cli_"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROCKET_TPU_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    runs = {}
    try:
        for name, argv in (
                ("run", ["-m", "rocket_tpu_torch.serve", "run", "--config", "charlm",
                         "--requests", str(SERVE_CLI_REQUESTS), "--export", "--metrics-port", "0",
                         "--slo",
                         "default:serve", "--trace-steps", "4:8", "--out-dir", str(root / "run")]),
                ("report", ["-m", "rocket_tpu_torch.serve", "report", str(root / "run")]),
                ("timeline", ["-m", "rocket_tpu_torch.obs", "timeline", str(root / "run"),
                              "--slowest", "3"]),
                ("prof", ["-m", "rocket_tpu_torch.obs", "prof", str(root / "run" / "traces"),
                          "--format", "json", "--top", "200"])):
            t0 = time.perf_counter()
            if name == "run":
                done = subprocess.run([sys.executable, *argv], env=env, cwd=str(root),
                                      capture_output=True, text=True, timeout=300)
                rc, stdout, text = done.returncode, done.stdout, done.stdout + done.stderr
            else:
                entry = serve_cli.main if argv[1] == "rocket_tpu_torch.serve" else obs_main
                with contextlib.redirect_stdout(io.StringIO()) as captured:
                    rc = entry(argv[2:])
                stdout = text = captured.getvalue()
            runs[name] = {"rc": rc, "s": time.perf_counter() - t0,
                          "process": "subprocess" if name == "run" else "in-process"}
            (out / f"serve_cli_{name}.log").write_text(text)
            require(rc == 0, f"serve_cli: {name} exited {rc}: {text[-1500:]}")
            runs[name]["stdout"] = stdout
        prof = json.loads(runs["prof"].pop("stdout"))
        compute = {op["name"] for op in prof["top_ops"] if op["category"] == "compute"}
        require({"paged_split_kernel", "paged_combine_kernel"} <= compute,
                f"serve_cli: obs prof's compute ops {sorted(compute)[:12]}")
        require("serve/itl_s" in runs["report"].pop("stdout"), "serve_cli: report lacks ITL")
        require(runs["timeline"].pop("stdout").count("request ") >= 3,
                "serve_cli: obs timeline rendered fewer than 3 requests")
        text = runs["run"].pop("stdout")
        served = json.loads(text[text.index('{\n "serve_report"'):])["serve_report"]
        require(served["requests"]["completed"] == SERVE_CLI_REQUESTS,
                f"serve_cli: {served['requests']}")
        emit("serve_cli", runs=runs, n_steps=prof["n_steps"], n_slices=prof["n_slices"],
             categories_us=prof["categories_us"], paged_ops=sorted(
                 op["name"] for op in prof["top_ops"] if op["module"] == "paged_decode"),
             tokens_per_s=served["tokens_per_sec"], phases=served["phases"], card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: profile_serve's new tokens a request (cut from 32, then 16, to keep the
#: script inside its time limit: the trace's host-side parse grows with its
#: ops).
PROFILE_SERVE_TOKENS = 8


def profile_serve(engine, vocab, card, phase="serve_profile"):
    """Where a serve run's time goes: a torch.profiler trace of 8 requests
    (prompt 128, PROFILE_SERVE_TOKENS new tokens) on the warm engine. Device busy share is the
    summed kernel/copy time over the wall time (one stream, so no overlap);
    the host's share shows in the operators' own CPU time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=128).astype(np.int32) for _ in range(8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, max_new_tokens=PROFILE_SERVE_TOKENS)
        engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = _device_s_by_name(_device_events(prof))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(((ev.key, ev.self_cpu_time_total * 1e-6, ev.count)
                   for ev in prof.key_averages()), key=lambda row: -row[1])[:10]
    emit(phase, requests=8, prompt=128, new_tokens=PROFILE_SERVE_TOKENS, wall_s=wall,
         device_busy_s=busy, device_idle_share=(1.0 - busy / wall) if busy else None,
         device_time_measured=busy > 0,
         top_kernels=[{"name": n[:120], "s": t, "share_of_device": t / busy} for n, t in top],
         top_host_ops=[{"name": n[:80], "self_cpu_s": t, "calls": c} for n, t, c in host],
         card=card)


def generate_phase(model, params, card):
    prompt = np.random.default_rng(1).integers(0, model.config.vocab_size, size=(4, 128))
    generate(model, params, prompt, 4, temperature=0)  # warmup
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, 64, temperature=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.decode_attention.launches
    require(tuple(out.shape) == (4, 192), f"generate shape {tuple(out.shape)}")
    require(torch.equal(out[:, :128].cpu(), torch.as_tensor(prompt, dtype=torch.int32)),
            "generate changed the prompt")
    require(int(out.min()) >= 0 and int(out.max()) < model.config.vocab_size, "token range")
    require(launches == model.config.num_layers * 64,
            f"decode_attention launched {launches} times, want {model.config.num_layers * 64}")
    emit("generate", model="gpt2_124m", dtype="bfloat16", batch=4, prompt=128, new_tokens=64,
         decode_attention_launches=launches, wall_s=wall,
         tokens_per_s=4 * 64 / wall, card=card)
    return launches


def model_check_phase():
    """decode_step_paged at full width, 2 layers, f32: card vs CPU; then
    serve vs generate greedy tokens on the card (the two kernels' paths)."""
    cfg = TransformerConfig.gpt2_124m()
    cfg.num_layers, cfg.activation_dtype = 2, None
    model = TransformerLM(cfg)
    cpu = model.init(torch.Generator().manual_seed(3), device="cpu")
    dev = map_params(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(2)
    s, mb, bl = 4, 8, 16
    shape = (2, 1 + s * mb, bl, 12, 64)
    pools = {d: (torch.zeros(shape, device=d), torch.zeros(shape, device=d))
             for d in ("cpu", "cuda")}
    table = torch.tensor(1 + np.arange(s)[:, None] * mb + np.arange(mb)[None, :],
                         dtype=torch.int32)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(s, 65)), dtype=torch.int32)
    logits = {}
    with torch.no_grad():
        for d, p in (("cpu", cpu), ("cuda", dev)):
            kp, vp = pools[d]
            ones = torch.ones(s, dtype=torch.int32, device=d)
            model.decode_step_paged(p, prompt[:, :64].to(d), kp, vp, table.to(d),
                                    torch.zeros(s, dtype=torch.int32, device=d), ones * 64)
            logits[d], _, _ = model.decode_step_paged(p, prompt[:, 64:].to(d), kp, vp,
                                                      table.to(d), ones * 64, ones)
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    require(err <= MODEL_TOL, f"decode_step_paged card vs cpu: max abs err {err}")
    engine = ServeEngine(model, dev, ServeConfig(max_slots=2, block_len=16, prefill_chunk=16,
                                                 max_model_len=128))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 40)]
    rids = [engine.submit(p, max_new_tokens=16) for p in prompts]
    engine.drain()
    for r, p in zip(rids, prompts):
        ref = generate(model, dev, p, 16, temperature=0)[0, len(p):].cpu().tolist()
        require(engine.result(r).tokens == ref, f"serve vs generate tokens differ for {r}")
    emit("model_check", layers=2, dim=768, dtype="float32", max_abs_err=err, tol=MODEL_TOL,
         serve_equals_generate=True)


# -- phases 7-9: training ---------------------------------------------------

class StepClock(Capsule):
    """Runs after the Module in every iteration (priority 10): reads the
    step's loss (a device sync), stamps the host clock after a
    ``synchronize``, and keeps a ``torch.profiler`` window over the last
    ``profile_last`` steps, each step under its own ``ProfilerStep#N``
    range (the profiler's step markers: the calibration joins per step)."""

    def __init__(self, profile_last: int = 0, module=None):
        super().__init__(priority=10)
        self.profile_last = profile_last
        self.module = module
        self.prepared = None
        self.stamps, self.losses = [], []
        self.moe_aux, self.moe_dropped, self.perf = [], [], []
        self.prof, self.prof_wall = None, None

    def set(self, attrs=None):
        super().set(attrs)
        self.repeats = attrs.looper.repeats
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def launch(self, attrs=None):
        from torch.profiler import ProfilerAction, ProfilerActivity, profile

        self.losses.append(float(attrs.step_metrics["loss"]))
        if isinstance(attrs.batch, dict) and "moe_aux_loss" in attrs.batch:
            self.moe_aux.append(float(attrs.batch["moe_aux_loss"].detach()))
            self.moe_dropped.append(float(attrs.batch["moe_frac_dropped"]))
        state = attrs.looper.state
        if state is not None and state.steps_per_sec is not None:
            self.perf.append({"steps_per_sec": state.steps_per_sec, "mfu": state.mfu})
        if self.module is not None:
            self.prepared = self.module.prepared  # the train state, past destroy
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        done = len(self.losses)
        if self.profile_last and done == self.repeats - self.profile_last:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=lambda step: ProfilerAction.RECORD, acc_events=True)
            self.prof.start()
            self.prof_t0 = self.stamps[-1]
        elif self.prof is not None and done == self.repeats:
            self.prof.stop()
            self.prof_wall = self.stamps[-1] - self.prof_t0
        elif self.prof is not None and done > self.repeats - self.profile_last:
            self.prof.step()


#: Param trees drawn on the CPU from seed 0 and kept on the card, one per
#: shape of model: GPT-2's and the MoE LM's CPU-side init takes 10-30 s a
#: draw, and several phases train or serve the same model.
_DRAWN: dict = {}


def _drawn_params(cfg) -> dict:
    """A copy of the seed-0 params of ``TransformerLM(cfg)`` on the card
    (drawn once for every config of the same param shapes)."""
    key = (cfg.vocab_size, cfg.max_seq_len, cfg.dim, cfg.num_layers, cfg.num_heads,
           cfg.num_kv_heads, cfg.mlp_ratio, cfg.tied_embeddings, cfg.pos_embedding, cfg.norm,
           cfg.mlp, cfg.num_experts)
    if key not in _DRAWN:
        _DRAWN[key] = TransformerLM(cfg).init(torch.Generator().manual_seed(0))
    return map_params(lambda t: t.clone(), _DRAWN[key])


def run_train(cfg, batch: int, steps: int, profile_last: int = 0, capsules=()):
    """``steps`` steps of ``examples.gpt2``'s capsule tree (``gpt2.build``
    over its corpus, remat on, without its Checkpointer, Profiler, Tracker
    and progress bar; ``capsules`` join the Looper, e.g. a Profiler) on a
    fresh Runtime on the card, the batches device-resident, with the kernel
    launch counts zeroed just before and read just after (the MoE kernels'
    too for an MoE config, whose train forward also hands the clock its
    outputs)."""
    clock = StepClock(profile_last)
    runtime = rt.Runtime(seed=0)
    run = gpt2.build(cfg, _gpt2_corpus(cfg.max_seq_len, cfg.vocab_size), batch_size=batch,
                     runtime=runtime, steps=steps, record=False,
                     capsules=(*capsules, clock),
                     return_outputs="always" if cfg.num_experts else "eval")
    # The seed-0 params (the Module would draw its own from the Runtime's
    # seed otherwise).
    runtime.models.add(run["model"], PreparedModule(run["model"],
                                                    {"params": _drawn_params(cfg)}))
    clock.module = run["module"]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    run["launcher"].launch()
    require(run["dataset"].device_resident, "train: the batches were not device-resident")
    counts = {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
              "flash_dq": fa.flash_dq.launches}
    if cfg.num_experts:
        counts.update(moe_launches())
    require(len(clock.losses) == steps, f"train ran {len(clock.losses)} of {steps} steps")
    require(all(math.isfinite(x) for x in clock.losses), f"non-finite loss: {clock.losses}")
    return clock, counts


def _train_group(kernel: str) -> str:
    """The train profile's device-time group of a kernel name. Nearly all
    int64 elementwise work in a train step is the dropout masks' counter
    hash (``nn/keys.py``); the rest is a few T-long index vectors."""
    if "flash_" in kernel and "_kernel<" in kernel:
        return "flash kernels"
    if "fused_block_kernel" in kernel:
        return "fused_block kernel"
    if any(k in kernel for k in ("gemm", "nvjet", "xmma")):
        return "GEMMs"
    if "elementwise" in kernel and "<long" in kernel:
        return "int64 elementwise"
    if "multi_tensor_apply" in kernel:
        return "optimizer (multi-tensor apply)"
    return "other"


def _device_events(prof) -> list:
    """The kernels and copies of a profiler window: its device events, less
    the ``record_function`` ranges the profiler mirrors onto the device's
    timeline (they span kernels already counted)."""
    return [ev for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]


def _device_s_by_name(events) -> dict:
    by_name: dict = {}
    for ev in events:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() * 1e-6
    return by_name


def _device_profile(prof, wall):
    """(busy seconds, idle share, top device ops, seconds per
    :func:`_train_group`) of a profiler window. One stream, so summed
    kernel/copy times do not overlap."""
    by_name = _device_s_by_name(_device_events(prof))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    groups: dict = {}
    for name, t in by_name.items():
        groups[_train_group(name)] = groups.get(_train_group(name), 0.0) + t
    return busy, (1.0 - busy / wall) if busy else None, [
        {"name": n[:120], "s": t, "share_of_device": t / busy} for n, t in top], groups


def train_phase(card):
    """GPT-2 124M at full width (dropout 0.1, loss_chunk 128, bf16 compute,
    remat) through the Launcher: B=8, T=1024, TRAIN_STEPS timed steps then
    PROFILE_STEPS under torch.profiler. Under the whole-forward remat each
    layer's flash forward runs twice per step (forward and recompute) and
    its backward once."""
    cfg = TransformerConfig.gpt2_124m()
    b, t, layers = 8, cfg.max_seq_len, cfg.num_layers
    steps = TRAIN_STEPS + PROFILE_STEPS
    clock, counts = run_train(cfg, b, steps, profile_last=PROFILE_STEPS)
    losses = clock.losses
    require(float(np.mean(losses[-5:])) < losses[0],
            f"train loss did not fall: first {losses[0]}, last five {losses[-5:]}")
    require(counts == {"flash_fwd": 2 * layers * steps, "flash_bwd": layers * steps,
                       "flash_dq": 0}, f"train launches {counts} over {steps} steps")
    step_s = np.diff(clock.stamps)[WARM_STEPS:TRAIN_STEPS]
    median = float(np.median(step_s))
    # examples/gpt2.py:114-120: analytic params and FLOPs per sample.
    n_params = cfg.vocab_size * cfg.dim + cfg.max_seq_len * cfg.dim + layers * 12 * cfg.dim ** 2
    flops_per_sample = 6.0 * n_params * t + 12.0 * layers * cfg.dim * t ** 2
    tokens_per_s = b * t / median
    emit("train", model="gpt2_124m", dtype="bfloat16", batch=b, seq_len=t, steps=steps,
         losses=losses, step_ms_median=median * 1e3, step_ms=[x * 1e3 for x in step_s],
         first_step_s=float(np.diff(clock.stamps)[0]), tokens_per_s=tokens_per_s,
         mfu=tokens_per_s / t * flops_per_sample / PEAK_FLOPS[torch.bfloat16],
         flops_per_sample=flops_per_sample, launches=counts,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    busy, idle, top, groups = _device_profile(clock.prof, clock.prof_wall)
    emit("train_profile", steps=PROFILE_STEPS, wall_s=clock.prof_wall, device_busy_s=busy,
         device_idle_share=idle, device_time_measured=busy > 0, top_kernels=top,
         device_s_by_group=groups, card=card)
    return counts, clock.prepared, clock.prof


def calib_phase(prof, card):
    """The roofline loop closed on the card (``analysis/calib.py``): the
    ``train`` phase's own profiled window (its last PROFILE_STEPS GPT-2
    124M steps, each under a ``ProfilerStep#N`` range) reconciled against
    ``train_flash``'s step traced on meta tensors and priced as this card.
    The join (launching aten op or hand kernel, ordinal in the step) must
    cover RKT702's floor, the step's |calibration error| must stay under
    RKT703's ceiling on the matched card, and rows 3-4 must join by their
    ``LaunchFact`` names. No GPU step is added: the window is the phase's."""
    from rocket_tpu_torch.analysis.calib import (
        CALIB_TARGETS,
        priced_ops_for_target,
        reconcile_trace,
    )
    from rocket_tpu_torch.obs.prof import load_trace_events

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    target = dataclasses.replace(CALIB_TARGETS["train_flash"], device_kind=kind)
    ops, priced = priced_ops_for_target(target)
    t_priced = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_window.trace.json")
        prof.export_chrome_trace(path)
        trace_mb = os.path.getsize(path) / 2**20
        events = load_trace_events(path)
    t_loaded = time.perf_counter()
    report = reconcile_trace(events, ops, priced, label="train_flash", measured_kind=kind,
                             join_floor=target.join_floor, error_ceiling=target.error_ceiling)
    del events
    record = report.record
    require(record, "calib: " + "; ".join(f.message for f in report.findings))
    require(record["device_matched"], f"calib: priced for {record['priced_for']}, measured on "
            f"{record['device_kind_measured']}")
    require(record["n_steps"] == PROFILE_STEPS, f"calib: {record['n_steps']} steps joined")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "calib_train_flash.json").write_text(json.dumps(record, indent=1, sort_keys=True))
    joined = {row["name"].split("#")[0] for row in report.rows}
    emit("calib", **record, joined_kernels=sorted(n for n in joined if not n.startswith("aten")),
         findings=[f.message for f in report.findings], price_s=t_priced - t0,
         export_load_s=t_loaded - t_priced, join_s=time.perf_counter() - t_loaded,
         seconds=time.perf_counter() - t0, trace_mb=trace_mb, card=card)
    require(report.clean, "calib: " + "; ".join(f.message for f in report.findings))
    require({"flash_fwd", "flash_bwd"} <= joined,
            f"calib: rows 3-4 did not join by their LaunchFact names: {sorted(joined)[:20]}")
    return record


def _measured_step_peak(batch: int) -> dict:
    """One ``train_flash`` step (``sched_audit._gpt2_parts`` on the card:
    GPT-2 124M, T=1024, bf16, remat, AdamW, the aten sequence of
    ``calib``'s measured leg) at ``batch``, after one warm step that creates
    AdamW's moments: the allocator's peak over the step less what was
    allocated before its params were built, the bytes resident after the
    warm step (the state and the batch), the requested peak (no block
    rounding) and the step's seconds. Its params are the seed-0 draw the
    serve phase made (drawn once on the host)."""
    from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts

    cfg = TransformerConfig.gpt2_124m()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_requested = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    params = map_params(lambda t: t.to("cuda"), _drawn_params(cfg))
    step, args = _gpt2_parts(cfg.max_seq_len, batch=batch, device="cuda", params=params)
    del params
    step(*args)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(*args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = torch.cuda.memory_stats()
    out = {"batch": batch, "measured_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "requested_peak_bytes": stats.get("requested_bytes.all.peak", 0) - base_requested,
           "resident_bytes": resident, "step_s": seconds, "loss": loss}
    del step, args
    torch.cuda.empty_cache()
    return out


def mem_phase(record, card):
    """The memory audit held to the card (RKT805): ``train_flash``'s
    liveness peak, priced as this card by ``launch_audit`` (``record``), is
    reconciled with the CUDA caching allocator's measured peak of the same
    step within RKT805's floor, at B=8 and at half the H100 frontier the
    record predicts (rounded down to a multiple of 8; the batch-proportional
    part of the model, without risking an out-of-memory), the latter
    priced by its own trace. ``DeviceSpec.hbm_bytes`` is checked against
    the card's ``total_memory``. No profiler window is open."""
    from rocket_tpu_torch.analysis.mem_audit import audit_memory, train_state
    from rocket_tpu_torch.analysis.rules.mem_rules import check_reconciliation
    from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    spec = device_spec(kind)
    total = torch.cuda.get_device_properties(0).total_memory
    require(0.9 * spec.hbm_bytes <= total <= spec.hbm_bytes,
            f"mem: DeviceSpec.hbm_bytes {spec.hbm_bytes} against total_memory {total}")
    frontier = record["oom_frontier"][spec.kind]
    half = frontier // 2 // 8 * 8
    require(half > 8, f"mem: the predicted frontier {frontier} leaves no second batch")
    step, args = _gpt2_parts(1024, batch=half)
    predicted_half = audit_memory(step, *args, state=lambda: train_state(step), warmup=1,
                                  device_kind=kind, slope=False, label="train_flash").record
    del step, args
    t_priced = time.perf_counter()
    rows = []
    for predicted in (record, predicted_half):
        measured = _measured_step_peak(predicted["batch_size"])
        findings = check_reconciliation(predicted["predicted_peak_bytes"],
                                        measured["measured_peak_bytes"], label="train_flash")
        rows.append({**measured, "predicted_peak_bytes": predicted["predicted_peak_bytes"],
                     "peak_breakdown": predicted["peak_breakdown"],
                     "saved_activation_bytes": predicted["saved_activation_bytes"],
                     "expected_state_bytes": predicted["expected_state_bytes"],
                     "error": (predicted["predicted_peak_bytes"] - measured["measured_peak_bytes"])
                     / measured["measured_peak_bytes"],
                     "findings": [f.message for f in findings]})
    emit("mem", target="train_flash", device_kind=kind, hbm_bytes=spec.hbm_bytes,
         total_memory=total, oom_frontier=record["oom_frontier"],
         fixed_bytes=record["fixed_bytes"], per_sample_bytes=record["per_sample_bytes"],
         rows=rows, price_s=t_priced - t0, seconds=time.perf_counter() - t0, card=card)
    for row in rows:
        require(not row["findings"], "mem: " + "; ".join(row["findings"]))
        require(math.isfinite(row["loss"]), f"mem: non-finite loss at batch {row['batch']}")


#: The repro phase's MoE LM: ``moe_config()`` (GPT-2 widths, 4 experts,
#: dropless top-2, the fused gather-GMM forced) at this many layers.
REPRO_MOE_LAYERS = 2
#: cuBLAS's bf16 reduced-precision reduction, checked at GPT-2's GEMMs
#: (M, K, N): the MLP's in-projection at B=8 T=1024, the loss head's chunk
#: (128 positions of 8 sequences over the vocab) and the in-projection's
#: weight gradient (its contraction over the step's 8192 tokens).
CUBLAS_SHAPES = ((8192, 768, 3072), (1024, 768, 50257), (768, 8192, 3072))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _health_word(loss, params, grads) -> torch.Tensor:
    """The step's health word as the Module's sentinels take it
    (``obs/health.step_flags``, ``branch_sumsq``): the loss, the gradient
    norm, the param norm, the step and loss flags."""
    from rocket_tpu_torch.obs.health import branch_sumsq, step_flags

    with torch.no_grad():
        it = iter(grads)
        step_ok, loss_ok, _branch_ok, grad_norm = step_flags(
            loss.float(), map_params(lambda _t: next(it), params))
        return torch.stack([loss.float(), grad_norm, branch_sumsq(params).sum().sqrt(),
                            step_ok.float(), loss_ok.float()])


def _repro_builders(device: str):
    """``{name: build() -> (step, args)}``: GPT-2 124M's train step as the
    ``mem`` phase builds it (``sched_audit._gpt2_parts``: B=8, T=1024, bf16,
    remat, dropout 0.1 and its counter keys, AdamW, the serve phase's
    seed-0 params), and the MoE LM at REPRO_MOE_LAYERS layers (seeded
    tokens, the same AdamW), each from fresh identical state on
    ``device`` (meta for the audit's trace)."""
    from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts, _train_parts

    gpt2_cfg = TransformerConfig.gpt2_124m()
    moe_cfg = moe_config(num_layers=REPRO_MOE_LAYERS)
    tokens = torch.from_numpy(np.random.RandomState(26).randint(
        0, moe_cfg.vocab_size, (8, moe_cfg.max_seq_len)).astype(np.int32)).to(device)

    def params_of(cfg):
        if device == "meta":
            return None
        return map_params(lambda t: t.to(device), _drawn_params(cfg))

    def gpt2_step():
        return _gpt2_parts(1024, batch=8, device=device, params=params_of(gpt2_cfg),
                           keep_grads=True)

    def moe_step():
        return _train_parts(TransformerLM(moe_cfg), {"tokens": tokens},
                            make_opt=optim.adamw(weight_decay=0.1), loss_fn=next_token_loss(),
                            device=device, params=params_of(moe_cfg), keep_grads=True)

    return {"gpt2": gpt2_step, "moe": moe_step}


def _replay_run(build, steps: int = 2) -> dict:
    """``steps`` steps (the first a warm one that creates AdamW's moments)
    of the train step ``build()`` makes from fresh state on the card, the
    launch counts zeroed just before: SHA-256 digests of the params, both
    moments, the step counts, the last loss and the health word, and the
    kernels launched."""
    step, args = build()
    require(all(t.is_cuda for t in step.leaves), "repro: the step's state is not on the card")
    zero_launches()
    for _ in range(steps):
        loss = step(*args)
    torch.cuda.synchronize()
    leaves, opt = step.leaves, step.optimizer
    word = _health_word(loss, args[0], step.grads)
    return {"params": _digest(leaves),
            "exp_avg": _digest([opt.state[p]["exp_avg"] for p in leaves]),
            "exp_avg_sq": _digest([opt.state[p]["exp_avg_sq"] for p in leaves]),
            "count": _digest([torch.as_tensor(opt.state[p]["step"]) for p in leaves]),
            "loss": _digest([loss]), "word": _digest([word]), "loss_value": float(loss),
            "word_value": word.tolist(),
            "launches": {fn.__name__: fn.launches for fn in COUNTED if fn.launches}}


def _deterministic_warnings(build) -> list:
    """The warnings of one step of ``build()``'s train step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (restored
    after), with uninitialised memory left unfilled so the program is the
    replayed one."""
    import warnings

    from torch.utils import deterministic

    step, args = build()
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    fill = deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        deterministic.fill_uninitialized_memory = False
        try:
            step(*args)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
            deterministic.fill_uninitialized_memory = fill
    return [str(w.message) for w in caught]


def _cublas_reduction(gen) -> list:
    """Each CUBLAS_SHAPES bf16 GEMM with cuBLAS's reduced-precision split-K
    reduction on (torch's default) and off, on the same operands: whether
    the two results are bitwise equal, how many elements differ, and each
    one's max abs error against the f64 product."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for m, k, n in CUBLAS_SHAPES:
            a = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
            b = (torch.randn(k, n, generator=gen) * k ** -0.5).to(torch.bfloat16).cuda()
            outs = {}
            for flag in (True, False):
                matmul.allow_bf16_reduced_precision_reduction = flag
                outs[flag] = a @ b
            exact = a.double() @ b.double()
            rows.append({"m_k_n": [m, k, n], "bitwise_equal": torch.equal(outs[True], outs[False]),
                         "differing": int((outs[True] != outs[False]).sum()),
                         "max_abs_err_on": float((outs[True].double() - exact).abs().max()),
                         "max_abs_err_off": float((outs[False].double() - exact).abs().max())})
            del a, b, outs, exact
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    return rows


def repro_phase(card):
    """The determinism audit held to the card (RKT902, RKT905): GPT-2
    124M's train step and the REPRO_MOE_LAYERS-layer MoE LM (rows 11,
    ``gmm`` and ``tgmm``, both index_adds) each run twice from identical
    state, a warm step and one more; params, both moments, the step counts,
    the loss and the health word must be byte-equal. Then one step of each
    under torch's deterministic mode (warn only): every op torch warns about
    must be an order-free op the audit traced in the same step (a finding
    or a reviewed site); cuBLAS's workspace warnings (no
    ``CUBLAS_WORKSPACE_CONFIG`` is set once CUDA has started) are counted
    apart and the replay speaks for them. Last, cuBLAS's bf16
    reduced-precision reduction on and off at GPT-2's GEMMs. On the card
    only, outside any profiler window."""
    t0 = time.perf_counter()
    require(torch.cuda.is_available(), "repro: needs the card")
    cards = _repro_builders("cuda")
    metas = _repro_builders("meta")
    # The reviewed sites of the audit's train targets of the same layers.
    allow = {"gpt2": REPRO_TARGETS["fsdp_1x8"].allow, "moe": REPRO_TARGETS["moe"].allow}
    out, want_kernels = {}, {"gpt2": ("flash_fwd", "flash_bwd"),
                             "moe": ("flash_fwd", "flash_bwd", "gather_gmm_fwd", "gmm", "tgmm")}
    for name in ("gpt2", "moe"):
        with moe_gmm("fused" if name == "moe" else None):
            runs = [_replay_run(cards[name]) for _ in range(2)]
            torch.cuda.empty_cache()
            messages = _deterministic_warnings(cards[name])
            torch.cuda.empty_cache()
            step, args = metas[name]()
            tracer, _record, _ = repro_audit.trace_program(step, *args)
        warned, cublas = repro_audit.warned_ops(messages)
        findings = repro_audit.check_nondet_ops(tracer.nondet, allow=allow[name])
        traced = sorted({f"{op}@{site}" for op, site, _ in tracer.nondet})
        keys_ = ("params", "exp_avg", "exp_avg_sq", "count", "loss", "word")
        out[name] = {"runs": runs, "equal": {k: runs[0][k] == runs[1][k] for k in keys_},
                     "warned_ops": warned, "cublas_warnings": cublas, "warnings": len(messages),
                     "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                     "traced_order_free": traced,
                     "findings": [f.message for f in findings],
                     "unexplained": repro_audit.explained(warned, tracer.nondet)}
    gen = torch.Generator().manual_seed(26)
    cublas_rows = _cublas_reduction(gen)
    emit("repro", gpt2=out["gpt2"], moe=out["moe"], moe_layers=REPRO_MOE_LAYERS,
         cublas_reduction=cublas_rows, seconds=time.perf_counter() - t0, card=card)
    for name, rec in out.items():
        require(all(rec["equal"].values()), f"repro {name}: two runs from identical state "
                f"differ at {[k for k, v in rec['equal'].items() if not v]}")
        for run in rec["runs"]:
            require(all(run["launches"].get(k, 0) > 0 for k in want_kernels[name]),
                    f"repro {name}: launches {run['launches']}")
            require(math.isfinite(run["loss_value"]), f"repro {name}: non-finite loss")
        require(not rec["findings"], f"repro {name}: " + "; ".join(rec["findings"]))
        require(not rec["unexplained"], f"repro {name}: torch warns about "
                f"{rec['unexplained']}, which the audit did not trace")


def train_long_phase(card):

    """GPT-2 124M at T=2048, B=8: the f32 dq partial buffer (nk * B * T *
    H * D * 4 bytes, nk = T / 64) passes DQ_PARTIALS_MAX_BYTES, so the
    backward takes flash_bwd without dq plus the accumulating flash_dq."""
    cfg = TransformerConfig.gpt2_124m(max_seq_len=2048)
    b, t, layers, steps = 8, 2048, cfg.num_layers, 3
    partial_bytes = -(-t // fa.TILE) * b * t * cfg.dim * 4
    require(partial_bytes > fa.DQ_PARTIALS_MAX_BYTES, "train_long does not pass the switch")
    clock, counts = run_train(cfg, b, steps)
    require(counts == {"flash_fwd": 2 * layers * steps, "flash_bwd": layers * steps,
                       "flash_dq": layers * steps}, f"train_long launches {counts}")
    step_s = np.diff(clock.stamps)[1:]
    emit("train_long", model="gpt2_124m", dtype="bfloat16", batch=b, seq_len=t, steps=steps,
         losses=clock.losses, step_ms=[x * 1e3 for x in step_s],
         tokens_per_s=b * t / float(np.median(step_s)), dq_partial_bytes=partial_bytes,
         launches=counts, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    return counts


def checkpoint_gpt2_phase(prepared, card):
    """The GPT-2 124M train state of the ``train`` phase (params and the
    AdamW moments, f32) through ``checkpoint_io``: the synchronous
    snapshot to host, the file write, the load back to host and the
    restore into the live state after zeroing it. The restored state must
    snapshot bitwise equal to the saved one."""
    view = prepared.checkpoint_state()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = checkpoint_io.snapshot(view)
        t1 = time.perf_counter()
        checkpoint_io.write_snapshot(tmp, plan)
        t2 = time.perf_counter()
        flat = checkpoint_io.load_pytree(tmp)
        t3 = time.perf_counter()
        file_bytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
    with torch.no_grad():
        for p in optim.param_leaves(prepared.state["params"]):
            p.zero_()
        for st in prepared.state["optimizer"].state.values():
            for v in st.values():
                v.zero_()
    t4 = time.perf_counter()
    prepared.load_checkpoint_state(checkpoint_io.unflatten(flat))
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    again = checkpoint_io.snapshot(prepared.checkpoint_state())["local"]
    require(again.keys() == plan["local"].keys(), "checkpoint_gpt2: leaves differ")
    require(all(np.array_equal(again[k], v) and np.array_equal(flat[k[:-2]], v)
                for k, v in plan["local"].items()), "checkpoint_gpt2: restore is not bitwise")
    # The reference's layout (ROADMAP Queue C3): optax's opt_state, an int32
    # step, uint32[2] key data, and no torch-layout leaf.
    counts = sorted(k for k in flat if k.startswith("opt_state/") and k.endswith("/count"))
    require(any(k.startswith("opt_state/0/mu/") for k in flat)
            and any(k.startswith("opt_state/0/nu/") for k in flat) and counts
            and not any(k.startswith("optimizer/") for k in flat)
            and flat["step"].dtype == np.int32 and flat["base_key"].dtype == np.uint32
            and flat["base_key"].shape == (2,),
            f"checkpoint_gpt2: not the reference's layout ({sorted(flat)[:6]}...)")
    nbytes = sum(v.nbytes for v in plan["local"].values())
    emit("checkpoint_gpt2", model="gpt2_124m", leaves=len(plan["local"]), bytes=nbytes,
         layout="reference", count_leaves=counts,
         count=int(flat[counts[0]]), step=int(flat["step"]),
         file_bytes_pr17_layout=1_493_578_119,
         file_bytes=file_bytes, snapshot_s=t1 - t0, write_s=t2 - t1, load_s=t3 - t2,
         restore_s=t5 - t4, snapshot_gb_per_s=nbytes / (t1 - t0) / 1e9,
         write_gb_per_s=nbytes / (t2 - t1) / 1e9, bitwise=True, card=card)


# -- phases 10-14: the char-LM slice ----------------------------------------

def _char_lm_losses(path="runs/char_lm.jsonl"):
    """(loss, host time) per Tracker flush: one per step."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows], [r["time"] for r in rows]


def _flash_launches():
    return fa.flash_fwd.launches + fa.flash_bwd.launches + fa.flash_dq.launches


def char_lm_train_phase(card):
    """``examples.char_lm.main(num_epochs=1)`` at the preset (B=128, T=256,
    bf16, dropout 0.1) with the fused attention half forced: every block's
    forward is one ``fused_block`` launch (separate epilogue: dropout and
    the projection outside), its backward the plain recompute. Step times
    are the gaps between the Tracker's flushes, each after the loss's
    device sync."""
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run = char_lm.main(num_epochs=1, out_dir="checkpoints/char_lm")
    wall = time.perf_counter() - t0
    launches, flash = fb.fused_block.launches, _flash_launches()
    steps = run["total_steps"]
    layers = run["model"].config.num_layers
    losses, stamps = _char_lm_losses()
    require(len(losses) == steps, f"char_lm: {len(losses)} tracker lines for {steps} steps")
    require(all(math.isfinite(x) for x in losses), f"char_lm: non-finite loss {losses}")
    require(float(np.mean(losses[-5:])) < losses[0], f"char_lm: loss did not fall {losses}")
    require(launches == layers * steps and flash == 0,
            f"char_lm: {launches} fused_block and {flash} flash launches over {steps} steps")
    ckpt = "checkpoints/char_lm"
    steps_dirs = sorted(d for d in os.listdir(ckpt) if d.isdigit())
    require(steps_dirs == [str(steps)] and newest_complete_step(ckpt) == steps,
            f"char_lm: checkpoint steps {steps_dirs}")
    step_s = np.diff(stamps)[2:]
    cfg = run["model"].config
    save = run["checkpointer"].save_times[0]
    emit("char_lm_train", model="char_lm", dtype="bfloat16", batch=128, seq_len=cfg.max_seq_len,
         vocab=cfg.vocab_size, steps=steps, losses=losses, fused_block_launches=launches,
         fused_block_per_step=launches / steps, flash_launches=flash,
         step_ms_median=float(np.median(step_s)) * 1e3, step_ms=[x * 1e3 for x in step_s],
         tokens_per_s=128 * cfg.max_seq_len / float(np.median(step_s)), wall_s=wall,
         checkpoint_snapshot_s=save["snapshot_s"], checkpoint_write_s=save["write_s"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         sample=run["sample"][:80], card=card)
    return launches, run


def _resume_run(root, num_epochs, resume_from=None, profile=False):
    """``char_lm.build``'s tree at the preset in ``root`` -> (losses, final
    params, step directories, the launch's (profiler, wall seconds) or
    None)."""
    root.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        text = _text()
        tok = CharTokenizer(text)
        tokens = tok.encode(text)
        data = TokenDataset(tokens[:int(len(tokens) * 0.95)], seq_len=256)
        config = TransformerConfig.char_lm(vocab_size=tok.vocab_size, max_seq_len=256)
        run = char_lm.build(data, config, batch_size=128, num_epochs=num_epochs, out_dir="ckpt",
                            runtime=rt.Runtime(seed=0), resume_from=resume_from)
        from torch.profiler import ProfilerActivity, profile as profiler

        prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile \
            else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), prof:
            run["launcher"].launch()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (_char_lm_losses()[0], run["trained"]["params"],
                sorted((d for d in os.listdir("ckpt") if d.isdigit()), key=int),
                (prof, wall) if profile else None)
    finally:
        os.chdir(cwd)


def char_lm_resume_phase(root, card):
    """An uninterrupted three-epoch run (B), and a fresh tree (A) resumed
    with ``resume_from="latest"`` from a copy of B's epoch-two checkpoint
    (the schedule spans a run's total steps, so it must be B's), which
    trains the third epoch only. A's losses and final params must equal
    B's within RESUME_TOL; B's step directories must be the last two saves
    (``keep_last=2``: three epoch-end saves, the first pruned). A's whole
    launch (resume, one epoch of steps, one save) runs under
    ``torch.profiler``: where a char-LM train step's device time goes."""
    t0 = time.perf_counter()
    whole, want, dirs, _ = _resume_run(root / "b", 3)
    spe = len(whole) // 3
    require(dirs == [str(2 * spe), str(3 * spe)], f"char_lm_resume: keep_last left {dirs}")
    shutil.copytree(root / "b" / "ckpt" / str(2 * spe), root / "a" / "ckpt" / str(2 * spe))
    resumed, got, _, (prof, prof_wall) = _resume_run(root / "a", 3, resume_from="latest",
                                                     profile=True)
    wall = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[2 * spe:]))
    require(len(resumed) == spe and loss_err <= RESUME_TOL,
            f"char_lm_resume: {len(resumed)} steps, loss rel err {loss_err}")
    param_err = max(((p - q).abs().max() / q.abs().max().clamp(min=1e-30)).item()
                    for p, q in zip(optim.param_leaves(got), optim.param_leaves(want)))
    require(param_err <= RESUME_TOL, f"char_lm_resume: param rel err {param_err}")
    emit("char_lm_resume", steps_per_epoch=spe, uninterrupted_epochs=3, resumed_epochs=1,
         loss_rel_err=loss_err, param_rel_err=param_err, tol=RESUME_TOL, kept_steps=dirs,
         bitwise=loss_err == 0.0 and param_err == 0.0, wall_s=wall, card=card)
    busy, idle, top, groups = _device_profile(prof, prof_wall)
    emit("char_lm_profile", steps=spe, wall_s=prof_wall, device_busy_s=busy,
         device_idle_share=idle, device_time_measured=busy > 0, top_kernels=top,
         device_s_by_group=groups, card=card)


def char_lm_eval_phase(run, card):
    """One eval forward at the preset (B=128, T=256) with the trained
    params: forced, it takes the fused epilogue (one launch per block);
    unforced, the flash kernels. In f32 activations the logits must agree
    element by element within TOL (this pins the math); in bf16, the
    preset, within the bf16 TOL of their norm: six layers of bf16 roundings
    taken at different places (the flash kernel rounds exp(s - m), the
    fused one p / l) spread the elements apart by a few bf16 steps."""
    model, params = run["model"], run["trained"]["params"]
    text = _text()
    tokens = CharTokenizer(text).encode(text)[:128 * 256].reshape(128, 256)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    row = {"batch": 128, "seq_len": 256}
    layers = model.config.num_layers
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cfg = dataclasses.replace(model.config, activation_dtype=name)
        m = TransformerLM(cfg)
        logits, launches = {}, {}
        with torch.no_grad():
            for forced in (True, False):
                if forced:
                    os.environ["ROCKET_TPU_BLOCK_ATTN"] = "fused"
                else:
                    os.environ.pop("ROCKET_TPU_BLOCK_ATTN", None)
                zero_launches()
                logits[forced] = m.apply(params, batch, mode="eval")["logits"].float()
                torch.cuda.synchronize()
                launches[forced] = (fb.fused_block.launches, fa.flash_fwd.launches)
        os.environ["ROCKET_TPU_BLOCK_ATTN"] = "fused"
        require(launches == {True: (layers, 0), False: (0, layers)},
                f"char_lm_eval {name}: launches (fused_block, flash_fwd) {launches}")
        got, want = logits[True], logits[False]
        rel = ((got - want).norm() / want.norm()).item()
        if dtype == torch.float32:
            err = _flash_err(got, want, dtype, "char_lm_eval f32 logits")
        else:
            err = (got - want).abs().max().item()
            require(rel <= TOL[dtype], f"char_lm_eval bf16 logits: relative error {rel}")
        row[name] = {"max_abs_err": err, "norm_rel_err": rel, "tol": TOL[dtype],
                     "max_abs_logit": want.abs().max().item()}
    emit("char_lm_eval", fused_block_launches=layers, flash_fwd_launches_unforced=layers,
         **row, card=card)


def char_lm_generate_phase(card):
    """``examples.generate`` loads the checkpoint and generates 128 tokens,
    greedy and sampled (``decode_attention``); a timed ``generate()`` of the
    loaded params gives tokens/s. Then ``python -m rocket_tpu_torch.serve
    run --config charlm --checkpoint`` serves 4 requests (``paged_decode``)."""
    ckpt = "checkpoints/char_lm"
    counts = {}
    for mode, flags in (("greedy", ["--greedy"]), ("sampled", [])):
        zero_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            text = char_generate.main(["--ckpt", ckpt, "--tokens", "128", *flags])
        require("loaded params from" in out.getvalue() and len(text) == len("the ") + 128,
                f"generate {mode}: {out.getvalue()[-300:]}")
        counts[mode] = da.decode_attention.launches
        require(counts[mode] > 0, f"generate {mode}: no decode_attention launch")
    with open(os.path.join(ckpt, "config.json")) as f:
        model = TransformerLM(TransformerConfig(**json.load(f)))
    with contextlib.redirect_stdout(io.StringIO()):
        params = char_generate.load_params(model, ckpt)
    prompt = CharTokenizer(_text()).encode("the ")[None, :]
    generate(model, params, prompt, 8, temperature=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, params, prompt, 128, temperature=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = serve_cli.main(["run", "--config", "charlm", "--checkpoint", ckpt, "--requests", "4",
                             "--max-new-tokens", "32", "--show", "0"])
    paged = pa.paged_decode.launches
    printed = out.getvalue()
    require(rc == 0 and "loaded params from" in printed and paged > 0,
            f"serve --checkpoint: rc {rc}, paged_decode {paged}: {printed[-300:]}")
    report = json.loads(printed[printed.index('{\n "serve_report"'):])["serve_report"]
    emit("char_lm_generate", tokens=128, decode_attention_launches=counts,
         generate_tokens_per_s=128 / gen_s, serve_requests=4,
         serve_completed=report["requests"]["completed"],
         serve_tokens_per_s=report["tokens_per_sec"], paged_decode_launches=paged, card=card)


def char_lm_phases(card):
    """The char-LM phases in a temporary directory (checkpoints, runs/),
    with the fused attention half forced; the environment and working
    directory are restored after."""
    cwd, forced = os.getcwd(), os.environ.get("ROCKET_TPU_BLOCK_ATTN")
    os.environ["ROCKET_TPU_BLOCK_ATTN"] = "fused"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            launches, run = char_lm_train_phase(card)
            char_lm_eval_phase(run, card)
            del run
            char_lm_generate_phase(card)
            char_lm_resume_phase(Path(tmp) / "resume", card)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        if forced is None:
            os.environ.pop("ROCKET_TPU_BLOCK_ATTN", None)
        else:
            os.environ["ROCKET_TPU_BLOCK_ATTN"] = forced
    return launches


# -- phases 15-18: the CIFAR-10 ResNet-18 slice -------------------------------

def _cifar_lines(path="runs/cifar_resnet18.jsonl"):
    """(train losses, their host times, val accuracies) from the Tracker's
    jsonl: one train line per optimizer step, one val line per epoch."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "train/loss" in r]
    return ([r["train/loss"] for r in train], [r["time"] for r in train],
            [r["val/accuracy"] for r in rows if "val/accuracy" in r])


def _bn_launches():
    return {"bn_twopass": fc.bn_twopass.launches, "bn_normalize": fc.bn_normalize.launches}


def cifar_train_phase(val, card):
    """``examples.cifar_resnet.main(num_epochs=3, batch_size=512)``: ResNet-18
    at full width on the synthetic CIFAR-10 (50,000 train images), f32
    with cuDNN's default TF32 convolutions, augmentation on the device,
    every train-mode BatchNorm(+relu) through the two-pass kernel
    (``ROCKET_TPU_FUSED_CONV=pallas``): 20 launches per step, none in eval.
    Step times are the gaps between the Tracker's flushes within an epoch
    (each after the loss's device sync), from the third step on."""
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = cifar_resnet.main(num_epochs=CIFAR_EPOCHS, batch_size=CIFAR_BATCH)
    wall = time.perf_counter() - t0
    launches = _bn_launches()
    steps = run["total_steps"]
    spe = steps // CIFAR_EPOCHS
    require(all(d.device_resident for d in run["datasets"]),
            "cifar: the train and val batches were not device-resident")
    losses, stamps, accuracy = _cifar_lines()
    require(len(losses) == steps, f"cifar: {len(losses)} tracker lines for {steps} steps")
    require(all(math.isfinite(x) for x in losses), f"cifar: non-finite loss {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    require(last < first, f"cifar: loss did not fall, first ten {first}, last ten {last}")
    require(launches == {"bn_twopass": CIFAR_BN_LAYERS * steps, "bn_normalize": 0},
            f"cifar: launches {launches} over {steps} steps")
    ckpt = "checkpoints/cifar"
    dirs = sorted(d for d in os.listdir(ckpt) if d.isdigit())
    require(dirs == [str(CIFAR_SAVE_STEP)] and newest_complete_step(ckpt) == CIFAR_SAVE_STEP,
            f"cifar: checkpoint steps {dirs}")
    with open(os.path.join(ckpt, str(CIFAR_SAVE_STEP), "model_0", "index.json")) as f:
        n_state = sum(k.startswith("model_state/") for k in json.load(f))
    require(n_state == 2 * CIFAR_BN_LAYERS, f"cifar: checkpoint holds {n_state} state leaves")
    require(len(accuracy) == CIFAR_EPOCHS and accuracy[-1] > 0.2,
            f"cifar: val accuracy {accuracy}")
    # Eval reads the running statistics: no kernel launch.
    state = run["trained"]["state"]
    zero_launches()
    with torch.no_grad():
        run["model"].apply(state["params"], {"image": torch.from_numpy(
            val.get_batch(np.arange(CIFAR_BATCH))["image"]).cuda()},
            state=state["model_state"], mode="eval")
    torch.cuda.synchronize()
    require(_bn_launches() == {"bn_twopass": 0, "bn_normalize": 0},
            f"cifar: eval launched {_bn_launches()}")
    step_s = _epoch_step_s(stamps, spe, CIFAR_EPOCHS)
    median = float(np.median(step_s))
    save = run["checkpointer"].save_times[0]
    RECORD["cifar_losses"] = losses
    emit("cifar_train", model="resnet18_cifar", dtype="float32 (convs in cuDNN's TF32)",
         batch=CIFAR_BATCH, steps=steps, epochs=CIFAR_EPOCHS, loss_first10_mean=first,
         loss_last10_mean=last, val_accuracy=accuracy, bn_twopass_launches=launches["bn_twopass"],
         bn_twopass_per_step=launches["bn_twopass"] / steps, eval_launches=0,
         step_ms_median=median * 1e3, step_ms_p10_p90=[float(np.percentile(step_s, q)) * 1e3
                                                       for q in (10, 90)],
         images_per_s=CIFAR_BATCH / median, wall_s=wall, device_resident=True,
         checkpoint_step=save["step"],
         checkpoint_snapshot_s=save["snapshot_s"], checkpoint_write_s=save["write_s"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         cudnn={"deterministic": torch.backends.cudnn.deterministic,
                "benchmark": torch.backends.cudnn.benchmark,
                "allow_tf32": torch.backends.cudnn.allow_tf32}, card=card)
    return run, launches["bn_twopass"]


def _cifar_group(kernel: str) -> str:
    """The CIFAR profile's device-time group of a kernel name."""
    low = kernel.lower()
    if any(k in kernel for k in ("twopass_kernel", "normalize_kernel")):
        return "fused_conv kernels"
    if "multi_tensor_apply" in low or "sgd" in low:
        return "SGD (multi-tensor apply)"
    if "memcpy" in low:
        return "copies"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "fprop",
                              "cutlass", "winograd", "gemm", "nvjet", "nhwc", "nchw")):
        return "convolutions and GEMMs"
    if "reduce" in low:
        return "reductions (BN backward sums, loss, pool)"
    return "elementwise (BN backward, relu, residual, masks, casts)"


def _epoch_step_s(stamps, per_epoch: int, epochs: int) -> np.ndarray:
    """Step seconds from the Tracker's per-step host stamps: the gaps within
    each epoch (each flush after the loss's device sync), the first epoch's
    first two dropped (warm-up)."""
    return np.concatenate([np.diff(stamps[e * per_epoch:(e + 1) * per_epoch])[2 if e == 0 else 0:]
                           for e in range(epochs)])


def _range_kernels(prof, name: str, start: float, end: float) -> dict:
    """{kernel name: device seconds} of the kernels launched inside the
    ``record_function`` ranges ``name`` that start in [start, end) (the
    profiler's µs), found through each range's tree of host events."""
    by_name: dict = {}

    def walk(ev):
        for k in ev.kernels:
            if k.name != name:  # the range's own mirror, if the profiler attaches one
                by_name[k.name] = by_name.get(k.name, 0.0) + k.duration * 1e-6
        for child in ev.cpu_children:
            walk(child)

    for ev in prof.events():
        if (ev.name == name and ev.device_type == DeviceType.CPU
                and start <= ev.time_range.start < end):
            walk(ev)
    return by_name


def _step_window(prof, group_of, first: int = 0, last: int = -1) -> dict:
    """Where the time of whole train steps goes, from a trace of a tree
    whose Module has a ``batch_transform``: the window runs from the start
    of step ``first``'s ``Module.batch_transform`` range to the start of
    step ``last``'s, so it holds whole steps (each ends on the loss's device
    sync). The idle share is the window's device time over its wall time
    (profiler overhead included); augmentation is every kernel launched
    inside the ranges; ``h2d_copies`` counts the host-to-device copies that
    ran in the window (none, when the batches come from the device)."""
    starts = sorted(ev.time_range.start for ev in prof.events()
                    if ev.name == "Module.batch_transform" and ev.device_type == DeviceType.CPU)
    w0, w1 = starts[first], starts[last]
    steps = starts.index(w1) - starts.index(w0)
    window = (w1 - w0) * 1e-6
    events = [ev for ev in _device_events(prof) if w0 <= ev.time_range.start < w1]
    by_name = _device_s_by_name(events)
    busy = sum(by_name.values())
    augment = _range_kernels(prof, "Module.batch_transform", w0, w1)
    groups: dict = {"augmentation (the batch_transform range)": sum(augment.values())}
    for name, t in by_name.items():
        rest = t - augment.get(name, 0.0)
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + rest
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "window_s": window, "step_ms": window / steps * 1e3,
            "device_busy_s": busy, "device_idle_share": (1.0 - busy / window) if busy else None,
            "device_busy_ms_per_step": busy / steps * 1e3, "device_time_measured": busy > 0,
            "device_s_by_group": groups,
            "share_by_group": {k: v / busy for k, v in groups.items()} if busy else None,
            "augment_kernels": len(augment),
            "h2d_copies": sum("HtoD" in ev.name for ev in events),
            "top_kernels": [{"name": k[:120], "s": t, "share_of_device": t / busy}
                            for k, t in top]}


def cifar_resume_phase(root, train, val, run, card):
    """A fresh tree (``cifar_resnet.build``) resumed with ``resume_from=
    "latest"`` from a copy of the train phase's step-200 checkpoint runs to
    the end of epoch 3 under ``torch.profiler``, its batches
    device-resident. Its losses, val accuracy, params and BatchNorm state
    must equal the uninterrupted run's bitwise (cuDNN deterministic, no
    autotuning, as for the train phase).

    Where the time goes is read from one window of the trace
    (:func:`_step_window`): from the first train step's ``Module.
    batch_transform`` range to the last one's, so whole train steps and
    nothing of the resume or the eval epoch; no host-to-device copy may run
    in it. The augmentation of one batch is also timed alone with CUDA
    events."""
    whole, _, whole_acc = _cifar_lines()
    want = run["trained"]["state"]
    src = Path("checkpoints/cifar") / str(CIFAR_SAVE_STEP)
    shutil.copytree(src, root / "ck" / str(CIFAR_SAVE_STEP))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        resumed = cifar_resnet.build(train, val, batch_size=CIFAR_BATCH, num_epochs=CIFAR_EPOCHS,
                                     out_dir="ck", runtime=rt.Runtime(seed=0),
                                     resume_from="latest")
        from torch.profiler import ProfilerActivity, profile

        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            resumed["launcher"].launch()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses, _, accuracy = _cifar_lines()
    finally:
        os.chdir(cwd)
    got = resumed["trained"]["state"]
    n = len(whole) - CIFAR_SAVE_STEP
    require(losses == whole[CIFAR_SAVE_STEP:], f"cifar_resume: {len(losses)} losses, want the "
            f"uninterrupted run's last {n}, equal bitwise")
    require(accuracy[-1:] == whole_acc[-1:], f"cifar_resume: accuracy {accuracy} vs {whole_acc}")
    for tree in ("params", "model_state"):
        for a, b in zip(optim.param_leaves(got[tree]), optim.param_leaves(want[tree])):
            require(torch.equal(a, b), f"cifar_resume: {tree} differs from the uninterrupted run")
    launches = _bn_launches()
    require(launches["bn_twopass"] == CIFAR_BN_LAYERS * n, f"cifar_resume: launches {launches}")
    require(all(d.device_resident for d in resumed["datasets"]),
            "cifar_resume: the batches were not device-resident")
    emit("cifar_resume", resumed_from_step=CIFAR_SAVE_STEP, steps=n, bitwise=True,
         device_resident=True, cudnn={"deterministic": torch.backends.cudnn.deterministic,
                                      "benchmark": torch.backends.cudnn.benchmark},
         wall_s=wall, card=card)

    window = _step_window(prof, _cifar_group)
    require(window["steps"] == n - 1, f"cifar_profile: {window['steps'] + 1} batch_transform "
            f"ranges, {n} steps")
    require(window["h2d_copies"] == 0,
            f"cifar_profile: {window['h2d_copies']} host-to-device copies in the step window")
    images = torch.from_numpy(train.get_batch(np.arange(CIFAR_BATCH))["image"]).cuda()
    transform = cifar_resnet.image_augment(crop_padding=4, flip=True)
    aug = Timer().ms(lambda: transform({"image": images}, 12345), iters=20)
    emit("cifar_profile", **window, augment_alone_ms=aug, launch_wall_s=wall, card=card)


def cifar_stats_xla_phase(root, train, val, card):
    """The seam's other schedule on the main path: 10 train steps of the
    same tree with ``fused_conv`` table entries pinning ``{"impl":
    "pallas", "schedule": "stats_xla"}`` for this card at each of
    ResNet-18's four train-mode BatchNorm shapes, written into a copy of
    the shipped tables and read through ``ROCKET_TPU_TUNE_DIR`` (the force
    override off): every train-mode BatchNorm runs the plain moments and the
    normalise kernel, 20 ``bn_normalize`` launches per step, each lookup a
    table hit."""
    entry = {"impl": "pallas", "schedule": "stats_xla", "block_rows": 512}
    shapes = [(CIFAR_BATCH * hw * hw, c) for hw, c in ((32, 64), (16, 128), (8, 256), (4, 512))]
    tables = root / "tables"
    shutil.copytree(tune.CONFIGS_DIR, tables)
    tune.write_table("fused_conv", [{
        "device_kind": torch.cuda.get_device_name(0), "dtype": "float32", "shape": shape,
        "shape_bucket": TUNE_SPACES["fused_conv"].bucket(shape), "config": entry}
        for shape in ({"n": n, "c": c} for n, c in shapes)], str(tables))
    require(not tune.validate_tables(str(tables)),
            f"cifar_stats_xla: {tune.validate_tables(str(tables))}")
    forced = os.environ.pop("ROCKET_TPU_FUSED_CONV", None)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with _tune_dir(tables):
            steps = 10
            sub_train = train.get_batch(np.arange(steps * CIFAR_BATCH))
            sub_val = val.get_batch(np.arange(CIFAR_BATCH))
            run = cifar_resnet.build(ArrayDataset(sub_train["image"], sub_train["label"]),
                                     ArrayDataset(sub_val["image"], sub_val["label"]),
                                     batch_size=CIFAR_BATCH, num_epochs=1, out_dir="ck",
                                     runtime=rt.Runtime(seed=0))
            zero_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                run["launcher"].launch()
            torch.cuda.synchronize()
            launches = _bn_launches()
            losses, _, _ = _cifar_lines()
            lookups = [r for r in tune.lookup_log_summary() if r["kernel"] == "fused_conv"]
    finally:
        os.chdir(cwd)
        if forced is not None:
            os.environ["ROCKET_TPU_FUSED_CONV"] = forced
    require(len(lookups) == len(shapes) and all(r["source"] == "table" for r in lookups),
            f"cifar_stats_xla: fused_conv lookups {lookups}")
    require(launches == {"bn_twopass": 0, "bn_normalize": CIFAR_BN_LAYERS * steps},
            f"cifar_stats_xla: launches {launches}")
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"cifar_stats_xla: losses {losses}")
    emit("cifar_stats_xla", table_entry=entry, table_shapes=shapes, lookups=lookups,
         steps=steps, losses=losses, launches=launches, card=card)
    return launches["bn_normalize"]


def cifar_model_check(card):
    """One train forward + backward of ResNet-18 (CIFAR stem, B=32, 32x32:
    the smallest batch whose every BatchNorm tiles 512 rows) on the card,
    every BatchNorm through the two-pass kernel, against the same params
    on the CPU (the plain version). With TF32 off the logits, the loss and
    the new BN state must agree within CIFAR_TOL of their largest element,
    and every gradient within CIFAR_TOL of its norm or CIFAR_GRAD_FLOOR
    times the CPU's own worst gap when the batch is permuted (the same math
    summed in another order), whichever is larger. The gap with TF32 on,
    as the train phase runs, is reported."""
    model = resnet18(10, stem="cifar")
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    state = model.init_state(device="cpu")
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 32).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(32))
    results = {}
    for key in (("cpu", False), ("cpu", "permuted"), ("cuda", False), ("cuda", True)):
        dev, flag = key
        torch.backends.cudnn.allow_tf32 = flag is True
        order = perm if flag == "permuted" else torch.arange(32)
        p = map_params(lambda t: t.detach().to(dev).requires_grad_(), params)
        zero_launches()
        out, new_state = model.apply(p, {"image": images[order].to(dev)}, state=map_params(
            lambda t: t.to(dev), state), mode="train")
        loss = cifar_resnet.cross_entropy({"logits": out["logits"], "label": labels[order].to(dev)})
        grads = torch.autograd.grad(loss, optim.param_leaves(p))
        if dev == "cuda":
            torch.cuda.synchronize()
            require(fc.bn_twopass.launches == CIFAR_BN_LAYERS,
                    f"cifar_model_check: {fc.bn_twopass.launches} kernel launches")
        logits = out["logits"].detach().cpu()
        if flag == "permuted":
            logits = logits[torch.argsort(perm)]
        results[key] = ([logits, loss.detach().cpu()[None]]
                        + [t.cpu() for t in optim.param_leaves(new_state)],
                        [g.cpu() for g in grads])

    def gaps(key):
        vals, grads = results[key]
        wvals, wgrads = results[("cpu", False)]
        val_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                      for a, b in zip(vals, wvals))
        grad_err = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                       for a, b in zip(grads, wgrads))
        return val_err, grad_err

    floor, off, on = gaps(("cpu", "permuted")), gaps(("cuda", False)), gaps(("cuda", True))
    grad_tol = max(CIFAR_TOL, CIFAR_GRAD_FLOOR * floor[1])
    require(off[0] <= CIFAR_TOL and off[1] <= grad_tol,
            f"cifar_model_check: card vs CPU with TF32 off: values {off[0]} (tol {CIFAR_TOL}), "
            f"grads {off[1]} (tol {grad_tol}; the CPU's own reorder gap {floor[1]})")
    emit("cifar_model_check", model="resnet18_cifar", batch=32, dtype="float32",
         tf32_off={"value_rel_err": off[0], "grad_norm_rel_err": off[1]},
         tf32_on={"value_rel_err": on[0], "grad_norm_rel_err": on[1]},
         cpu_reorder_gap={"value_rel_err": floor[0], "grad_norm_rel_err": floor[1]},
         tol={"values": CIFAR_TOL, "grads": grad_tol},
         loss=float(results[("cuda", False)][0][1]), card=card)


def cifar_phases(card):
    """The CIFAR-10 ResNet-18 phases in a temporary directory, with the
    fused BatchNorm forced (``ROCKET_TPU_FUSED_CONV=pallas``), cuDNN
    deterministic without autotuning (bitwise resume needs both) and
    cuDNN's TF32 convolutions on, PyTorch's default, which the port leaves
    alone; the settings, environment and directory are restored after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cwd, forced = os.getcwd(), os.environ.get("ROCKET_TPU_FUSED_CONV")
    os.environ["ROCKET_TPU_FUSED_CONV"] = "pallas"
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = True, False, True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            train, val = cifar_resnet.cifar10(train=True), cifar_resnet.cifar10(train=False)
            run, twopass = cifar_train_phase(val, card)
            cifar_resume_phase(Path(tmp) / "resume", train, val, run, card)
            del run
            normalize = cifar_stats_xla_phase(Path(tmp) / "stats_xla", train, val, card)
            os.chdir(cwd)
            cifar_model_check(card)
    finally:
        os.chdir(cwd)
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
        if forced is None:
            os.environ.pop("ROCKET_TPU_FUSED_CONV", None)
        else:
            os.environ["ROCKET_TPU_FUSED_CONV"] = forced
    return twopass, normalize


# -- the ViT, MNIST and Llama examples ----------------------------------------

#: vit_train: examples.vit_cifar at its full width (vit_tiny: D=192, 9 blocks,
#: 3 heads, dropout 0.1, 65 tokens), bf16, B=512, on the synthetic CIFAR-10,
#: 1 epoch (cut from the example's 5, then from 2); vit_profile: a
#: torch.profiler window of VIT_PROFILE_STEPS whole steps of the same tree
#: over its first batches.
VIT_EPOCHS, VIT_BATCH, VIT_LAYERS, VIT_TOKENS, VIT_PROFILE_STEPS = 1, 512, 9, 65, 3
#: vit_model_check: ViT at full width (D=192, 3 heads, 32x32 in 4x4
#: patches), depth 2, f32, dropout 0, B=32: the card (flash kernels, TF32
#: off) against the CPU (plain attention), the logits absolutely and every
#: gradient relative to its largest element.
VIT_CHECK_TOL = {"logits": 1e-3, "grad": 1e-3}
#: llama_train: examples.llama_lm at its width (dim 256, 6 layers, 8 heads
#: over 4 K/V heads of 32), B=128, T=256, one epoch of the synthetic corpus
#: (cut from the example's 2), then its nucleus sample of 64 tokens;
#: llama_profile: LLAMA_PROFILE_STEPS steps of the same tree under a step
#: clock, the last 3 under torch.profiler.
LLAMA_LAYERS, LLAMA_NEW_TOKENS, LLAMA_PROFILE_STEPS = 6, 64, 8  # profile steps cut from 12


def _flash_counts() -> dict:
    return {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
            "flash_dq": fa.flash_dq.launches}


def vit_train_phase(card):
    """``examples.vit_cifar.main(num_epochs=2, batch_size=512)``: both
    Loopers device-resident, one ``flash_fwd`` and one ``flash_bwd`` launch
    per block per train step (no remat) and one ``flash_fwd`` per block per
    val batch, a finite falling loss and val accuracy above 0.2 (chance
    0.1). Step times as in cifar_train."""
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run = vit_cifar.main(num_epochs=VIT_EPOCHS, batch_size=VIT_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts()
    steps = run["total_steps"]
    train, val = run["datasets"]
    require(train.device_resident and val.device_resident,
            "vit_train: the train and val batches were not device-resident")
    losses, stamps, accuracy = _cifar_lines("runs/vit_cifar.jsonl")
    require(len(losses) == steps, f"vit_train: {len(losses)} tracker lines for {steps} steps")
    require(all(math.isfinite(x) for x in losses), f"vit_train: non-finite loss {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    require(last < first, f"vit_train: loss did not fall, first ten {first}, last ten {last}")
    want = {"flash_fwd": VIT_LAYERS * (steps + VIT_EPOCHS * val.total),
            "flash_bwd": VIT_LAYERS * steps, "flash_dq": 0}
    require(launches == want, f"vit_train: launches {launches}, want {want}")
    require(len(accuracy) == VIT_EPOCHS and accuracy[-1] > 0.2, f"vit_train: accuracy {accuracy}")
    step_s = _epoch_step_s(stamps, steps // VIT_EPOCHS, VIT_EPOCHS)
    median = float(np.median(step_s))
    emit("vit_train", model="vit_tiny", dtype="bfloat16", batch=VIT_BATCH, tokens=VIT_TOKENS,
         steps=steps, epochs=VIT_EPOCHS, loss_first10_mean=first, loss_last10_mean=last,
         val_accuracy=accuracy, launches=launches,
         flash_fwd_per_train_step=(launches["flash_fwd"] - VIT_LAYERS * VIT_EPOCHS * val.total)
         / steps, flash_bwd_per_train_step=launches["flash_bwd"] / steps,
         val_batches_per_epoch=val.total, device_resident=True, step_ms_median=median * 1e3,
         step_ms_p10_p90=[float(np.percentile(step_s, q)) * 1e3 for q in (10, 90)],
         images_per_s=VIT_BATCH / median, tokens_per_s=VIT_BATCH * VIT_TOKENS / median,
         wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    return launches


def vit_profile_phase(train, val, card):
    """A torch.profiler trace of ``vit_cifar.build``'s tree over the first
    2 + VIT_PROFILE_STEPS + 1 batches of the train set (one epoch, one val
    batch): the window holds train steps 2 to 2 + VIT_PROFILE_STEPS
    (:func:`_step_window`), and no host-to-device copy may run in it."""
    from torch.profiler import ProfilerActivity, profile

    n = (VIT_PROFILE_STEPS + 3) * VIT_BATCH
    sub = train.get_batch(np.arange(n))
    sub_val = val.get_batch(np.arange(VIT_BATCH))
    run = vit_cifar.build(ArrayDataset(sub["image"], sub["label"]),
                          ArrayDataset(sub_val["image"], sub_val["label"]), batch_size=VIT_BATCH,
                          num_epochs=1, out_dir="ck_profile", runtime=rt.Runtime(seed=0))
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run["launcher"].launch()
        torch.cuda.synchronize()
    window = _step_window(prof, _train_group, first=2, last=2 + VIT_PROFILE_STEPS)
    require(window["steps"] == VIT_PROFILE_STEPS, f"vit_profile: window {window['steps']} steps")
    require(window["h2d_copies"] == 0,
            f"vit_profile: {window['h2d_copies']} host-to-device copies in the step window")
    emit("vit_profile", **window, images_per_s=VIT_BATCH / window["step_ms"] * 1e3,
         tokens_per_s=VIT_BATCH * VIT_TOKENS / window["step_ms"] * 1e3, card=card)


def vit_model_check(card):
    """One train forward + backward of ViT at full width, depth 2, f32,
    dropout 0, B=32: the card (the f32 flash kernels, TF32 off) against the
    same params on the CPU (plain attention)."""
    model = ViT(32, 4, dim=192, depth=2, num_heads=3)
    init = model.init(torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 32).astype(np.int32))
    result = {}
    for dev in ("cpu", "cuda"):
        params = map_params(lambda t: t.to(dev).requires_grad_(), init)
        zero_launches()
        out = model.apply(params, {"image": images.to(dev)}, mode="train", rng=0)
        loss = cifar_resnet.cross_entropy({"logits": out["logits"], "label": labels.to(dev)})
        grads = torch.autograd.grad(loss, optim.param_leaves(params))
        result[dev] = (out["logits"].detach().cpu(), [g.cpu() for g in grads])
    require(fa.flash_fwd.launches == 2 and fa.flash_bwd.launches == 2,
            "vit_model_check: the card pass did not run the flash kernels")
    logit_err = (result["cuda"][0] - result["cpu"][0]).abs().max().item()
    grad_err = max(((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                   for g, w in zip(result["cuda"][1], result["cpu"][1]))
    require(logit_err <= VIT_CHECK_TOL["logits"], f"vit_model_check: logits {logit_err}")
    require(grad_err <= VIT_CHECK_TOL["grad"], f"vit_model_check: grads relative {grad_err}")
    emit("vit_model_check", depth=2, dim=192, heads=3, tokens=VIT_TOKENS, dtype="float32",
         batch=32, logit_max_abs_err=logit_err, grad_rel_err=grad_err, tol=VIT_CHECK_TOL,
         n_grads=len(result["cuda"][1]), card=card)


def vit_phases(card):
    """The ViT phases in a temporary directory (checkpoints, runs/)."""
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            launches = vit_train_phase(card)
            torch.cuda.empty_cache()
            vit_profile_phase(cifar_resnet.cifar10(train=True), cifar_resnet.cifar10(train=False),
                              card)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
    vit_model_check(card)
    return launches


def mnist_phase(card):
    """``examples.mnist.main(num_epochs=1)`` in a temporary directory:
    LeNet on the device-resident SyntheticMNIST (60,000 train, 10,000 val),
    B=1024, gradient accumulation 2; val accuracy above 0.2 (chance 0.1).
    A Tracker line is one optimizer step (two batches): the step time is
    half its gap. No hand kernel is on this path."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run = mnist.main(num_epochs=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses, stamps, accuracy = _cifar_lines("runs/mnist.jsonl")
        finally:
            os.chdir(cwd)
    train, val = run["datasets"]
    require(train.device_resident and val.device_resident,
            "mnist: the train and val batches were not device-resident")
    require(losses and all(math.isfinite(x) for x in losses), f"mnist: losses {losses}")
    require(len(accuracy) == 1 and accuracy[0] > 0.2, f"mnist: accuracy {accuracy}")
    step_s = np.diff(stamps)[2:] / 2
    emit("mnist_train", model="lenet", dtype="float32", batch=1024, accumulation=2,
         batches=train.total, optimizer_steps=len(losses), loss_first=losses[0],
         loss_last=losses[-1], val_accuracy=accuracy, device_resident=True,
         step_ms_median=float(np.median(step_s)) * 1e3,
         images_per_s=1024 / float(np.median(step_s)), wall_s=wall, card=card)


def llama_phase(card):
    """``examples.llama_lm.main(num_epochs=1)`` in a temporary directory:
    one ``flash_fwd`` and one ``flash_bwd`` launch per layer per step on the
    bthd GQA operands (head dim 32), a falling loss, then the nucleus sample:
    one row 2 call (its split and combine) per layer per generated token."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run = llama_lm.main(num_epochs=1, out_dir="ck")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    counts = {**_flash_counts(), "decode_attention": da.decode_attention.launches}
    losses = [float(v) for v in run["trained"]["losses"]]
    steps, cfg = len(losses), run["model"].config
    require(run["dataset"].device_resident, "llama: the batches were not device-resident")
    require(steps == run["total_steps"] and all(math.isfinite(x) for x in losses),
            f"llama: {steps} losses for {run['total_steps']} steps")
    require(float(np.mean(losses[-5:])) < float(np.mean(losses[:5])),
            f"llama: loss did not fall {losses}")
    want = {"flash_fwd": LLAMA_LAYERS * steps, "flash_bwd": LLAMA_LAYERS * steps, "flash_dq": 0,
            "decode_attention": LLAMA_LAYERS * LLAMA_NEW_TOKENS}
    require(counts == want, f"llama: launches {counts}, want {want}")
    require(len(run["sample"]) == 4 + LLAMA_NEW_TOKENS, f"llama: sample {run['sample']!r}")
    emit("llama_train", model="llama_lm", dtype="bfloat16", batch=128, seq_len=cfg.max_seq_len,
         layers=LLAMA_LAYERS, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, steps=steps,
         losses=losses, launches=counts, flash_fwd_per_step=counts["flash_fwd"] / steps,
         decode_calls_per_token_per_layer=counts["decode_attention"]
         / (LLAMA_NEW_TOKENS * LLAMA_LAYERS), sample=run["sample"], wall_s=wall, card=card)
    llama_profile_phase(card)
    return counts


def llama_profile_phase(card):
    """LLAMA_PROFILE_STEPS steps of ``llama_lm.build``'s tree (the first
    windows of its corpus) with a step clock, the last PROFILE_STEPS under
    torch.profiler: step ms, tokens/s, device ms a step, the idle share,
    the groups, and no host-to-device copy in the window."""
    text = tiny_shakespeare()
    tok = CharTokenizer(text)
    seq_len, batch = 256, 128
    tokens = tok.encode(text)[:LLAMA_PROFILE_STEPS * batch * seq_len + 1]
    clock = StepClock(profile_last=PROFILE_STEPS)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            run = llama_lm.build(TokenDataset(tokens, seq_len=seq_len),
                                 llama_lm.config_for(tok.vocab_size, seq_len), batch_size=batch,
                                 num_epochs=1, out_dir="ck", runtime=rt.Runtime(seed=0),
                                 capsules=(clock,))
            with contextlib.redirect_stderr(io.StringIO()):
                run["launcher"].launch()
        finally:
            os.chdir(cwd)
    require(len(clock.losses) == LLAMA_PROFILE_STEPS, f"llama_profile: {len(clock.losses)} steps")
    step_s = np.diff(clock.stamps)[WARM_STEPS:LLAMA_PROFILE_STEPS - PROFILE_STEPS]
    median = float(np.median(step_s))
    busy, idle, top, groups = _device_profile(clock.prof, clock.prof_wall)
    h2d = sum("HtoD" in ev.name for ev in _device_events(clock.prof))
    require(h2d == 0, f"llama_profile: {h2d} host-to-device copies in the profiled steps")
    emit("llama_profile", steps=PROFILE_STEPS, step_ms_median=median * 1e3,
         tokens_per_s=batch * seq_len / median, wall_s=clock.prof_wall, device_busy_s=busy,
         device_busy_ms_per_step=busy / PROFILE_STEPS * 1e3, device_idle_share=idle,
         device_time_measured=busy > 0, h2d_copies=h2d, top_kernels=top,
         device_s_by_group=groups, card=card)

# -- head dim 128 and the recipe modules --------------------------------------

#: parity_flash_d128: rows 3-5 at the attention widths of public models with
#: head dim 128 (B, T, Hq, Hkv, D, fused operand), bf16, causal, T=2048, each
#: also in f32 at T=256: Llama-3-8B (32 query heads over 8 K/V heads, bthd
#: GQA), Llama-2-7B (32 heads, the fused MHA operand), and Phi-3-mini (32
#: heads of 96) and Phi-2 (32 of 80), which run on heads zero-padded to 128.
D128_FLASH = {"llama3_8b": (2, 2048, 32, 8, 128, False),
              "llama2_7b": (2, 2048, 32, 32, 128, True),
              "phi3_mini": (1, 2048, 32, 32, 96, True),
              "phi2": (1, 2048, 32, 32, 80, True)}
#: Rows 6-7 at Llama-2-7B's stacked (3, B, H, T, D) operand, at the one tile
#: pair compiled at D=128 (64 x 64).
D128_QKV = (2, 32, 2048, 128)
#: llama_d128_*: TransformerConfig.llama_style at Llama-3-8B's attention
#: widths (dim 4096, 32 query heads over 8 K/V heads of 128), depth cut to
#: 2, with the recipe's own vocabulary (50257, not Llama-3's 128256) and
#: SwiGLU hidden (4 * dim = 16384, not 14336); B=4, T=2048, bf16 compute,
#: remat, Lion, EMA 0.999.
LLAMA_D128 = dict(dim=4096, num_layers=2, num_heads=32, num_kv_heads=8, max_seq_len=2048)
LLAMA_D128_BATCH, LLAMA_D128_STEPS, LLAMA_D128_EMA = 4, 8, 0.999
#: vit_recipe: examples.vit_cifar at its full width with mixup (alpha 0.2)
#: and soft cross-entropy, Lion (peak lr 1e-3, decay 0.1), EMA 0.999 read
#: by the eval Module, one epoch; a checkpoint at step VIT_RECIPE_SAVE.
VIT_RECIPE_SAVE, VIT_RECIPE_EMA, VIT_RECIPE_PLAIN_STEPS = 50, 0.999, 12
#: bpe_lm: the synthetic corpus under a byte-level BPE of 512 ids, the
#: char-LM recipe's widths (dim 256, 6 layers, 4 heads of 64) over them.
BPE_VOCAB, BPE_STEPS, BPE_BATCH, BPE_SEQ = 512, 30, 32, 256


def check_flash_d128(timer, gen):
    """Rows 3-5 at :data:`D128_FLASH` and rows 6-7 at :data:`D128_QKV`:
    each kernel against its plain version at the true D (the padded D's
    through the wrappers' zero padding), two launches bitwise, dk and dv
    equal with and without dq, bf16 timed with the L2 flushed beside SDPA
    and the bound; every case must launch the kernels (no plain path on
    the card)."""
    rows = {}
    for name, (b, t, hq, h_kv, d, fused) in D128_FLASH.items():
        kd = fa.kernel_dim(d)
        pad = {"model": name, "kernel_d": kd, "padded_work_share": (kd - d) / kd}
        for dtype, tt, time_it in ((torch.bfloat16, t, True), (torch.float32, 256, False)):
            before = _flash_counts()
            row = flash_case(timer, gen, b, tt, hq, h_kv, d, dtype, True, fused, time_it)
            after = _flash_counts()
            require(all(after[k] > before[k] for k in after),
                    f"parity_flash_d128 {name}: a kernel did not launch ({before} -> {after})")
            emit("parity_flash_d128", **pad, **row)
            if time_it:
                rows[name] = row
    b, h, t, d = D128_QKV
    before = (fqa.flash_qkv_fwd.launches, fqa.flash_qkv_bwd.launches)
    rows["llama2_7b_stacked"] = qkv_case(timer, gen, b, h, t, d, torch.bfloat16, True, 64, 64,
                                         time_it=True)
    emit("parity_flash_d128", model="llama2_7b_stacked", **rows["llama2_7b_stacked"])
    for dtype, tt, dd, causal in ((torch.bfloat16, t, d, False), (torch.float32, 256, d, True),
                                  (torch.bfloat16, 256, 96, True)):
        emit("parity_flash_d128", model="llama2_7b_stacked" if dd == d else "phi3_stacked",
             **qkv_case(timer, gen, b, h, tt, dd, dtype, causal, 64, 64))
    require(fqa.flash_qkv_fwd.launches > before[0] and fqa.flash_qkv_bwd.launches > before[1],
            "parity_flash_d128: rows 6-7 did not launch")
    return rows


def llama_d128_config(**over) -> TransformerConfig:
    return TransformerConfig.llama_style(**{**LLAMA_D128, **over})


def _param_count(params) -> int:
    return sum(t.numel() for t in optim.param_leaves(params))


def llama_d128_train_phase(card):
    """LLAMA_D128_STEPS steps of the Llama-style model at head dim 128
    through the Launcher (the train Module with Lion and ema_decay, remat,
    bf16 compute, the batches device-resident): a finite falling loss, an
    EMA shadow that moved, and per step two flash forwards (forward and
    remat recompute), one backward without dq and one accumulating dq per
    layer (the dq partials would pass DQ_PARTIALS_MAX_BYTES)."""
    cfg = llama_d128_config()
    b, t, layers, steps = LLAMA_D128_BATCH, cfg.max_seq_len, cfg.num_layers, LLAMA_D128_STEPS
    partials = -(-t // fa.TILE) * b * t * cfg.dim * 4
    require(partials > fa.DQ_PARTIALS_MAX_BYTES, "llama_d128: the dq switch does not apply")
    model = TransformerLM(cfg)
    module = rt.Module(model, [
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.lion(weight_decay=0.1)),
        rt.Scheduler(optim.warmup_cosine_lr(3e-4, warmup_steps=1, decay_steps=steps)),
    ], compute_dtype=torch.bfloat16, remat=True, ema_decay=LLAMA_D128_EMA)
    clock = StepClock(module=module)
    dataset = rt.Dataset(_gpt2_corpus(t, cfg.vocab_size), batch_size=b, shuffle=True,
                         drop_last=True)
    launcher = rt.Launcher([rt.Looper([dataset, module, clock], tag="train", repeats=steps,
                                      progress=False)], statefull=True, runtime=rt.Runtime(seed=0))
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    launcher.launch()
    counts = _flash_counts()
    losses = clock.losses
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"llama_d128_train: losses {losses}")
    require(float(np.mean(losses[-3:])) < losses[0],
            f"llama_d128_train: loss did not fall, first {losses[0]}, last three {losses[-3:]}")
    want = {"flash_fwd": 2 * layers * steps, "flash_bwd": layers * steps,
            "flash_dq": layers * steps}
    require(counts == want, f"llama_d128_train: launches {counts}, want {want}")
    require(dataset.device_resident, "llama_d128_train: the batches were not device-resident")
    state = clock.prepared.state
    ema, params = optim.param_leaves(state["ema_params"]), optim.param_leaves(state["params"])
    require(all(bool(torch.isfinite(e).all()) for e in ema), "llama_d128_train: EMA not finite")
    require(not torch.equal(ema[0], params[0]), "llama_d128_train: the EMA shadow did not lag")
    step_s = np.diff(clock.stamps)[1:]
    median = float(np.median(step_s))
    emit("llama_d128_train", config={**LLAMA_D128, "vocab_size": cfg.vocab_size,
                                     "ffn_hidden": cfg.mlp_ratio * cfg.dim, "head_dim": 128},
         params=_param_count(state["params"]), dtype="bfloat16", batch=b, seq_len=t,
         steps=steps, optimizer="lion", ema_decay=LLAMA_D128_EMA, losses=losses,
         step_ms=[x * 1e3 for x in step_s], step_ms_median=median * 1e3,
         tokens_per_s=b * t / median, launches=counts,
         flash_per_step={k: v / steps for k, v in counts.items()},
         dq_partial_bytes=partials, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         card=card)
    return counts


def llama_d128_model_check(card):
    """The Llama-style model at head dim 128, depth 1, f32, T=256, B=1: the
    card's forward (the f32 flash kernel at D=128, TF32 off) against the
    CPU's (plain attention), logits within MODEL_TOL."""
    cfg = dataclasses.replace(llama_d128_config(num_layers=1, max_seq_len=256),
                              activation_dtype=None)
    model = TransformerLM(cfg)
    cpu = model.init(torch.Generator().manual_seed(8), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int32))
    logits = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            params = cpu if dev == "cpu" else map_params(lambda x: x.cuda(), cpu)
            zero_launches()
            logits[dev] = model.apply(params, {"tokens": tokens.to(dev)},
                                      mode="eval")["logits"].float().cpu()
            if dev == "cuda":
                require(fa.flash_fwd.launches == 1, "llama_d128_model_check: no flash launch")
            del params
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    require(err <= MODEL_TOL, f"llama_d128_model_check: logits max abs err {err}")
    emit("llama_d128_model_check", layers=1, dim=cfg.dim, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=128, seq_len=256, dtype="float32",
         max_abs_err=err, tol=MODEL_TOL, card=card)


def llama_d128_serve_phase(card):
    """The Llama-style model at head dim 128 (random weights from a seed,
    bf16) serving 4 greedy requests (prompts 128 to 1024 tokens, 32 new
    each) through ``Scheduler.run_until_idle``: row 1 at D=128 and a group
    of 4; one ``SlotEngine.decode`` equal to the harvested dispatch it
    replaces; then ``generate()`` (row 2 at D=128, g=4)."""
    cfg = llama_d128_config()
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    engine = ServeEngine(model, params, ServeConfig(max_slots=4, block_len=16, prefill_chunk=256,
                                                    max_model_len=2048),
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    lens = [128, 384, 700, 1024]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    waves0 = engine.engine.decode_waves
    zero_launches()
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=32, temperature=0.0) for p in prompts]
    events = engine.scheduler.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waves = engine.engine.decode_waves - waves0
    launches = pa.paged_decode.launches
    require(engine.scheduler.idle and events, "llama_d128_serve: not idle")
    for r in rids:
        toks = engine.result(r).tokens
        require(engine.result(r).finished and len(toks) == 32
                and all(0 <= x < cfg.vocab_size for x in toks),
                f"llama_d128_serve: request {r} gave {len(toks)} tokens")
    require(launches == cfg.num_layers * waves,
            f"llama_d128_serve: paged_decode launched {launches} times over {waves} waves")
    # One SlotEngine.decode against the dispatch it stands for: one slot
    # prefilled by hand (its blocks are free again), the same arguments.
    slot = engine.engine
    table = np.zeros_like(engine.scheduler.block_table)
    table[0, :16] = np.arange(1, 17)
    slot.prefill(table[:1], prompts[1][None, :256], np.zeros((1,), np.int32),
                 np.asarray([256], np.int32))
    s = table.shape[0]
    z_i, z_f = np.zeros((s,), np.int32), np.zeros((s,), np.float32)
    run = np.zeros((s,), bool)
    run[0] = True
    args = (table, np.where(run, 256, 0).astype(np.int32),
            np.where(run, int(prompts[1][255]), 0).astype(np.int32), run,
            np.where(run, 8, 0).astype(np.int32), z_f, z_i, np.ones((s,), np.float32),
            np.full((s,), -1, np.int32), z_i)
    got = slot.decode(*args)
    want = slot.harvest(slot.decode_dispatch(*args))
    require(all(np.array_equal(g, w) for g, w in zip(got, want)),
            "llama_d128_serve: SlotEngine.decode differs from its dispatch")
    # Row 2 at D=128: the dense-cache decode of generate().
    prompt = prompts[0][None, :]
    zero_launches()
    out = generate(model, params, prompt, 16, temperature=0)
    torch.cuda.synchronize()
    decode_calls = da.decode_attention.launches
    require(tuple(out.shape) == (1, 128 + 16), f"llama_d128_serve: generate {tuple(out.shape)}")
    require(decode_calls == cfg.num_layers * 16,
            f"llama_d128_serve: decode_attention launched {decode_calls} times")
    emit("llama_d128_serve", requests=4, prompt_lens=lens, new_tokens=32, decode_waves=waves,
         paged_decode_launches=launches, decode_attention_launches=decode_calls,
         slot_decode_equals_dispatch=True, tokens_per_s=4 * 32 / wall, wall_s=wall,
         head_dim=128, group=4, card=card)


class _FirstState(Capsule):
    """The train state as the first step finds it (ahead of the Module)."""

    def __init__(self, module_of):
        super().__init__(priority=2000)
        self.module_of = module_of
        self.state = None

    def launch(self, attrs=None):
        if self.state is None:
            state = self.module_of().state
            self.state = {k: [x.detach().clone() for x in optim.param_leaves(state[k])]
                          for k in ("params", "ema_params") if k in state}


def _vit_recipe(train, val, out_dir, *, ema=True, resume_from=None, save_every=None,
                capsules=()):
    save_every = save_every or VIT_RECIPE_SAVE
    return vit_cifar.build(train, val, batch_size=VIT_BATCH, num_epochs=1, out_dir=out_dir,
                           runtime=rt.Runtime(seed=0), optimizer=optim.lion(weight_decay=0.1),
                           lr=1e-3, objective=soft_cross_entropy(),
                           batch_transform=mixup(alpha=0.2, num_classes=10),
                           ema_decay=VIT_RECIPE_EMA if ema else None, save_every=save_every,
                           resume_from=resume_from, capsules=capsules)


def _lion_moments(state) -> list:
    opt = state["optimizer"]
    return [opt.state[p]["exp_avg"] for p in optim.param_leaves(state["params"])]


def vit_recipe_phase(card):
    """examples.vit_cifar's tree at its full width with mixup, soft
    cross-entropy, Lion and EMA (the eval Module reading the shadow): one
    epoch of the synthetic CIFAR-10 with EMA eval accuracy above 0.2; a
    fresh tree resumed from the step-VIT_RECIPE_SAVE checkpoint ends with
    params, EMA shadow and Lion moments equal to the uninterrupted run's
    bitwise; a run that saved without EMA, resumed with ema_decay, starts
    its shadow at the restored params."""
    train, val = cifar_resnet.cifar10(train=True), cifar_resnet.cifar10(train=False)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run = _vit_recipe(train, val, "ck")
                run["launcher"].launch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _flash_counts()
            accuracy = run["accuracy"].value
            whole = run["trained"]["state"]
            steps = run["total_steps"]
            require(accuracy is not None and accuracy > 0.2,
                    f"vit_recipe: EMA eval accuracy {accuracy}")
            with contextlib.redirect_stdout(io.StringIO()):
                resumed = _vit_recipe(train, val, "ck_resumed",
                                      resume_from=f"ck/{VIT_RECIPE_SAVE}")
                resumed["launcher"].launch()
            got = resumed["trained"]["state"]
            for what, a, b in (("params", optim.param_leaves(got["params"]),
                                optim.param_leaves(whole["params"])),
                               ("ema_params", optim.param_leaves(got["ema_params"]),
                                optim.param_leaves(whole["ema_params"])),
                               ("Lion moments", _lion_moments(got), _lion_moments(whole))):
                require(all(torch.equal(x, y) for x, y in zip(a, b)),
                        f"vit_recipe: resumed {what} differ from the uninterrupted run")
            require(resumed["accuracy"].value == accuracy,
                    f"vit_recipe: resumed accuracy {resumed['accuracy'].value} vs {accuracy}")
            # A pre-EMA checkpoint: a short run without EMA, then an EMA run
            # resumed from it; the first step finds the shadow at the params.
            n = (VIT_RECIPE_PLAIN_STEPS + 2) * VIT_BATCH
            sub = train.get_batch(np.arange(n))
            sub_val = val.get_batch(np.arange(VIT_BATCH))
            data = (ArrayDataset(sub["image"], sub["label"]),
                    ArrayDataset(sub_val["image"], sub_val["label"]))
            with contextlib.redirect_stdout(io.StringIO()):
                _vit_recipe(*data, "ck_plain", ema=False,
                            save_every=VIT_RECIPE_PLAIN_STEPS)["launcher"].launch()
                holder = {}
                first = _FirstState(lambda: holder["module"])
                seeded = _vit_recipe(*data, "ck_seeded",
                                     resume_from=f"ck_plain/{VIT_RECIPE_PLAIN_STEPS}",
                                     capsules=(first,))
                holder["module"] = seeded["module"]
                seeded["launcher"].launch()
            require(first.state is not None and "ema_params" in first.state,
                    "vit_recipe: the resumed EMA run took no step")
            require(all(torch.equal(e, p) for e, p in zip(first.state["ema_params"],
                                                           first.state["params"])),
                    "vit_recipe: a pre-EMA checkpoint did not seed the shadow from its params")
        finally:
            os.chdir(cwd)
    emit("vit_recipe", model="vit_tiny", dtype="bfloat16", batch=VIT_BATCH, steps=steps,
         optimizer="lion", lr=1e-3, mixup_alpha=0.2, ema_decay=VIT_RECIPE_EMA,
         ema_eval_accuracy=accuracy, resumed_from_step=VIT_RECIPE_SAVE, resume_bitwise=True,
         pre_ema_seeded=True, launches=launches, wall_s=wall, card=card)


def bpe_lm_phase(card):
    """A byte-level BPE of BPE_VOCAB ids trained on the synthetic corpus,
    the char-LM recipe's widths over its ids for BPE_STEPS steps with a val
    Looper reading ``Perplexity`` (the eval Module through the flash
    kernels at D=64), then 8 text requests served through
    ``Scheduler.run_until_idle`` and decoded by the tokenizer."""
    text = _text()
    t0 = time.perf_counter()
    tok = BPETokenizer.train(text, BPE_VOCAB)
    train_s = time.perf_counter() - t0
    ids = tok.encode(text)
    require(tok.decode(ids) == text, "bpe_lm: the corpus does not round-trip")
    split = int(len(ids) * 0.9)
    cfg = TransformerConfig.char_lm(vocab_size=BPE_VOCAB, max_seq_len=BPE_SEQ)
    model = TransformerLM(cfg)
    ppl = Perplexity()
    module = rt.Module(model, [
        rt.Loss(next_token_loss()), rt.Optimizer(optim.adamw(weight_decay=0.1)),
        rt.Scheduler(optim.warmup_cosine_lr(3e-3, warmup_steps=3, decay_steps=BPE_STEPS)),
    ], compute_dtype=torch.bfloat16)
    clock = StepClock(module=module)
    launcher = rt.Launcher([
        rt.Looper([rt.Dataset(TokenDataset(ids[:split], BPE_SEQ), batch_size=BPE_BATCH,
                              shuffle=True, drop_last=True), module, clock],
                  tag="train", repeats=BPE_STEPS, progress=False),
        rt.Looper([rt.Dataset(TokenDataset(ids[split:], BPE_SEQ), batch_size=BPE_BATCH),
                   rt.Module(model, compute_dtype=torch.bfloat16),
                   rt.Meter(["logits", "tokens"], [ppl])],
                  tag="val", grad_enabled=False, progress=False),
    ], statefull=True, runtime=rt.Runtime(seed=0))
    zero_launches()
    launcher.launch()
    losses = clock.losses
    require(len(losses) == BPE_STEPS and all(math.isfinite(x) for x in losses),
            f"bpe_lm: losses {losses}")
    require(float(np.mean(losses[-5:])) < losses[0], f"bpe_lm: loss did not fall {losses}")
    require(ppl.value is not None and math.isfinite(ppl.value) and ppl.value > 1.0,
            f"bpe_lm: val perplexity {ppl.value}")
    launches = _flash_counts()
    params = clock.prepared.state["params"]
    engine = ServeEngine(model, params, ServeConfig(max_slots=4, block_len=16, prefill_chunk=64,
                                                    max_model_len=BPE_SEQ),
                         tokenizer=tok, generator=torch.Generator().manual_seed(0))
    starts = [text[i * 997:i * 997 + 120] for i in range(8)]
    rids = [engine.submit(s, max_new_tokens=24, temperature=0.0) for s in starts]
    engine.scheduler.run_until_idle()
    texts = [engine.text(r) for r in rids]
    require(all(engine.result(r).finished for r in rids) and all(isinstance(x, str) and x
                                                                 for x in texts),
            f"bpe_lm: served texts {texts}")
    emit("bpe_lm", vocab=BPE_VOCAB, merges=len(tok.merges), tokenizer_train_s=train_s,
         corpus_chars=len(text), corpus_ids=len(ids), chars_per_id=len(text) / len(ids),
         dim=cfg.dim, layers=cfg.num_layers, heads=cfg.num_heads, steps=BPE_STEPS,
         batch=BPE_BATCH, seq_len=BPE_SEQ, losses=losses, val_perplexity=ppl.value,
         launches=launches, served=len(texts), served_texts=texts[:2], card=card)


#: moe_train: bench.py's moe_gpt2_e4 (GPT-2 124M widths, 4 experts, top-2,
#: capacity factor 1.25, dropout 0) with the dropless dispatch, B=8,
#: T=1024, bf16, remat: MOE_STEPS steps, the last MOE_PROFILE_STEPS under
#: torch.profiler, step times after MOE_WARM_STEPS.
MOE_STEPS, MOE_PROFILE_STEPS, MOE_WARM_STEPS, MOE_BATCH = 12, 2, 2, 8
#: moe_model_check: card vs CPU, f32, TF32 off: the loss relative to
#: itself, the logits and every gradient relative to their norm (two layers
#: of f32 sums in another order).
MOE_CHECK_TOL = {"loss": 1e-4, "values": 1e-3}


def moe_launches() -> dict:
    return {"gather_gmm": gg.gather_gmm_fwd.launches, "gmm": gm.gmm.launches,
            "tgmm": gm.tgmm.launches}


@contextlib.contextmanager
def moe_gmm(value):
    """``ROCKET_TPU_MOE_GMM`` set to ``value`` (None clears it) inside,
    restored after."""
    saved = os.environ.get("ROCKET_TPU_MOE_GMM")
    if value is None:
        os.environ.pop("ROCKET_TPU_MOE_GMM", None)
    else:
        os.environ["ROCKET_TPU_MOE_GMM"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ROCKET_TPU_MOE_GMM", None)
        else:
            os.environ["ROCKET_TPU_MOE_GMM"] = saved


#: The MoE phases' depth: bench.py's ``moe_gpt2_e4`` widths at 6 of its 12
#: layers (cut when the multi-process phases grew, to keep the
#: script inside its time limit).
MOE_LAYERS = 6


def moe_config(activation_dtype="bfloat16", **over):
    """bench.py's ``moe_gpt2_e4`` with ``expert_dispatch="dropless"``, at
    :data:`MOE_LAYERS` layers."""
    cfg = TransformerConfig.gpt2_124m()
    cfg.num_layers = MOE_LAYERS
    cfg.dropout, cfg.activation_dtype = 0.0, activation_dtype
    cfg.num_experts, cfg.expert_top_k, cfg.expert_capacity_factor = 4, 2, 1.25
    cfg.expert_dispatch = "dropless"
    for key, value in over.items():
        setattr(cfg, key, value)
    return cfg


def _moe_routing(gen, n_tok, dim=768, e=4, k=2, tile_m=512, dtype=torch.bfloat16):
    """The main path's routing of ``n_tok`` seeded token rows through a
    seeded router (the MoE layer's own init): ``(x, experts, counts,
    sorted_token, padded layout)``."""
    moe = MoE(dim, 4 * dim, e, top_k=k, dispatch="dropless")
    params = map_params(lambda t: t.cuda(), moe.init_params(gen))
    x = (torch.randn(n_tok, dim, generator=gen) * 0.5).to(dtype).cuda()
    _, _, top_idx = moe.route(params, x[None])
    pair_expert = top_idx.reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    sorted_token = torch.arange(n_tok, device="cuda").repeat_interleave(k)[order]
    counts = torch.bincount(pair_expert, minlength=e).to(torch.int32)
    layout = gg.padded_group_layout(counts, sorted_token, min(tile_m, n_tok * k), n_tok * k,
                                    sorted_expert=pair_expert[order])
    return x, params["experts"], counts, sorted_token, layout


def _rows_in_groups(sizes, m: int) -> int:
    return min(int(sizes.clamp(min=0).sum()), m)


def gmm_bounds(kind, m, k, n, e, rows, dtype, src_rows=0):
    """Least time of one grouped product, from the work its launch fact
    carries at these group sizes (``grouped_matmul.gmm_work``: its inputs
    read once and its output written once, 2*K*N flops per row that lies
    in a group)."""
    return bound_ms(*gm.gmm_work(kind, m, k, n, e, dtype, rows, src_rows), dtype)


def _library_grouped(kind, lhs, other, sizes, transpose=False):
    """The library yardstick of a grouped product (``other`` is the rhs, or
    dy for tgmm), timed and never used by the port: ``torch._grouped_mm``
    with int32 cumulative offsets where this torch has it, takes the
    operands and agrees with the plain version, else a loop of
    ``torch.matmul`` over the groups (host bounds taken before timing).
    Returns ``(name, fn)``."""
    bounds = gm.group_bounds(sizes, lhs.shape[0])
    if kind == "tgmm":
        want = gm.tgmm_reference(lhs, other, sizes)
        loop = lambda: [lhs[s:e].t() @ other[s:e] for s, e in bounds]  # noqa: E731
        grouped = lambda offs: torch._grouped_mm(lhs.t(), other, offs=offs)  # noqa: E731
    else:
        rhs = other.transpose(-2, -1) if transpose else other
        want = gm.gmm_reference(lhs, other, sizes, transpose)
        loop = lambda: [lhs[s:e] @ rhs[g] for g, (s, e) in enumerate(bounds)]  # noqa: E731
        grouped = lambda offs: torch._grouped_mm(lhs, rhs, offs=offs)  # noqa: E731
    if hasattr(torch, "_grouped_mm") and lhs.dtype == torch.bfloat16:
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        try:
            got = grouped(offs)
        except (RuntimeError, TypeError, ValueError) as exc:
            emit("moe_library_note", kind=kind, error=str(exc)[:200])
        else:
            if kind != "tgmm":  # rows past the groups are not the function's
                rows = _rows_in_groups(sizes, lhs.shape[0])
                got, want = got[:rows], want[:rows]
            tol = TOL[torch.bfloat16] * (1.0 + want.float().abs().max().item())
            if got.shape == want.shape and (got.float() - want.float()).abs().max().item() <= tol:
                return "torch._grouped_mm", lambda: grouped(offs)
            emit("moe_library_note", kind=kind, error="torch._grouped_mm disagrees")
    return "torch.matmul loop over groups", loop


def _moe_case(what, dtype, kernel, plain):
    """Kernel vs plain on the same CUDA tensors, every element within
    TOL * (1 + |want|); two launches must give the same bits. Returns (max
    abs error, the tightest element's slack: its bound less its error)."""
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{what}: two launches differ")
    got, want = got.float(), want.float()
    slack = (TOL[dtype] * (1.0 + want.abs()) - (got - want).abs()).min().item()
    return _flash_err(got, want, dtype, what), slack


def check_moe_kernels(timer, gen):
    """gather_gmm, gmm (both modes) and tgmm against their plain versions
    on the same CUDA tensors, f32 and bf16, at the main path's shapes — the
    fused in-projection (18432, 768) -> 3072 over the padded layout of a
    seeded router's 8192 tokens, the out-projection (18432, 3072) -> 768,
    the unpadded ``impl="gmm"`` layout with the raw counts, the backward's
    transposed gmm and both tgmm — and ragged ones: an empty group, groups
    straddling the kernels' 128-row tiles, NK = 16 at tile_m = 16 (the
    decode size), and row 11 at K = N = 200 with rows past the groups and
    row ids outside the source. At the main shapes in bf16 each kernel, its plain version
    and the library yardstick are timed with the L2 flushed."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        x, ex, counts, sorted_token, (row_ids, gsz, _, m_pad) = _moe_routing(gen, 8192,
                                                                             dtype=dtype)
        w_in, w_out = ex["w_in"].to(dtype), ex["w_out"].to(dtype)
        h = (torch.randn(m_pad, 3072, generator=gen) * 0.5).to(dtype).cuda()
        dy_h = (torch.randn(m_pad, 3072, generator=gen) * 0.5).to(dtype).cuda()
        dy_o = (torch.randn(m_pad, 768, generator=gen) * 0.5).to(dtype).cuda()
        xs = x[sorted_token]
        xg = x[row_ids.long()]
        hs = h[:xs.shape[0]].contiguous()
        cases = [
            ("gather_gmm", "in-proj fused", (m_pad, 768, 3072, 8192, gsz),
             lambda: gg.gather_gmm_fwd(x, w_in, row_ids, gsz, 512),
             lambda: gg.gather_gmm_reference(x, w_in, row_ids, gsz, 512)),
            ("gmm", "out-proj fused", (m_pad, 3072, 768, 0, gsz),
             lambda: gm.gmm(h, w_out, gsz), lambda: gm.gmm_reference(h, w_out, gsz)),
            ("gmm", "in-proj gmm (raw counts)", (xs.shape[0], 768, 3072, 0, counts),
             lambda: gm.gmm(xs, w_in, counts), lambda: gm.gmm_reference(xs, w_in, counts)),
            ("gmm", "out-proj gmm (raw counts)", (hs.shape[0], 3072, 768, 0, counts),
             lambda: gm.gmm(hs, w_out, counts), lambda: gm.gmm_reference(hs, w_out, counts)),
            ("gmm", "in-proj dlhs (transpose_rhs)", (m_pad, 3072, 768, 0, gsz),
             lambda: gm.gmm(dy_h, w_in, gsz, transpose_rhs=True),
             lambda: gm.gmm_reference(dy_h, w_in, gsz, transpose_rhs=True)),
            ("tgmm", "in-proj drhs", (m_pad, 768, 3072, 0, gsz),
             lambda: gm.tgmm(xg, dy_h, gsz), lambda: gm.tgmm_reference(xg, dy_h, gsz)),
            ("tgmm", "out-proj drhs", (m_pad, 3072, 768, 0, gsz),
             lambda: gm.tgmm(h, dy_o, gsz), lambda: gm.tgmm_reference(h, dy_o, gsz)),
        ]
        # Ragged: one empty group and groups straddling the 128-row tiles;
        # then the decode size, 8 tokens x top-2 at tile_m = 16.
        rag = torch.tensor([0, 301, 0, 699], dtype=torch.int32, device="cuda")
        lhs_r = (torch.randn(1000, 768, generator=gen) * 0.5).to(dtype).cuda()
        dy_r = (torch.randn(1000, 3072, generator=gen) * 0.5).to(dtype).cuda()
        xd, exd, _, _, (ids_d, gsz_d, _, m_d) = _moe_routing(gen, 8, tile_m=16, dtype=dtype)
        wd = exd["w_in"].to(dtype)
        hd = (torch.randn(m_d, 3072, generator=gen) * 0.5).to(dtype).cuda()
        cases += [
            ("gmm", "ragged (0, 301, 0, 699)", (1000, 768, 3072, 0, rag),
             lambda: gm.gmm(lhs_r, w_in, rag), lambda: gm.gmm_reference(lhs_r, w_in, rag)),
            ("gmm", "ragged transpose_rhs", (1000, 3072, 768, 0, rag),
             lambda: gm.gmm(dy_r, w_in, rag, transpose_rhs=True),
             lambda: gm.gmm_reference(dy_r, w_in, rag, transpose_rhs=True)),
            ("tgmm", "ragged, empty groups zero", (1000, 768, 3072, 0, rag),
             lambda: gm.tgmm(lhs_r, dy_r, rag), lambda: gm.tgmm_reference(lhs_r, dy_r, rag)),
            ("gather_gmm", "decode NK=16 tile_m=16", (m_d, 768, 3072, 8, gsz_d),
             lambda: gg.gather_gmm_fwd(xd, wd, ids_d, gsz_d, 16),
             lambda: gg.gather_gmm_reference(xd, wd, ids_d, gsz_d, 16)),
            ("gmm", "decode out-proj", (m_d, 3072, 768, 0, gsz_d),
             lambda: gm.gmm(hd, exd["w_out"].to(dtype), gsz_d),
             lambda: gm.gmm_reference(hd, exd["w_out"].to(dtype), gsz_d)),
        ]
        # Row 11 off its tiles: K = N = 200, two empty groups, sizes that
        # stop at row 231 of 300 (the rest come out as zeros) and row ids
        # outside the 70 source rows (zero rows), against the grouped
        # product of the explicit gather.
        ids_e = torch.randint(0, 70, (300,), generator=gen, dtype=torch.int32)
        ids_e[::17], ids_e[5::23] = -1, 70
        ids_e = ids_e.cuda()
        sizes_e = torch.tensor([0, 131, 0, 100], dtype=torch.int32, device="cuda")
        x_e = (torch.randn(70, 200, generator=gen) * 0.5).to(dtype).cuda()
        w_e = (torch.randn(4, 200, 200, generator=gen) * 200 ** -0.5).to(dtype).cuda()
        valid_e = ((ids_e >= 0) & (ids_e < 70))[:, None]
        xg_e = torch.where(valid_e, x_e[ids_e.long().clamp(0, 69)], torch.zeros_like(x_e[:1]))
        cases.append(("gather_gmm", "K=N=200, empty groups, rows past the groups, bad ids",
                      (300, 200, 200, 70, sizes_e),
                      lambda: gg.gather_gmm_fwd(x_e, w_e, ids_e, sizes_e, 8),
                      lambda: gm.gmm_reference(xg_e, w_e, sizes_e)))
        errs = []
        for kind, label, shape, kernel, plain in cases:
            what = f"{kind} {label} {name}"
            err, slack = _moe_case(what, dtype, kernel, plain)
            errs.append({"kernel": kind, "case": label, "m_k_n": list(shape[:3]),
                         "max_abs_err": err, "min_slack": slack})
            rows.setdefault(kind, {"max_abs_err": 0.0})
            rows[kind]["max_abs_err"] = max(rows[kind]["max_abs_err"], err)
        require(not gm.tgmm(lhs_r, dy_r, rag)[0].any(), "tgmm: an empty group is not zeros")
        require(not gg.gather_gmm_fwd(x_e, w_e, ids_e, sizes_e, 8)[231:].any(),
                "gather_gmm: rows past the groups are not zeros")
        emit("parity_moe_kernels", dtype=name, tol=TOL[dtype], cases=errs,
             counts=counts.tolist(), padded_group_sizes=gsz.tolist(), m_pad=m_pad)
        if dtype != torch.bfloat16:
            continue
        # The f32 accumulators at the main path's longest contractions: gmm
        # over K = 3072 (the out-projection), tgmm over each expert's routed
        # rows of the 18,432 (the in-projection's weight gradient).
        prec = {"gmm": accuracy.grouped_errors("gmm", h, w_out, gsz, gm.gmm(h, w_out, gsz),
                                               gm.WG_SLICE),
                "tgmm": accuracy.grouped_errors("tgmm", xg, dy_h, gsz, gm.tgmm(xg, dy_h, gsz),
                                                gm.WG_SLICE)}
        emit("parity_prec", kernel="grouped", m_pad=m_pad, tile=gm.WG_SLICE, **prec)
        for kind, e in prec.items():
            require_f32_accumulation(kind, e)
        # Timed at the main path's shapes (forced fused): the in-projection,
        # the out-projection forward, and both weight gradients (drhs).
        # Half of gmm's launches per step are the backward's transpose_rhs
        # mode (the in-projection's dlhs), timed beside the forward.
        timed = {
            "gather_gmm": cases[0], "gmm": cases[1], "tgmm": cases[5],
            "gmm_transpose_rhs": cases[4], "tgmm_out_proj": cases[6],
        }
        library = {
            "gather_gmm": _library_grouped("gmm", xg, w_in, gsz),
            "gmm": _library_grouped("gmm", h, w_out, gsz),
            "tgmm": _library_grouped("tgmm", xg, dy_h, gsz),
            "gmm_transpose_rhs": _library_grouped("gmm", dy_h, w_in, gsz, transpose=True),
            "tgmm_out_proj": _library_grouped("tgmm", h, dy_o, gsz),
        }
        rows["gmm_transpose_rhs"] = {"max_abs_err": errs[4]["max_abs_err"]}
        rows["tgmm_out_proj"] = {"max_abs_err": errs[6]["max_abs_err"]}
        # gather_gmm's yardstick is the explicit gather, then the grouped
        # product (timed on xg, the same rows the gather gives).
        lib_name, product = library["gather_gmm"]
        library["gather_gmm"] = (lib_name + " after x[row_ids]",
                                 lambda: (x[row_ids.long()], product()))
        for key, (kind, label, (m, k, n, src, sizes), kernel, plain) in timed.items():
            bound = gmm_bounds(kind, m, k, n, 4, _rows_in_groups(sizes, m), dtype, src)
            rows[key].update(case=label, m=m, k=k, n=n, ms=timer.ms(kernel, iters=10),
                             plain_ms=timer.ms(plain, iters=5), library=library[key][0],
                             library_ms=timer.ms(library[key][1], iters=10),
                             bound_ms=bound[0], bound_by=bound[1])
        rows["gmm"]["transpose_rhs"] = rows.pop("gmm_transpose_rhs")
        emit("parity_moe_kernels_timed", dtype=name, **rows)
        del x, h, dy_h, dy_o, xs, xg, hs, lhs_r, dy_r, cases, timed, library
    return rows


# -- row 12: the seeded-bad demo of the schedule audit ------------------------

#: Row 12's whole-array timings: 2 * x over all of a (4096, 4096) f32 array
#: in the fixture's misaligned (7, 100) blocks and in aligned (8, 128) ones.
BAD_BLOCKS = ((7, 100), (8, 128))


def badpallas_phase(timer, gen, card):
    """Row 12 (``ops/badpallas.py``): the demo target reports exactly RKT504,
    once as a tile misfit and once over budget; its step on the card
    (the main path: launch counts zeroed just before) launches the (7, 100)
    kernel once and raises at the whole-array launch, which the card
    refuses; the kernel equals its plain version bitwise on the written
    blocks; after the refusal the next launch runs clean; and 2 * x over the
    whole array is timed in both block shapes, against ``x.mul(2)`` and the
    bytes bound."""
    report = run_sched_target(SCHED_TARGETS["badpallas"], torch.cuda.get_device_name(0))
    budget = [f for f in report.findings if "shared memory per CTA" in f.message]
    misfit = [f for f in report.findings if "misaligns" in f.message]
    require({f.rule for f in report.findings} == {"RKT504"} and len(budget) == 1
            and len(misfit) == 1 and len(report.findings) == 2,
            f"badpallas: the demo reported {[f.render() for f in report.findings]}")
    step, _ = SCHED_TARGETS["badpallas"].build()
    x = torch.randn(4096, 4096, generator=gen).cuda()
    zero_launches()
    try:
        step(x)
        refused = None
    except RuntimeError as err:
        refused = str(err)
    torch.cuda.synchronize()
    launches = bp.bad_scale.launches
    require(refused is not None and "cudaError" in refused,
            "badpallas: the whole-array launch (64 MiB of shared memory) was not refused")
    require(launches == 1, f"badpallas: the demo step launched {launches} times, want 1")
    block, grid = (7, 100), (4,)
    got, want = bp.bad_scale(x, block, grid), bp.bad_scale_plain(x, block, grid)
    rows, cols = bp.written_blocks(x.shape, block, grid)
    torch.cuda.synchronize()
    require(torch.equal(got[rows, cols], want[rows, cols]),
            "badpallas: (7, 100) blocks differ from the plain version")
    timings = {}
    for block in BAD_BLOCKS:
        grid = (-(-4096 // block[0]), -(-4096 // block[1]))
        y = bp.bad_scale(x, block, grid)
        torch.cuda.synchronize()
        require(torch.equal(y, x * 2.0), f"badpallas: {block} blocks over the whole array")
        timings[block] = (grid, timer.ms(lambda: bp.bad_scale(x, block, grid)))
    grid7 = timings[BAD_BLOCKS[0]][0]
    row = {
        "launches": launches, "max_abs_err": 0.0, "refused": refused,
        "findings": [f.message for f in report.findings],
        "ms": timings[BAD_BLOCKS[0]][1], "ms_8x128": timings[BAD_BLOCKS[1]][1],
        "grids": {f"{b[0]}x{b[1]}": list(g) for b, (g, _) in timings.items()},
        "plain_ms": timer.ms(lambda: bp.bad_scale_plain(x, BAD_BLOCKS[0], grid7)),
        "library_ms": timer.ms(lambda: x.mul(2)),
    }
    # The timed launch's fact: x read once and y written once over its whole
    # grid, f32; one multiply per element.
    row["bound_ms"], row["bound_by"] = fact_bound(bp.bad_scale_launch((4096, 4096),
                                                                      BAD_BLOCKS[0], grid7))
    emit("badpallas", **row, card=card)
    return row


class _RouteLog:
    """Records each MoE layer's routing (top-k ids and the gap between the
    k-th and the (k+1)-th gate) while installed over ``MoE.route``."""

    def __init__(self):
        self.calls = []
        self._route = MoE.route

    def __enter__(self):
        log, route = self, self._route

        def recording(moe, params, x):
            gates, top_gates, top_idx = route(moe, params, x)
            ranked = torch.sort(gates.detach(), dim=-1, descending=True).values
            gap = (ranked[..., moe.top_k - 1] - ranked[..., moe.top_k]).min()
            log.calls.append((top_idx.detach().cpu(), float(gap)))
            return gates, top_gates, top_idx

        MoE.route = recording
        return self

    def __exit__(self, *exc):
        MoE.route = self._route


def _moe_group(kernel: str) -> str:
    """The MoE train profile's device-time group of a kernel name."""
    low = kernel.lower()
    if "rkt_gg::" in kernel or "rkt_wg::" in kernel:  # the wgmma template; f32 tiles
        return "MoE kernels (gather_gmm, gmm, tgmm)"
    if "flash_" in kernel and "_kernel<" in kernel:
        return "flash kernels"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "cuBLAS GEMMs"
    if any(k in low for k in ("sort", "radix", "index", "gather", "scatter", "scan", "search",
                              "embedding", "segment", "grad_weight")):
        return "routing glue (sort, counts, layout, gathers and their backward, index_add)"
    if "multi_tensor_apply" in kernel:
        return "optimizer (multi-tensor apply)"
    return "other elementwise"


def _moe_param_counts(cfg) -> tuple:
    """(all params, expert params) of the MoE LM from its shapes."""
    d, h, e, v, t = cfg.dim, cfg.mlp_ratio * cfg.dim, cfg.num_experts, cfg.vocab_size, \
        cfg.max_seq_len
    experts = e * (2 * d * h + h + d)
    block = 4 * d + 3 * d * d + 3 * d + d * d + d + d * e + experts
    return v * d + t * d + cfg.num_layers * block + 2 * d, cfg.num_layers * experts


def _active_flops_per_token(cfg) -> tuple:
    """bench.py:331-336: 6 x active params (the expert params count k/E)
    + 12 * L * T * D attention; returns (flops per token, params, expert
    params)."""
    n_params, experts = _moe_param_counts(cfg)
    active = n_params - experts * (1 - cfg.expert_top_k / cfg.num_experts)
    return 6 * active + 12 * cfg.num_layers * cfg.max_seq_len * cfg.dim, n_params, experts


def moe_train_phase(card):
    """moe_gpt2_e4, dropless, forced fused, through the Launcher with the
    Profiler capsule in the tree: finite, falling loss, no drops, a finite
    aux loss, and per step (remat runs each layer's forward twice): 2
    gather_gmm (forward and recompute), 4 gmm (out-projection forward twice,
    the in- and out-projection's dlhs) and 2 tgmm per layer, with the flash
    kernels' 2 forward and 1 backward."""
    cfg = moe_config()
    b, t, layers, steps = MOE_BATCH, cfg.max_seq_len, cfg.num_layers, MOE_STEPS
    per_token, n_params, n_experts = _active_flops_per_token(cfg)
    profiler = rt.Profiler(flops_per_sample=per_token * t, warmup=MOE_WARM_STEPS)
    with moe_gmm("fused"):
        clock, counts = run_train(cfg, b, steps, profile_last=MOE_PROFILE_STEPS,
                                  capsules=[profiler])
    losses = clock.losses
    live = clock.prepared.state["params"]
    require(clock.prepared.model.num_params(live) == n_params,
            f"moe_train: {clock.prepared.model.num_params(live)} params, counted {n_params}")
    del live
    want = {"flash_fwd": 2 * layers * steps, "flash_bwd": layers * steps, "flash_dq": 0,
            "gather_gmm": 2 * layers * steps, "gmm": 4 * layers * steps,
            "tgmm": 2 * layers * steps}
    require(counts == want, f"moe_train launches {counts}, want {want}")
    require(float(np.mean(losses[-3:])) < float(np.mean(losses[:3])),
            f"moe_train loss did not fall: {losses}")
    require(all(d == 0.0 for d in clock.moe_dropped), f"dropless dropped: {clock.moe_dropped}")
    require(len(clock.moe_aux) == steps and all(math.isfinite(a) for a in clock.moe_aux),
            f"moe_aux_loss {clock.moe_aux}")
    step_s = np.diff(clock.stamps)[MOE_WARM_STEPS + 1:steps - MOE_PROFILE_STEPS + 1]
    median = float(np.median(step_s))
    tokens_per_s = b * t / median
    emit("moe_train", model="moe_gpt2_e4 (dropless, ROCKET_TPU_MOE_GMM=fused)",
         dtype="bfloat16", batch=b, seq_len=t, steps=steps, params=n_params,
         expert_params=n_experts, losses=losses, moe_aux_loss=clock.moe_aux,
         moe_frac_dropped=clock.moe_dropped, step_ms_median=median * 1e3,
         step_ms=[x * 1e3 for x in step_s], first_step_s=float(np.diff(clock.stamps)[0]),
         tokens_per_s=tokens_per_s, active_flops_per_token=per_token,
         mfu_active=tokens_per_s * per_token / PEAK_FLOPS[torch.bfloat16],
         profiler_capsule=clock.perf[-1] if clock.perf else None,
         launches=counts, launches_per_step={k: v / steps for k, v in counts.items()},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    by_name = _device_s_by_name(_device_events(clock.prof))
    busy = sum(by_name.values())
    groups: dict = {}
    for name, sec in by_name.items():
        groups[_moe_group(name)] = groups.get(_moe_group(name), 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit("moe_train_profile", steps=MOE_PROFILE_STEPS, wall_s=clock.prof_wall,
         device_busy_s=busy, device_idle_share=(1.0 - busy / clock.prof_wall) if busy else None,
         device_time_measured=busy > 0, device_s_by_group=groups,
         top_kernels=[{"name": n[:120], "s": sec, "share_of_device": sec / busy}
                      for n, sec in top], card=card)
    return counts


def moe_train_gmm_phase(card):
    """Three steps unforced (``impl="gmm"``, the shipped table's): no
    gather_gmm; per layer and step 6 gmm (both projections' forward twice,
    their dlhs) and 2 tgmm."""
    cfg = moe_config()
    layers, steps = cfg.num_layers, 3
    with moe_gmm(None):
        clock, counts = run_train(cfg, MOE_BATCH, steps)
    want = {"gather_gmm": 0, "gmm": 6 * layers * steps, "tgmm": 2 * layers * steps}
    require({k: counts[k] for k in want} == want, f"moe_train_gmm launches {counts}")
    step_s = np.diff(clock.stamps)[1:]
    emit("moe_train_gmm", steps=steps, losses=clock.losses, step_ms=[x * 1e3 for x in step_s],
         tokens_per_s=MOE_BATCH * cfg.max_seq_len / float(np.median(step_s)), launches=counts,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)


def _serve_run(engine, prompts, new_tokens):
    rids = [engine.submit(p, max_new_tokens=new_tokens, temperature=0.0) for p in prompts]
    engine.drain()
    return [engine.result(r).tokens for r in rids]


def moe_serve_phase(card):
    """The MoE LM (random weights, dropless, forced fused) served: 8 slots,
    16 greedy requests with prompts of 32-512 tokens and 32 new tokens, then
    ``generate()`` (batch 4, prompt 128, 32 tokens), each with the kernel
    counts zeroed before and read after. Dropless routes each token alone,
    so the engine and ``generate()`` must give the same greedy tokens: held
    in f32 at full width (MOE_LAYERS layers), where the paged and dense decode
    paths agree to f32 rounding; in bf16 their roundings differ, so the
    bf16 agreement is reported."""
    cfg = moe_config()
    model = TransformerLM(cfg)
    params = _drawn_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=16)]
    gen_prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 128))
    with moe_gmm("fused"):
        engine = ServeEngine(model, params, ServeConfig(max_slots=8, block_len=16,
                                                        prefill_chunk=64),
                             generator=torch.Generator().manual_seed(0))
        _serve_run(engine, [np.arange(40, dtype=np.int32)] * 2, 4)  # warmup
        engine.reset_metrics()
        waves0 = engine.engine.decode_waves
        zero_launches()
        t0 = time.perf_counter()
        tokens = _serve_run(engine, prompts, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        serve_counts = {**moe_launches(), "paged_decode": pa.paged_decode.launches}
        waves = engine.engine.decode_waves - waves0
        rep = engine.report()
        require(rep["requests"]["completed"] == 16 and all(
            len(tk) == 32 and all(0 <= v < cfg.vocab_size for v in tk) for tk in tokens),
            f"moe serve: {rep['requests']}")
        require(serve_counts["paged_decode"] == cfg.num_layers * waves,
                f"moe serve: paged_decode {serve_counts} over {waves} waves")
        require(serve_counts["gather_gmm"] > 0 and serve_counts["gmm"] > 0,
                f"moe serve: the MoE kernels did not run: {serve_counts}")
        generate(model, params, gen_prompt, 2, temperature=0)  # warmup
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = generate(model, params, gen_prompt, 32, temperature=0)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        gen_counts = {**moe_launches(), "decode_attention": da.decode_attention.launches}
        require(tuple(out.shape) == (4, 160), f"moe generate shape {tuple(out.shape)}")
        bf16_serve = _serve_run(engine, list(gen_prompt.astype(np.int32)), 32)
        bf16_agree = [int(np.mean(np.asarray(s) == out[i, 128:].cpu().numpy()) * 32)
                      for i, s in enumerate(bf16_serve)]
        profile_serve(engine, cfg.vocab_size, card, phase="moe_serve_profile")
        del engine
        # f32, full width: the two decode paths must give the same tokens.
        cfg32 = moe_config(activation_dtype=None)
        model32 = TransformerLM(cfg32)
        engine32 = ServeEngine(model32, params, ServeConfig(max_slots=4, block_len=16,
                                                            prefill_chunk=64))
        served = _serve_run(engine32, list(gen_prompt.astype(np.int32)), 32)
        ref = generate(model32, params, gen_prompt, 32, temperature=0)[:, 128:].cpu().tolist()
        require(served == ref, "moe serve vs generate greedy tokens differ (f32)")
        del engine32
    ttft, itl = rep["time_to_first_token_s"], rep["inter_token_latency_s"]
    emit("moe_serve", model="moe_gpt2_e4 (dropless, fused)", dtype="bfloat16", requests=16,
         new_tokens=32, prompt_lens=[len(p) for p in prompts], decode_waves=waves,
         prefill_chunks=rep["compiled"]["prefill_chunks"], serve_launches=serve_counts,
         tokens_per_s=rep["tokens_per_sec"], wall_s=wall, ttft_p50_s=ttft["p50"],
         ttft_p99_s=ttft["p99"], itl_p50_s=itl["p50"], itl_p99_s=itl["p99"],
         generate_launches=gen_counts, generate_wall_s=gen_wall,
         generate_tokens_per_s=4 * 32 / gen_wall, serve_equals_generate_f32=True,
         bf16_tokens_agreeing_of_32=bf16_agree, card=card)
    del params


def moe_model_check():
    """One train forward + backward of a 2-layer full-width MoE LM (dim 768,
    E=4, top-2, dropless, forced fused; f32, TF32 off; B=2, T=256, logits
    materialised) on the card against the same params on the CPU (the
    kernels' plain versions): identical routing in both layers (compared
    first, with the smallest gap between the k-th and (k+1)-th gate, so a
    flip cannot hide behind the value tolerance), the loss and aux loss,
    the logits and every gradient."""
    cfg = moe_config(activation_dtype=None, num_layers=2, loss_chunk=0)
    model = TransformerLM(cfg)
    init = model.init(torch.Generator().manual_seed(5), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 256)))
    result = {}
    with moe_gmm("fused"):
        for dev in ("cpu", "cuda"):
            params = map_params(lambda x: x.to(dev).requires_grad_(), init)
            zero_launches()
            with _RouteLog() as log:
                out = model.apply(params, {"tokens": tokens.to(dev)}, mode="train")
            loss = next_token_loss()(out)
            grads = torch.autograd.grad(loss, optim.param_leaves(params))
            result[dev] = {"loss": loss.item(), "aux": out["moe_aux_loss"].item(),
                           "logits": out["logits"].detach().cpu(),
                           "grads": [g.cpu() for g in grads], "routes": log.calls,
                           "launches": moe_launches()}
    cpu, card = result["cpu"], result["cuda"]
    gaps = [gap for _, gap in card["routes"]]
    require(len(card["routes"]) == len(cpu["routes"]) == cfg.num_layers,
            f"moe_model_check: {len(card['routes'])} routings")
    for layer, ((got, gap), (want, _)) in enumerate(zip(card["routes"], cpu["routes"])):
        flips = int((got != want).sum())
        require(flips == 0, f"moe_model_check: layer {layer} routes {flips} choices elsewhere "
                f"on the card (smallest k-th gate gap {gap})")
    require(card["launches"] == {"gather_gmm": 2, "gmm": 6, "tgmm": 4},
            f"moe_model_check: the card pass launched {card['launches']}")
    require(cpu["launches"] == {"gather_gmm": 0, "gmm": 0, "tgmm": 0}, "cpu pass launched")
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()  # noqa: E731
    logits_err = rel(card["logits"], cpu["logits"])
    grad_err = max(rel(g, w) for g, w in zip(card["grads"], cpu["grads"]))
    require(loss_err <= MOE_CHECK_TOL["loss"], f"moe_model_check loss: relative {loss_err}")
    require(logits_err <= MOE_CHECK_TOL["values"], f"moe_model_check logits: {logits_err}")
    require(grad_err <= MOE_CHECK_TOL["values"], f"moe_model_check grads: relative {grad_err}")
    emit("moe_model_check", layers=2, dim=768, experts=4, top_k=2, dtype="float32", batch=2,
         seq_len=256, routing_identical=True, min_gate_gap=min(gaps), loss=card["loss"],
         loss_rel_err=loss_err, aux_loss=card["aux"], aux_loss_cpu=cpu["aux"],
         logits_rel_err=logits_err, grad_rel_err=grad_err, tol=MOE_CHECK_TOL,
         n_grads=len(card["grads"]), card_launches=card["launches"])


def moe_lm_phase(card):
    """``examples.moe_lm.main(num_epochs=1)`` in a temporary directory: the
    MoE char-LM (dim 128, 4 heads of 32, 4 layers, einsum dispatch, f32) on
    the synthetic corpus, B=64, T=128. Each step launches the D=32 flash
    forward and backward once per layer (no remat) and no grouped kernel."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, moe_gmm(None):
        os.chdir(tmp)
        try:
            zero_launches()
            t0 = time.perf_counter()
            run = moe_lm.main(num_epochs=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    losses = [float(v) for v in run["trained"]["losses"]]
    steps, layers = len(losses), run["model"].config.num_layers
    counts = {**moe_launches(), "flash_fwd": fa.flash_fwd.launches,
              "flash_bwd": fa.flash_bwd.launches}
    require(steps > 10 and all(math.isfinite(x) for x in losses), f"moe_lm losses {losses[:5]}")
    require(float(np.mean(losses[-10:])) < float(np.mean(losses[:10])),
            f"moe_lm loss did not fall: first {losses[:10]}, last {losses[-10:]}")
    require(counts == {"gather_gmm": 0, "gmm": 0, "tgmm": 0, "flash_fwd": layers * steps,
                       "flash_bwd": layers * steps}, f"moe_lm launches {counts}")
    emit("moe_lm", steps=steps, head_dim=32, dispatch="einsum", wall_s=wall,
         loss_first10=float(np.mean(losses[:10])), loss_last10=float(np.mean(losses[-10:])),
         launches=counts, profiler_steps_per_sec=run["profiler"]._ema and 1.0 / run["profiler"]._ema,
         card=card)


def moe_phases(card):
    """The MoE slice's main paths, each with the launch counts zeroed
    before and read after; ``ROCKET_TPU_MOE_GMM`` is restored after each."""
    counts = moe_train_phase(card)
    torch.cuda.empty_cache()
    moe_train_gmm_phase(card)
    torch.cuda.empty_cache()
    moe_serve_phase(card)
    torch.cuda.empty_cache()
    moe_lm_phase(card)
    torch.cuda.empty_cache()
    return counts


def train_model_check():
    """One training forward + backward at GPT-2 width, 2 layers, f32,
    dropout 0, B=4, T=256 (the fused chunked loss): loss and every gradient
    on the card (flash kernels) against the same params on the CPU (plain
    attention)."""
    cfg = TransformerConfig.gpt2_124m()
    cfg.num_layers, cfg.activation_dtype, cfg.dropout = 2, None, 0.0
    model = TransformerLM(cfg)
    init = model.init(torch.Generator().manual_seed(4), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 256)))
    result = {}
    for dev in ("cpu", "cuda"):
        params = map_params(lambda x: x.to(dev).requires_grad_(), init)
        zero_launches()
        out = model.apply(params, {"tokens": tokens.to(dev)}, mode="train")
        loss = next_token_loss()(out)
        leaves = optim.param_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        result[dev] = (loss.item(), [g.cpu() for g in grads])
    require(fa.flash_fwd.launches == 2 and fa.flash_bwd.launches == 2,
            "train_model_check: the card pass did not run the flash kernels")
    loss_err = abs(result["cuda"][0] - result["cpu"][0])
    grad_err = max(((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                   for g, w in zip(result["cuda"][1], result["cpu"][1]))
    require(loss_err <= TRAIN_TOL["loss"], f"train loss card vs cpu: {loss_err}")
    require(grad_err <= TRAIN_TOL["grad"], f"train grads card vs cpu: relative {grad_err}")
    emit("train_model_check", layers=2, dim=768, dtype="float32", batch=4, seq_len=256,
         loss=result["cuda"][0], loss_err=loss_err, grad_rel_err=grad_err, tol=TRAIN_TOL,
         n_grads=len(result["cuda"][1]))


# -- the ops plane's training half (telemetry, health gate, strict guard) ------

#: Rows 9-10's coverage shapes (N, C, dtype): f16 in the vec form, C = 3
#: and bf16 C = 12 in the any form, C = 4096 as two channel chunks.
BN_COVERAGE = [(262144, 64, torch.float16), (262144, 3, torch.float32),
               (262144, 12, torch.bfloat16), (16384, 4096, torch.float32)]
#: ops_train: GPT-2 124M steps, the step (0-based) whose loss is made NaN
#: (past the schedule's one-step warmup) and the profiled last steps.
OPS_STEPS, OPS_NAN_STEP, OPS_PROFILE = 16, 5, 3


def check_fused_conv_coverage(timer, gen, card):
    """Rows 9 and 10 against their plain versions at :data:`BN_COVERAGE`
    (act on), both tolerances of ``BN_TOL`` (f16 as bf16: one 16-bit
    rounding), two launches of row 9 bitwise, each chunk's launch counted;
    kernel, plain and ``F.batch_norm`` [+ relu] timed."""
    for n, c, dtype in BN_COVERAGE:
        x = (torch.randn(n, c, generator=gen) * 2 + 0.5).to(dtype).cuda()
        sc = torch.stack([1 + 0.1 * torch.randn(c, generator=gen),
                          0.1 * torch.randn(c, generator=gen)]).cuda()
        name = str(dtype).removeprefix("torch.")
        tol = BN_TOL[torch.float32 if dtype == torch.float32 else torch.bfloat16]
        zero_launches()
        y, stats = fc.bn_twopass(x, sc, eps=1e-5, act=True)
        y2, stats2 = fc.bn_twopass(x, sc, eps=1e-5, act=True)
        want_y, want_stats = fc.bn_twopass_plain(x, sc, eps=1e-5, act=True)
        mi = fc.epilogue_rows(want_stats, sc[0], sc[1], 1e-5).contiguous()
        yn = fc.bn_normalize(x, mi, act=True)
        want_yn = fc.bn_normalize_plain(x, mi, act=True)
        torch.cuda.synchronize()
        launches = {"bn_twopass": fc.bn_twopass.launches, "bn_normalize": fc.bn_normalize.launches}
        chunks = len(fc.chunks(c))
        require(launches == {"bn_twopass": 2 * chunks, "bn_normalize": chunks},
                f"fused_conv coverage N={n} C={c} {name}: launches {launches}")
        require(torch.equal(y, y2) and torch.equal(stats, stats2),
                f"fused_conv coverage N={n} C={c} {name}: two launches differ")
        excess = {}
        for key, got, want, bound in (("y", y, want_y, tol), ("stats", stats, want_stats,
                                                                BN_TOL[torch.float32]),
                                      ("normalize", yn, want_yn, tol)):
            diff = (got.float() - want.float()).abs()
            excess[key] = ((diff - bound[0] - bound[1] * want.float().abs()).max().item(),
                           diff.max().item())
        require(all(e <= 0 and math.isfinite(e) for e, _ in excess.values()),
                f"fused_conv coverage N={n} C={c} {name}: past the bound {excess}")
        w, b = sc[0], sc[1]
        mean = want_stats[:, 0].contiguous()
        var = torch.clamp(want_stats[:, 1] - mean.square(), min=0.0)
        bounds = bn_bounds(n, c, dtype)
        row = {"n": n, "c": c, "dtype": name, "tol": tol, "chunks": chunks,
               "form": "vec" if fc.vec_form(min(c, fc.MAX_C), c, 0, dtype) else "any",
               "launches": launches, "card": card}
        for key, kernel, plain, library, bound, err in (
            ("twopass", lambda: fc.bn_twopass(x, sc, eps=1e-5, act=True),
             lambda: fc.bn_twopass_plain(x, sc, eps=1e-5, act=True),
             lambda: F.relu(F.batch_norm(x, None, None, w.to(dtype), b.to(dtype),
                                         training=True, eps=1e-5)), bounds[0],
             max(excess["y"][1], excess["stats"][1])),
            ("normalize", lambda: fc.bn_normalize(x, mi, act=True),
             lambda: fc.bn_normalize_plain(x, mi, act=True),
             lambda: F.relu(F.batch_norm(x, mean.to(dtype), var.to(dtype), w.to(dtype),
                                         b.to(dtype), training=False, eps=1e-5)), bounds[1],
             excess["normalize"][1]),
        ):
            row[key] = {"max_abs_err": err, "ms": timer.ms(kernel), "plain_ms": timer.ms(plain),
                        "library_ms": timer.ms(library), "bound_ms": bound[0],
                        "bound_by": bound[1]}
        emit("parity_fused_conv_coverage", **row)
        del x, y, y2, want_y, yn, want_yn


def _poisoned(objective, nan_at: int, device):
    """``objective`` plus NaN on its ``nan_at``-th call (0-based), from a
    call counter kept on the card: no host read, no branch on a device
    value. The NaN is a constant of the loss, so the gradients stay finite
    and the loss flag alone fires."""
    calls = torch.full((), -1, dtype=torch.int64, device=device)

    def poisoned(batch):
        calls.add_(1)
        return objective(batch) + torch.where(calls == nan_at, float("nan"), 0.0)

    return poisoned


def _train_snapshot(module):
    """Device clones of the train state a held step must keep: params, both
    AdamW moments, the optimizer's count and the EMA, if any."""
    state = module.prepared.state
    opt = state["optimizer"]
    leaves = optim.param_leaves(state["params"])
    snap = {"params": [p.detach().clone() for p in leaves],
            "exp_avg": [opt.state[p]["exp_avg"].clone() for p in leaves],
            "exp_avg_sq": [opt.state[p]["exp_avg_sq"].clone() for p in leaves],
            "count": torch.stack([opt.state[p]["step"] for p in leaves]).clone()}
    if "ema_params" in state:
        snap["ema"] = [e.clone() for e in optim.param_leaves(state["ema_params"])]
    return snap


class OpsClock(Capsule):
    """The ops_train instrument, after the Module (priority 5): a CUDA event
    at each step's end (no sync), device snapshots of the train state
    around :data:`OPS_NAN_STEP`, the applied lr and the optimizer's count of
    every step, and a ``torch.profiler`` window over the last
    :data:`OPS_PROFILE` steps, started and stopped through the
    explicit-transfer helper (the profiler synchronises)."""

    def __init__(self, module, repeats):
        super().__init__(priority=5)
        self.module, self.repeats = module, repeats
        self.events, self.lrs, self.counts, self.snaps = [], [], [], {}
        self.prof = None

    def launch(self, attrs=None):
        from torch.profiler import ProfilerActivity, profile

        from rocket_tpu_torch.runtime import explicit_transfer

        step = len(self.events)
        state = self.module.prepared.state
        first = optim.param_leaves(state["params"])[0]
        self.lrs.append(self.module.last_lr.clone())
        self.counts.append(state["optimizer"].state[first]["step"].clone())
        if step in (OPS_NAN_STEP - 1, OPS_NAN_STEP):
            self.snaps[step] = _train_snapshot(self.module)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        if step + 1 == self.repeats - OPS_PROFILE:
            with explicit_transfer():
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.start()
        elif self.prof is not None and step + 1 == self.repeats:
            with explicit_transfer():
                torch.cuda.synchronize()
                self.prof.stop()


def ops_train_phase(card, train_median_ms):
    """GPT-2 124M through ``examples.gpt2.build`` (B=8, T=1024, bf16, remat,
    AdamW under warmup-cosine, dropout 0.1) on ``Runtime(strict=True,
    telemetry=True, health=True, anomaly_action="skip_step",
    watchdog_secs=60)``, a NaN loss at :data:`OPS_NAN_STEP`. Holds: no sync
    error under the guard (the run completes), the held step leaves params,
    both moments and the optimizer's count bitwise as they were, the next
    step's lr is the schedule at the applied count, one anomaly and one skip
    with the loss flag, the telemetry files load through the port's readers
    with goodput's phases summing to the wall clock within 1%, and rows 3-4
    launch as often a step as in ``train``."""
    cfg = TransformerConfig.gpt2_124m()
    layers, b = cfg.num_layers, 8
    root = Path(tempfile.mkdtemp(prefix="ops_train_"))
    try:
        wall0 = time.perf_counter()
        runtime = rt.Runtime(seed=0, strict=True, telemetry=True, health=True,
                             anomaly_action="skip_step", watchdog_secs=60,
                             project_dir=str(root), telemetry_dir=str(root / "tel"))
        run = gpt2.build(cfg, _gpt2_corpus(cfg.max_seq_len, cfg.vocab_size), batch_size=b,
                         runtime=runtime, steps=OPS_STEPS, record=False)
        runtime.models.add(run["model"], PreparedModule(run["model"],
                                                        {"params": _drawn_params(cfg)}))
        module = run["module"]
        loss = module.find(rt.Loss)[0]
        loss._objective = _poisoned(loss.objective, OPS_NAN_STEP, runtime.device)
        clock = OpsClock(module, OPS_STEPS)
        looper = run["launcher"].find(rt.Looper)[0]
        looper._capsules = sorted([*looper._capsules, clock], key=lambda c: -c.priority)
        clock.bind(runtime)
        zero_launches()
        run["launcher"].launch()
        wall = time.perf_counter() - wall0
        require(not runtime.strict.enabled, "ops_train: end_training left the guard on")
        counts = {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches}
        require(counts == {"flash_fwd": 2 * layers * OPS_STEPS, "flash_bwd": layers * OPS_STEPS},
                f"ops_train launches {counts} over {OPS_STEPS} steps")
        torch.cuda.synchronize()
        before, after = clock.snaps[OPS_NAN_STEP - 1], clock.snaps[OPS_NAN_STEP]
        held = {key: all(torch.equal(a, c) for a, c in zip(before[key], after[key]))
                if isinstance(before[key], list) else torch.equal(before[key], after[key])
                for key in before}
        require(all(held.values()), f"ops_train: the held step changed {held}")
        counts_by_step = [int(c) for c in clock.counts]
        want_counts = [i + 1 if i < OPS_NAN_STEP else i for i in range(OPS_STEPS)]
        require(counts_by_step == want_counts, f"ops_train: optimizer counts {counts_by_step}")
        schedule = optim.warmup_cosine_lr(6e-4, warmup_steps=max(1, OPS_STEPS // 50),
                                          decay_steps=OPS_STEPS)
        nxt = OPS_NAN_STEP + 1
        lr_next = float(clock.lrs[nxt])
        lr_want = float(schedule(torch.tensor(float(OPS_NAN_STEP), device="cuda")))
        require(lr_next == lr_want and abs(lr_next - schedule(OPS_NAN_STEP)) <= 1e-7 * lr_want,
                f"ops_train: step {nxt} lr {lr_next}, schedule at the applied count {lr_want}")
        summary = runtime.health.summary()
        flags = [r["flag_names"] for r in runtime.health.anomaly_records]
        require(summary["anomalies"] == 1 and summary["skipped_steps"] == 1
                and flags == [["loss_nonfinite"]],
                f"ops_train: health {summary}, flags {flags}")
        with open(root / "tel" / "telemetry.json") as f:
            doc = json.load(f)
        events = load_chrome_trace(str(root / "tel" / "spans.trace.json"))
        good = doc["goodput"]
        phase_sum = sum(good["categories"].values())
        require(abs(phase_sum - good["total_wall_s"]) <= 0.01 * good["total_wall_s"]
                and abs(good["total_wall_s"] - wall) <= 0.01 * wall,
                f"ops_train: goodput phases {phase_sum} s, total {good['total_wall_s']} s, "
                f"wall {wall} s")
        step_ms = [a.elapsed_time(c) for a, c in zip(clock.events, clock.events[1:])]
        timed = [ms for i, ms in enumerate(step_ms, start=1)
                 if i >= WARM_STEPS and i not in (OPS_NAN_STEP - 1, OPS_NAN_STEP)
                 and i < OPS_STEPS - OPS_PROFILE]
        window = sum(step_ms[-OPS_PROFILE:]) / 1e3
        busy, idle, top, groups = _device_profile(clock.prof, window)
        emit("ops_train", model="gpt2_124m", steps=OPS_STEPS, nan_step=OPS_NAN_STEP,
             held_bitwise=held, optimizer_counts=counts_by_step, lr_after_skip=lr_next,
             health=summary, goodput=good, span_events=len(events),
             spans_by_cat={c: sum(1 for e in events if e.get("cat") == c)
                           for c in ("compile", "step", "data_wait", "flush", "checkpoint")},
             step_ms_median=float(np.median(timed)), step_ms=step_ms,
             train_step_ms_median=train_median_ms, launches=counts,
             profile={"steps": OPS_PROFILE, "wall_s": window, "device_busy_s": busy,
                      "device_idle_share": idle, "top_kernels": top,
                      "device_s_by_group": groups},
             registry_gauges=sorted(doc["metrics"]["gauges"]), card=card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ops_halt_phase(card):
    """The char-LM at its widths (``examples.char_lm.build``, B=128, T=256)
    under ``anomaly_action="dump_and_halt"``, a NaN loss at step k: a
    ``HealthAnomalyError``, a bundle with its manifest and an emergency
    checkpoint whose ``resume_from=`` restores params and both moments
    bitwise to the state after step k-1 (the gate's latch held every step
    after the anomaly until the lagged word halted the run)."""
    from rocket_tpu_torch.obs.health import HealthAnomalyError

    k = 4
    root = Path(tempfile.mkdtemp(prefix="ops_halt_"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        text = synthetic_corpus(num_chars=400_000)
        tok = CharTokenizer(text)
        data = TokenDataset(tok.encode(text), seq_len=256)
        config = TransformerConfig.char_lm(vocab_size=tok.vocab_size, max_seq_len=256)
        runtime = rt.Runtime(seed=0, health=True, anomaly_action="dump_and_halt",
                             project_dir=str(root))
        run = char_lm.build(data, config, batch_size=128, num_epochs=1,
                            out_dir=str(root / "ck"), runtime=runtime)
        module = run["module"]
        loss = module.find(rt.Loss)[0]
        loss._objective = _poisoned(loss.objective, k, runtime.device)
        snaps = {}

        class Snap(Capsule):
            def __init__(self):
                super().__init__(priority=6)
                self.step = 0

            def launch(self, attrs=None):
                if self.step == k - 1:
                    snaps["good"] = _train_snapshot(module)
                self.step += 1

        looper = run["launcher"].find(rt.Looper)[0]
        snap = Snap()
        snap.bind(runtime)
        looper._capsules = sorted([*looper._capsules, snap], key=lambda c: -c.priority)
        try:
            run["launcher"].launch()
            raise RuntimeError("chip_smoke: ops_halt: no HealthAnomalyError")
        except HealthAnomalyError as exc:
            bundle = exc.bundle
        require(bundle is not None and (Path(bundle) / "blackbox.json").is_file(),
                f"ops_halt: no bundle ({bundle})")
        with open(Path(bundle) / "blackbox.json") as f:
            manifest = json.load(f)
        require(manifest["checkpoint"] == "checkpoint" and manifest["reason"] == f"anomaly_step{k}",
                f"ops_halt: manifest {manifest.get('reason')} {manifest.get('checkpoint')}")
        again = rt.Runtime(seed=0, project_dir=str(root))
        back = char_lm.build(data, config, batch_size=128, num_epochs=1,
                             out_dir=str(root / "ck2"), runtime=again,
                             resume_from=str(Path(bundle) / "checkpoint"))
        back["launcher"].setup()
        try:
            restored = _train_snapshot(back["module"])
            same = {key: all(torch.equal(a, b.to(a.device))
                             for a, b in zip(snaps["good"][key], restored[key]))
                    if isinstance(restored[key], list)
                    else torch.equal(snaps["good"][key], restored[key].to(snaps["good"][key].device))
                    for key in restored}
        finally:
            back["launcher"].destroy()
            again.end_training()
        require(all(same.values()), f"ops_halt: the bundle's checkpoint is not step {k - 1}'s "
                f"state: {same}")
        emit("ops_halt", nan_step=k, bundle=os.path.relpath(bundle, root),
             last_good_step=manifest["last_good_step"], restored_bitwise=same,
             health=manifest.get("health"), card=card)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


class _EventClock(Capsule):
    """A CUDA event after every step (after the Module; no sync)."""

    def __init__(self):
        super().__init__(priority=5)
        self.events = []

    def launch(self, attrs=None):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)


def _gpt2_step_ms(ops: bool, steps: int = 12) -> float:
    """The median step ms (CUDA events, after WARM_STEPS) of ``train``'s
    GPT-2 124M tree, with the ops plane of ``ops_train`` on or all off."""
    cfg = TransformerConfig.gpt2_124m()
    root = Path(tempfile.mkdtemp(prefix="ops_cost_"))
    try:
        plane = dict(strict=True, telemetry=True, health=True, anomaly_action="skip_step",
                     watchdog_secs=60, telemetry_dir=str(root / "tel")) if ops else {}
        runtime = rt.Runtime(seed=0, project_dir=str(root), **plane)
        clock = _EventClock()
        run = gpt2.build(cfg, _gpt2_corpus(cfg.max_seq_len, cfg.vocab_size), batch_size=8,
                         runtime=runtime, steps=steps, record=False, capsules=(clock,))
        run["launcher"].launch()
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(clock.events, clock.events[1:])]
        return float(np.median(step_ms[WARM_STEPS - 1:]))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ops_cost(timer=None, gen=None) -> dict:
    """The ops plane's cost on GPT-2 124M's train step: the median step with
    it off and on, in turns (off, on, on, off, twice) in one process, so the
    host's drift falls on both sides. Not part of ``main``: run it with
    ``python -m rocket_tpu_torch.obs.ab --phase ops_cost .``."""
    medians = {"off": [], "on": []}
    for ops in (False, True, True, False, False, True, True, False):
        medians["on" if ops else "off"].append(_gpt2_step_ms(ops))
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    emit("ops_cost", step_ms_median=medians, card=card)
    return medians


class _HostRead(Capsule):
    """Reads a CUDA scalar on the host (``.item()``) in every wave."""

    def __init__(self):
        super().__init__()
        self.values = []

    def launch(self, attrs=None):
        self.values.append((torch.ones((), device="cuda") * 2).item())


def strict_guard_phase(card):
    """A capsule calling ``.item()`` on a CUDA tensor inside the wave raises
    under ``strict=True`` (from the second wave: the first runs unguarded)
    and runs with strict off."""
    outcome = {}
    for strict in (False, True):
        reader = _HostRead()
        runtime = rt.Runtime(strict=strict)
        try:
            rt.Launcher([rt.Looper([reader], repeats=3, progress=False)],
                        runtime=runtime).launch()
            outcome[strict] = ("ran", len(reader.values))
        except RuntimeError as exc:
            outcome[strict] = ("raised", len(reader.values), str(exc)[:160])
        require(torch.cuda.get_sync_debug_mode() == 0, "strict_guard: the guard outlived the run")
    require(outcome[False] == ("ran", 3), f"strict_guard: strict off {outcome[False]}")
    require(outcome[True][0] == "raised" and outcome[True][1] == 1,
            f"strict_guard: strict on {outcome[True]}")
    emit("strict_guard", off=list(outcome[False]), on=list(outcome[True]), card=card)


class _Sleep(Capsule):
    def __init__(self, seconds):
        super().__init__()
        self.seconds, self.calls = seconds, 0

    def launch(self, attrs=None):
        self.calls += 1
        if self.calls == 2:
            time.sleep(self.seconds)


def watchdog_phase(card):
    """A capsule that sleeps 3.5 s past a 2 s ``watchdog_secs`` makes the
    watchdog report, with the CUDA allocator's line."""
    hold = torch.ones(1 << 20, device="cuda")  # something allocated to report
    root = Path(tempfile.mkdtemp(prefix="watchdog_"))
    try:
        runtime = rt.Runtime(watchdog_secs=2.0, project_dir=str(root),
                             telemetry_dir=str(root / "tel"))
        rt.Launcher([rt.Looper([_Sleep(3.5)], repeats=3, progress=False)],
                    runtime=runtime).launch()
        dog = runtime.telemetry.watchdog
        report = dog.last_report or ""
        line = next((ln for ln in report.splitlines() if ln.startswith("cuda allocator:")), "")
        require(dog.stall_count >= 1 and "MiB allocated" in line,
                f"watchdog: {dog.stall_count} stalls, allocator line {line!r}")
        require((root / "tel" / "watchdog_stalls.txt").is_file(), "watchdog: no stall file")
        emit("watchdog", stalls=dog.stall_count, allocator_line=line, card=card)
    finally:
        del hold
        shutil.rmtree(root, ignore_errors=True)


# -- PR 17: GPT-2 training under the supervising launcher; the poison gate ------

#: The supervised run: GPT-2 124M at full width, SUPERVISED_STEPS steps in
#: all, a checkpoint every 5 (keep 3); generation 0 killed at the top of its
#: 11th wave, generation 1 wedged at its 4th (the watchdog's 2 s deadline
#: escalates to exit 85), generation 2 sent SIGTERM at its 4th (it drains at
#: the next boundary); a plain resume then takes the tree to the end. The
#: kill lands at wave 11, not 8: the step-5 save writes its 1.49 GB on a
#: background thread for ~5 s on the card's host, so a kill three waves
#: later tears it (the first chip run of this phase saw generations 1 and 2
#: skip the torn step and start over). Wave 10's save waits for step 5's
#: files first (one write in flight), so at wave 11 step 5 is complete and
#: step 10 is torn: the kill exercises both the skip and the resume.
SUPERVISED_STEPS = 16
#: Its depth: GPT-2 124M's widths at 3 of its 12 layers (cut to 6, then to
#: 3, when the multi-process phases grew, to keep the script inside its
#: time limit; at 3 layers a save with both moments is ~0.73 GB, still
#: seconds of background writing, so the kill still tears step 10's; every
#: process loads the seed-0 params from a file the phase writes instead of
#: drawing its own, so a restart's latency holds no CPU-side draw).
SUPERVISED_LAYERS = 3
SUPERVISED_FAULTS = "kill:step=11,gen=0;wedge:step=4,gen=1,secs=600;sigterm:step=4,gen=2"

#: The worker of ``supervised_train``: examples.gpt2's tree with a
#: Checkpointer, a Profiler (perf/steps_per_sec for the SLO) and a step log
#: (the step's wall time and the flash launch counts so far, on a line of its
#: own after every wave, so a killed generation leaves them too; a step
#: counter and the generation in the registry, so /metrics shows them); at
#: the end the SHA-256 of the params, both AdamW moments and the counts.
SUPERVISED_WORKER = r"""
import time

T0 = time.time()
import hashlib, json, logging, os, sys

import numpy as np
import torch

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.examples import gpt2
from rocket_tpu_torch.models.transformer import TransformerConfig
from rocket_tpu_torch.ops import flash_native as fa

T_IMPORTED = time.time()
root, run_dir, steps, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                    format="%(created).3f %(name)s %(message)s")
torch.backends.cuda.matmul.allow_tf32 = False
gen = int(os.environ.get("ROCKET_TPU_GENERATION", "-1"))
cfg = TransformerConfig.gpt2_124m()
cfg.num_layers = int(os.environ["SUPERVISED_LAYERS"])
data = TokenDataset(np.load(os.path.join(root, "tokens.npy")) % cfg.vocab_size,
                    seq_len=cfg.max_seq_len)
# The supervised generations' shards in <run_dir>/telemetry, a plain run's
# (the uninterrupted one, the resume after the drain) under <run_dir>/plain.
tel_dir = run_dir if os.environ.get("ROCKET_TPU_SUPERVISED") else os.path.join(run_dir, "plain")
runtime = rt.Runtime(seed=0, telemetry=True, watchdog_secs=2, export=True,
                     export_interval_s=0.5, metrics_port=port, project_dir=run_dir,
                     telemetry_dir=tel_dir)


class StepLog(rt.Capsule):
    def __init__(self):
        super().__init__(priority=1)
        self.module = self.prepared = None

    def launch(self, attrs=None):
        self.prepared = self.module.prepared
        registry = self._runtime.telemetry.registry
        registry.counter("train/steps").inc()
        registry.gauge("train/generation").set(gen)
        print("STEP " + json.dumps({
            "gen": gen, "step": int(self.prepared.state["step"]), "t": time.time(),
            "flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
            "flash_dq": fa.flash_dq.launches}), flush=True)


ckpt = rt.Checkpointer(output_dir=os.path.join(run_dir, "ck"), save_every=5, keep_last=3,
                       resume_from="latest")
log = StepLog()
run = gpt2.build(cfg, data, batch_size=8, runtime=runtime, steps=steps, record=False,
                 capsules=(rt.Profiler(flops_per_sample=gpt2.flops_per_sample(
                     cfg, cfg.max_seq_len)), ckpt, log))
log.module = run["module"]
# The seed-0 params the phase drew once, from a file (GPT-2's CPU-side draw
# takes seconds, in every generation).
runtime.models.add(run["model"], PreparedModule(run["model"], {"params": torch.load(
    os.path.join(root, "init_params.pt"), map_location="cuda")}))
print("START " + json.dumps({"gen": gen, "t": time.time(), "pid": os.getpid(), "t0": T0,
                             "t_imported": T_IMPORTED}), flush=True)
try:
    run["launcher"].launch()
except SystemExit as exc:
    print("EXIT " + json.dumps({"gen": gen, "t": time.time(), "code": exc.code,
                                "saves": ckpt.save_times}), flush=True)
    raise
state = log.prepared.state
opt = state["optimizer"]
leaves = optim.param_leaves(state["params"])


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


print("DIGEST " + json.dumps({
    "gen": gen, "t": time.time(), "step": int(state["step"]), "params": digest(leaves),
    "exp_avg": digest([opt.state[p]["exp_avg"] for p in leaves]),
    "exp_avg_sq": digest([opt.state[p]["exp_avg_sq"] for p in leaves]),
    "count": digest([opt.state[p]["step"] for p in leaves]),
    "counts": sorted({float(opt.state[p]["step"]) for p in leaves})}), flush=True)
"""


def _tagged(text: str, tag: str) -> list:
    """The JSON payloads of the lines holding ``TAG {...}``."""
    return [json.loads(line.split(f"{tag} ", 1)[1]) for line in text.splitlines()
            if f"{tag} {{" in line]


def _logged_at(text: str, needle: str) -> list:
    """The unix times of the worker's log lines (``%(created)`` first) that
    hold ``needle``."""
    out = []
    for line in text.splitlines():
        if needle in line:
            head = line.split("] ", 1)[-1].split(" ", 1)[0]
            try:
                out.append(float(head))
            except ValueError:
                pass
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Scraper:
    """Polls a worker's ``/metrics`` every 0.1 s on a thread while the
    supervised run goes on; keeps (time, generation, step count) of each
    answer."""

    def __init__(self, port: int):
        import threading

        self.url, self.seen = f"http://127.0.0.1:{port}/metrics", []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import urllib.request

        while not self._stop.wait(0.1):
            try:
                body = urllib.request.urlopen(self.url, timeout=1).read().decode()
            except OSError:
                continue
            values = {}
            for line in body.splitlines():
                for name in ("rocket_tpu_train_generation", "rocket_tpu_train_steps"):
                    if line.startswith(name + "{"):
                        values[name] = float(line.rsplit(" ", 1)[1])
            self.seen.append((time.time(), values.get("rocket_tpu_train_generation"),
                              values.get("rocket_tpu_train_steps")))

    def stop(self):
        self._stop.set()
        self._thread.join(5)


def _step_ms(steps: list) -> list:
    """Gaps between consecutive step lines of one process, its first wave
    left out (it builds the allocator's pools and cuBLAS's handles)."""
    times = [s["t"] for s in steps]
    return [1e3 * (b - a) for a, b in zip(times[1:], times[2:])]


#: The uninterrupted supervised run's trace window (ROCKET_TPU_PROF): the
#: Profiler capsule traces 3 steps and parses them into obs/prof/*.
SUPERVISED_PROF = "6:9"


def _supervised_prof_window(root):
    """The uninterrupted supervised run's trace window: its telemetry
    carries the ``obs/prof/*`` gauges of the parsed window, and the
    window's trace holds 18 ``flash_fwd`` and 9 ``flash_bwd`` launches (3
    steps of SUPERVISED_LAYERS = 3 layers; the forward twice under remat) launched inside its
    ``ProfilerStep`` ranges."""
    from rocket_tpu_torch.obs import prof as prof_lib

    traces = sorted((root / "traces").glob("window_*.json"))
    require(len(traces) == 1, f"supervised_train: trace windows {traces}")
    summary = prof_lib.parse_trace(prof_lib.load_trace_events(str(traces[0])))
    layers = SUPERVISED_LAYERS
    got = {"flash_fwd": summary.step_launches("flash_fwd"),
           "flash_bwd": summary.step_launches("flash_bwd")}
    require(len(summary.steps) == 3 and got == {"flash_fwd": 3 * 2 * layers,
                                                "flash_bwd": 3 * layers},
            f"supervised_train: the trace window holds {len(summary.steps)} steps, {got}")
    docs = [json.loads(p.read_text()) for p in (root / "plain").rglob("telemetry.json")]
    gauges = {k: v for d in docs for k, v in d["metrics"]["gauges"].items()
              if k.startswith("obs/prof/")}
    require(gauges.get("obs/prof/n_steps") == 3.0 and "obs/prof/measured_step_us" in gauges,
            f"supervised_train: telemetry's obs/prof gauges {gauges}")
    return {"launches": got, "gauges": gauges, "device_s": summary.device_total_us * 1e-6,
            "record": prof_lib.prof_record(summary, top=5)}


def supervised_train_phase(card, train_median_ms):
    """GPT-2 124M (B=8, T=1024, bf16, remat, dropout 0.1) trained through
    ``python -m rocket_tpu_torch.launch --supervise -n 1`` under
    :data:`SUPERVISED_FAULTS`, exporting shards every 0.5 s and serving
    ``/metrics``, judged by ``ROCKET_TPU_SLO=default:train``; then a plain
    resume to :data:`SUPERVISED_STEPS`. Holds: generations crashed (a
    SIGKILL), wedged (85, the watchdog's escalation) and drained (84, with
    ``drain.json``), the supervisor's exit 0; the resumed run's params, both
    AdamW moments and the counts bitwise those of an uninterrupted run of
    the same script (SHA-256 of their bytes); the flash kernels launched in
    every process; a scrape of ``/metrics`` during generation 2 holding the
    step counter; the supervised generations' shards parse; ``obs watch
    --slo default:train`` over them exits 0 and ``obs top --once`` renders
    (the plain runs keep their shards under ``plain/``: the resume's
    verdict is recorded beside)."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="supervised_"))
    try:
        text = _text(2_000_000)  # examples.gpt2.corpus's text
        np.save(root / "tokens.npy", CharTokenizer(text).encode(text))
        (root / "worker.py").write_text(SUPERVISED_WORKER)
        sup_cfg = TransformerConfig.gpt2_124m()
        sup_cfg.num_layers = SUPERVISED_LAYERS
        torch.save(map_params(lambda t: t.cpu(), _drawn_params(sup_cfg)), root / "init_params.pt")
        env = {k: v for k, v in os.environ.items() if not k.startswith("ROCKET_TPU_")}
        env.update(ROCKET_TPU_SLO="default:train", SUPERVISED_LAYERS=str(SUPERVISED_LAYERS),
                   PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
        port = _free_port()
        worker = [str(root / "worker.py"), str(root)]

        def start_plain(run_dir, run_port, extra_env=None):
            # Output to files: the run may write while nothing reads it.
            files = [open(root / f"{run_dir.name}.{kind}", "w") for kind in ("out", "err")]
            return time.time(), run_dir, files, subprocess.Popen(
                [sys.executable, *worker, str(run_dir), str(SUPERVISED_STEPS), str(run_port)],
                env=dict(env, **(extra_env or {})), cwd=str(root), stdout=files[0],
                stderr=files[1])

        def finish_plain(started):
            t0, run_dir, files, proc = started
            try:
                proc.wait(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for f in files:
                    f.close()
            stdout, stderr = (Path(f.name).read_text() for f in files)
            (out / f"supervised_{run_dir.name}.log").write_text(stdout + stderr)
            require(proc.returncode == 0, f"supervised_train: the {run_dir.name} run exited "
                    f"{proc.returncode}: {(stdout + stderr)[-1500:]}")
            return stdout, time.time() - t0

        torch.cuda.empty_cache()
        # The uninterrupted run traces a window of 3 steps (ROCKET_TPU_PROF);
        # it runs beside the supervised one, serving its own /metrics port.
        plain_port = _free_port()
        while plain_port == port:
            plain_port = _free_port()
        plain_run = start_plain(root / "plain", plain_port, {"ROCKET_TPU_PROF": SUPERVISED_PROF})
        try:
            scraper = _Scraper(port)
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "rocket_tpu_torch.launch", "--supervise", "-n", "1",
                 "--backoff", "0.1", "--ckpt-dir", str(root / "sup" / "ck"), "--state-dir",
                 str(root / "sup"), *worker, str(root / "sup"), str(SUPERVISED_STEPS),
                 str(port)], env=dict(env, ROCKET_TPU_FAULTS=SUPERVISED_FAULTS), cwd=str(root),
                capture_output=True, text=True, timeout=600)
            sup_wall = time.time() - t0
            scraper.stop()
        except BaseException:
            plain_run[3].kill()
            plain_run[3].wait()
            raise
        uninterrupted, plain_wall = finish_plain(plain_run)
        prof_window = _supervised_prof_window(root)
        log = proc.stdout + proc.stderr
        (out / "supervised_train.log").write_text(log)
        require(proc.returncode == 0, f"supervised_train: the supervisor exited "
                f"{proc.returncode}: {log[-2000:]}")
        with open(root / "sup" / "supervisor.json") as f:
            sup = json.load(f)
        gens = sup["generations"]
        require([g["outcome"] for g in gens] == ["crashed", "wedged", "drained"]
                and [g["exit_codes"] for g in gens] == [[-signal.SIGKILL], [85], [84]],
                f"supervised_train: generations {[(g['outcome'], g['exit_codes']) for g in gens]}")
        require(gens[0]["ckpt_step"] == 5 and sup["outcome"] == "drained",
                f"supervised_train: {sup['outcome']}, checkpoint steps "
                f"{[g['ckpt_step'] for g in gens]}")
        drain_dir = root / "sup" / "ck" / str(gens[2]["ckpt_step"])
        require((drain_dir / "drain.json").is_file(), f"supervised_train: no drain.json in "
                f"{sorted(os.listdir(root / 'sup' / 'ck'))}")
        drain_bytes = sum(f.stat().st_size for f in drain_dir.rglob("*") if f.is_file())
        resumed, resume_wall = finish_plain(start_plain(root / "sup", port))

        digests = {name: _tagged(text, "DIGEST") for name, text in
                   (("uninterrupted", uninterrupted), ("resumed", resumed))}
        require(all(len(d) == 1 for d in digests.values()), f"supervised_train: {digests}")
        want, got = digests["uninterrupted"][0], digests["resumed"][0]
        keys = ("step", "params", "exp_avg", "exp_avg_sq", "count")
        bitwise = {k: got[k] == want[k] for k in keys}
        require(all(bitwise.values()) and got["step"] == SUPERVISED_STEPS,
                f"supervised_train: resumed vs uninterrupted {bitwise} (steps {got['step']}, "
                f"{want['step']}; counts {got['counts']} vs {want['counts']})")

        steps = {g: [s for s in _tagged(log, "STEP") if s["gen"] == g] for g in (0, 1, 2)}
        steps["resume"] = _tagged(resumed, "STEP")
        steps["uninterrupted"] = _tagged(uninterrupted, "STEP")
        launches = {str(g): {k: s[-1][k] for k in ("flash_fwd", "flash_bwd", "flash_dq")}
                    if s else {} for g, s in steps.items()}
        layers = SUPERVISED_LAYERS
        for g, s in steps.items():
            n = len(s)
            require(n > 0 and launches[str(g)]["flash_fwd"] == 2 * layers * n
                    and launches[str(g)]["flash_bwd"] == layers * n,
                    f"supervised_train: process {g}: {n} steps, launches {launches[str(g)]}")
        require([s["step"] for s in steps["resume"]] == list(range(10, SUPERVISED_STEPS + 1)),
                f"supervised_train: resumed steps {[s['step'] for s in steps['resume']]}")

        live = [(t, g, n) for t, g, n in scraper.seen if g == 2 and n]
        require(live, f"supervised_train: no /metrics scrape in generation 2 with the step "
                f"counter ({len(scraper.seen)} scrapes, generations "
                f"{sorted({g for _, g, _ in scraper.seen if g is not None})})")
        shards = read_telemetry_dir(str(root / "sup"))
        records = shards.get(0, [])
        require(records and {r.get("pid") for r in records} and all(
            r.get("version") == 1 for r in records), f"supervised_train: shards {sorted(shards)}")
        # ``obs watch`` through the main its ``python -m`` entry point runs,
        # in this process (a process of its own cost ~10 s of start-up).
        with contextlib.redirect_stdout(io.StringIO()) as watch:
            watch_rc = obs_main(["watch", "--slo", "default:train", str(root / "sup")])
        with contextlib.redirect_stdout(io.StringIO()) as top:
            top_rc = obs_main(["top", "--once", str(root / "sup")])
        # The plain resume's own shards, judged alike (recorded, not held:
        # it is not the supervised run).
        with contextlib.redirect_stdout(io.StringIO()) as watch_resume:
            resume_rc = obs_main(["watch", "--slo", "default:train", str(root / "sup" / "plain")])
        (out / "supervised_obs.log").write_text(watch.getvalue() + top.getvalue()
                                               + watch_resume.getvalue())
        require(watch_rc == 0, f"supervised_train: obs watch exited {watch_rc}: "
                f"{watch.getvalue()[-800:]}")
        require(top_rc == 0 and "obs top — 1 rank(s)" in top.getvalue(),
                f"supervised_train: obs top returned {top_rc}")

        killed = _logged_at(log, "fault injection: firing kill")
        escalated = _logged_at(log, "watchdog escalation under supervision")
        sigterm = _logged_at(log, "fault injection: firing sigterm")
        exits = [e for e in _tagged(log, "EXIT") if e["gen"] == 2]
        require(killed and escalated and sigterm and exits,
                f"supervised_train: fault times {killed} {escalated} {sigterm} {exits}")
        gen_end = [g["started_unix"] + g["duration_s"] for g in gens]
        drain_saves = [s for s in exits[0]["saves"] if "drain_s" in s]
        starts = _tagged(log, "START")
        restart = {}
        for name, died, start, first in (("kill", killed[0], starts[1], steps[1][0]["t"]),
                                         ("wedge", escalated[0], starts[2], steps[2][0]["t"])):
            restart[name] = {"total_s": first - died, "to_process_start_s": start["t0"] - died,
                             "imports_s": start["t_imported"] - start["t0"],
                             "runtime_and_tree_s": start["t"] - start["t_imported"],
                             "setup_and_first_wave_s": first - start["t"]}
        # The last process (the plain resume) wrote the span file: its setup
        # by capsule and its first wave, a resume's costs one by one.
        events = [e for e in load_chrome_trace(str(root / "sup" / "plain" / "spans.trace.json"))
                  if e.get("ph") == "X"]

        def span_s(name):
            return next((e["dur"] / 1e6 for e in events if e.get("name") == name), None)

        resume_setup = {n: span_s(n) for n in ("Dataset.setup", "Module.setup",
                                                "Checkpointer.setup", "checkpoint/load",
                                                "Launcher.setup")}
        resume_setup["first_wave"] = next((e["dur"] / 1e6 for e in events
                                           if e.get("cat") == "compile"), None)
        last_slo = records[-1].get("slo") or []
        emit("supervised_train", model="gpt2_124m", layers=SUPERVISED_LAYERS, dtype="bfloat16",
             batch=8, seq_len=1024,
             steps=SUPERVISED_STEPS, faults=SUPERVISED_FAULTS, prof_window=prof_window,
             outcomes=[g["outcome"] for g in gens], exit_codes=[g["exit_codes"] for g in gens],
             supervisor_rc=proc.returncode, restarts=sup["restarts"],
             goodput_fraction=sup["goodput_fraction"], total_wall_s=sup["total_wall_s"],
             productive_wall_s=sup["productive_wall_s"],
             generation_wall_s=[g["duration_s"] for g in gens],
             generation_ckpt_step=[g["ckpt_step"] for g in gens],
             step_ms_median={str(g): float(np.median(_step_ms(s))) if len(s) > 2 else None
                             for g, s in steps.items()},
             train_step_ms_median=train_median_ms,
             steps_per_generation={str(g): [x["step"] for x in s] for g, s in steps.items()},
             restart_latency_s=restart, resume_setup_s=resume_setup,
             torn_steps_skipped=sorted({int(x.rsplit("/", 1)[1]) for x in re.findall(
                 r"skipping incomplete checkpoint (\S+)", log)}),
             wedge_to_escalation_s=escalated[0] - steps[1][-1]["t"],
             drain_latency_s={"sigterm_to_exit_line": exits[0]["t"] - sigterm[0],
                              "sigterm_to_generation_end": gen_end[2] - sigterm[0]},
             drain_save_s=drain_saves[0]["drain_s"] if drain_saves else None,
             drain_bytes=drain_bytes, drain_step=gens[2]["ckpt_step"],
             bitwise=bitwise, launches=launches,
             scrapes={"total": len(scraper.seen), "generation_2": len(live),
                      "last_generation_2_steps": live[-1][2] if live else None},
             shard_records=len(records), shard_processes=len({r.get("pid") for r in records}),
             last_slo=[{k: s.get(k) for k in ("name", "value", "burn_rate", "violated")}
                       for s in last_slo],
             obs_watch=watch.getvalue().strip().splitlines()[-1:],
             obs_watch_resume={"rc": resume_rc,
                               "lines": watch_resume.getvalue().strip().splitlines()[-3:]},
             wall_s={"uninterrupted": plain_wall, "supervised": sup_wall,
                     "resume": resume_wall}, card=card)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


class _KeepBatch(Capsule):
    """After the Module: keeps the ``nth`` wave's input image tensor (a
    reference, no read)."""

    def __init__(self, nth: int):
        super().__init__(priority=5)
        self.nth, self.calls, self.image = nth, 0, None

    def launch(self, attrs=None):
        self.calls += 1
        if self.calls == self.nth:
            self.image = attrs.batch["image"]


def poison_gate_phase(card):
    """``examples.mnist.build`` (LeNet, B=1024, accumulation 2, one epoch)
    on device-resident batches under ``Runtime(strict=True, health=True,
    anomaly_action="skip_step")`` with ``ROCKET_TPU_FAULTS="poison:step=3"``:
    the third batch is NaN-filled on the card (no upload, so the sync guard
    stays quiet: the run completes under it), the optimizer step holding it
    is the one held step."""
    from rocket_tpu_torch.data.datasets import mnist as mnist_data

    saved = os.environ.get("ROCKET_TPU_FAULTS")
    os.environ["ROCKET_TPU_FAULTS"] = "poison:step=3"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            runtime = rt.Runtime(seed=0, gradient_accumulation_steps=2, strict=True,
                                 health=True, anomaly_action="skip_step", project_dir=tmp)
            run = mnist.build(mnist_data(train=True), mnist_data(train=False), batch_size=1024,
                              num_epochs=1, out_dir=os.path.join(tmp, "ck"), runtime=runtime)
            keep = _KeepBatch(3)
            looper = run["launcher"].find(rt.Looper)[0]
            looper._capsules = sorted([*looper._capsules, keep], key=lambda c: -c.priority)
            keep.bind(runtime)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                run["launcher"].launch()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            if saved is None:
                os.environ.pop("ROCKET_TPU_FAULTS", None)
            else:
                os.environ["ROCKET_TPU_FAULTS"] = saved
    train, val = run["datasets"]
    summary = runtime.health.summary()
    flags = [r["flag_names"] for r in runtime.health.anomaly_records]
    image = keep.image
    require(train.device_resident and val.device_resident,
            "poison_gate: the batches were not device-resident")
    require(runtime.faults.fired == ("poison@batch[3]",),
            f"poison_gate: fired {runtime.faults.fired}")
    require(image is not None and image.is_cuda and bool(torch.isnan(image).all()),
            "poison_gate: the third batch is not an all-NaN CUDA tensor")
    require(summary["skipped_steps"] == 1 and summary["anomalies"] == 1,
            f"poison_gate: health {summary}, flags {flags}")
    require(not runtime.strict.enabled and torch.cuda.get_sync_debug_mode() == 0,
            "poison_gate: the guard outlived the run")
    emit("poison_gate", model="lenet", batch=1024, accumulation=2, faults="poison:step=3",
         fired=list(runtime.faults.fired), health=summary, flags=flags,
         nan_batch={"device": str(image.device), "dtype": str(image.dtype),
                    "shape": list(image.shape)},
         strict=True, device_resident=True, wall_s=wall, card=card)



# -- the data-parallel slice: process group, bucketed sync, FSDP layout -------

#: dp_train: two ranks against one, per-step losses (bf16 compute, the
#: batch split differently over the GEMMs) and the step-1 gradients (f32
#: compute and wire: the batch split and the reduction alone), relative to
#: the largest one-rank gradient.
DP_LOSS_TOL, DP_GRAD_TOL = 2e-2, 1e-3
#: dp_train's bf16 wire against its f32 wire, step 1, f32 compute (the
#: CPU tests' bounds): each bucket's sum relative to its mass (the f32
#: bucket-sum correction: f32 precision), each element relative to its
#: bucket's largest (two bf16 roundings of 2^-9 and the correction's shift).
DP_WIRE_SUM_TOL, DP_WIRE_TOL = 1e-6, 2.0 ** -7
#: dp_checkpoint: a one-rank run resumed from the two ranks' step-4
#: checkpoint against the uninterrupted two-rank run's step 8: AdamW moves
#: a param at most ~lr (6e-4) a step, so a gradient whose sign the batch
#: split flips moves it 2 lr apart: 4 steps, 5e-3.
DP_PARAM_TOL = 5e-3
#: Cut from 8 and 4, then from 6 and 3, when the multi-process phases grew,
#: to keep the script inside its time limit.
DP_STEPS, DP_SAVE_AT = 4, 2
#: tp_train: the bf16 wire's step-1 gradients against the f32 wire's, both
#: at f32 compute, relative to the largest element. Unlike the data
#: reduction's one rounding at the end, the TP wire rounds the activation
#: gradient at every collective of every layer (4 a layer, 12 layers), and
#: each rounding (2^-9) flows on through the layers below it.
TP_WIRE_TOL = 3e-2

# -- sync-BN, ring attention and the pipeline -----------------------------------

#: pp_train / pp_checkpoint: GPT-2 124M (scan_layers, dropout 0.1, bf16,
#: AdamW) over ``{"data": 1, "pipe": 2}``, 6 layers a stage, B=8 in M=4
#: microbatches of 2 rows, PP_STEPS steps a schedule (cut from 8, then 6), a
#: save at PP_SAVE_AT (cut from 4, then 3); the peak memory at M = 4 is theirs, at M = 8
#: (2-row microbatches) that of a 2-step job each.
PP_STEPS, PP_SAVE_AT, PP_M, PP_MB_ROWS = 4, 2, 4, 2
PP_MESH = {"data": 1, "pipe": 2}
#: The step-1 gradients at f32 compute, pipelined against unpipelined,
#: relative to the largest element: the same f32 function with the batch's
#: mean taken over microbatch means and the shared leaves' gradients summed
#: over the stages (f32 rounding, as ``dp_train``'s DP_GRAD_TOL bounds).
PP_GRAD_TOL = DP_GRAD_TOL
#: 1F1B's peak may grow with M by the buffers whose size is the batch's
#: (the embedding's output and its cotangent, the batch itself): 2 rows x
#: 1024 x 768 x (2 + 4) bytes a microbatch, ~9.4 MB; GPipe's grows by its
#: saved stage inputs and its head over the whole batch besides.
PP_FLAT_BYTES = 64 << 20
#: ring_train: GPT-2 124M widths at T = 4096 (``gpt2_124m(max_seq_len=
#: 4096)``), ``attention_impl="ring"``, dropout 0, B=2, remat, over
#: ``{"data": 1, "seq": 2}``; against one rank at ``attention_impl="auto"``
#: (rows 3-5). The ring's probabilities are f32 where the flash kernels'
#: are bf16, so the losses differ by bf16 rounding: 2.87e-4 over the 8
#: steps on an H100 (PERF.md), bounded at 3.5 times that.
RING_T, RING_B, RING_STEPS = 4096, 2, 4  # steps cut from 8
RING_MESH = {"data": 1, "seq": 2}
RING_LOSS_TOL = 1e-3
#: The step-1 loss at f32 compute, ring against one rank's plain attention:
#: f32 reassociation (~1e-6), where a mean over B*T tokens instead of the
#: B*(T-1) next-token targets moves it by ln(V)/T ~ 2.6e-3. The step-1
#: gradients are held to PP_GRAD_TOL: a leaf left out of the seq group's
#: sum is half its value.
RING_F32_LOSS_TOL = 1e-4
#: dp_cifar: ResNet-18 (CIFAR stem) on synthetic CIFAR-10 images, momentum
#: SGD at lr 0.05, two ranks at B=256 each against one rank at B=512, 4
#: steps, TF32 off, cuDNN deterministic. The ranks' statistics are the
#: global batch's, summed over two halves: f32 reassociation, amplified by
#: 4 steps (CIFAR_TOL's bound for a card-vs-CPU step, per element of
#: ``|want|``).
CIFAR_DP_STEPS, CIFAR_DP_BATCH, CIFAR_DP_TOL = 4, 512, 1e-3

#: ep_train / ep_checkpoint: bench.py's moe_gpt2_e4 (GPT-2 widths, 4
#: experts, top-2) at MOE_LAYERS layers, B=8, T=1024, bf16, remat, AdamW,
#: over ``{"data": 1, "expert": 2}`` (two experts a rank), EP_STEPS steps a
#: dispatch (dropless with ROCKET_TPU_MOE_GMM=fused, and einsum), a save at
#: EP_SAVE_AT; against one rank. The first resumed step's loss on one rank
#: is held within EP_RESUME_TOL of the uninterrupted run's (the same
#: params, a dropless forward that adds the same two rows onto zero).
EP_MESH = {"data": 1, "expert": 2}
EP_STEPS, EP_SAVE_AT, EP_RESUME_TOL = DP_STEPS, DP_SAVE_AT, 1e-4
#: moe_par: the MoE LM at full width and MOE_PAR_LAYERS layers, two f32
#: steps with the gradient tap under the model, seq and pipe axes (GPipe at
#: PP_M microbatches of 2 rows), each against one rank (the pipe job's
#: against one rank's microbatch mean, through gradient accumulation).
MOE_PAR_LAYERS = 2

# -- every mesh the reference runs: the flash seams and item 8's pairs -------------

#: tp_pp_train / tp_pp_checkpoint: GPT-2 124M at full width and depth (B=8,
#: T=1024, bf16, remat, dropout 0.1, AdamW) over ``{"data": 1, "model": 2,
#: "pipe": 2}`` under ``pipeline_over(gpt2_tp_rules())``, four ranks sharing
#: the card over gloo, PP_M microbatches of 2 rows, TP_PP_STEPS steps a
#: schedule, a save at TP_PP_SAVE_AT; against ``pp_train``'s one rank at its
#: bounds, and a 2-step f32 1F1B tap held to PP_GRAD_TOL. Each stage's
#: model shards are gathered over its model group at step entry (the
#: reference's stage body: its model axis gathered, TP off there).
TP_PP_MESH = {"data": 1, "model": 2, "pipe": 2}
TP_PP_STEPS, TP_PP_SAVE_AT = PP_STEPS, PP_SAVE_AT
#: mesh_pairs: the MoE LM at MOE_PAR_LAYERS layers, f32, two steps with the
#: gradient tap at each of the reference's other pairs of split axes, in
#: the four-rank world, against ``moe_par``'s one rank.
MESH_PAIRS = {"model_seq": ({"data": 1, "model": 2, "seq": 2}, "tp", "ring"),
              "model_expert": ({"data": 1, "model": 2, "expert": 2}, "tp_moe", "auto"),
              "seq_expert": ({"data": 1, "seq": 2, "expert": 2}, "moe", "ring")}
#: tp_fallback: ViT-Ti (3 heads, 9 layers) at f32 on synthetic 32x32 images,
#: gpt2_tp_rules at ``{"data": 1, "model": 2}`` (3 heads and the ViT's
#: missing TP path: every layer replicated over the model group), AdamW,
#: VIT_TP_STEPS steps of VIT_TP_BATCH images; its step-1 gradients against
#: one rank's within PP_GRAD_TOL of the largest.
VIT_TP_BATCH, VIT_TP_STEPS = 64, 2

#: The jobs of the sync-BN, ring, pipeline and expert phases; the
#: data-parallel worker runs them too (a job with a ``kind``), after its own.
PAR_DEFS = r"""
def model_config(seq_len=1024, **over):
    return dataclasses.replace(TransformerConfig.gpt2_124m(max_seq_len=seq_len), **over)


_INIT = {1024: init_params}


def par_init(seq_len, moe_layers=0):
    # A longer context tiles the 1024 position rows; an MoE job's params are
    # the first layers of the MoE phases' seed-0 draw.
    if moe_layers:
        if "moe" not in _INIT:
            _INIT["moe"] = torch.load(os.path.join(root, "moe_init_params.pt"), map_location="cuda")
        p = dict(_INIT["moe"])
        p["blocks"] = {str(i): p["blocks"][str(i)] for i in range(moe_layers)}
        return map_params(lambda t: t.clone(), p)
    if seq_len not in _INIT:
        p = dict(init_params)
        table = init_params["wpe"]["table"]
        p["wpe"] = {"table": table.repeat(-(-seq_len // 1024), 1)[:seq_len].contiguous()}
        _INIT[seq_len] = p
    return map_params(lambda t: t.clone(), _INIT[seq_len])


ROUTE_FP, ROUTE_ON, _route = [], [False], moe_lib.MoE.route


def routed(moe, params, x):
    # Each routing's top-k ids as an order-sensitive hash, kept on the card.
    gates, top_gates, top_idx = _route(moe, params, x)
    if ROUTE_ON[0]:
        ids = top_idx.reshape(-1).long()
        w = (torch.arange(ids.numel(), device=ids.device) * 2654435761) % 2147483647
        ROUTE_FP.append((ids * w).sum())
    return gates, top_gates, top_idx


moe_lib.MoE.route = routed


FP, FP_ON, draw = {}, [False], keys.dropout_mask


def fingerprint(k, p, shape, dev, split=None):
    # Each draw's mask as an order-free sum of its global indices' hashes
    # over the kept elements; a recompute's draw overwrites its first.
    mask = draw(k, p, shape, dev, split)
    if FP_ON[0]:
        n = int(np.prod(shape))
        if split is None:
            first = keys.shard_offset(n)
            idx = torch.arange(first, first + n, device=dev)
        else:
            idx = keys.global_index(shape, dev, split).reshape(-1)
            first = int(idx[0])
        w = (idx * 2654435761) % 2147483647
        FP[(int(k), int(first), n)] = int((mask.reshape(-1).long() * w).sum())
    return mask


keys.dropout_mask = fingerprint


class ParClock(rt.Capsule):
    def __init__(self):
        super().__init__(priority=10)
        self.module = self.prepared = None
        self.losses, self.stamps, self.waits, self.marks, self.wire = [], [], [], [], []

    def set(self, attrs=None):
        super().set(attrs)
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def launch(self, attrs=None):
        self.prepared = self.module.prepared
        self.losses.append(float(attrs.step_metrics["loss"]))
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        if self.module.grad_sync is not None:
            self.waits.append(self.module.grad_sync.stats["wait_s"])
            self.wire.append(self.module.grad_sync.stats["wire_bytes"])
        self.marks.append((pl.STATS["wait_s"], ra.STATS["wait_s"], coll.STATS["wait_s"],
                           coll.STATS["wire_bytes"], pl.STATS["wire_bytes"]))


def par_whole(prepared, runtime, values):
    # Per param of the whole tree (its order), this rank's value (a model or
    # expert shard gathered whole over its group) or, for another stage's
    # layer, its stage's, broadcast over the pipe group.
    values = list(values)
    for i, v in enumerate(values):
        lay = prepared.layout(i) if prepared.shard_dims is not None else None
        if lay is not None:
            parts = [torch.empty_like(v) for _ in range(lay[1])]
            dist.all_gather(parts, v.contiguous(),
                            group=runtime.axis_group(prepared.shard_axes[i]))
            values[i] = torch.cat(parts, lay[0])
    local = dict(zip(_paths(prepared.state["params"]), values))
    if not prepared.remote:
        return [local[p] for p in _paths(prepared.state["params"])]
    stage_of = {leaf[0]: leaf[3].stage for leaf in prepared.stage_leaves}
    ranks, group = runtime.axis_ranks("pipe"), runtime.axis_group("pipe")
    out = []
    for path in prepared.full_paths:
        if path in stage_of:
            shape = next(leaf[1] for leaf in prepared.stage_leaves if leaf[0] == path)
            buf = (local[path].detach().float().clone() if path in local
                   else torch.empty(shape, dtype=torch.float32, device="cuda"))
            dist.broadcast(buf, src=ranks[stage_of[path]], group=group)
            out.append(buf)
        else:
            out.append(local[path].float())
    return out


class ParTap(rt.Capsule):
    # Before the Module: its first update's (reduced) gradients, whole, flat.
    def __init__(self, path, runtime):
        super().__init__(priority=2000)
        self.module, self.path, self.done, self.rt = None, path, False, runtime

    def launch(self, attrs=None):
        if self.done:
            return
        self.done, module, update = True, self.module, self.module._update

        def tap(leaves, grads, *args, **kw):
            flat = par_whole(module.prepared, self.rt, grads)
            if rank == 0:
                np.save(self.path, torch.cat([g.float().reshape(-1) for g in flat]).cpu().numpy())
            module._update = update
            return update(leaves, grads, *args, **kw)

        module._update = tap


RULES = {"moe": moe_rules, "tp": gpt2_tp_rules, "pipe": pipeline_rules,
         "tp_moe": lambda: combine_rules(moe_rules(), gpt2_tp_rules()),
         "pp_tp": lambda: pipeline_over(gpt2_tp_rules())}


def lm_job(job):
    seq_len = job.get("seq_len", 1024)
    over = dict(scan_layers=job.get("scan_layers", True), attention_impl=job.get("attention", "auto"))
    if job.get("schedule"):
        over.update(pipeline_axis="pipe", pipeline_schedule=job["schedule"],
                    pipeline_microbatches=job.get("m", 4))
    if "dropout" in job:
        over["dropout"] = job["dropout"]
    if job.get("f32"):
        over["activation_dtype"] = "float32"
    moe_layers = job.get("moe_layers", 0)
    if moe_layers:  # bench.py's moe_gpt2_e4 at moe_layers layers
        over.update(num_layers=moe_layers, dropout=0.0, num_experts=4, expert_top_k=2,
                    expert_capacity_factor=1.25, expert_dispatch=job["dispatch"])
    mcfg = model_config(seq_len, **over)
    for key in ("ROCKET_TPU_MOE_GMM", "ROCKET_TPU_OVERLAP_WIRE"):
        os.environ.pop(key, None)
    os.environ.update(job.get("env", {}))
    runtime = rt.Runtime(seed=0, mesh_shape=job.get("mesh"),
                         gradient_accumulation_steps=job.get("accum", 1))
    clock, caps = ParClock(), []
    tap = ParTap(os.path.join(root, job["name"] + "_grads.npy"), runtime) if job.get("tap") else None
    caps += [tap] if tap is not None else []
    caps.append(clock)
    ckpt = None
    if job.get("save_every") or job.get("resume_from"):
        ckpt = rt.Checkpointer(output_dir=os.path.join(root, job["name"] + "_ck"),
                               save_every=job.get("save_every") or 1000,
                               resume_from=job.get("resume_from"))
        caps.append(ckpt)
    data = TokenDataset(tokens % mcfg.vocab_size, seq_len=seq_len)
    rule = job.get("rule") or ("pipe" if job.get("schedule") else None)
    runtime_index = {axis: runtime.axis_index(axis) for axis in runtime.mesh}
    run = gpt2.build(mcfg, data, batch_size=job["batch"], runtime=runtime, steps=job["steps"],
                     record=False, capsules=tuple(caps),
                     param_sharding=RULES[rule]() if rule else None)
    module = clock.module = run["module"]
    runtime.models.add(run["model"], PreparedModule(run["model"],
                                                    {"params": par_init(seq_len, moe_layers)}))
    if tap is not None:
        tap.module = module
    for kernel in (fa.flash_fwd, fa.flash_bwd, fa.flash_dq, gg.gather_gmm_fwd, gm.gmm, gm.tgmm):
        kernel.launches = 0
    pl.reset_stats()
    ra.reset_stats()
    coll.reset_stats()
    FP.clear()
    FP_ON[0] = bool(job.get("masks"))
    ROUTE_FP.clear()
    ROUTE_ON[0] = bool(moe_layers)
    moe_lib.ROWS["total"] = (torch.zeros((), dtype=torch.int64, device="cuda") if moe_layers
                             else None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run["launcher"].launch()
    wall = time.perf_counter() - t0
    FP_ON[0] = ROUTE_ON[0] = False
    prepared = clock.prepared
    leaves = optim.param_leaves(prepared.state["params"])
    marks = [(0.0, 0.0, 0.0, 0, 0)] + clock.marks
    out = {"losses": clock.losses, "step_ms": [1e3 * d for d in np.diff(clock.stamps)],
           "wall_s": wall, "launches": {"flash_fwd": fa.flash_fwd.launches,
                                        "flash_bwd": fa.flash_bwd.launches,
                                        "flash_dq": fa.flash_dq.launches},
           "grad_sync_wait_ms": [1e3 * w for w in clock.waits],
           "pipe_wait_ms": [1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:])],
           "ring_wait_ms": [1e3 * (b[1] - a[1]) for a, b in zip(marks, marks[1:])],
           "coll_wait_ms": [1e3 * (b[2] - a[2]) for a, b in zip(marks, marks[1:])],
           "coll_wire_bytes": [b[3] - a[3] for a, b in zip(marks, marks[1:])],
           "pipe_wire_bytes": [b[4] - a[4] for a, b in zip(marks, marks[1:])],
           "grad_sync_wire_bytes": clock.wire, "coords": runtime_index,
           "replicated_layers": coll.STATS["replicated_layers"],
           "held_bytes": prepared.held_bytes(),
           "coll_calls": coll.STATS["calls"], "expert_index": runtime.axis_index("expert"),
           "pipe": dict(pl.STATS), "ring": dict(ra.STATS), "backend": runtime.backend,
           "world": runtime.process_count, "mesh": runtime.mesh,
           "stage": runtime.axis_index("pipe"), "seq_index": runtime.axis_index("seq"),
           "held_leaves": len(leaves),
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "masks": [[k, first, n, fp] for (k, first, n), fp in FP.items()]}
    if moe_layers:
        out.update(moe_launches={"gather_gmm": gg.gather_gmm_fwd.launches,
                                 "gmm": gm.gmm.launches, "tgmm": gm.tgmm.launches},
                   routing=[int(v) for v in torch.stack(ROUTE_FP).tolist()],
                   routed_rows=(int(moe_lib.ROWS["total"]) if job["dispatch"] == "dropless"
                                else None),
                   expert_param_bytes=sum(t.numel() * t.element_size() for p, t in
                                          zip(_paths(prepared.state["params"]), leaves)
                                          if "experts" in p),
                   moment_bytes=prepared.held_bytes()["moments"])
        moe_lib.ROWS["total"] = None
    for key in job.get("env", {}):
        os.environ.pop(key, None)
    if ckpt is not None:
        out["saves"] = ckpt.save_times
    if job.get("keep_params"):
        kept = list(bridge.gather_params(prepared, runtime).values())
        if rank == 0:
            np.save(os.path.join(root, job["name"] + "_params.npy"),
                    torch.cat([t.detach().float().reshape(-1) for t in kept]).cpu().numpy())
    del run, leaves
    clock.prepared = None
    return out


def cifar_job(job):
    # ResNet-18 with sync-BN over the data ranks; the fused kernels forced,
    # which the two-rank path must not launch.
    os.environ.update(job.get("env", {}))
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = True, False, False
    runtime = rt.Runtime(seed=0)
    rng = np.random.default_rng(0)
    n = job["batch"] * job["steps"]
    images = rng.normal(size=(n, job.get("size", 32), job.get("size", 32), 3)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    model = resnet18(num_classes=10, stem="cifar")
    module = rt.Module(model, [rt.Loss(cifar_resnet.cross_entropy),
                               rt.Optimizer(optim.momentum(0.9), learning_rate=0.05)])
    clock = ParClock()
    clock.module = module
    fc.bn_twopass.launches = fc.bn_normalize.launches = 0
    layers.SYNC_BN_STATS["all_reduces"] = 0
    marks = []

    class Count(rt.Capsule):
        def __init__(self):
            super().__init__(priority=5)

        def launch(self, attrs=None):
            marks.append(layers.SYNC_BN_STATS["all_reduces"])

    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=job["batch"]),
                            module, clock, Count()], tag="train", repeats=job["steps"],
                           progress=False)], runtime=runtime).launch()
    state = clock.prepared.state
    params = optim.param_leaves(state["params"])
    stats = optim.param_leaves(state["model_state"])
    if rank == 0:
        np.save(os.path.join(root, job["name"] + "_params.npy"),
                torch.cat([t.detach().reshape(-1) for t in params]).cpu().numpy())
        np.save(os.path.join(root, job["name"] + "_stats.npy"),
                torch.cat([t.detach().reshape(-1) for t in stats]).cpu().numpy())
    for key in job.get("env", {}):
        os.environ.pop(key, None)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
    return {"losses": clock.losses, "step_ms": [1e3 * d for d in np.diff(clock.stamps)],
            "grad_sync_wait_ms": [1e3 * w for w in clock.waits],
            "all_reduces": marks, "bn_twopass": fc.bn_twopass.launches,
            "bn_normalize": fc.bn_normalize.launches, "world": runtime.process_count,
            "backend": runtime.backend, "stats_sha256": digest(stats),
            "params_sha256": digest(params)}


def vit_job(job):
    # ViT-Ti (3 heads) at f32 on synthetic CIFAR images, under a model axis
    # with gpt2_tp_rules: no TP path, so its model shards are gathered at
    # step entry and the model runs replicated (rows 3-4 on the whole heads).
    runtime = rt.Runtime(seed=0, mesh_shape=job.get("mesh"))
    rng = np.random.default_rng(0)
    n = job["batch"] * job["steps"]
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    model = ViT(32, 4, dim=192, depth=9, num_heads=3)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    runtime.models.add(model, PreparedModule(model, {"params": params}))
    module = rt.Module(model, [rt.Loss(cifar_resnet.cross_entropy),
                               rt.Optimizer(optim.adamw(), learning_rate=1e-3)],
                       param_sharding=gpt2_tp_rules() if job.get("mesh") else None)
    clock = ParClock()
    clock.module = module
    tap = ParTap(os.path.join(root, job["name"] + "_grads.npy"), runtime)
    tap.module = module
    for kernel in (fa.flash_fwd, fa.flash_bwd, fa.flash_dq):
        kernel.launches = 0
    coll.reset_stats()
    rt.Launcher([rt.Looper([rt.Dataset(ArrayDataset(images, labels), batch_size=job["batch"]),
                            tap, module, clock], tag="train", repeats=job["steps"],
                           progress=False)], runtime=runtime).launch()
    prepared = clock.prepared
    return {"losses": clock.losses, "step_ms": [1e3 * d for d in np.diff(clock.stamps)],
            "launches": {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches,
                         "flash_dq": fa.flash_dq.launches},
            "replicated_layers": coll.STATS["replicated_layers"],
            "replicated": coll.STATS.get("replicated", {}), "world": runtime.process_count,
            "backend": runtime.backend, "model_index": runtime.axis_index("model"),
            "model_shards": sum(a == "model" for a in prepared.shard_axes or ()),
            "held_bytes": prepared.held_bytes()}


def par_job(job):
    return {"cifar": cifar_job, "vit": vit_job}.get(job.get("kind"), lm_job)(job)
"""

DP_WORKER = (r"""
import dataclasses, hashlib, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, port, root, job_file = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = json.load(open(job_file))
torch.backends.cuda.matmul.allow_tf32 = False
if cfg["backend"] == "gloo":
    # The caller opens the group; the Runtime adopts it.
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=cfg["world"])
import rocket_tpu_torch as rt
from rocket_tpu_torch import bridge, optim
from rocket_tpu_torch.core.module import PreparedModule, _paths
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.examples import cifar_resnet, gpt2
from rocket_tpu_torch.models.resnet import resnet18
from rocket_tpu_torch.models.transformer import TransformerConfig
from rocket_tpu_torch.models.vit import ViT
from rocket_tpu_torch.nn import keys, layers
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.ops import flash_native as fa
from rocket_tpu_torch.ops import fused_conv as fc
from rocket_tpu_torch.parallel import collectives as coll
from rocket_tpu_torch.parallel import pipeline as pl
import rocket_tpu_torch.parallel.ring_attention  # noqa: F401 (the module, not the function)
ra = sys.modules["rocket_tpu_torch.parallel.ring_attention"]
from rocket_tpu_torch.parallel.sharding import (combine_rules, fsdp_rules, gpt2_tp_rules,
                                                moe_rules, pipeline_over, pipeline_rules)
from rocket_tpu_torch.nn import moe as moe_lib
from rocket_tpu_torch.ops import gather_gmm as gg
from rocket_tpu_torch.ops import grouped_matmul as gm

model_cfg = TransformerConfig.gpt2_124m()
tokens = np.load(os.path.join(root, "tokens.npy"))
data = TokenDataset(tokens % model_cfg.vocab_size, seq_len=model_cfg.max_seq_len)
# Every job of every rank starts from these params: the caller's seed-0 draw
# (GPT-2's CPU-side init takes 10-13 s a process).
init_params = torch.load(os.path.join(root, "init_params.pt"), map_location="cuda")


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


class Clock(rt.Capsule):
    def __init__(self):
        super().__init__(priority=10)
        self.module, self.prepared = None, None
        self.losses, self.stamps, self.waits, self.coll = [], [], [], []

    def set(self, attrs=None):
        super().set(attrs)
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def launch(self, attrs=None):
        self.prepared = self.module.prepared  # the train state, past destroy
        self.losses.append(float(attrs.step_metrics["loss"]))
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        if self.module.grad_sync is not None:
            self.waits.append(self.module.grad_sync.stats["wait_s"])
        # The model group's collectives, cumulative.
        self.coll.append((coll.STATS["wait_s"], coll.STATS["wire_bytes"]))


def whole_grads(module, grads):
    # Under tensor parallelism a rank's gradients are its shards: the
    # model group's shards gathered whole, in param order (every rank calls).
    prepared = module.prepared
    if prepared.shard_axes is None or "model" not in prepared.shard_axes:
        return grads
    out = []
    for i, g in enumerate(grads):
        lay = prepared.layout(i)
        if lay is not None and prepared.shard_axes[i] == "model":
            parts = [torch.empty_like(g) for _ in range(lay[1])]
            dist.all_gather(parts, g.contiguous(), group=module._runtime.axis_group("model"))
            g = torch.cat(parts, lay[0])
        out.append(g)
    return out


class GradTap(rt.Capsule):
    # Before the Module: its first update's (reduced) gradients, saved flat.
    def __init__(self, path):
        super().__init__(priority=2000)
        self.module, self.path, self.done = None, path, False

    def launch(self, attrs=None):
        if self.done:
            return
        self.done, module, update = True, self.module, self.module._update

        def tap(leaves, grads, *args, **kw):
            whole = whole_grads(module, grads)
            if rank == 0:
                np.save(self.path, torch.cat([g.float().reshape(-1) for g in whole]).cpu().numpy())
            module._update = update
            return update(leaves, grads, *args, **kw)

        module._update = tap


""" + PAR_DEFS + r"""
# A world started while another runs waits here, its start-up done, until
# the world before it has finished (its gate file appears).
while cfg.get("gate") and not os.path.exists(cfg["gate"]):
    time.sleep(0.2)
results = {"rank": rank, "jobs": {}}
if cfg.get("probe"):
    # Does this backend take FSDP's collectives on CUDA tensors?
    try:
        x = torch.ones(4 * cfg["world"], device="cuda")
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.all_gather_into_tensor(torch.empty(4 * cfg["world"], device="cuda"),
                                    torch.ones(4, device="cuda"))
        torch.cuda.synchronize()
        results["probe"] = "ok"
    except (RuntimeError, NotImplementedError) as exc:
        results["probe"] = repr(exc)[:300]
for job in cfg["jobs"]:
    # A job that reads another world's output waits for that world's results.
    while any(not os.path.exists(path) for path in job.get("after", ())):
        time.sleep(0.2)
    if rank == 0:  # the caller starts the next world at a given job
        with open(os.path.join(root, f"{cfg['tag']}_progress"), "a") as f:
            f.write(job["name"] + "\n")
    if job.get("kind"):
        results["jobs"][job["name"]] = par_job(job)
        torch.cuda.empty_cache()
        continue
    if job.get("needs_probe") and results.get("probe") != "ok":
        continue
    for key in ("ROCKET_TPU_OVERLAP", "ROCKET_TPU_OVERLAP_WIRE"):
        os.environ.pop(key, None)
    os.environ.update(job.get("env", {}))
    runtime = rt.Runtime(seed=0, strict=job.get("strict", False), mesh_shape=job.get("mesh"))
    coll.reset_stats()
    clock, caps = Clock(), []
    tap = GradTap(os.path.join(root, job["name"] + "_grads.npy")) if job.get("tap") else None
    caps += [tap] if tap is not None else []
    caps.append(clock)
    ckpt = None
    if job.get("save_every") or job.get("resume_from"):
        ckpt = rt.Checkpointer(output_dir=os.path.join(root, job["name"] + "_ck"),
                               save_every=job.get("save_every") or 1000,
                               resume_from=job.get("resume_from"))
        caps.append(ckpt)
    job_cfg = model_cfg
    if job.get("activation_dtype"):
        job_cfg = dataclasses.replace(model_cfg, activation_dtype=job["activation_dtype"])
    run = gpt2.build(job_cfg, data, batch_size=8, runtime=runtime, steps=job["steps"],
                     record=False, capsules=tuple(caps), grad_sync=job.get("grad_sync", "auto"),
                     grad_wire_dtype=job.get("wire", "bfloat16"),
                     param_sharding=gpt2_tp_rules() if job.get("tp") else
                     fsdp_rules() if job.get("fsdp") else None)
    module = clock.module = run["module"]
    runtime.models.add(run["model"], PreparedModule(
        run["model"], {"params": map_params(lambda t: t.clone(), init_params)}))
    if tap is not None:
        tap.module = module
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = fa.flash_bwd.launches = fa.flash_dq.launches = 0
    t0 = time.perf_counter()
    run["launcher"].launch()
    wall = time.perf_counter() - t0
    leaves = optim.param_leaves(clock.prepared.state["params"])
    out = {"losses": clock.losses, "step_ms": [1e3 * d for d in np.diff(clock.stamps)],
           "wall_s": wall, "launches": {"flash_fwd": fa.flash_fwd.launches,
                                        "flash_bwd": fa.flash_bwd.launches,
                                        "flash_dq": fa.flash_dq.launches},
           "wait_ms": [1e3 * w for w in clock.waits], "backend": runtime.backend,
           "world": runtime.process_count, "device_mesh": str(runtime.device_mesh),
           "params_sha256": digest(leaves), "sharded": clock.prepared.sharded(),
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "moment_bytes": sum(v.numel() * v.element_size()
                               for st in clock.prepared.state["optimizer"].state.values()
                               for v in st.values() if v.dim() > 0),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if module.grad_sync is not None:
        out["buckets"] = module.grad_sync.stats["buckets"]
        out["wire_bytes_per_step"] = module.grad_sync.stats["wire_bytes"]
        if tap is not None:  # the leaves of each bucket, in the tapped order
            out["plan"] = module.grad_sync.units
            out["sizes"] = [t.numel() for t in leaves]
    if ckpt is not None:
        out["saves"] = ckpt.save_times
    if job.get("tp"):
        cum = [(0.0, 0)] + clock.coll
        out.update(coll_calls=coll.STATS["calls"], staged=coll.STATS["staged"],
                   coll_wait_ms=[1e3 * (b[0] - a[0]) for a, b in zip(cum, cum[1:])],
                   coll_wire_bytes=[b[1] - a[1] for a, b in zip(cum, cum[1:])],
                   model_index=runtime.axis_index("model"),
                   replicated_sha256=digest([t for i, t in enumerate(leaves)
                                             if clock.prepared.layout(i) is None]),
                   replicated_leaves=sum(clock.prepared.layout(i) is None
                                         for i in range(len(leaves))),
                   replicated_layers=coll.STATS["replicated_layers"])
    if job.get("keep_params"):
        kept = leaves
        if job.get("tp"):  # the whole params, gathered on every rank
            kept = list(bridge.gather_params(clock.prepared, runtime).values())
        if rank == 0:
            np.save(os.path.join(root, job["name"] + "_params.npy"),
                    torch.cat([t.detach().reshape(-1) for t in kept]).cpu().numpy())
    results["jobs"][job["name"]] = out
    del run, leaves
    clock.prepared = None
    torch.cuda.empty_cache()
json.dump(results, open(os.path.join(root, f"{cfg['tag']}_rank{rank}.json"), "w"))
if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()
""")


def _start_ranks(root: Path, tag: str, jobs: list, world: int, backend: str,
                 probe: bool = False, gate=None) -> dict:
    """Start :data:`DP_WORKER`'s ``jobs`` as ``world`` processes on the card:
    ``backend`` "gloo" (the caller opens the group, the Runtimes adopt it),
    "env" (the launcher's environment, the Runtime opens NCCL) or "none"
    (one process, no group). With ``gate`` the processes import, load the
    params (and open their group), then wait until the file ``gate``
    exists before their first job: a world started while another runs
    does its start-up then and none of its jobs. :func:`_wait_ranks`
    collects them."""
    worker = root / f"{tag}_worker.py"
    worker.write_text(DP_WORKER)
    job_file = root / f"{tag}.json"
    job_file.write_text(json.dumps({"world": world, "backend": backend, "probe": probe,
                                    "jobs": jobs, "tag": tag,
                                    "gate": None if gate is None else str(gate)}))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("ROCKET_TPU_STRICT", None)
    procs = []
    for r in range(world):
        renv = dict(env)
        if backend == "env":
            renv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                        RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, str(worker), str(r), str(port), str(root),
                                       str(job_file)], env=renv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return {"tag": tag, "world": world, "procs": procs}


def _reach(root: Path, started: dict, job: str, timeout: float = 600.0) -> None:
    """Wait until the world ``started`` begins ``job`` (or one of its
    processes has exited)."""
    progress = root / f"{started['tag']}_progress"
    t0 = time.time()
    while time.time() - t0 < timeout:
        if progress.exists() and job in progress.read_text().split():
            return
        if any(proc.poll() is not None for proc in started["procs"]):
            return
        time.sleep(0.5)


def _stop_ranks(started: dict) -> None:
    for proc in started["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _wait_ranks(root: Path, started: dict, timeout: float = 600.0) -> list:
    """Each rank's results of a world :func:`_start_ranks` started; each
    rank's output goes to ``dp_<tag>_rank<r>.log`` in the output
    directory."""
    tag, world, procs = started["tag"], started["world"], started["procs"]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        _stop_ranks(started)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for r, text in enumerate(outs):
        (out_dir / f"dp_{tag}_rank{r}.log").write_text(text)
    for r, (proc, text) in enumerate(zip(procs, outs)):
        require(proc.returncode == 0, f"dp {tag}: rank {r} exited {proc.returncode}: "
                f"{text[-2000:]}")
    results = [json.loads((root / f"{tag}_rank{r}.json").read_text()) for r in range(world)]
    for r, result in enumerate(results):
        (out_dir / f"dp_{tag}_rank{r}.json").write_text(json.dumps(result))
    return results


def _dp_ranks(root: Path, tag: str, jobs: list, world: int, backend: str,
              probe: bool = False, timeout: float = 600.0) -> list:
    """:func:`_start_ranks` and :func:`_wait_ranks` in one."""
    return _wait_ranks(root, _start_ranks(root, tag, jobs, world, backend, probe), timeout)


def _dp_launches_ok(job, layers: int, steps: int) -> bool:
    return job["launches"] == {"flash_fwd": 2 * layers * steps, "flash_bwd": layers * steps,
                               "flash_dq": 0}


def dp_phases(card):
    """The data-parallel slice on the card (module docstring): ``dp_train``,
    ``dp_checkpoint``, ``dp_fsdp`` and ``dp_launch``. GPT-2 124M at full
    width (B=8 global, T=1024, bf16, remat, dropout 0.1, AdamW): two ranks
    sharing the card over a gloo group the caller opens, against one rank
    at B=8 in a process of its own."""
    cfg = TransformerConfig.gpt2_124m()
    layers, steps = cfg.num_layers, DP_STEPS
    root = Path(tempfile.mkdtemp(prefix="dp_"))
    worlds: list = []
    try:
        text = _text(2_000_000)  # examples.gpt2.corpus's text
        np.save(root / "tokens.npy", CharTokenizer(text).encode(text))
        torch.save(map_params(lambda t: t.cpu(), _drawn_params(cfg)), root / "init_params.pt")
        torch.save(map_params(lambda t: t.cpu(), _drawn_params(moe_config())),
                   root / "moe_init_params.pt")
        dp_job = {"name": "dp", "steps": steps, "grad_sync": "bucketed",
                  "save_every": DP_SAVE_AT, "keep_params": True}
        # The step-1 gradients: f32 compute and wire, so the two sides
        # differ only in the batch split and the reduction; then the same
        # step on the bf16 wire, held to the f32 wire's bucket by bucket.
        f32_job = {"name": "dp_f32", "steps": 2, "tap": True, "activation_dtype": "float32",
                   "grad_sync": "bucketed", "wire": None}
        wire_job = {"name": "dp_wire", "steps": 2, "tap": True, "activation_dtype": "float32",
                    "grad_sync": "bucketed"}
        fsdp_job = {"name": "fsdp", "steps": steps, "fsdp": True, "needs_probe": True}
        # The tensor-parallel, pipeline, ring and sync-BN jobs run on the same
        # two processes.
        par_two, par_one = par_jobs(root)
        # Three worlds: the two ranks, four (dp x tp x pp and the other pairs
        # of split axes) and one rank (which resumes their checkpoints). The
        # two ranks run their f32 taps last, whose seconds no phase reports;
        # the later worlds start when the first tap does. The one rank runs
        # its jobs beside the taps and then the four ranks (its resume of
        # their checkpoint waits for their results); the four wait at a gate
        # for the two, so their start-up overlaps the taps.
        two = [dp_job, f32_job, wire_job, fsdp_job, *TP_JOBS, *par_two]
        two = [j for j in two if not j.get("tap")] + [j for j in two if j.get("tap")]
        gloo2 = _start_ranks(root, "gloo2", two, 2, "gloo", probe=True)
        worlds.append(gloo2)
        _reach(root, gloo2, next(j["name"] for j in two if j.get("tap")))
        gloo4 = _start_ranks(root, "gloo4", mesh_jobs(), 4, "gloo", gate=root / "gate")
        worlds.append(gloo4)
        for job in par_one:
            if job["name"] == "tp_pp_one_resumed":
                job["after"] = [str(root / f"gloo4_rank{r}.json") for r in range(4)]
        one_world = _start_ranks(root, "one", [
            {"name": "one", "steps": steps},
            {"name": "one_f32", "steps": 2, "tap": True, "activation_dtype": "float32"},
            {"name": "one_resumed", "steps": steps, "keep_params": True,
             "resume_from": str(root / "dp_ck" / str(DP_SAVE_AT))},
            {"name": "one_tp_resumed", "steps": steps, "keep_params": True,
             "resume_from": str(root / "tp_ck" / str(DP_SAVE_AT))}, *par_one], 1,
            "none")
        worlds.append(one_world)
        ranks = _wait_ranks(root, gloo2)
        (root / "gate").touch()
        ranks4 = _wait_ranks(root, gloo4)
        one = _wait_ranks(root, one_world)[0]["jobs"]
        ref = one["one"]
        # -- dp_train: the record first, then its checks.
        dp = [r["jobs"]["dp"] for r in ranks]
        two_g = np.load(root / "dp_f32_grads.npy")
        one_g = np.load(root / "one_f32_grads.npy")
        grad_err = float(np.abs(two_g - one_g).max() / np.abs(one_g).max())
        wire_g = np.load(root / "dp_wire_grads.npy").astype(np.float64)
        wire = ranks[0]["jobs"]["dp_wire"]
        ends = np.cumsum([0] + wire["sizes"])
        wire_sum_err, wire_err = [], []
        for unit in wire["plan"]:
            idx = np.concatenate([np.arange(ends[i], ends[i + 1]) for i in unit])
            got, want = wire_g[idx], two_g[idx].astype(np.float64)
            wire_sum_err.append(float(abs(got.sum() - want.sum()) / np.abs(want).sum()))
            wire_err.append(float(np.abs(got - want).max() / np.abs(want).max()))
        gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in dp]
        emit("dp_train", model="gpt2_124m", dtype="bfloat16", batch=8, batch_per_rank=4,
             seq_len=cfg.max_seq_len, steps=steps, ranks=2, backend=dp[0]["backend"],
             device_mesh=dp[0]["device_mesh"], grad_sync="bucketed", wire="bfloat16",
             losses=dp[0]["losses"], one_rank_losses=ref["losses"], loss_gap_per_rank=gaps,
             step_ms_median_per_rank=[float(np.median(j["step_ms"][1:])) for j in dp],
             step_ms_per_rank=[j["step_ms"] for j in dp],
             one_rank_step_ms_median=float(np.median(ref["step_ms"][1:])),
             train_step_ms_median=RECORD["train"][0]["step_ms_median"] if "train" in RECORD
             else None, buckets=dp[0].get("buckets"),
             wire_bytes_per_step=dp[0].get("wire_bytes_per_step"),
             wait_ms_median_per_rank=[float(np.median(j["wait_ms"][1:])) for j in dp],
             step1_grad_err_f32=grad_err, step1_wire_buckets=len(wire["plan"]),
             step1_wire_bucket_sum_err_max=max(wire_sum_err),
             step1_wire_grad_err_max=max(wire_err),
             params_sha256=[j["params_sha256"] for j in dp],
             launches_per_rank=[j["launches"] for j in dp], one_rank_launches=ref["launches"],
             peak_memory_gb_per_rank=[j["peak_memory_gb"] for j in dp], card=card)
        for r, job in enumerate(dp):
            require(job["backend"] == "gloo" and job["world"] == 2,
                    f"dp_train: rank {r} ran on {job['backend']} x {job['world']}")
            require(_dp_launches_ok(job, layers, steps),
                    f"dp_train: rank {r} launches {job['launches']} over {steps} steps")
            require(len(job["losses"]) == steps and gaps[r] <= DP_LOSS_TOL,
                    f"dp_train: rank {r} losses {job['losses']} vs one rank {ref['losses']}")
        require(dp[0]["params_sha256"] == dp[1]["params_sha256"],
                "dp_train: the ranks' end params differ")
        require(_dp_launches_ok(ref, layers, steps), f"dp_train: one rank launches {ref['launches']}")
        require(grad_err <= DP_GRAD_TOL, f"dp_train: step-1 gradients {grad_err} of the largest")
        require(len(wire["plan"]) == dp[0]["buckets"] and max(wire_sum_err) <= DP_WIRE_SUM_TOL,
                f"dp_train: bf16-wire bucket sums {max(wire_sum_err)} of their mass apart "
                f"from the f32 wire's over {len(wire['plan'])} buckets")
        require(max(wire_err) <= DP_WIRE_TOL and not np.array_equal(wire_g, two_g),
                f"dp_train: bf16-wire gradients {max(wire_err)} of their bucket's largest "
                "from the f32 wire's (or not rounded)")
        # -- dp_checkpoint
        resumed = one["one_resumed"]
        tail = dp[0]["losses"][DP_SAVE_AT:]
        param_gap = float(np.abs(np.load(root / "one_resumed_params.npy")
                                 - np.load(root / "dp_params.npy")).max())
        files = sorted(os.listdir(root / "dp_ck" / str(DP_SAVE_AT) / "model_0"))
        emit("dp_checkpoint", saved_at=DP_SAVE_AT, ranks_saving=2, ranks_resuming=1,
             files=files, write_s_per_rank=[[s.get("write_s") for s in j["saves"]] for j in dp],
             snapshot_s_per_rank=[[s["snapshot_s"] for s in j["saves"]] for j in dp],
             bytes_per_rank=[[s["shard_bytes"] for s in j["saves"]] for j in dp],
             resumed_losses=resumed["losses"], uninterrupted_losses=tail,
             end_param_max_abs_gap=param_gap, card=card)
        require(files == ["index.json", "shard_p0.npz", "shard_p1.npz"],
                f"dp_checkpoint: {files}")
        require(len(resumed["losses"]) == steps - DP_SAVE_AT
                and max(abs(a - b) for a, b in zip(resumed["losses"], tail)) <= DP_LOSS_TOL,
                f"dp_checkpoint: resumed losses {resumed['losses']} vs {tail}")
        require(param_gap <= DP_PARAM_TOL, f"dp_checkpoint: end params {param_gap} apart")
        # -- dp_fsdp
        probe = ranks[0].get("probe")
        if probe == "ok":
            fsdp = [r["jobs"]["fsdp"] for r in ranks]
        else:
            fsdp = [r["jobs"]["fsdp"] for r in _dp_ranks(
                root, "nccl1", [{**fsdp_job, "needs_probe": False}], 1, "env")]
        whole = ref["param_bytes"]
        gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in fsdp]
        emit("dp_fsdp", ranks=len(fsdp), backend=fsdp[0]["backend"], gloo_cuda_probe=probe,
             loss_gap_per_rank=gaps,
             losses=fsdp[0]["losses"], one_rank_losses=ref["losses"],
             param_bytes_per_rank=[j["param_bytes"] for j in fsdp],
             moment_bytes_per_rank=[j["moment_bytes"] for j in fsdp], whole_param_bytes=whole,
             step_ms_median_per_rank=[float(np.median(j["step_ms"][1:])) for j in fsdp],
             wire_bytes_per_step=fsdp[0].get("wire_bytes_per_step"),
             wait_ms_median_per_rank=[float(np.median(j["wait_ms"][1:])) if j["wait_ms"]
                                      else None for j in fsdp],
             launches_per_rank=[j["launches"] for j in fsdp], card=card)
        for job, gap in zip(fsdp, gaps):
            require(_dp_launches_ok(job, layers, steps), f"dp_fsdp: launches {job['launches']}")
            require(gap <= DP_LOSS_TOL, f"dp_fsdp: losses {job['losses']} vs {ref['losses']}")
        require(all(j["param_bytes"] < whole for j in fsdp) if len(fsdp) > 1
                else fsdp[0]["param_bytes"] == whole, f"dp_fsdp: shard bytes "
                f"{[j['param_bytes'] for j in fsdp]} of {whole}")
        tp_phases(root, ranks, one, card)
        # Sync-BN, ring attention and the pipeline.
        pp_phases(root, ranks, one, card)
        ring_phase(root, ranks, one, card)
        dp_cifar_phase(root, ranks, one, card)
        # Expert parallelism and the MoE under the model, seq and pipe axes.
        ep_phases(root, ranks, one, card)
        # The flash seams on a seq-sharded batch, the replicated program over
        # the model group, dp x tp x pp and the other pairs of split axes.
        seq_flash_phase(root, ranks, one, card)
        tp_fallback_phase(root, ranks, one, card)
        tp_pp_phases(root, ranks4, one, card)
        mesh_pairs_phase(root, ranks4, one, card)
        # -- dp_launch, with the pipeline and long-context examples beside it
        examples = examples_par_start(root)
        dp_launch_phase(root, card)
        examples_par_phase(examples, card)
    finally:
        for started in worlds:  # a world left waiting at its gate by a failure
            _stop_ranks(started)
        shutil.rmtree(root, ignore_errors=True)


#: The tensor-parallel jobs of the two gloo ranks, at ``{"data": 1,
#: "model": 2}`` under ``gpt2_tp_rules()``: ``tp`` (the DP_STEPS steps of
#: ``dp_train``'s tree, a save at step 4, the whole params kept), ``tp_f32``
#: (step 1 at f32 compute and the f32 wire, its gradients tapped whole) and
#: ``tp_wire`` (the same on the default bf16 wire).
TP_MESH = {"data": 1, "model": 2}
TP_JOBS = [
    {"name": "tp", "steps": DP_STEPS, "tp": True, "mesh": TP_MESH, "save_every": DP_SAVE_AT,
     "keep_params": True},
    {"name": "tp_f32", "steps": 2, "tp": True, "mesh": TP_MESH, "tap": True,
     "activation_dtype": "float32", "env": {"ROCKET_TPU_OVERLAP_WIRE": "fp32"}},
    {"name": "tp_wire", "steps": 2, "tp": True, "mesh": TP_MESH, "tap": True,
     "activation_dtype": "float32"},
]


def _tp_param_bytes(cfg) -> int:
    """A rank's param bytes at ``--model-axis 2`` under ``gpt2_tp_rules``:
    the blocks' QKV, MLP-in (kernels and biases) and the two row-parallel
    kernels halve; ``wte`` stays whole where the vocab does not divide."""
    d, h = cfg.dim, cfg.mlp_ratio * cfg.dim
    whole = (cfg.vocab_size + cfg.max_seq_len) * d + 2 * d + cfg.num_layers * (
        4 * d + 3 * d * d + 3 * d + d * d + d + 2 * d * h + h + d)
    split = cfg.num_layers * (3 * d * d + 3 * d + d * d + 2 * d * h + h)
    if cfg.vocab_size % 2 == 0:
        split += cfg.vocab_size * d
    return 4 * (whole - split // 2)


def tp_phases(root: Path, ranks: list, one: dict, card) -> None:
    """``tp_train`` and ``tp_checkpoint``: GPT-2 124M at full width (B=8,
    T=1024, bf16, remat, dropout 0.1, AdamW) on two ranks sharing the card
    over gloo at ``{"data": 1, "model": 2}`` (each rank 6 of the 12 heads,
    half the blocks' projections, the residual stream sequence-sharded),
    against the one-rank jobs of ``dp_phases``."""
    cfg = TransformerConfig.gpt2_124m()
    layers, steps = cfg.num_layers, DP_STEPS
    ref = one["one"]
    tp = [r["jobs"]["tp"] for r in ranks]
    f32_g = np.load(root / "tp_f32_grads.npy")
    one_g = np.load(root / "one_f32_grads.npy")
    grad_err = float(np.abs(f32_g - one_g).max() / np.abs(one_g).max())
    wire_g = np.load(root / "tp_wire_grads.npy")
    wire_err = float(np.abs(wire_g - f32_g).max() / np.abs(f32_g).max())
    gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in tp]
    per_step = {name: {mode: n / steps for mode, n in modes.items()}
                for name, modes in tp[0]["coll_calls"].items()}
    want_bytes = _tp_param_bytes(cfg)
    emit("tp_train", model="gpt2_124m", dtype="bfloat16", batch=8, seq_len=cfg.max_seq_len,
         steps=steps, ranks=2, mesh=TP_MESH, backend=tp[0]["backend"],
         heads_per_rank=cfg.num_heads // 2, losses=tp[0]["losses"],
         one_rank_losses=ref["losses"], loss_gap_per_rank=gaps,
         step_ms_median_per_rank=[float(np.median(j["step_ms"][1:])) for j in tp],
         step_ms_spread_per_rank=[[float(min(j["step_ms"][1:])), float(max(j["step_ms"][1:]))]
                                  for j in tp],
         step_ms_per_rank=[j["step_ms"] for j in tp],
         one_rank_step_ms_median=float(np.median(ref["step_ms"][1:])),
         coll_wait_ms_median_per_rank=[float(np.median(j["coll_wait_ms"][1:])) for j in tp],
         grad_sync_wait_ms_median_per_rank=[float(np.median(j["wait_ms"][1:])) for j in tp],
         coll_wire_bytes_per_step_per_rank=[int(np.median(j["coll_wire_bytes"][1:]))
                                            for j in tp],
         grad_sync_wire_bytes_per_step=tp[0].get("wire_bytes_per_step"),
         calls_per_step=per_step, ring_hops_staged_through_host=tp[0]["staged"],
         param_bytes_per_rank=[j["param_bytes"] for j in tp], expected_param_bytes=want_bytes,
         whole_param_bytes=ref["param_bytes"],
         replicated_leaves=tp[0]["replicated_leaves"],
         replicated_layers_per_rank=[j["replicated_layers"] for j in tp],
         replicated_sha256=[j["replicated_sha256"] for j in tp],
         step1_grad_err_f32=grad_err, step1_wire_vs_f32_grad_err=wire_err,
         launches_per_rank=[j["launches"] for j in tp], one_rank_launches=ref["launches"],
         peak_memory_gb_per_rank=[j["peak_memory_gb"] for j in tp], card=card)
    for r, job in enumerate(tp):
        require(job["backend"] == "gloo" and job["world"] == 2 and job["model_index"] == r,
                f"tp_train: rank {r} ran on {job['backend']} x {job['world']}")
        require(_dp_launches_ok(job, layers, steps),
                f"tp_train: rank {r} launches {job['launches']} over {steps} steps")
        require(len(job["losses"]) == steps and gaps[r] <= DP_LOSS_TOL,
                f"tp_train: rank {r} losses {job['losses']} vs one rank {ref['losses']}")
        require(job["param_bytes"] == want_bytes,
                f"tp_train: rank {r} holds {job['param_bytes']} param bytes, not {want_bytes}")
    require(tp[0]["replicated_sha256"] == tp[1]["replicated_sha256"],
            "tp_train: the model group's replicated leaves differ across the ranks")
    require(all(j["replicated_layers"] == 0 for j in tp),
            f"tp_train: layers ran the replicated program: "
            f"{[j['replicated_layers'] for j in tp]}")
    require(all(modes["ring"] > 0 for name, modes in per_step.items()
                if name in ("all_gather_matmul", "matmul_reduce_scatter")),
            f"tp_train: the collective matmuls never took the ring: {per_step}")
    require(grad_err <= DP_GRAD_TOL, f"tp_train: step-1 gradients {grad_err} of the largest")
    require(wire_err <= TP_WIRE_TOL and not np.array_equal(wire_g, f32_g),
            f"tp_train: bf16-wire gradients {wire_err} of the largest from the f32 wire's "
            "(or not rounded)")
    # -- tp_checkpoint
    resumed = one["one_tp_resumed"]
    tail = tp[0]["losses"][DP_SAVE_AT:]
    param_gap = float(np.abs(np.load(root / "one_tp_resumed_params.npy")
                             - np.load(root / "tp_params.npy")).max())
    files = sorted(os.listdir(root / "tp_ck" / str(DP_SAVE_AT) / "model_0"))
    emit("tp_checkpoint", saved_at=DP_SAVE_AT, ranks_saving=2, ranks_resuming=1, files=files,
         write_s_per_rank=[[s.get("write_s") for s in j["saves"]] for j in tp],
         bytes_per_rank=[[s["shard_bytes"] for s in j["saves"]] for j in tp],
         resumed_losses=resumed["losses"], uninterrupted_losses=tail,
         end_param_max_abs_gap=param_gap, card=card)
    require(files == ["index.json", "shard_p0.npz", "shard_p1.npz"], f"tp_checkpoint: {files}")
    require(len(resumed["losses"]) == steps - DP_SAVE_AT
            and max(abs(a - b) for a, b in zip(resumed["losses"], tail)) <= DP_LOSS_TOL,
            f"tp_checkpoint: resumed losses {resumed['losses']} vs {tail}")
    require(param_gap <= DP_PARAM_TOL, f"tp_checkpoint: end params {param_gap} apart")


def dp_launch_phase(root: Path, card):
    """``python -m rocket_tpu_torch.launch -n 1`` on ``examples/gpt2.py``
    (``--small``, T=1024, B=256: the corpus's 7 steps) under
    ``ROCKET_TPU_STRICT=1``: the worker's Runtime opens an NCCL group of
    one from the launcher's environment (NCCL's own log says so), and every
    wave after the first runs strict-clean (a violation raises)."""
    work = root / "launch"
    work.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "ROCKET_TPU_STRICT": "1", "NCCL_DEBUG": "INFO"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rocket_tpu_torch.launch", "-n", "1",
                           str(ROOT / "rocket_tpu_torch" / "examples" / "gpt2.py"), "--small",
                           "--seq-len", "1024", "--batch", "256", "--data-axis", "1"],
                          cwd=work, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    (ROOT / "chiprun_out" / "dp_launch.log").write_text(text)
    require(proc.returncode == 0, f"dp_launch: exit {proc.returncode}: {text[-2000:]}")
    require("NCCL INFO" in text, "dp_launch: no NCCL group was opened")
    lines = [json.loads(x) for x in (work / "runs" / "gpt2.jsonl").read_text().splitlines()]
    losses = [x["train/loss"] for x in lines if "train/loss" in x]
    require(losses and all(math.isfinite(x) for x in losses), f"dp_launch: losses {losses}")
    emit("dp_launch", nproc=1, backend="nccl", strict=True, steps=len(losses), losses=losses,
         wall_s=wall, card=card)





def _masks_by_key(jobs) -> dict:
    """The fingerprints of the ranks' dropout draws, each draw once (by
    key, first global index and size), summed per key."""
    draws = {}
    for job in jobs:
        for k, first, n, fp in job["masks"]:
            draws[(k, first, n)] = fp
    out: dict = {}
    for (k, _, _), fp in draws.items():
        out[k] = out.get(k, 0) + fp
    return out


def _median(values) -> float:
    return float(np.median(values[1:] if len(values) > 1 else values))


def par_jobs(root: Path) -> tuple:
    """The sync-BN, ring, pipeline and expert jobs (module docstring):
    ``(two-rank jobs, one-rank jobs)``, run by the data-parallel workers
    after their own. ``pp_*``: GPT-2 124M over two pipeline stages under
    each schedule, the f32 step-1 taps with the dropout masks'
    fingerprints, the peak-memory jobs at M = 8; ``ring``: T = 4096 over
    two seq ranks, and its f32 step-1 tap; ``dp_cifar``: ResNet-18 with
    sync-BN; ``ep_*``: the MoE LM over two expert ranks, both dispatches,
    a save, the f32 step-1 tap; ``moe_*_f32``: the MoE LM under the model,
    seq and pipe axes; each against its one-rank job."""
    lm = {"kind": "lm"}
    pp = {**lm, "mesh": PP_MESH, "batch": 8, "m": PP_M}
    # The peak at M = 4 is the 8-step runs'; these hold the microbatch at 2
    # rows at M = 8.
    mem = [{**lm, "name": f"pp_mem_{s}_m8", "schedule": s, "steps": 2, "mesh": PP_MESH,
            "batch": PP_MB_ROWS * 8, "m": 8} for s in ("gpipe", "1f1b")]
    cifar = {"kind": "cifar", "batch": CIFAR_DP_BATCH, "steps": CIFAR_DP_STEPS,
             "env": {"ROCKET_TPU_FUSED_CONV": "pallas"}}
    ring = {**lm, "scan_layers": False, "dropout": 0.0, "seq_len": RING_T, "batch": RING_B,
            "steps": RING_STEPS}
    two = [{**pp, "name": "pp_gpipe", "schedule": "gpipe", "steps": PP_STEPS,
            "save_every": PP_SAVE_AT, "keep_params": True},
           {**pp, "name": "pp_1f1b", "schedule": "1f1b", "steps": PP_STEPS},
           *[{**pp, "name": f"pp_{s}_f32", "schedule": s, "steps": 2, "f32": True, "tap": True,
              "masks": True} for s in ("gpipe", "1f1b")],
           *mem,
           {**ring, "name": "ring", "attention": "ring", "mesh": RING_MESH},
           {**ring, "name": "ring_f32", "attention": "ring", "mesh": RING_MESH, "steps": 2,
            "f32": True, "tap": True},
           # A non-ring impl on the seq-sharded batch: each attention gathers
           # the sequence and runs rows 3-5 whole on both seq ranks.
           {**ring, "name": "seq_flash", "attention": "auto", "mesh": RING_MESH},
           {**ring, "name": "seq_flash_f32", "attention": "auto", "mesh": RING_MESH, "steps": 2,
            "f32": True, "tap": True},
           {"kind": "vit", "name": "tp_fallback", "mesh": TP_MESH, "batch": VIT_TP_BATCH,
            "steps": VIT_TP_STEPS},
           {**cifar, "name": "dp_cifar"}]
    moe = {**lm, "moe_layers": MOE_LAYERS, "batch": 8, "dispatch": "dropless",
           "env": {"ROCKET_TPU_MOE_GMM": "fused"}}
    ep = {**moe, "mesh": EP_MESH, "rule": "moe"}
    par = {**moe, "moe_layers": MOE_PAR_LAYERS, "steps": 2, "f32": True, "tap": True}
    two += [{**ep, "name": "ep_dropless", "steps": EP_STEPS, "save_every": EP_SAVE_AT,
             "keep_params": True},
            {**ep, "name": "ep_einsum", "dispatch": "einsum", "env": {}, "steps": EP_STEPS},
            {**ep, "name": "ep_f32", "steps": 2, "f32": True, "tap": True},
            {**par, "name": "moe_tp_f32", "mesh": TP_MESH, "rule": "tp",
             "env": {**moe["env"], "ROCKET_TPU_OVERLAP_WIRE": "fp32"}},
            {**par, "name": "moe_seq_f32", "mesh": RING_MESH, "attention": "ring"},
            {**par, "name": "moe_pipe_f32", "mesh": PP_MESH, "schedule": "gpipe", "m": PP_M}]
    one = [{**moe, "name": "ep_one_dropless", "steps": EP_STEPS},
           {**moe, "name": "ep_one_einsum", "dispatch": "einsum", "env": {}, "steps": EP_STEPS},
           {**moe, "name": "ep_one_f32", "steps": 2, "f32": True, "tap": True},
           {**moe, "name": "ep_one_resumed", "steps": EP_STEPS, "keep_params": True,
            "resume_from": str(root / "ep_dropless_ck" / str(EP_SAVE_AT))},
           {**par, "name": "moe_one_f32"},
           {**par, "name": "moe_one_micro_f32", "batch": PP_MB_ROWS, "accum": PP_M,
            "steps": 2 * PP_M}]
    one += [{**lm, "name": "pp_one", "batch": 8, "steps": PP_STEPS},
           {**lm, "name": "pp_one_f32", "batch": 8, "steps": 2, "f32": True, "tap": True,
            "masks": True},
           {**lm, "name": "pp_one_resumed", "batch": 8, "steps": PP_STEPS, "keep_params": True,
            "resume_from": str(root / "pp_gpipe_ck" / str(PP_SAVE_AT))},
           {**ring, "name": "ring_one", "attention": "auto"},
           {**ring, "name": "ring_one_f32", "attention": "plain", "steps": 2, "f32": True,
            "tap": True},
           {**cifar, "name": "cifar_one"},
           {"kind": "vit", "name": "vit_one", "batch": VIT_TP_BATCH, "steps": VIT_TP_STEPS},
           {**lm, "name": "tp_pp_one_resumed", "batch": 8, "steps": TP_PP_STEPS,
            "keep_params": True,
            "resume_from": str(root / "tp_pp_gpipe_ck" / str(TP_PP_SAVE_AT))}]
    return two, one


def mesh_jobs() -> list:
    """The four-rank world's jobs: ``tp_pp_*`` (dp x tp x pp under each
    schedule, a save, the f32 1F1B tap) and ``pair_*`` (the MoE LM at the
    other pairs of split axes, f32, tapped)."""
    pp4 = {"kind": "lm", "mesh": TP_PP_MESH, "batch": 8, "m": PP_M, "rule": "pp_tp"}
    jobs = [{**pp4, "name": "tp_pp_gpipe", "schedule": "gpipe", "steps": TP_PP_STEPS,
             "save_every": TP_PP_SAVE_AT, "keep_params": True},
            {**pp4, "name": "tp_pp_1f1b", "schedule": "1f1b", "steps": TP_PP_STEPS},
            {**pp4, "name": "tp_pp_f32", "schedule": "1f1b", "steps": 2, "f32": True,
             "tap": True}]
    pair = {"kind": "lm", "moe_layers": MOE_PAR_LAYERS, "batch": 8, "dispatch": "dropless",
            "steps": 2, "f32": True, "tap": True}
    for name, (mesh, rule, attention) in MESH_PAIRS.items():
        env = {"ROCKET_TPU_MOE_GMM": "fused"}
        if "model" in mesh:
            env["ROCKET_TPU_OVERLAP_WIRE"] = "fp32"
        jobs.append({**pair, "name": f"pair_{name}", "mesh": mesh, "rule": rule,
                     "attention": attention, "env": env})
    return jobs


def pp_phases(root: Path, ranks: list, one: dict, card) -> None:
    """``pp_train`` and ``pp_checkpoint``: GPT-2 124M over two pipeline
    stages under each schedule, against one rank's unpipelined run of the
    same config, params and batches."""
    cfg = TransformerConfig.gpt2_124m()
    per_stage = cfg.num_layers // 2
    ref = one["pp_one"]
    one_g = np.load(root / "pp_one_f32_grads.npy")
    one_masks = _masks_by_key([one["pp_one_f32"]])
    hop_bytes = PP_MB_ROWS * cfg.max_seq_len * cfg.dim * 2
    out = {}
    for s in ("gpipe", "1f1b"):
        jobs = [r["jobs"][f"pp_{s}"] for r in ranks]
        g = np.load(root / f"pp_{s}_f32_grads.npy")
        grad_err = float(np.abs(g - one_g).max() / np.abs(one_g).max())
        masks = _masks_by_key([r["jobs"][f"pp_{s}_f32"] for r in ranks])
        peaks = {4: [r["jobs"][f"pp_{s}"]["peak_memory_bytes"] for r in ranks],
                 8: [r["jobs"][f"pp_mem_{s}_m8"]["peak_memory_bytes"] for r in ranks]}
        growth = [b - a for a, b in zip(peaks[4], peaks[8])]
        gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in jobs]
        sends = [j["pipe"]["sends"] for j in jobs]
        out[s] = {"losses": jobs[0]["losses"], "loss_gap_per_rank": gaps,
                  "step_ms_median_per_rank": [_median(j["step_ms"]) for j in jobs],
                  "step_ms_per_rank": [j["step_ms"] for j in jobs],
                  "hop_wait_ms_median_per_rank": [_median(j["pipe_wait_ms"]) for j in jobs],
                  "grad_sync_wait_ms_median_per_rank": [_median(j["grad_sync_wait_ms"])
                                                        for j in jobs],
                  "bytes_per_send": [j["pipe"]["wire_bytes"] / max(1, n)
                                     for j, n in zip(jobs, sends)],
                  "sends_per_step_per_rank": [n / PP_STEPS for n in sends],
                  "staged": jobs[0]["pipe"]["staged"],
                  "live_inputs_max_per_rank": [j["pipe"]["live_max"] for j in jobs],
                  "launches_per_rank": [j["launches"] for j in jobs],
                  "param_bytes_per_rank": [j["param_bytes"] for j in jobs],
                  "step1_grad_err_f32": grad_err, "masks_equal": masks == one_masks,
                  "mask_keys": len(masks),
                  "peak_memory_bytes_m4_per_rank": peaks[4],
                  "peak_memory_bytes_m8_per_rank": peaks[8],
                  "peak_growth_m4_to_m8_per_rank": growth}
    emit("pp_train", model="gpt2_124m", dtype="bfloat16", batch=8, seq_len=cfg.max_seq_len,
         microbatches=PP_M, microbatch_rows=PP_MB_ROWS, steps=PP_STEPS, ranks=2, mesh=PP_MESH,
         layers_per_stage=per_stage, backend=ranks[0]["jobs"]["pp_gpipe"]["backend"],
         one_rank_losses=ref["losses"], one_rank_step_ms_median=_median(ref["step_ms"]),
         one_rank_launches=ref["launches"], expected_bytes_per_send=hop_bytes,
         one_rank_peak_memory_bytes=ref["peak_memory_bytes"], schedules=out, card=card)
    for s, rec in out.items():
        jobs = [r["jobs"][f"pp_{s}"] for r in ranks]
        for r, job in enumerate(jobs):
            require(job["backend"] == "gloo" and job["world"] == 2 and job["stage"] == r,
                    f"pp_train {s}: rank {r} ran on {job['backend']} x {job['world']}")
            require(len(job["losses"]) == PP_STEPS and rec["loss_gap_per_rank"][r] <= DP_LOSS_TOL,
                    f"pp_train {s}: rank {r} losses {job['losses']} vs one rank {ref['losses']}")
            # Rows 3-4 on the stage's 6 layers, each microbatch: GPipe and a
            # 1F1B stage before the last recompute their forward in the
            # backward; 1F1B's last stage runs forward and backward once.
            fwd = per_stage * PP_M * (1 if (s == "1f1b" and r == 1) else 2)
            want = {"flash_fwd": fwd * PP_STEPS, "flash_bwd": per_stage * PP_M * PP_STEPS,
                    "flash_dq": 0}
            require(job["launches"] == want, f"pp_train {s}: rank {r} launches "
                    f"{job['launches']}, not {want}")
        require(all(b == hop_bytes for b in rec["bytes_per_send"]),
                f"pp_train {s}: {rec['bytes_per_send']} bytes a send, not {hop_bytes}")
        require(rec["step1_grad_err_f32"] <= PP_GRAD_TOL,
                f"pp_train {s}: step-1 gradients {rec['step1_grad_err_f32']} of the largest")
        require(rec["masks_equal"] and rec["mask_keys"] == 2 * (1 + 3 * cfg.num_layers),
                f"pp_train {s}: dropout masks differ from the unpipelined run's "
                f"({rec['mask_keys']} keys)")
        if s == "1f1b":
            require(rec["live_inputs_max_per_rank"] == [3, 0],
                    f"pp_train 1f1b: live stage inputs {rec['live_inputs_max_per_rank']}")
            require(max(rec["peak_growth_m4_to_m8_per_rank"]) <= PP_FLAT_BYTES,
                    f"pp_train 1f1b: peak grows {rec['peak_growth_m4_to_m8_per_rank']} "
                    "bytes from M=4 to M=8")
    require(out["gpipe"]["peak_growth_m4_to_m8_per_rank"][1] > PP_FLAT_BYTES
            and out["gpipe"]["peak_growth_m4_to_m8_per_rank"][1]
            > out["1f1b"]["peak_growth_m4_to_m8_per_rank"][1],
            f"pp_train: GPipe's peak does not grow with M: "
            f"{out['gpipe']['peak_growth_m4_to_m8_per_rank']}")
    # -- pp_checkpoint
    saved = [r["jobs"]["pp_gpipe"] for r in ranks]
    resumed = one["pp_one_resumed"]
    tail = saved[0]["losses"][PP_SAVE_AT:]
    param_gap = float(np.abs(np.load(root / "pp_one_resumed_params.npy")
                             - np.load(root / "pp_gpipe_params.npy")).max())
    files = sorted(os.listdir(root / "pp_gpipe_ck" / str(PP_SAVE_AT) / "model_0"))
    emit("pp_checkpoint", saved_at=PP_SAVE_AT, ranks_saving=2, ranks_resuming=1, files=files,
         write_s_per_rank=[[s.get("write_s") for s in j["saves"]] for j in saved],
         bytes_per_rank=[[s["shard_bytes"] for s in j["saves"]] for j in saved],
         resumed_losses=resumed["losses"], uninterrupted_losses=tail,
         end_param_max_abs_gap=param_gap, card=card)
    require(files == ["index.json", "shard_p0.npz", "shard_p1.npz"], f"pp_checkpoint: {files}")
    require(len(resumed["losses"]) == PP_STEPS - PP_SAVE_AT
            and max(abs(a - b) for a, b in zip(resumed["losses"], tail)) <= DP_LOSS_TOL,
            f"pp_checkpoint: resumed losses {resumed['losses']} vs {tail}")
    require(param_gap <= DP_PARAM_TOL, f"pp_checkpoint: end params {param_gap} apart")


def ring_phase(root: Path, ranks: list, one: dict, card) -> None:
    """``ring_train``: GPT-2 124M widths at T = 4096 over ``{"data": 1,
    "seq": 2}`` with ring attention, against one rank's flash run; step 1
    at f32 compute against one rank's plain attention (the loss across the
    shard edge, its global denominator and every leaf's sum over the seq
    group)."""
    cfg = TransformerConfig.gpt2_124m(max_seq_len=RING_T)
    jobs = [r["jobs"]["ring"] for r in ranks]
    ref = one["ring_one"]
    gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in jobs]
    one_g = np.load(root / "ring_one_f32_grads.npy")
    grad_err = float(np.abs(np.load(root / "ring_f32_grads.npy") - one_g).max()
                     / np.abs(one_g).max())
    f32_loss_gaps = [abs(r["jobs"]["ring_f32"]["losses"][0] - one["ring_one_f32"]["losses"][0])
                     for r in ranks]
    kv = RING_B * (RING_T // 2) * cfg.dim * 2
    per_hop = [j["ring"]["kv_bytes"] / max(1, j["ring"]["kv_hops"]) for j in jobs]
    emit("ring_train", model="gpt2_124m", dtype="bfloat16", batch=RING_B, seq_len=RING_T,
         steps=RING_STEPS, ranks=2, mesh=RING_MESH, backend=jobs[0]["backend"],
         losses=jobs[0]["losses"], one_rank_losses=ref["losses"], loss_gap_per_rank=gaps,
         step_ms_median_per_rank=[_median(j["step_ms"]) for j in jobs],
         step_ms_per_rank=[j["step_ms"] for j in jobs],
         one_rank_step_ms_median=_median(ref["step_ms"]),
         hop_wait_ms_median_per_rank=[_median(j["ring_wait_ms"]) for j in jobs],
         grad_sync_wait_ms_median_per_rank=[_median(j["grad_sync_wait_ms"]) for j in jobs],
         kv_bytes_per_hop=per_hop, expected_kv_bytes_per_hop=2 * kv,
         kv_hops_per_step_per_rank=[j["ring"]["kv_hops"] / RING_STEPS for j in jobs],
         hops_per_step_per_rank=[j["ring"]["hops"] / RING_STEPS for j in jobs],
         wire_bytes_per_step_per_rank=[j["ring"]["wire_bytes"] / RING_STEPS for j in jobs],
         staged=jobs[0]["ring"]["staged"],
         peak_memory_bytes_per_rank=[j["peak_memory_bytes"] for j in jobs],
         one_rank_peak_memory_bytes=ref["peak_memory_bytes"],
         launches_per_rank=[j["launches"] for j in jobs], one_rank_launches=ref["launches"],
         step1_grad_err_f32=grad_err, step1_loss_gap_f32_per_rank=f32_loss_gaps,
         step1_loss_f32=one["ring_one_f32"]["losses"][0], card=card)
    require(grad_err <= PP_GRAD_TOL, f"ring_train: step-1 gradients {grad_err} of the largest")
    for r, job in enumerate(jobs):
        require(job["backend"] == "gloo" and job["seq_index"] == r,
                f"ring_train: rank {r} ran on {job['backend']} at seq {job['seq_index']}")
        require(len(job["losses"]) == RING_STEPS and gaps[r] <= RING_LOSS_TOL,
                f"ring_train: rank {r} losses {job['losses']} vs one rank {ref['losses']}")
        require(f32_loss_gaps[r] <= RING_F32_LOSS_TOL,
                f"ring_train: rank {r} step-1 f32 loss {f32_loss_gaps[r]} from one rank's")
        require(per_hop[r] == 2 * kv, f"ring_train: {per_hop[r]} K/V bytes a hop, not {2 * kv}")
        require(job["launches"] == {"flash_fwd": 0, "flash_bwd": 0, "flash_dq": 0},
                f"ring_train: rank {r} launched flash kernels {job['launches']}")
    layers = cfg.num_layers
    want = {"flash_fwd": 2 * layers * RING_STEPS, "flash_bwd": layers * RING_STEPS,
            "flash_dq": layers * RING_STEPS}
    require(ref["launches"] == want, f"ring_train: one rank launches {ref['launches']}, not "
            f"{want} (row 5 at T = {RING_T})")


def dp_cifar_phase(root: Path, ranks: list, one: dict, card) -> None:
    """``dp_cifar``: ResNet-18 with sync-BN over two ranks at B=256 each
    against one rank at B=512 (the fused kernels forced on both)."""
    jobs = [r["jobs"]["dp_cifar"] for r in ranks]
    ref = one["cifar_one"]
    stats = np.load(root / "dp_cifar_stats.npy")
    params = np.load(root / "dp_cifar_params.npy")
    want_stats = np.load(root / "cifar_one_stats.npy")
    want_params = np.load(root / "cifar_one_params.npy")
    stats_err = float((np.abs(stats - want_stats) / (1 + np.abs(want_stats))).max())
    params_err = float((np.abs(params - want_params) / (1 + np.abs(want_params))).max())
    per_step = [[int(v) for v in np.diff([0] + j["all_reduces"])] for j in jobs]
    gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in jobs]
    emit("dp_cifar", model="resnet18_cifar", batch=CIFAR_DP_BATCH,
         batch_per_rank=CIFAR_DP_BATCH // 2, steps=CIFAR_DP_STEPS, ranks=2,
         backend=jobs[0]["backend"], losses=jobs[0]["losses"], one_rank_losses=ref["losses"],
         loss_gap_per_rank=gaps, stats_rel_err=stats_err, params_rel_err=params_err,
         stats_sha256=[j["stats_sha256"] for j in jobs],
         collectives_per_step_per_rank=per_step,
         step_ms_median_per_rank=[_median(j["step_ms"]) for j in jobs],
         step_ms_per_rank=[j["step_ms"] for j in jobs],
         one_rank_step_ms_median=_median(ref["step_ms"]),
         grad_sync_wait_ms_median_per_rank=[_median(j["grad_sync_wait_ms"]) for j in jobs],
         bn_twopass_launches_per_rank=[j["bn_twopass"] for j in jobs],
         one_rank_bn_twopass_launches=ref["bn_twopass"], card=card)
    for r, job in enumerate(jobs):
        require(job["world"] == 2 and job["bn_twopass"] == 0 and job["bn_normalize"] == 0,
                f"dp_cifar: rank {r} launched the fused BN kernels {job['bn_twopass']} / "
                f"{job['bn_normalize']} times over two ranks")
        require(per_step[r] == [2 * CIFAR_BN_LAYERS] * CIFAR_DP_STEPS,
                f"dp_cifar: rank {r} ran {per_step[r]} sync-BN collectives a step")
    require(ref["bn_twopass"] == CIFAR_BN_LAYERS * CIFAR_DP_STEPS,
            f"dp_cifar: one rank launched row 9 {ref['bn_twopass']} times")
    require(jobs[0]["stats_sha256"] == jobs[1]["stats_sha256"],
            "dp_cifar: the ranks' running statistics differ")
    require(stats_err <= CIFAR_DP_TOL and params_err <= CIFAR_DP_TOL,
            f"dp_cifar: statistics {stats_err}, params {params_err} from one rank's")


def _grad_err(root: Path, two: str, one: str) -> float:
    """The largest gap of two taps' step-1 gradients, relative to the
    largest element of ``one``'s."""
    want = np.load(root / f"{one}_grads.npy")
    return float(np.abs(np.load(root / f"{two}_grads.npy") - want).max() / np.abs(want).max())


def ep_phases(root: Path, ranks: list, one: dict, card) -> None:
    """``ep_train``, ``ep_checkpoint`` and ``moe_par``: the MoE LM over two
    expert ranks under both dispatches (rows 11, ``gmm`` and ``tgmm`` on
    each rank's two experts under dropless), its checkpoint resumed on one
    rank, and the MoE under the model, seq and pipe axes, each against one
    rank of the same config, params and batches."""
    cfg = moe_config()
    layers = cfg.num_layers
    two_layers = 2 * layers  # routings a step: the forward and the remat recompute
    ep_out = {}
    for dispatch in ("dropless", "einsum"):
        jobs = [r["jobs"][f"ep_{dispatch}"] for r in ranks]
        ref = one[f"ep_one_{dispatch}"]
        gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in jobs]
        routed = [j["routed_rows"] for j in jobs]
        ep_out[dispatch] = {
            "losses": jobs[0]["losses"], "one_rank_losses": ref["losses"],
            "loss_gap_per_rank": gaps,
            "step_ms_median_per_rank": [_median(j["step_ms"]) for j in jobs],
            "step_ms_spread_per_rank": [float(np.ptp(j["step_ms"][1:])) for j in jobs],
            "step_ms_per_rank": [j["step_ms"] for j in jobs],
            "one_rank_step_ms_median": _median(ref["step_ms"]),
            "expert_wait_ms_median_per_rank": [_median(j["coll_wait_ms"]) for j in jobs],
            "wire_bytes_per_step_per_rank": [_median(j["coll_wire_bytes"]) for j in jobs],
            "collective_calls_per_step": {k: v["bulk"] / EP_STEPS
                                          for k, v in jobs[0]["coll_calls"].items()},
            "expert_param_bytes_per_rank": [j["expert_param_bytes"] for j in jobs],
            "one_rank_expert_param_bytes": ref["expert_param_bytes"],
            "param_bytes_per_rank": [j["param_bytes"] for j in jobs],
            "moment_bytes_per_rank": [j["moment_bytes"] for j in jobs],
            "one_rank_param_bytes": ref["param_bytes"],
            "one_rank_moment_bytes": ref["moment_bytes"],
            "routed_rows_per_rank": routed, "one_rank_routed_rows": ref["routed_rows"],
            "step1_routing_equal": all(j["routing"][:two_layers] == ref["routing"][:two_layers]
                                       for j in jobs),
            "routings_equal": [sum(a == b for a, b in zip(j["routing"], ref["routing"]))
                               for j in jobs],
            "routings": len(ref["routing"]),
            "moe_launches_per_rank": [j["moe_launches"] for j in jobs],
            "one_rank_moe_launches": ref["moe_launches"],
            "launches_per_rank": [j["launches"] for j in jobs],
            "peak_memory_bytes_per_rank": [j["peak_memory_bytes"] for j in jobs],
            "one_rank_peak_memory_bytes": ref["peak_memory_bytes"]}
    f32_err = _grad_err(root, "ep_f32", "ep_one_f32")
    f32_routing = all(r["jobs"]["ep_f32"]["routing"] == one["ep_one_f32"]["routing"]
                      for r in ranks)
    emit("ep_train", model="moe_gpt2_e4", layers=layers, dtype="bfloat16", batch=8,
         seq_len=cfg.max_seq_len, steps=EP_STEPS, ranks=2, mesh=EP_MESH,
         backend=ranks[0]["jobs"]["ep_dropless"]["backend"], dispatches=ep_out,
         step1_grad_err_f32=f32_err, f32_routing_equal=f32_routing, card=card)
    for dispatch, rec in ep_out.items():
        jobs = [r["jobs"][f"ep_{dispatch}"] for r in ranks]
        for r, job in enumerate(jobs):
            require(job["backend"] == "gloo" and job["expert_index"] == r,
                    f"ep_train {dispatch}: rank {r} ran on {job['backend']} at expert "
                    f"{job['expert_index']}")
            require(len(job["losses"]) == EP_STEPS and rec["loss_gap_per_rank"][r]
                    <= RING_LOSS_TOL, f"ep_train {dispatch}: rank {r} losses {job['losses']} "
                    f"vs one rank {rec['one_rank_losses']}")
            require(job["moe_launches"] == rec["one_rank_moe_launches"]
                    and job["launches"] == one[f"ep_one_{dispatch}"]["launches"],
                    f"ep_train {dispatch}: rank {r} launches {job['moe_launches']} "
                    f"{job['launches']}, one rank {rec['one_rank_moe_launches']}")
            require(2 * job["expert_param_bytes"] == rec["one_rank_expert_param_bytes"],
                    f"ep_train {dispatch}: rank {r} holds {job['expert_param_bytes']} expert "
                    f"bytes of {rec['one_rank_expert_param_bytes']}")
        require(rec["step1_routing_equal"], f"ep_train {dispatch}: step-1 routing differs from "
                f"one rank's ({rec['routings_equal']} of {rec['routings']} routings equal)")
        if dispatch == "dropless":
            want = {"gather_gmm": 2 * layers * EP_STEPS, "gmm": 4 * layers * EP_STEPS,
                    "tgmm": 2 * layers * EP_STEPS}
            require(rec["one_rank_moe_launches"] == want,
                    f"ep_train: one rank launches {rec['one_rank_moe_launches']}, want {want}")
            require(sum(rec["routed_rows_per_rank"]) == rec["one_rank_routed_rows"]
                    and min(rec["routed_rows_per_rank"]) > 0,
                    f"ep_train: routed rows {rec['routed_rows_per_rank']} vs one rank "
                    f"{rec['one_rank_routed_rows']}")
    require(f32_err <= PP_GRAD_TOL and f32_routing,
            f"ep_train: step-1 f32 gradients {f32_err} of the largest (routing equal: "
            f"{f32_routing})")
    # -- ep_checkpoint
    saved = [r["jobs"]["ep_dropless"] for r in ranks]
    resumed = one["ep_one_resumed"]
    tail = saved[0]["losses"][EP_SAVE_AT:]
    param_gap = float(np.abs(np.load(root / "ep_one_resumed_params.npy")
                             - np.load(root / "ep_dropless_params.npy")).max())
    step_dir = root / "ep_dropless_ck" / str(EP_SAVE_AT) / "model_0"
    files = sorted(os.listdir(step_dir))
    expert_keys = [sum("experts" in k for k in np.load(step_dir / f"shard_p{r}.npz").files)
                   for r in range(2)]
    emit("ep_checkpoint", saved_at=EP_SAVE_AT, ranks_saving=2, ranks_resuming=1, files=files,
         expert_chunks_per_file=expert_keys,
         write_s_per_rank=[[s.get("write_s") for s in j["saves"]] for j in saved],
         bytes_per_rank=[[s["shard_bytes"] for s in j["saves"]] for j in saved],
         resumed_losses=resumed["losses"], uninterrupted_losses=tail,
         end_param_max_abs_gap=param_gap, card=card)
    require(files == ["index.json", "shard_p0.npz", "shard_p1.npz"]
            and min(expert_keys) > 0, f"ep_checkpoint: {files}, expert chunks {expert_keys}")
    require(len(resumed["losses"]) == EP_STEPS - EP_SAVE_AT
            and abs(resumed["losses"][0] - tail[0]) <= EP_RESUME_TOL
            and max(abs(a - b) for a, b in zip(resumed["losses"], tail)) <= RING_LOSS_TOL,
            f"ep_checkpoint: resumed losses {resumed['losses']} vs {tail}")
    require(param_gap <= DP_PARAM_TOL, f"ep_checkpoint: end params {param_gap} apart")
    # -- moe_par
    micro = one["moe_one_micro_f32"]["losses"][:PP_M]
    par = {}
    for axis, name, ref_name in (("model", "moe_tp_f32", "moe_one_f32"),
                                 ("seq", "moe_seq_f32", "moe_one_f32"),
                                 ("pipe", "moe_pipe_f32", "moe_one_micro_f32")):
        want_loss = (float(np.mean(micro)) if axis == "pipe"
                     else one[ref_name]["losses"][0])
        jobs = [r["jobs"][name] for r in ranks]
        par[axis] = {"loss": jobs[0]["losses"][0], "one_rank_loss": want_loss,
                     "loss_gap_per_rank": [abs(j["losses"][0] - want_loss) for j in jobs],
                     "step1_grad_err_f32": _grad_err(root, name, ref_name),
                     "step_ms_per_rank": [j["step_ms"] for j in jobs],
                     "moe_launches_per_rank": [j["moe_launches"] for j in jobs],
                     "launches_per_rank": [j["launches"] for j in jobs],
                     "peak_memory_bytes_per_rank": [j["peak_memory_bytes"] for j in jobs]}
    emit("moe_par", model="moe_gpt2_e4", layers=MOE_PAR_LAYERS, dtype="float32", batch=8,
         seq_len=cfg.max_seq_len, steps=2, meshes={"model": TP_MESH, "seq": RING_MESH,
                                                   "pipe": PP_MESH},
         microbatches=PP_M, one_rank_micro_losses=micro, axes=par, card=card)
    for axis, rec in par.items():
        require(max(rec["loss_gap_per_rank"]) <= RING_F32_LOSS_TOL * abs(rec["one_rank_loss"])
                and rec["step1_grad_err_f32"] <= PP_GRAD_TOL,
                f"moe_par {axis}: step-1 loss gaps {rec['loss_gap_per_rank']}, gradients "
                f"{rec['step1_grad_err_f32']} of the largest")
        require(all(sum(c.values()) > 0 for c in rec["moe_launches_per_rank"]),
                f"moe_par {axis}: MoE kernel launches {rec['moe_launches_per_rank']}")


def seq_flash_phase(root: Path, ranks: list, one: dict, card) -> None:
    """``seq_flash``: ``ring_train``'s job (GPT-2 124M widths at T = 4096,
    B = 2, RING_STEPS steps) with ``attention="auto"`` over ``{"data": 1,
    "seq": 2}``: each attention layer gathers the sequence over the seq
    group and runs rows 3-5 on it whole (the backward reduce-scatters), on
    both ranks; against ``ring_one`` (bf16 losses) and ``ring_one_f32``
    (the f32 step-1 gradients and loss)."""
    cfg = TransformerConfig.gpt2_124m(max_seq_len=RING_T)
    jobs = [r["jobs"]["seq_flash"] for r in ranks]
    ref = one["ring_one"]
    gaps = [max(abs(a - b) for a, b in zip(j["losses"], ref["losses"])) for j in jobs]
    grad_err = _grad_err(root, "seq_flash_f32", "ring_one_f32")
    f32_gaps = [abs(r["jobs"]["seq_flash_f32"]["losses"][0] - one["ring_one_f32"]["losses"][0])
                for r in ranks]
    emit("seq_flash", model="gpt2_124m", dtype="bfloat16", batch=RING_B, seq_len=RING_T,
         steps=RING_STEPS, ranks=2, mesh=RING_MESH, attention="auto",
         backend=jobs[0]["backend"], losses=jobs[0]["losses"], one_rank_losses=ref["losses"],
         loss_gap_per_rank=gaps, step_ms_median_per_rank=[_median(j["step_ms"]) for j in jobs],
         step_ms_per_rank=[j["step_ms"] for j in jobs],
         one_rank_step_ms_median=_median(ref["step_ms"]),
         seq_wait_ms_median_per_rank=[_median(j["coll_wait_ms"]) for j in jobs],
         seq_wire_bytes_per_step_per_rank=[_median(j["coll_wire_bytes"]) for j in jobs],
         grad_sync_wait_ms_median_per_rank=[_median(j["grad_sync_wait_ms"]) for j in jobs],
         coll_calls=jobs[0]["coll_calls"],
         peak_memory_bytes_per_rank=[j["peak_memory_bytes"] for j in jobs],
         launches_per_rank=[j["launches"] for j in jobs], one_rank_launches=ref["launches"],
         step1_grad_err_f32=grad_err, step1_loss_gap_f32_per_rank=f32_gaps, card=card)
    require(grad_err <= PP_GRAD_TOL, f"seq_flash: step-1 gradients {grad_err} of the largest")
    for r, job in enumerate(jobs):
        require(job["backend"] == "gloo" and job["seq_index"] == r,
                f"seq_flash: rank {r} ran on {job['backend']} at seq {job['seq_index']}")
        require(len(job["losses"]) == RING_STEPS and gaps[r] <= RING_LOSS_TOL,
                f"seq_flash: rank {r} losses {job['losses']} vs one rank {ref['losses']}")
        require(f32_gaps[r] <= RING_F32_LOSS_TOL,
                f"seq_flash: rank {r} step-1 f32 loss {f32_gaps[r]} from one rank's")
        # Rows 3-5 on the gathered sequence: the one rank's launches, each rank.
        require(job["launches"] == ref["launches"] and job["launches"]["flash_dq"] > 0,
                f"seq_flash: rank {r} launches {job['launches']}, one rank {ref['launches']}")


def tp_fallback_phase(root: Path, ranks: list, one: dict, card) -> None:
    """``tp_fallback``: ViT-Ti (3 heads) under ``gpt2_tp_rules()`` at
    ``{"data": 1, "model": 2}``: no TP path, so its model shards are
    gathered at step entry and every layer runs replicated over the model
    group (``replicated_layers`` > 0, where ``tp_train`` counts 0); its
    f32 step-1 gradients against one rank's."""
    jobs = [r["jobs"]["tp_fallback"] for r in ranks]
    ref = one["vit_one"]
    grad_err = _grad_err(root, "tp_fallback", "vit_one")
    emit("tp_fallback", model="vit_tiny", heads=3, layers=9, dtype="float32",
         batch=VIT_TP_BATCH, steps=VIT_TP_STEPS, ranks=2, mesh=TP_MESH,
         backend=jobs[0]["backend"], losses=jobs[0]["losses"], one_rank_losses=ref["losses"],
         step_ms_per_rank=[j["step_ms"] for j in jobs], one_rank_step_ms=ref["step_ms"],
         replicated_layers_per_rank=[j["replicated_layers"] for j in jobs],
         replicated_per_rank=[j["replicated"] for j in jobs],
         model_shards_per_rank=[j["model_shards"] for j in jobs],
         held_bytes_per_rank=[j["held_bytes"] for j in jobs],
         one_rank_held_bytes=ref["held_bytes"],
         launches_per_rank=[j["launches"] for j in jobs], one_rank_launches=ref["launches"],
         step1_grad_err_f32=grad_err,
         tp_train_replicated_layers=RECORD["tp_train"][0]["replicated_layers_per_rank"],
         card=card)
    require(grad_err <= PP_GRAD_TOL, f"tp_fallback: step-1 gradients {grad_err} of the largest")
    for r, job in enumerate(jobs):
        require(job["backend"] == "gloo" and job["world"] == 2 and job["model_index"] == r,
                f"tp_fallback: rank {r} ran on {job['backend']} x {job['world']}")
        require(job["replicated_layers"] > 0 and job["model_shards"] > 0,
                f"tp_fallback: rank {r} replicated {job['replicated_layers']} forwards over "
                f"{job['model_shards']} model shards")
        require(job["launches"] == ref["launches"] and job["launches"]["flash_fwd"] > 0,
                f"tp_fallback: rank {r} launches {job['launches']}, one rank {ref['launches']}")


def tp_pp_phases(root: Path, ranks: list, one: dict, card) -> None:
    """``tp_pp_train`` and ``tp_pp_checkpoint``: GPT-2 124M over ``{"data": 1,
    "model": 2, "pipe": 2}`` (four ranks: a stage's 6 layers on the two
    ranks of its model row, each holding half of their model shards) under
    each schedule, against ``pp_train``'s one rank; the save at step 2
    resumed by one rank."""
    cfg = TransformerConfig.gpt2_124m()
    per_stage = cfg.num_layers // 2
    ref = one["pp_one"]
    want_losses = ref["losses"][:TP_PP_STEPS]
    grad_err = _grad_err(root, "tp_pp_f32", "pp_one_f32")
    out = {}
    for s in ("gpipe", "1f1b"):
        jobs = [r["jobs"][f"tp_pp_{s}"] for r in ranks]
        out[s] = {"losses": jobs[0]["losses"],
                  "loss_gap_per_rank": [max(abs(a - b) for a, b in zip(j["losses"],
                                                                        want_losses))
                                        for j in jobs],
                  "coords_per_rank": [j["coords"] for j in jobs],
                  "step_ms_median_per_rank": [_median(j["step_ms"]) for j in jobs],
                  "step_ms_per_rank": [j["step_ms"] for j in jobs],
                  "model_wait_ms_median_per_rank": [_median(j["coll_wait_ms"]) for j in jobs],
                  "pipe_wait_ms_median_per_rank": [_median(j["pipe_wait_ms"]) for j in jobs],
                  "grad_sync_wait_ms_median_per_rank": [_median(j["grad_sync_wait_ms"])
                                                        for j in jobs],
                  "model_wire_bytes_per_step_per_rank": [_median(j["coll_wire_bytes"])
                                                         for j in jobs],
                  "pipe_wire_bytes_per_step_per_rank": [_median(j["pipe_wire_bytes"])
                                                        for j in jobs],
                  "grad_sync_wire_bytes_per_step_per_rank": [
                      _median(j["grad_sync_wire_bytes"]) for j in jobs],
                  "held_bytes_per_rank": [j["held_bytes"] for j in jobs],
                  "peak_memory_bytes_per_rank": [j["peak_memory_bytes"] for j in jobs],
                  "replicated_layers_per_rank": [j["replicated_layers"] for j in jobs],
                  "launches_per_rank": [j["launches"] for j in jobs]}
    emit("tp_pp_train", model="gpt2_124m", dtype="bfloat16", batch=8, seq_len=cfg.max_seq_len,
         microbatches=PP_M, steps=TP_PP_STEPS, ranks=4, mesh=TP_PP_MESH,
         rule="pipeline_over(gpt2_tp_rules())", layers_per_stage=per_stage,
         backend=ranks[0]["jobs"]["tp_pp_gpipe"]["backend"], one_rank_losses=want_losses,
         one_rank_step_ms_median=_median(ref["step_ms"]),
         one_rank_peak_memory_bytes=ref["peak_memory_bytes"], step1_grad_err_f32=grad_err,
         schedules=out, card=card)
    require(grad_err <= PP_GRAD_TOL, f"tp_pp_train: step-1 gradients {grad_err} of the largest")
    for s, rec in out.items():
        for r, job in enumerate([x["jobs"][f"tp_pp_{s}"] for x in ranks]):
            stage = job["coords"]["pipe"]
            require(job["backend"] == "gloo" and job["world"] == 4
                    and job["coords"] == {"data": 0, "model": r // 2, "pipe": r % 2},
                    f"tp_pp_train {s}: rank {r} at {job['coords']} on {job['backend']}")
            require(len(job["losses"]) == TP_PP_STEPS
                    and rec["loss_gap_per_rank"][r] <= DP_LOSS_TOL,
                    f"tp_pp_train {s}: rank {r} losses {job['losses']} vs {want_losses}")
            # Rows 3-4 on the stage's 6 layers (pp_train's counts): every
            # stage's ranks launch them.
            fwd = per_stage * PP_M * (1 if (s == "1f1b" and stage == 1) else 2)
            want = {"flash_fwd": fwd * TP_PP_STEPS,
                    "flash_bwd": per_stage * PP_M * TP_PP_STEPS, "flash_dq": 0}
            require(job["launches"] == want, f"tp_pp_train {s}: rank {r} launches "
                    f"{job['launches']}, not {want}")
            require(job["replicated_layers"] >= TP_PP_STEPS,
                    f"tp_pp_train {s}: rank {r} counted {job['replicated_layers']} replicated "
                    "steps")
    # -- tp_pp_checkpoint
    saved = [r["jobs"]["tp_pp_gpipe"] for r in ranks]
    resumed = one["tp_pp_one_resumed"]
    tail = saved[0]["losses"][TP_PP_SAVE_AT:]
    param_gap = float(np.abs(np.load(root / "tp_pp_one_resumed_params.npy")
                             - np.load(root / "tp_pp_gpipe_params.npy")).max())
    step_dir = root / "tp_pp_gpipe_ck" / str(TP_PP_SAVE_AT) / "model_0"
    files = sorted(os.listdir(step_dir))
    index = json.loads((step_dir / "index.json").read_text())
    writers = sorted({c["file"] for c in index["params/blocks/0/attn/qkv/w"]["chunks"]}
                     | {c["file"] for c in index["params/blocks/11/attn/qkv/w"]["chunks"]})
    emit("tp_pp_checkpoint", saved_at=TP_PP_SAVE_AT, ranks_saving=4, ranks_resuming=1,
         files=files, qkv_writers=writers,
         write_s_per_rank=[[x.get("write_s") for x in j["saves"]] for j in saved],
         bytes_per_rank=[[x["shard_bytes"] for x in j["saves"]] for j in saved],
         resumed_losses=resumed["losses"], uninterrupted_losses=tail,
         end_param_max_abs_gap=param_gap, card=card)
    require(files == ["index.json"] + [f"shard_p{r}.npz" for r in range(4)]
            and writers == [f"shard_p{r}.npz" for r in range(4)],
            f"tp_pp_checkpoint: {files}, the stages' QKV written by {writers}")
    require(len(resumed["losses"]) == TP_PP_STEPS - TP_PP_SAVE_AT
            and max(abs(a - b) for a, b in zip(resumed["losses"], tail)) <= DP_LOSS_TOL,
            f"tp_pp_checkpoint: resumed losses {resumed['losses']} vs {tail}")
    require(param_gap <= DP_PARAM_TOL, f"tp_pp_checkpoint: end params {param_gap} apart")


def mesh_pairs_phase(root: Path, ranks: list, one: dict, card) -> None:
    """``mesh_pairs``: the MoE LM at MOE_PAR_LAYERS layers, f32, two steps
    at ``{"model": 2, "seq": 2}`` (ring attention, the model axis
    replicated), ``{"model": 2, "expert": 2}`` (TP attention on the model
    group, two experts a rank on the expert group) and ``{"seq": 2,
    "expert": 2}`` (ring attention, two experts a rank), four ranks each;
    step-1 losses and gradients against ``moe_par``'s one rank, rows 11,
    ``gmm`` and ``tgmm`` counted on every rank of the expert pairs."""
    ref = one["moe_one_f32"]
    pairs = {}
    for name, (mesh, rule, attention) in MESH_PAIRS.items():
        jobs = [r["jobs"][f"pair_{name}"] for r in ranks]
        pairs[name] = {"mesh": mesh, "rule": rule, "attention": attention,
                       "loss": jobs[0]["losses"][0], "one_rank_loss": ref["losses"][0],
                       "loss_gap_per_rank": [abs(j["losses"][0] - ref["losses"][0])
                                             for j in jobs],
                       "step1_grad_err_f32": _grad_err(root, f"pair_{name}", "moe_one_f32"),
                       "coords_per_rank": [j["coords"] for j in jobs],
                       "step_ms_per_rank": [j["step_ms"] for j in jobs],
                       "coll_wait_ms_per_rank": [j["coll_wait_ms"] for j in jobs],
                       "coll_wire_bytes_per_rank": [j["coll_wire_bytes"] for j in jobs],
                       "ring_wait_ms_per_rank": [j["ring_wait_ms"] for j in jobs],
                       "grad_sync_wire_bytes_per_rank": [j["grad_sync_wire_bytes"]
                                                         for j in jobs],
                       "replicated_layers_per_rank": [j["replicated_layers"] for j in jobs],
                       "moe_launches_per_rank": [j["moe_launches"] for j in jobs],
                       "launches_per_rank": [j["launches"] for j in jobs],
                       "peak_memory_bytes_per_rank": [j["peak_memory_bytes"] for j in jobs]}
    emit("mesh_pairs", model="moe_gpt2_e4", layers=MOE_PAR_LAYERS, dtype="float32", batch=8,
         steps=2, ranks=4, pairs=pairs, card=card)
    for name, rec in pairs.items():
        require(max(rec["loss_gap_per_rank"]) <= RING_F32_LOSS_TOL * abs(rec["one_rank_loss"])
                and rec["step1_grad_err_f32"] <= PP_GRAD_TOL,
                f"mesh_pairs {name}: step-1 loss gaps {rec['loss_gap_per_rank']}, gradients "
                f"{rec['step1_grad_err_f32']} of the largest")
        if "expert" in rec["mesh"]:
            require(all(c["gmm"] > 0 and c["tgmm"] > 0 and c["gather_gmm"] > 0
                        for c in rec["moe_launches_per_rank"]),
                    f"mesh_pairs {name}: MoE kernel launches {rec['moe_launches_per_rank']}")


def _example_ranks(script: str, args: list, work: str) -> list:
    """Start ``script`` of ``rocket_tpu_torch/examples`` as two ranks
    sharing the card over gloo, spawned as the launcher does (one card:
    ``LOCAL_RANK`` 0 for both)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0", "ROCKET_TPU_DIST_BACKEND": "gloo"}
    env.pop("ROCKET_TPU_STRICT", None)
    path = str(ROOT / "rocket_tpu_torch" / "examples" / script)
    return [subprocess.Popen([sys.executable, path, *args], cwd=work, env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


#: examples_par: the steps of ``moe_lm.py --expert-axis 2`` (its defaults
#: otherwise: B=64, T=128, dim 128, 4 layers, einsum dispatch).
MOE_LM_EP_STEPS = 40


def examples_par_start(root: Path) -> dict:
    """Start ``examples_par``'s two pairs of ranks in ``root`` (each pair at
    once; :func:`examples_par_phase` waits for them)."""
    runs = {"t0": time.perf_counter()}
    for tag, script, args in (("pipeline_lm", "pipeline_lm.py", ["--schedule", "1f1b"]),
                              ("long_context", "long_context.py", []),
                              ("moe_lm", "moe_lm.py", ["--expert-axis", "2", "--epochs", "1",
                                                       "--steps", str(MOE_LM_EP_STEPS)])):
        (root / tag).mkdir()
        runs[tag] = _example_ranks(script, args, str(root / tag))
    return runs


def examples_par_phase(runs: dict, card) -> None:
    """``examples_par``: ``pipeline_lm.py --schedule 1f1b`` and
    ``long_context.py`` at their defaults and ``moe_lm.py --expert-axis 2``
    for MOE_LM_EP_STEPS steps, each as two ranks, the three pairs started
    by :func:`examples_par_start` and running beside ``dp_launch`` (so
    their walls overlap)."""
    procs = {tag: p for tag, p in runs.items() if tag != "t0"}
    outs = {}
    try:
        for tag, pair in procs.items():
            outs[tag] = [proc.communicate(timeout=600)[0] for proc in pair]
    finally:
        for pair in procs.values():
            for proc in pair:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    wall = time.perf_counter() - runs["t0"]
    for tag, texts in outs.items():
        for r, text in enumerate(texts):
            (ROOT / "chiprun_out" / f"examples_par_{tag}_rank{r}.log").write_text(text)
            require(procs[tag][r].returncode == 0, f"examples_par {tag}: rank {r} exited "
                    f"{procs[tag][r].returncode}: {text[-2000:]}")
    lines = [ln for ln in outs["pipeline_lm"][0].splitlines() if "1f1b over 2 stages" in ln]
    require(len(lines) == 1, f"examples_par: pipeline_lm printed {lines}")
    first, last = (float(v) for v in lines[0].split("loss ")[1].split(" (")[0].split(" -> "))
    losses = [float(x.split("loss=")[1].split(",")[0].rstrip("]"))
              for x in outs["long_context"][0].replace("\r", "\n").split("\n") if "loss=" in x]
    moe_lines = [ln for ln in outs["moe_lm"][0].splitlines() if "moe_lm over 2 expert" in ln]
    require(len(moe_lines) == 1, f"examples_par: moe_lm printed {moe_lines}")
    moe_first, moe_last = (float(v) for v in
                           moe_lines[0].split("loss ")[1].split(" (")[0].split(" -> "))
    emit("examples_par", wall_s=wall,
         pipeline_lm={"line": lines[0], "first": first, "last": last},
         long_context={"first": losses[0] if losses else None,
                       "last": losses[-1] if losses else None, "readings": len(losses)},
         moe_lm={"line": moe_lines[0], "first": moe_first, "last": moe_last}, card=card)
    require(last < first, f"examples_par: pipeline_lm loss {first} -> {last}")
    require(moe_last < moe_first, f"examples_par: moe_lm loss {moe_first} -> {moe_last}")
    require(losses and losses[-1] < losses[0],
            f"examples_par: long_context losses {losses[:2]} ... {losses[-2:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, kernels={
        name: {"seconds": info["seconds"], "ptxas": ptxas_entries(info["ptxas"])}
        for name, info in built.items()},
         # Rows 1, 2, 4, 5, 6, 7, 9, 11, gmm and tgmm (redesigned):
         # registers per thread and resident CTAs per SM at the serve wave,
         # at GPT-2's D=64 (rows 6 and 7 at every tile pair), for the
         # persistent wgmma kernel of row 11, gmm and tgmm (registers at
         # launch, before its warpgroups trade them with setmaxnreg), and
         # row 9's CTAs per SM at its BN shapes.
         redesigned={
             **{f"{kind} bf16 D=64": {
                 "registers": fa.registers(64, torch.bfloat16, kind),
                 "ctas_per_sm": fa.occupancy(64, torch.bfloat16, kind)}
                for kind in ("flash_bwd", "flash_dq")},
             **{f"paged_decode {which} bf16 g=1 D=64": {
                 "registers": pa.attribute(which, "registers", 1, 64, torch.bfloat16),
                 "ctas_per_sm": pa.attribute(which, "ctas", 1, 64, torch.bfloat16)}
                for which in ("split", "combine")},
             **{f"decode_attention {which} bf16 g=1 D=64": {
                 "registers": da.attribute(which, "registers", 1, 64, torch.bfloat16),
                 "ctas_per_sm": da.attribute(which, "ctas", 1, 64, torch.bfloat16)}
                for which in ("split", "combine")},
             "gather_gmm bf16 wgmma": {"registers": gg.attribute("registers"),
                                       "ctas_per_sm": gg.attribute("ctas")},
             **{f"gmm bf16 wgmma {bn}{' transpose_rhs' if trans else ''}": {
                 "registers": gm.attribute("registers", trans, bn),
                 "ctas_per_sm": gm.attribute("ctas", trans, bn)}
                for trans in (False, True) for bn in gm.GMM_BLOCK_NS},
             **{f"tgmm bf16 wgmma {bn}": {
                 "registers": gm.attribute("registers", block_n=bn, kind="tgmm"),
                 "ctas_per_sm": gm.attribute("ctas", block_n=bn, kind="tgmm")}
                for bn in gm.GMM_BLOCK_NS},
             # Row 9's one cooperative launch: its CTAs per SM, which must
             # hold its whole grid (two per SM at 264 CTAs on 132 SMs).
             **{f"bn_twopass N={n} C={c} {str(dt).removeprefix('torch.')}": {
                 "ctas_per_sm": fc.resident(n, c, dt)}
                for n, c, dt in BN_SHAPES},
             **{f"flash_qkv_bwd bf16 D=64 {bq}x{bk}": {
                 "registers": fqa.registers("bwd", 64, bq, bk, torch.bfloat16),
                 "ctas_per_sm": fqa.occupancy("bwd", 64, bq, bk, torch.bfloat16)}
                for bq in fqa.TILES for bk in fqa.TILES},
             **{f"flash_qkv_fwd bf16 D=64 {bq}x{bk}": {
                 "registers": fqa.registers("fwd", 64, bq, bk, torch.bfloat16),
                 "ctas_per_sm": fqa.occupancy("fwd", 64, bq, bk, torch.bfloat16)}
                for bq in fqa.TILES for bk in fqa.TILES},
             # Head dim 128: rows 4-5 and rows 6-7 at their one tile pair,
             # bf16 (the build's ptxas lines give their spills).
             **{f"{kind} bf16 D=128": {
                 "registers": fa.registers(128, torch.bfloat16, kind),
                 "ctas_per_sm": fa.occupancy(128, torch.bfloat16, kind)}
                for kind in ("flash_bwd", "flash_dq")},
             **{f"flash_qkv_{kind} bf16 D=128 64x64": {
                 "registers": fqa.registers(kind, 128, 64, 64, torch.bfloat16),
                 "ctas_per_sm": fqa.occupancy(kind, 128, 64, 64, torch.bfloat16)}
                for kind in ("fwd", "bwd")}},
         # Rows 6-7: resident CTAs per SM of each D=64 instantiation.
         flash_qkv_occupancy={
             f"{kind} {str(dt).removeprefix('torch.')} {bq}x{bk}": fqa.occupancy(kind, 64, bq, bk,
                                                                                dt)
             for kind in ("fwd", "bwd") for dt in (torch.float32, torch.bfloat16)
             for bq in fqa.TILES for bk in fqa.TILES},
         # Rows 3-5 and 8: resident CTAs per SM (bf16 on the tensor cores).
         flash_occupancy={f"{kind} D={d} {str(dt).removeprefix('torch.')}":
                          fa.occupancy(d, dt, kind)
                          for kind in ("flash_fwd", "flash_bwd", "flash_dq")
                          for d in fa.HEAD_DIMS for dt in (torch.float32, torch.bfloat16)},
         fused_block_occupancy={
             f"T={t} {ep} {str(dt).removeprefix('torch.')}": fb.occupancy(t, ep, dt)
             for t in (256, fb.MAX_T) for ep in fb.EPILOGUES
             for dt in (torch.float32, torch.bfloat16)})

    mem_record = launch_audit_phase(card)

    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    paged = check_paged(timer, gen)
    decode = check_decode_attention(timer, gen)
    flash = check_flash(timer, gen)
    flash_long = check_flash_long(timer, gen)
    time_dq_strategies(timer, gen)
    qkv = check_flash_qkv(timer, gen)[(fqa.DEFAULT_BLOCK, fqa.DEFAULT_BLOCK)]
    check_flash_examples(timer, gen)
    check_flash_d128(timer, gen)
    torch.cuda.empty_cache()
    block = check_fused_block(timer, gen)
    conv = check_fused_conv(timer, gen)[(524288, 64, "float32")]
    moe = check_moe_kernels(timer, gen)
    bad = badpallas_phase(timer, gen, card)
    del timer
    torch.cuda.empty_cache()
    # Rows 6-7: no model path reaches them (in either package); their path
    # is the tuner's, and their launches are those of the table-read drive.
    for name, count in tune_phase(card).items():
        qkv[name]["launches"] = count
    torch.cuda.empty_cache()

    model = TransformerLM(TransformerConfig.gpt2_124m())
    params = _drawn_params(model.config)
    paged["launches"] = serve_phase(model, params, card)
    # The serve half of the ops plane (PR 18): the same requests under
    # telemetry, the tracer, the exporter and a trace window; the CLI.
    serve_obs_phase(model, params, card)
    serve_cli_phase(card)
    decode["launches"] = generate_phase(model, params, card)
    del params
    train, prepared, window = train_phase(card)
    calib_phase(window, card)
    del window
    checkpoint_gpt2_phase(prepared, card)
    del prepared
    # The memory audit held to the allocator (PR 25), outside any profiler
    # window, before the longer context allocates more.
    torch.cuda.empty_cache()
    mem_phase(mem_record, card)
    # The determinism audit held to the card: both replays and the
    # deterministic-mode warnings, outside any profiler window.
    torch.cuda.empty_cache()
    repro_phase(card)
    flash["flash_fwd"]["launches"] = train["flash_fwd"]
    flash["flash_bwd"]["launches"] = train["flash_bwd"]
    flash_long["flash_dq"]["launches"] = train_long_phase(card)["flash_dq"]
    torch.cuda.empty_cache()
    # The char-LM train step runs the separate epilogue (attention dropout).
    block["separate"]["launches"] = char_lm_phases(card)
    torch.cuda.empty_cache()
    # Row 9 on the main path (cifar_train); row 10 on the stats_xla drive.
    conv["twopass"]["launches"], conv["normalize"]["launches"] = cifar_phases(card)
    torch.cuda.empty_cache()
    vit_phases(card)
    torch.cuda.empty_cache()
    mnist_phase(card)
    llama_phase(card)
    torch.cuda.empty_cache()
    llama_d128_train_phase(card)
    torch.cuda.empty_cache()
    llama_d128_serve_phase(card)
    torch.cuda.empty_cache()
    vit_recipe_phase(card)
    bpe_lm_phase(card)
    torch.cuda.empty_cache()
    # Rows 11, gmm and tgmm: launches of the moe_train main path (tgmm's
    # count covers both of its shapes, each half of it).
    for name, count in moe_phases(card).items():
        if name in moe:
            moe[name]["launches"] = count
    moe["tgmm_out_proj"]["launches"] = moe["tgmm"]["launches"]
    model_check_phase()
    train_model_check()
    moe_model_check()
    llama_d128_model_check(card)
    torch.cuda.empty_cache()
    # The ops plane's training half, and rows 9-10's coverage.
    ops_train_phase(card, RECORD["train"][0]["step_ms_median"])
    torch.cuda.empty_cache()
    ops_halt_phase(card)
    strict_guard_phase(card)
    watchdog_phase(card)
    # Resilience and the live export plane (PR 17): the flash kernels' rows
    # 3-4 run in every process of the supervised run.
    torch.cuda.empty_cache()
    supervised_train_phase(card, RECORD["train"][0]["step_ms_median"])
    torch.cuda.empty_cache()
    poison_gate_phase(card)
    # The data-parallel slice (PR 19): two ranks on the card over gloo, the
    # FSDP layout, the launcher's NCCL group; rows 3-4 on every rank.
    torch.cuda.empty_cache()
    # Sync-BN, ring attention and the pipeline run in the same
    # workers: rows 3-5 on the pipeline's stages and the one-rank T = 4096
    # run, none on the two-rank BN path.
    dp_phases(card)
    timer = Timer()
    check_fused_conv_coverage(timer, torch.Generator().manual_seed(16), card)
    del timer

    kernels = []
    for name, row, src, replaces in (
        ("paged_decode", paged, "rocket_tpu_torch/csrc/paged_decode.cu",
         "rocket_tpu/ops/paged_attention.py:137"),
        ("decode_attention", decode, "rocket_tpu_torch/csrc/decode_attention.cu",
         "rocket_tpu/ops/decode_attention.py:64"),
        ("flash_fwd", flash["flash_fwd"], "rocket_tpu_torch/csrc/flash_fwd.cu",
         "rocket_tpu/ops/flash_native.py:134"),
        ("flash_bwd", flash["flash_bwd"], "rocket_tpu_torch/csrc/flash_bwd.cu",
         "rocket_tpu/ops/flash_native.py:270"),
        ("flash_dq", flash_long["flash_dq"], "rocket_tpu_torch/csrc/flash_dq.cu",
         "rocket_tpu/ops/flash_native.py:348"),
        ("fused_block", block["separate"], "rocket_tpu_torch/csrc/fused_block.cu",
         "rocket_tpu/ops/fused_block.py:125"),
        ("fused_bn_twopass", {**conv["twopass"]}, "rocket_tpu_torch/csrc/fused_conv.cu",
         "rocket_tpu/ops/fused_conv.py:102"),
        ("fused_bn_normalize", {**conv["normalize"]}, "rocket_tpu_torch/csrc/fused_conv.cu",
         "rocket_tpu/ops/fused_conv.py:139"),
        ("gather_gmm", moe["gather_gmm"], "rocket_tpu_torch/csrc/gather_gmm.cu",
         "rocket_tpu/ops/gather_gmm.py:117"),
        # The megablox gmm/tgmm kernels live in JAX's library; the TPU
        # path reaches them at this call.
        ("gmm", moe["gmm"], "rocket_tpu_torch/csrc/grouped_gemm.cu", "rocket_tpu/nn/moe.py:85"),
        ("tgmm", moe["tgmm"], "rocket_tpu_torch/csrc/grouped_gemm.cu", "rocket_tpu/nn/moe.py:85"),
        ("tgmm_out_proj", moe["tgmm_out_proj"], "rocket_tpu_torch/csrc/grouped_gemm.cu",
         "rocket_tpu/nn/moe.py:85"),
        ("flash_qkv_fwd", qkv["flash_qkv_fwd"], "rocket_tpu_torch/csrc/flash_attention.cu",
         "rocket_tpu/ops/flash_attention.py:102"),
        ("flash_qkv_bwd", qkv["flash_qkv_bwd"], "rocket_tpu_torch/csrc/flash_attention.cu",
         "rocket_tpu/ops/flash_attention.py:232"),
        ("bad_scale", bad, "rocket_tpu_torch/csrc/badpallas.cu",
         "rocket_tpu/analysis/sched_audit.py:1369"),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        **{k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({**RECORD, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
