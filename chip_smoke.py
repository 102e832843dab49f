#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rocket_tpu_torch/csrc`` with
``nvcc`` (into ``build/kernels/``, first use), holds each kernel against
its plain PyTorch version at the serving path's shapes, serves GPT-2 124M
(random weights from a fixed seed, bf16) through ``ServeEngine``, runs
``generate()`` on it, and checks the whole model on the card against the
CPU. Each phase prints one JSON line; the last three lines are the
per-kernel summary, the card's name and power limit as ``nvidia-smi``
reports them, and ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits 2 and prints no
result. The full record is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, generate
from rocket_tpu_torch.nn.module import map_params
from rocket_tpu_torch.ops import _build
from rocket_tpu_torch.ops import decode_attention as da
from rocket_tpu_torch.ops import paged_attention as pa
from rocket_tpu_torch.serve import ServeConfig, ServeEngine

ROOT = Path(__file__).resolve().parent
#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: Kernel vs plain version on the same CUDA tensors. f32: the same math in
#: another order (and TF32 off). bf16: the plain versions round the
#: attention weights to bf16 before the PV product, the kernels keep them
#: in f32 — about 4e-3 relative on values of order one.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: decode_step_paged on the card vs the CPU, f32 logits of order one.
MODEL_TOL = 1e-3
RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    RECORD.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the serving path finds its pages cold)."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# -- phase 3: kernels against their plain versions -------------------------

def paged_case(dtype, h_kv, gen):
    """The serve path's decode wave: S=8 slots, MB=64 pages of BL=16, D=64,
    Hq=12; positions at 0, block boundaries and 1023; pages past each
    slot's live length point at the trash block 0."""
    s, mb, bl, d, hq = 8, 64, 16, 64, 12
    nb = 1 + s * mb
    positions = torch.tensor([0, 15, 16, 17, 255, 511, 700, 1023], dtype=torch.int32)
    table = torch.zeros((s, mb), dtype=torch.int32)
    for i, p in enumerate(positions.tolist()):
        live = p // bl + 1
        table[i, :live] = 1 + i * mb + torch.randperm(mb, generator=gen)[:live].to(torch.int32)
    mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
    ops = dict(q=mk(s, hq, d), k_pages=mk(nb, bl, h_kv, d), v_pages=mk(nb, bl, h_kv, d),
               block_table=table.cuda(), positions=positions.cuda())
    item = torch.empty((), dtype=dtype).element_size()
    rows = (positions + 1).double()
    nbytes = float(2 * rows.sum() * h_kv * d * item + 2 * s * hq * d * item
                   + 4 * (rows / bl).ceil().sum() + 4 * s)
    flops = float(4 * rows.sum() * hq * d)
    return ops, nbytes, flops


def check_paged(timer, gen):
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        for h_kv in (12, 4):
            ops, nbytes, flops = paged_case(dtype, h_kv, gen)
            got = pa.paged_decode(**ops)
            want = pa.paged_decode_plain(**ops)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(math.isfinite(err) and err <= TOL[dtype],
                    f"paged_decode {dtype} Hkv={h_kv}: max abs err {err} > {TOL[dtype]}")
            # Library yardstick: SDPA over the gathered context (gather untimed).
            s, hq, d = ops["q"].shape
            k = pa.paged_gather(ops["k_pages"], ops["block_table"]).transpose(1, 2)
            v = pa.paged_gather(ops["v_pages"], ops["block_table"]).transpose(1, 2)
            k = k.repeat_interleave(hq // h_kv, 1).contiguous()
            v = v.repeat_interleave(hq // h_kv, 1).contiguous()
            mask = (torch.arange(k.shape[2], device="cuda")[None, :]
                    <= ops["positions"][:, None].long())[:, None, None, :]
            q4 = ops["q"][:, :, None, :]
            row = {
                "dtype": str(dtype).removeprefix("torch."), "s": s, "hq": hq, "hkv": h_kv,
                "d": d, "max_abs_err": err, "tol": TOL[dtype],
                "ms": timer.ms(lambda: pa.paged_decode(**ops)),
                "plain_ms": timer.ms(lambda: pa.paged_decode_plain(**ops)),
                "library_ms": timer.ms(
                    lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)),
            }
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
            emit("parity_paged_decode", **row)
            if dtype == torch.bfloat16 and h_kv == 12:  # GPT-2's serving shape
                entry = row
    return entry


def check_decode_attention(timer, gen):
    def case(b, t_max, h_kv, dtype, pos):
        hq, d = 12, 64
        mk = lambda *shape: torch.randn(*shape, generator=gen).to(dtype).cuda()  # noqa: E731
        ops = dict(q=mk(b, hq, d), k_new=mk(b, h_kv, d), v_new=mk(b, h_kv, d),
                   k_cache=mk(b, h_kv, t_max, d), v_cache=mk(b, h_kv, t_max, d), pos=pos)
        twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        return ops, twin

    for dtype in (torch.bfloat16, torch.float32):
        for h_kv in (12, 4):
            for pos in (0, 500, 1023):
                ops, twin = case(8, 1024, h_kv, dtype, pos)
                got = da.decode_attention(**ops)
                want = da.decode_attention_plain(**twin)
                torch.cuda.synchronize()
                err = (got[0].float() - want[0].float()).abs().max().item()
                require(math.isfinite(err) and err <= TOL[dtype],
                        f"decode_attention {dtype} Hkv={h_kv} pos={pos}: err {err}")
                require(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
                        f"decode_attention {dtype} Hkv={h_kv} pos={pos}: cache row differs")
                emit("parity_decode_attention", dtype=str(dtype).removeprefix("torch."),
                     b=8, t=1024, hkv=h_kv, pos=pos, max_abs_err=err, tol=TOL[dtype])
    # Timed at generate()'s shape in the generate phase: B=4, T=192, the
    # last position, bf16, MHA.
    b, t_max, pos, dtype = 4, 192, 191, torch.bfloat16
    ops, twin = case(b, t_max, 12, dtype, pos)
    err = (da.decode_attention(**ops)[0].float()
           - da.decode_attention_plain(**twin)[0].float()).abs().max().item()
    require(err <= TOL[dtype], f"decode_attention timing case: err {err}")
    q4 = ops["q"][:, :, None, :]
    kc, vc = ops["k_cache"][:, :, :pos + 1], ops["v_cache"][:, :, :pos + 1]
    # Cache rows [0, pos) of K and V read; q, out, k_new, v_new and the
    # written K/V row moved once each (bf16, 2 bytes).
    nbytes = 2 * b * 12 * pos * 64 * 2 + 6 * b * 12 * 64 * 2
    row = {
        "dtype": "bfloat16", "b": b, "t": t_max, "pos": pos, "hq": 12, "hkv": 12, "d": 64,
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": timer.ms(lambda: da.decode_attention(**ops)),
        "plain_ms": timer.ms(lambda: da.decode_attention_plain(**twin)),
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(q4, kc, vc)),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4 * b * 12 * 64 * (pos + 1), dtype)
    emit("timing_decode_attention", **row)
    return row


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
    pa.paged_decode.launches = 0
    da.decode_attention.launches = 0
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
    profile_serve(engine, model.config.vocab_size, card)
    return launches


def profile_serve(engine, vocab, card):
    """Where a serve run's time goes: a torch.profiler trace of 8 requests
    (prompt 128, 32 new tokens) on the warm engine. Device busy share is the
    summed kernel/copy time over the wall time (one stream, so no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=128).astype(np.int32) for _ in range(8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, max_new_tokens=32)
        engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() * 1e-6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit("serve_profile", requests=8, prompt=128, new_tokens=32, wall_s=wall,
         device_busy_s=busy, device_idle_share=(1.0 - busy / wall) if busy else None,
         device_time_measured=busy > 0,
         top_kernels=[{"name": n[:120], "s": t, "share_of_device": t / busy} for n, t in top],
         card=card)


def generate_phase(model, params, card):
    prompt = np.random.default_rng(1).integers(0, model.config.vocab_size, size=(4, 128))
    generate(model, params, prompt, 4, temperature=0)  # warmup
    torch.cuda.synchronize()
    da.decode_attention.launches = 0
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
    emit("build", seconds=time.perf_counter() - t0, kernels={
        name: {"seconds": info["seconds"],
               "ptxas": [ln.strip() for ln in info["ptxas"].splitlines() if "Used" in ln]}
        for name, info in built.items()})

    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    paged = check_paged(timer, gen)
    decode = check_decode_attention(timer, gen)
    del timer

    model = TransformerLM(TransformerConfig.gpt2_124m())
    params = model.init(torch.Generator().manual_seed(0))
    paged["launches"] = serve_phase(model, params, card)
    decode["launches"] = generate_phase(model, params, card)
    del params
    model_check_phase()

    kernels = []
    for name, row, src, replaces in (
        ("paged_decode", paged, "rocket_tpu_torch/csrc/paged_decode.cu",
         "rocket_tpu/ops/paged_attention.py:137"),
        ("decode_attention", decode, "rocket_tpu_torch/csrc/decode_attention.cu",
         "rocket_tpu/ops/decode_attention.py:64"),
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
