"""The schedule audit's kernel leg for Hopper (counterpart of
``rocket_tpu/analysis/sched_audit.py``: ``PallasFact`` and its collector
at ``:777-857``, ``SchedAuditReport`` and ``audit_schedule`` at
``:943-1011``, ``SchedTarget`` at ``:1066``, the targets at ``:1403``).

A step function runs on ``meta`` tensors: torch's abstract tensors, which
carry shapes and dtypes and no storage, so a full-width GPT-2 train step
traces on the CPU in well under a second and needs no card. Every kernel
wrapper of the port (``rocket_tpu_torch/ops``) given meta tensors records
the :class:`~rocket_tpu_torch.ops._launch.LaunchFact` of the launch it
would make — grid, threads, dynamic and static shared memory, operand
tiles — and returns empty outputs of the right shapes, so the step runs on
to its end. :func:`collect_launch_facts` gathers the facts under
``tune.priced_device_kind(kind)``, so tune-table lookups resolve as they
would on the audited card; :func:`audit_schedule` holds them to that card
with RKT504 (:func:`~rocket_tpu_torch.analysis.rules.sched_rules.
check_launches`): shared memory over the opt-in, and tiles misaligned with
its sectors and tensor-core fragments. A kernel whose shapes, tune table or
template outgrow the card is caught here, on the CPU, before any launch.

The reference's HLO roofline legs (RKT501-503, 505, 506: exposed
collectives, convoys, memory-bound critical paths, the predicted-MFU floor
and the schedule budgets) have no torch counterpart yet.

``python -m rocket_tpu_torch.analysis sched`` audits the non-demo
:data:`SCHED_TARGETS`, each at the shapes ``chip_smoke.py`` runs its
kernels on the card; ``--target badpallas`` runs the seeded-bad demo (row
12), which must report RKT504 in both kinds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from rocket_tpu_torch.analysis.rules.sched_rules import check_launches
from rocket_tpu_torch.ops._launch import record_launches
from rocket_tpu_torch.utils.perf import device_spec

__all__ = [
    "DEFAULT_DEVICE_KIND", "SchedAuditReport", "SchedTarget", "SCHED_TARGETS",
    "audit_schedule", "collect_launch_facts", "run_sched_target",
]

#: The card the audit prices against unless told otherwise: the card
#: ``chip_smoke.py`` runs on.
DEFAULT_DEVICE_KIND = "NVIDIA H100 80GB HBM3"


def _spec(device_kind: str):
    spec = device_spec(device_kind)
    if spec is None:
        raise ValueError(f"sched_audit: unknown device kind {device_kind!r}; add it to "
                         "rocket_tpu_torch.utils.perf.DEVICE_SPECS")
    return spec


def collect_launch_facts(step_fn: Callable, *args, device_kind: str = DEFAULT_DEVICE_KIND) -> list:
    """Run ``step_fn(*args)`` (meta tensors in ``args``) and return the
    facts of every kernel launch it would make on ``device_kind``, in
    launch order."""
    from rocket_tpu_torch.tune import priced_device_kind

    _spec(device_kind)
    with priced_device_kind(device_kind), record_launches() as facts:
        step_fn(*args)
    return list(facts)


@dataclass
class SchedAuditReport:
    """One audited step: its label, the launches it would make, and the
    RKT504 findings against the card."""

    label: str
    launches: list = field(default_factory=list)
    findings: list = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def audit_schedule(step_fn: Callable, *args, device_kind: str = DEFAULT_DEVICE_KIND,
                   label: str = "step") -> SchedAuditReport:
    """The kernel leg of the schedule audit for ``step_fn(*args)`` on
    ``device_kind``: :func:`collect_launch_facts`, then RKT504."""
    facts = collect_launch_facts(step_fn, *args, device_kind=device_kind)
    return SchedAuditReport(label=label, launches=facts,
                            findings=check_launches(facts, _spec(device_kind), label=label))


# -- targets ------------------------------------------------------------------


@dataclass(frozen=True)
class SchedTarget:
    """One configuration the CLI audits: ``build() -> (step_fn, args)``
    with meta tensors in ``args``. A demo target runs only when named."""

    name: str
    build: Callable[[], tuple]
    doc: str = ""
    demo: bool = False


def _meta(*shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _gpt2_parts(seq_len: int):
    """GPT-2 124M at full width, B=8, bf16 compute, train mode (dropout 0.1
    and its counter-hash keys): the forward and the gradient of every
    parameter. The optimizer launches no hand kernel and is left out; the
    whole-forward remat of the train step only repeats the forward's
    launches."""
    from rocket_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        next_token_loss,
    )
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params

    model = TransformerLM(TransformerConfig.gpt2_124m(max_seq_len=seq_len))
    meta = torch.device("meta")
    with meta:
        params = model.init(torch.Generator().manual_seed(0), device=meta)
    leaves = []
    map_params(lambda t: leaves.append(t.requires_grad_()), params)
    tokens = _meta(8, seq_len, dtype=torch.int32)

    def step(params, tokens):
        out = model.apply(params, {"tokens": tokens}, mode="train", rng=keys.key(0))
        return torch.autograd.grad(next_token_loss()(out), leaves)

    return step, (params, tokens)


def _train_flash_parts():
    """Rows 3-4: GPT-2 124M train step at T=1024, the fused flash forward
    and the backward with dq partials (``chip_smoke.py`` train phase)."""
    return _gpt2_parts(1024)


def _train_flash_long_parts():
    """Row 5: the same at T=2048, where the dq partial buffer passes
    ``ops/flash_native.DQ_PARTIALS_MAX_BYTES`` and the backward adds the
    accumulating dq kernel (``chip_smoke.py`` train_long phase)."""
    return _gpt2_parts(2048)


def _train_flash_tp_parts():
    """Rows 3-4 on one rank of GPT-2 124M's tensor-parallel train step at
    ``--model-axis 2``: each of the 12 layers' attention runs on the rank's
    6 of 12 heads (``MultiHeadAttention._apply_tp``'s ``flash_bthd`` on
    the gathered sequence, B=8, T=1024, D=64), forward and backward
    (``chip_smoke.py`` tp_train phase). The collectives around it launch no
    hand kernel."""
    from rocket_tpu_torch.ops.flash_native import flash_bthd

    heads = 12 // 2
    q, k, v = (_meta(8, 1024, heads * 64).requires_grad_() for _ in range(3))

    def step(q, k, v):
        grads = ()
        for _ in range(12):
            grads += torch.autograd.grad(flash_bthd(q, k, v, heads, heads).float().sum(),
                                         (q, k, v))
        return grads

    return step, (q, k, v)


def _qkv_flash_parts():
    """Rows 6-7: forward and backward of the stacked (3, 8, 12, 1024, 64)
    bf16 operand at both square tile pairs, 128 and 64 (the shapes
    ``chip_smoke.py``'s parity_flash_qkv and tune phases run)."""
    from rocket_tpu_torch.ops.flash_attention import flash_attention_qkv

    qkv = _meta(3, 8, 12, 1024, 64).requires_grad_()

    def step(qkv):
        grads = []
        for block in (128, 64):
            out = flash_attention_qkv(qkv, causal=True, block_q=block, block_k=block)
            grads.append(torch.autograd.grad(out.float().sum(), qkv)[0])
        return grads

    return step, (qkv,)


def _fused_kernels_parts():
    """Rows 8-11 and the grouped products at the reference's
    ``fused_kernels`` shapes (``sched_audit.py:1181-1183``), bf16: the BN
    epilogue over (262144, 64) under both schedules (``"twopass"``: moments,
    finalize and normalise in one launch; ``"stats_xla"``: normalise
    alone), the fused block at (64, 256, 256) with 4 heads under both
    epilogues, gather-GMM of 2048 x 768 rows into (4, 768, 3072), and the
    dropless MoE FFN's grouped products at GPT-2 widths (16384 routed rows,
    4 experts): the in- and out-projection forward, gmm with the transposed
    rhs and tgmm in their backward."""
    from rocket_tpu_torch.ops.fused_block import block_attn_half
    from rocket_tpu_torch.ops.fused_conv import fused_bn_act
    from rocket_tpu_torch.ops.gather_gmm import gather_gmm
    from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

    f32, i32 = torch.float32, torch.int32
    m, dim, ffn, e = 16384, 768, 3072, 4
    operands = {
        "x_conv": _meta(262144, 64), "bn_scale": _meta(64, dtype=f32),
        "bn_bias": _meta(64, dtype=f32),
        "x_blk": _meta(64, 256, 256), "ln_scale": _meta(256, dtype=f32),
        "ln_bias": _meta(256, dtype=f32), "wqkv": _meta(256, 768, dtype=f32),
        "bqkv": _meta(768, dtype=f32), "wproj": _meta(256, 256, dtype=f32),
        "bproj": _meta(256, dtype=f32),
        "x_tok": _meta(2048, dim), "experts": _meta(e, dim, ffn),
        "row_ids": _meta(2048, dtype=i32), "group_sizes": _meta(e, dtype=i32),
        "h_in": _meta(m, dim).requires_grad_(), "w_in": _meta(e, dim, ffn).requires_grad_(),
        "w_out": _meta(e, ffn, dim).requires_grad_(), "sizes": _meta(e, dtype=i32),
    }

    def step(p):
        outs = [fused_bn_act(p["x_conv"], p["bn_scale"], p["bn_bias"], schedule=schedule)[0]
                for schedule in ("twopass", "stats_xla")]
        outs += [block_attn_half(p["x_blk"], p["ln_scale"], p["ln_bias"], p["wqkv"], p["bqkv"],
                                 p["wproj"], p["bproj"], num_heads=4, epilogue=epilogue)
                 for epilogue in ("fused", "separate")]
        outs.append(gather_gmm(p["x_tok"], p["experts"], p["row_ids"], p["group_sizes"]))
        up = grouped_matmul(p["h_in"], p["w_in"], p["sizes"])
        down = grouped_matmul(up, p["w_out"], p["sizes"])
        outs += torch.autograd.grad(down.float().sum(), (p["h_in"], p["w_in"], p["w_out"]))
        return outs

    return step, (operands,)


def _serve_parts():
    """Rows 1-2 at ``chip_smoke.py``'s serve shapes, bf16, GPT-2 heads
    (Hq = Hkv = 12, D = 64): a paged decode wave of 8 slots over 64 blocks
    of 16 rows each, and ``generate()``'s cached decode step at B=4 against
    a 192-row cache."""
    from rocket_tpu_torch.ops.decode_attention import decode_attention
    from rocket_tpu_torch.ops.paged_attention import paged_decode

    s, mb, bl, h, d = 8, 64, 16, 12, 64
    pool = _meta(1 + s * mb, bl, h, d)
    paged = (_meta(s, h, d), pool, pool, _meta(s, mb, dtype=torch.int32),
             _meta(s, dtype=torch.int32))
    cache = _meta(4, h, 192, d)
    dense = (_meta(4, h, d), _meta(4, h, d), _meta(4, h, d), cache, cache, 191)

    def step(paged, dense):
        return paged_decode(*paged), decode_attention(*dense)

    return step, (paged, dense)


def _vit_flash_parts():
    """Rows 3-4 at ViT's shape: the ``vit_cifar`` example's train step
    (``vit_tiny``: D=192, 9 blocks, 3 heads of 64, dropout 0.1) at B=512 on
    32x32 images in 4x4 patches, bf16: T = 65 tokens (a second 64-row tile
    holding one row), non-causal, the fused qkv operand (``chip_smoke.py``
    vit_train phase)."""
    from rocket_tpu_torch.models.vit import vit_tiny
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params

    model = vit_tiny(dropout=0.1)
    meta = torch.device("meta")
    with meta:
        params = model.init(torch.Generator().manual_seed(0), device=meta)
    leaves = []
    map_params(lambda t: leaves.append(t.requires_grad_()), params)

    def step(params, images, labels):
        out = model.apply(params, {"image": images}, mode="train", rng=keys.key(0))
        loss = torch.nn.functional.cross_entropy(out["logits"].float(), labels.long())
        return torch.autograd.grad(loss, leaves)

    return step, (params, _meta(512, 32, 32, 3), _meta(512, dtype=torch.int32))


def _llama_flash_parts():
    """Rows 3-4 and 2 at the ``llama_lm`` example's shapes, bf16: its train
    step (dim 256, 6 layers, 8 query heads over 4 K/V heads of 32, RoPE) at
    B=128, T=256 on the bthd GQA operands, and one decode step of its
    nucleus sample (B=1, a 68-row cache, the last position), a group of 2
    (``chip_smoke.py`` llama_train phase)."""
    from rocket_tpu_torch.examples.llama_lm import config_for
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params
    from rocket_tpu_torch.ops.decode_attention import decode_attention

    model = TransformerLM(config_for(vocab_size=64, seq_len=256))
    meta = torch.device("meta")
    with meta:
        params = model.init(torch.Generator().manual_seed(0), device=meta)
    leaves = []
    map_params(lambda t: leaves.append(t.requires_grad_()), params)
    cache = _meta(1, 4, 68, 32)
    dense = (_meta(1, 8, 32), _meta(1, 4, 32), _meta(1, 4, 32), cache, cache, 67)

    def step(params, tokens, dense):
        out = model.apply(params, {"tokens": tokens}, mode="train", rng=keys.key(0))
        return torch.autograd.grad(next_token_loss()(out), leaves), decode_attention(*dense)

    return step, (params, _meta(128, 256, dtype=torch.int32), dense)


def _flash_d128_parts():
    """Rows 3-7 at head dim 128, bf16, causal: the Llama-3-8B attention
    width (B=2, T=2048, 32 query heads over 8 K/V heads of 128, bthd GQA;
    its dq partials would pass ``DQ_PARTIALS_MAX_BYTES``, so the backward
    is row 4 without dq and row 5), Phi-3-mini's 32 heads of 96 on the fused
    operand (B=1, padded to 128: row 4 with dq partials), and the stacked
    (3, 2, 32, 2048, 128) operand at its one compiled tile pair, 64 x 64
    (``chip_smoke.py``'s parity_flash_d128 phase)."""
    from rocket_tpu_torch.ops.flash_attention import flash_attention_qkv
    from rocket_tpu_torch.ops.flash_native import flash_bthd, flash_fused

    q, k, v = (_meta(2, 2048, w).requires_grad_() for w in (32 * 128, 8 * 128, 8 * 128))
    fused = _meta(1, 2048, 3 * 32 * 96).requires_grad_()
    qkv = _meta(3, 2, 32, 2048, 128).requires_grad_()

    def step(q, k, v, fused, qkv):
        grads = torch.autograd.grad(flash_bthd(q, k, v, 32, 8).float().sum(), (q, k, v))
        grads += torch.autograd.grad(flash_fused(fused, 32).float().sum(), (fused,))
        return grads + torch.autograd.grad(
            flash_attention_qkv(qkv, True, 64, 64).float().sum(), (qkv,))

    return step, (q, k, v, fused, qkv)


def _badpallas_parts():
    """Row 12, the seeded-bad demo: the fixture's two launches on a
    (4096, 4096) f32 array, 2 * x in (7, 100) blocks over grid (4,) — a tile
    misfit on both dims — and in one whole-array block, 64 MiB of shared
    memory. Exactly RKT504, once of each kind, and nothing else."""
    from rocket_tpu_torch.ops.badpallas import bad_scale

    def step(x):
        y = bad_scale(x, block=(7, 100), grid=(4,))
        z = bad_scale(x, block=tuple(x.shape), grid=())
        return y, z

    return step, (_meta(4096, 4096, dtype=torch.float32),)


#: name -> target; the CLI's default sweep runs every non-demo one.
SCHED_TARGETS = {target.name: target for target in (
    SchedTarget("train_flash", _train_flash_parts, "GPT-2 124M train step, B=8 T=1024 (rows 3-4)"),
    SchedTarget("train_flash_long", _train_flash_long_parts,
                "GPT-2 124M train step, B=8 T=2048 (rows 3-5)"),
    SchedTarget("train_flash_tp", _train_flash_tp_parts, "GPT-2 124M tensor-parallel train "
                "step, one rank at --model-axis 2: 6 of 12 heads, B=8 T=1024 (rows 3-4)"),
    SchedTarget("qkv_flash", _qkv_flash_parts, "stacked-qkv flash, (3, 8, 12, 1024, 64), "
                "tiles 128 and 64 (rows 6-7)"),
    SchedTarget("fused_kernels", _fused_kernels_parts, "BN epilogue, fused block, gather-GMM, "
                "gmm/tgmm (rows 8-11)"),
    SchedTarget("serve", _serve_parts, "paged decode wave and cached decode step (rows 1-2)"),
    SchedTarget("vit_flash", _vit_flash_parts, "ViT-Ti train step, B=512 T=65 non-causal "
                "(rows 3-4)"),
    SchedTarget("llama_flash", _llama_flash_parts, "Llama char-LM train step, B=128 T=256 GQA "
                "D=32, and its decode step (rows 2-4)"),
    SchedTarget("train_flash_d128", _flash_d128_parts, "head dim 128: Llama-3-8B GQA "
                "B=2 T=2048 (rows 3-5), Phi-3-mini D=96 padded (rows 3-4), stacked 64x64 "
                "(rows 6-7)"),
    SchedTarget("badpallas", _badpallas_parts, "seeded-bad 2*x: misaligned and over-budget "
                "blocks (row 12)", demo=True),
)}


def run_sched_target(target: SchedTarget, device_kind: str = DEFAULT_DEVICE_KIND
                     ) -> SchedAuditReport:
    step_fn, args = target.build()
    return audit_schedule(step_fn, *args, device_kind=device_kind, label=target.name)
