"""Declarative tune spaces — the LEGAL config set per tunable kernel
(counterpart of ``rocket_tpu/tune/space.py``).

Each tunable kernel declares a :class:`TuneSpace`: the config axes the
offline tuner (``python -m rocket_tpu_torch.tune``) may sweep, the default
config (today's hand-picked values — the runtime fallback when no table
entry matches) and a legality predicate that rejects configs the card
cannot run BEFORE anything is timed.

Axes come in two kinds. **Launch-config axes** pick parameters of one
kernel (the flash tiles). **Structural axes** (:attr:`TuneSpace.structural`)
pick between different programs: the CUDA kernel or the plain path
(``paged_decode.impl``, ``fused_conv.impl``, ``block_attn.impl``), fusion
boundaries (``block_attn.epilogue``), whole variants (``moe_gmm.impl``),
schedules (``fused_conv.schedule``). The sweep treats both alike
(enumerate -> build -> time with the build excluded -> fwd+bwd parity
reject -> table). Every structural default is the pre-existing path, so an
empty table, or ``ROCKET_TPU_TUNE=0``, runs exactly what an untuned
checkout runs.

The axes are what the port's code varies on the card. The names and
values are the reference's, so a table reads the same in both packages;
an axis the CUDA kernel does not take is not invented. Where the
reference's TPU tile (``block_rows``, ``block_b``) survives only as the
call site's shape gate, the axis stays with its default as the one legal
value, and the gate is its legality. The flash tiles are the compiled
tiles of ``csrc/flash_attention.cu`` at the shape's head dim (64 and 128 at
D <= 64, 64 at D = 128), checked against the
card's shared-memory budget (:class:`~rocket_tpu_torch.utils.perf.
DeviceSpec.smem_bytes`).

:data:`TUNE_SPACES` is shared by the runtime lookup (``table.get_config``
buckets shapes with :meth:`TuneSpace.bucket`), the tuner (candidates) and
the table gate (``table.validate_tables`` re-verifies every entry).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Tuple

from rocket_tpu_torch.utils.perf import DeviceSpec

__all__ = ["TuneSpace", "TUNE_SPACES", "canonical_dtype"]


def canonical_dtype(dtype) -> str:
    """``'bfloat16'`` / ``'float32'`` style name for a torch dtype, a numpy
    dtype or a string — the table's dtype key."""
    if isinstance(dtype, str):
        return dtype.removeprefix("torch.")
    name = getattr(dtype, "name", None)
    if isinstance(name, str):
        return name
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class TuneSpace:
    """The legal config set for one tunable kernel.

    ``axes`` maps config key -> candidate values (the cross product is the
    raw search space; ``legal`` prunes it). ``default`` computes today's
    config for a shape — the runtime fallback, and the baseline every
    candidate is timed and parity-checked against. ``legal`` returns a list
    of human-readable violations (empty = legal). ``shape_keys`` names the
    shape-dict keys the bucket is keyed on.
    """

    kernel: str
    axes: Mapping[str, Tuple]
    shape_keys: Tuple[str, ...]
    default: Callable[[Mapping], dict]
    legal: Callable[[dict, Mapping, Optional[DeviceSpec], str], list] = \
        field(default=lambda config, shape, spec, dtype: [])
    doc: str = ""
    #: Axis names whose values are different programs, not launch
    #: parameters of one. Drives the ``--list`` catalog and the
    #: stale-structural-winner table gate.
    structural: Tuple[str, ...] = ()
    #: Per-dtype (atol, rtol) parity-tolerance overrides for this kernel's
    #: sweeps, merged over the tuner's defaults.
    parity_tol: Mapping[str, Tuple[float, float]] = field(default_factory=dict)

    def bucket(self, shape: Mapping) -> str:
        """Deterministic shape-bucket string for the table key: exact
        shapes, not ranges."""
        parts = []
        for key in self.shape_keys:
            value = shape[key]
            if isinstance(value, bool):
                value = "t" if value else "f"
            parts.append(f"{key}{value}")
        return "_".join(parts)

    def candidates(self, shape: Mapping, spec: Optional[DeviceSpec], dtype: str) -> list:
        """Every LEGAL config in the axes cross product (default included
        when legal), deterministic order."""
        keys = sorted(self.axes)
        out = []
        for values in itertools.product(*(self.axes[k] for k in keys)):
            config = dict(zip(keys, values))
            if not self.legal(config, shape, spec, dtype):
                out.append(config)
        return out

    def violations(self, config: Mapping, shape: Mapping, spec: Optional[DeviceSpec],
                   dtype: str) -> list:
        """Axis-membership + kernel legality violations for ``config``."""
        problems = []
        for key, value in config.items():
            if key not in self.axes:
                problems.append(f"unknown config axis {key!r}")
            elif value not in self.axes[key]:
                problems.append(f"{key}={value!r} not in candidates {self.axes[key]}")
        for key in self.axes:
            if key not in config:
                problems.append(f"config missing axis {key!r}")
        for key in self.shape_keys:
            if key not in shape:
                problems.append(f"shape missing key {key!r}")
        if problems:
            return problems
        return list(self.legal(dict(config), shape, spec, dtype))


def _inert(config, pins: Mapping, why: str) -> list:
    """Reject non-default values of axes that cannot affect the selected
    variant — one candidate per program."""
    return [
        f"{axis}={config[axis]!r} is inert for {why} — only the default {default!r} is "
        "enumerated"
        for axis, default in pins.items()
        if config.get(axis) != default
    ]


# -- per-kernel legality ------------------------------------------------------


def _flash_legal(kind: str):
    def legal(config, shape, spec, dtype) -> list:
        from rocket_tpu_torch.ops import flash_attention as fa

        problems = []
        t, d = shape["t"], shape["d"]
        bq, bk = config["block_q"], config["block_k"]
        for what, block in (("block_q", bq), ("block_k", bk)):
            if t % block:
                problems.append(f"{what}={block} does not divide T={t}")
        if shape.get("causal", True) and bq != bk:
            problems.append(f"causal requires block_q == block_k (got {bq} != {bk})")
        if not fa.flash_supported(d):
            problems.append(f"head dim {d} has no kernel (D <= {fa.HEAD_DIMS[-1]})")
            return problems
        for what, block in (("block_q", bq), ("block_k", bk)):
            if block not in fa.tiles_for(d):
                problems.append(f"{what}={block} is not compiled at head dim "
                                f"{fa.kernel_dim(d)} (tiles {fa.tiles_for(d)})")
        if shape.get("h_kv", shape["h"]) != shape["h"]:
            problems.append("the stacked-qkv kernels take h_kv == h only")
        if spec is not None:
            need = fa.smem_bytes(kind, bq, bk, fa.kernel_dim(d), dtype)
            if need > spec.smem_bytes:
                problems.append(f"shared memory {need} B over the {spec.kind} budget "
                                f"{spec.smem_bytes} B")
        return problems

    return legal


def _flash_default(shape) -> dict:
    from rocket_tpu_torch.ops.flash_attention import default_block, pick_block

    fallback = default_block(shape["d"])
    block = pick_block(shape["t"], min(fallback, shape["t"]), shape["d"]) or fallback
    return {"block_q": block, "block_k": block}


def _paged_legal(config, shape, spec, dtype) -> list:
    """paged_decode: the CUDA kernel takes head dims that are multiples of 8
    up to 256 (``ops/paged_attention.paged_decode``); the gather path
    (``"xla"``) takes anything."""
    d = shape["d"]
    if config["impl"] == "pallas" and (d % 8 or d > 256):
        return [f"head_dim={d} is not a multiple of 8 up to 256 (the CUDA kernel)"]
    return []


#: Hand-picked defaults, single-sourced: the ``default`` lambdas and the
#: inert-axis pins both read these.
_GMM_DEFAULT = {"impl": "gmm", "tile_m": 512}
#: The gather-GMM tile_n the port's MoE layer passes (``nn/moe.gmm_config``).
_GMM_TILE_N = 512
_FUSED_CONV_DEFAULT = {"impl": "reference", "schedule": "twopass", "block_rows": 512}
_BLOCK_ATTN_DEFAULT = {"impl": "reference", "epilogue": "fused", "block_b": 1}


def _gmm_legal(config, shape, spec, dtype) -> list:
    """moe_gmm: ``"gmm"`` (explicit row gather, then the grouped GEMM
    kernels, which choose their own tiles: tile_m is inert) or ``"fused"``
    (gather-GMM over the padded layout, whose groups pad to tile_m; the
    layer passes tile_n = min(512, N), which must tile N by 128-multiples,
    ``ops/gather_gmm.gather_gmm_supported``)."""
    if config["impl"] == "gmm":
        return _inert(config, {"tile_m": _GMM_DEFAULT["tile_m"]},
                      "impl=gmm (the grouped GEMM kernels tile themselves)")
    from rocket_tpu_torch.ops.gather_gmm import gather_gmm_supported

    tn = min(_GMM_TILE_N, shape["n"])
    if not gather_gmm_supported(shape["k"], shape["n"], tn):
        return [f"gather-GMM does not take K={shape['k']}, N={shape['n']} at tile_n={tn}"]
    return []


def _fused_conv_legal(config, shape, spec, dtype) -> list:
    """fused_conv: the BN(+relu) epilogue kernels over the flattened (N, C)
    activation. The CUDA kernels choose their own grid: block_rows is the
    call site's gate only (N must tile it), so only its default is
    enumerated; C must be a kernel width."""
    if config["impl"] == "reference":
        return _inert(config, {k: _FUSED_CONV_DEFAULT[k] for k in ("schedule", "block_rows")},
                      "impl=reference (the plain BN + relu chain)")
    from rocket_tpu_torch.ops import fused_conv

    problems = _inert(config, {"block_rows": _FUSED_CONV_DEFAULT["block_rows"]},
                      "the CUDA kernels (they choose their own grid)")
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    if not fused_conv.fused_bn_act_supported(shape["n"], config["block_rows"], itemsize):
        problems.append(f"block_rows={config['block_rows']} does not tile N={shape['n']}")
    c = shape["c"]
    if c % 8 or not 8 <= c <= fused_conv.MAX_C:
        problems.append(f"C={c} is not a multiple of 8 up to {fused_conv.MAX_C}")
    return problems


def _block_attn_legal(config, shape, spec, dtype) -> list:
    """block_attn: the whole-block ln1+QKV+attention(+projection) kernel
    (``ops/fused_block.py``): one CTA per (head, batch row), so block_b is
    the call site's gate only; the kernel's own limits (head dim, T, heads
    of the fused epilogue) hold."""
    if config["impl"] == "reference":
        return _inert(config, {k: _BLOCK_ATTN_DEFAULT[k] for k in ("epilogue", "block_b")},
                      "impl=reference (the per-op layer chain)")
    from rocket_tpu_torch.ops import fused_block

    b, t, d, h = shape["b"], shape["t"], shape["d"], shape["h"]
    problems = _inert(config, {"block_b": _BLOCK_ATTN_DEFAULT["block_b"]},
                      "the CUDA kernel (one CTA per head and batch row)")
    if not fused_block.block_attn_supported(b, t, d, h, config["block_b"]):
        problems.append(f"shape B={b} T={t} D={d} H={h} fails the block_attn gate")
    if not fused_block.kernel_supported(t, d, h, config["epilogue"]):
        problems.append(f"the kernel does not take T={t} D={d} H={h} with the "
                        f"{config['epilogue']} epilogue")
    return problems


#: kernel name -> TuneSpace. The names are the table file names
#: (``rocket_tpu_torch/tune/configs/<kernel>.json``) and the lookup keys.
TUNE_SPACES: dict[str, TuneSpace] = {
    space.kernel: space
    for space in (
        TuneSpace(
            kernel="flash_fwd",
            axes={"block_q": (64, 128), "block_k": (64, 128)},
            shape_keys=("t", "d", "h", "h_kv", "causal"),
            default=_flash_default,
            legal=_flash_legal("fwd"),
            doc="flash attention forward (ops/flash_attention.py, rows 6-7): the "
                "kernel's compiled query/key tiles; causal pins square tiles",
        ),
        TuneSpace(
            kernel="flash_bwd",
            axes={"block_q": (64, 128), "block_k": (64, 128)},
            shape_keys=("t", "d", "h", "h_kv", "causal"),
            default=_flash_default,
            legal=_flash_legal("bwd"),
            doc="flash attention fused backward (dk/dv sweep + dq partials): tiles "
                "independent of the forward's; block_k sets the dq partial count",
        ),
        TuneSpace(
            kernel="decode_attention",
            axes={"rows": (8,)},
            shape_keys=("t", "d", "hkv"),
            default=lambda shape: {"rows": 8},
            doc="fused decode attention (ops/decode_attention.py): the port's kernel "
                "has no write-back tile; 8 is the one value, recorded by the lookup only",
        ),
        TuneSpace(
            kernel="paged_decode",
            axes={"impl": ("pallas", "xla")},
            shape_keys=("s", "mb", "bl", "hkv", "hq", "d"),
            default=lambda shape: {"impl": "pallas"},
            legal=_paged_legal,
            structural=("impl",),
            doc="paged-pool decode attention (ops/paged_attention.py at C == 1): impl "
                "'pallas' is the CUDA kernel, 'xla' the gather path (attend_plain) the "
                "prefill already runs; the kernel takes no block_kv",
        ),
        TuneSpace(
            kernel="moe_gmm",
            axes={"impl": ("gmm", "fused"), "tile_m": (128, 256, 512, 1024)},
            shape_keys=("m", "k", "n"),
            default=lambda shape: dict(_GMM_DEFAULT),
            legal=_gmm_legal,
            structural=("impl",),
            doc="dropless-MoE expert products (nn/moe.py): impl 'gmm' (row gather + "
                "grouped GEMM kernels) vs 'fused' (gather-GMM over the padded layout); "
                "tile_m the padded layout's group multiple",
        ),
        TuneSpace(
            kernel="fused_bn",
            axes={"moments": ("separate",)},
            shape_keys=("c",),
            default=lambda shape: {"moments": "separate"},
            structural=("moments",),
            doc="train-mode batchnorm moments (ops/fused_conv.moments): the port takes "
                "the two means separately, the one value, recorded by the lookup only",
        ),
        TuneSpace(
            kernel="fused_conv",
            axes={"impl": ("reference", "pallas"), "schedule": ("twopass", "stats_xla"),
                  "block_rows": (256, 512, 1024)},
            shape_keys=("n", "c"),
            default=lambda shape: dict(_FUSED_CONV_DEFAULT),
            legal=_fused_conv_legal,
            structural=("impl", "schedule"),
            # The schedules reassociate the f32 moment sums (the kernel's
            # fixed-order partials vs torch's reduction): ~e-6 on the
            # statistics, a few e-5 on gradients. Scoped here.
            parity_tol={"float32": (5e-5, 5e-5)},
            doc="conv-stack BN(+relu) epilogue (nn/layers.bn_act_train): impl "
                "'reference' (the plain chain, the default) vs 'pallas' (the CUDA "
                "kernels); schedule 'twopass' (moments in the kernel) vs 'stats_xla' "
                "(plain moments + the normalise kernel); block_rows the gate's tile",
        ),
        TuneSpace(
            kernel="block_attn",
            axes={"impl": ("reference", "fused"), "epilogue": ("fused", "separate"),
                  "block_b": (1, 2, 4, 8)},
            shape_keys=("b", "t", "d", "h"),
            default=lambda shape: dict(_BLOCK_ATTN_DEFAULT),
            legal=_block_attn_legal,
            structural=("impl", "epilogue"),
            # The fused kernel reorders f32 LN/softmax sums; the backward
            # recomputes through the plain chain and inherits the forward's
            # reassociation through the cotangent. Scoped here.
            parity_tol={"float32": (5e-5, 5e-5)},
            doc="whole-block attention half (models/transformer.Block): impl "
                "'reference' (the per-op chain, the default) vs 'fused' (the CUDA "
                "kernel); epilogue 'fused' (projection inside) vs 'separate'; "
                "block_b the gate's batch tile",
        ),
    )
}
