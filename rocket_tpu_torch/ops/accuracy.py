"""How well a hand kernel accumulates: its error against an f64 result of
the same operands, beside the error the same sum would have if it were
accumulated in bf16 one K tile at a time.

A kernel that declares an f32 accumulator (``ops._launch.LaunchFact.
acc_dtype``, read by the precision audit) should round once, at its
output; a sum carried in bf16 across the kernel's K tiles rounds once per
tile. :func:`grouped_errors` and :func:`flash_bwd_errors` measure both on
the card at a main path's longest contraction (``tgmm`` over the MoE's
routed rows, ``gmm`` over K = 3072, ``flash_bwd``'s dk and dv over
T = 1024 queries); a kernel whose error is not below the tile-wise bf16
sum's does not accumulate in f32. The f64 sums run in PyTorch on the same
device, outside the port's paths.
"""

from __future__ import annotations

import torch

__all__ = ["bf16_tile_sum", "grouped_errors", "flash_bwd_errors"]


def bf16_tile_sum(partials) -> torch.Tensor:
    """The sum of f64 ``partials`` (one a K tile) carried in bf16: each exact
    partial added to a bf16 running sum, one rounding a tile."""
    acc = None
    for part in partials:
        acc = part.to(torch.bfloat16) if acc is None else (acc.double() + part).to(
            torch.bfloat16)
    return acc


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max())


def _bounds(sizes: torch.Tensor, m: int) -> list:
    out, start = [], 0
    for size in sizes.tolist():
        end = min(start + max(int(size), 0), m)
        out.append((start, end))
        start = end
    return out


def grouped_errors(kind: str, lhs: torch.Tensor, other: torch.Tensor, sizes: torch.Tensor,
                   out: torch.Tensor, tile: int) -> dict:
    """``{"kernel": err, "bf16_tiles": err, "contraction": n}``, max abs
    errors against the f64 result, of ``out``: ``gmm``'s ``lhs (M, K) @
    rhs[g] (K, N)`` over each group's rows (K in ``tile``-wide slices), or
    ``tgmm``'s ``lhs_g.T @ dy_g`` (the group's rows in ``tile``-row
    slices)."""
    m = lhs.shape[0]
    f64, tiles = torch.zeros_like(out, dtype=torch.float64), torch.zeros_like(out)
    longest = 0
    for g, (s, e) in enumerate(_bounds(sizes, m)):
        if e <= s:
            continue
        if kind == "gmm":
            a, b = lhs[s:e].double(), other[g].double()
            parts = [a[:, k:k + tile] @ b[k:k + tile] for k in range(0, a.shape[1], tile)]
            f64[s:e], tiles[s:e] = sum(parts), bf16_tile_sum(parts)
            longest = max(longest, a.shape[1])
        else:
            a, b = lhs[s:e].double(), other[s:e].double()
            parts = [a[r:r + tile].T @ b[r:r + tile] for r in range(0, e - s, tile)]
            f64[g], tiles[g] = sum(parts), bf16_tile_sum(parts)
            longest = max(longest, e - s)
    return {"kernel": _max_err(out, f64), "bf16_tiles": _max_err(tiles, f64),
            "contraction": longest}


def flash_bwd_errors(p: torch.Tensor, ds: torch.Tensor, q: torch.Tensor, do: torch.Tensor,
                     dk: torch.Tensor, dv: torch.Tensor, tile: int) -> dict:
    """``{"dk": {...}, "dv": {...}}`` as :func:`grouped_errors` for the
    flash backward's key-side gradients: ``dv = sum_q p[q, s] dout[q]`` and
    ``dk = sum_q ds[q, s] q[q]`` over the queries in ``tile``-row steps.
    ``p``, ``ds`` (B, Hkv, g, Tq, Tk) and ``q``, ``do`` (B, Tq, Hkv, g, D)
    are the plain version's (``flash_native._probs_and_ds``); ``dk``,
    ``dv`` (B, Tk, Hkv*D) the kernel's."""
    b, t = q.shape[:2]
    out = {}
    for name, weights, rows, got in (("dv", p, do, dv), ("dk", ds, q, dk)):
        parts = [torch.einsum("bkgqs,bqkgd->bskd", weights[..., r:r + tile, :].double(),
                              rows[:, r:r + tile].double()).reshape(b, t, -1)
                 for r in range(0, t, tile)]
        want = sum(parts)
        out[name] = {"kernel": _max_err(got, want), "bf16_tiles": _max_err(
            bf16_tile_sum(parts), want), "contraction": t}
    return out
