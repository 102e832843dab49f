"""Mixture-of-Experts FFN (counterpart of ``rocket_tpu/nn/moe.py``).

GShard/Switch-style top-k routing, expert params stacked with a leading E
dim (``moe/router/w``, ``moe/experts/{w_in,b_in,w_out,b_out}``, the JAX
tree's names):

* f32 router logits -> softmax gates -> the top k, renormalised over the
  chosen experts (``max(sum, 1e-9)``). The top k come from a stable
  descending sort, so an exact tie routes to the lower expert id first,
  as ``lax.top_k`` does (``torch.topk`` promises no order among ties);
* ``dispatch="einsum"`` (default) and ``"scatter"``: grouped routing per
  batch row with ``capacity = cf * k * T / E`` slots per expert (overflow
  pairs drop to the residual path); one-hot dispatch/combine einsums, or
  a scatter into (B, E, C, D) slots and a gather back. Both are the
  reference's XLA code, written as plain PyTorch;
* ``dispatch="dropless"``: a stable sort of the (token, choice) pairs by
  expert and grouped matmuls over exactly the routed rows. Under the
  ``moe_gmm`` config's ``impl="gmm"`` (the default) the rows are gathered
  and both products go through ``ops.grouped_matmul``; under
  ``impl="fused"`` (``ROCKET_TPU_MOE_GMM=fused`` forces it, also on the
  CPU through the kernel's plain version) the in-projection reads the
  unsorted rows by index inside ``ops.gather_gmm`` over the padded
  layout and the out-projection runs over the padded groups.

The load-balancing aux loss (GShard eq. 4) and the dropped fraction
come back beside the output, for the model to surface in its batch.

Not ported: the sequence-sharded TP-context gather in the reference's
``apply`` (``:153-174``), which goes with expert parallelism (ROADMAP
Queue A 6 item 5); ``TransformerLM`` refuses an MoE config under a
tensor-parallel context, so nothing reaches it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from rocket_tpu_torch.nn.layers import Dense, gelu_fn
from rocket_tpu_torch.nn.module import Layer
from rocket_tpu_torch.ops.gather_gmm import gather_gmm, gather_gmm_supported, padded_group_layout
from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

__all__ = ["MoE", "DISPATCHES", "gmm_config"]

DISPATCHES = ("einsum", "scatter", "dropless")


def _expert_rows(table, expert):
    """``table[expert]``: each routed row's row of an (E, F) expert table
    (the biases). The same gather as indexing, through ``F.embedding``,
    whose backward sums each expert's rows as parallel segments; the
    backward of an indexing gather adds a row's duplicates one after the
    other, and here each of the E rows has thousands."""
    return F.embedding(expert, table)


def gmm_config(m: int, k: int, n: int, dtype) -> dict:
    """The ``moe_gmm`` tuned config for (m, k, n, dtype) on this card, over
    the defaults ``impl="gmm"`` and the hand-picked 512 tiles (the shipped
    table is empty). The tiles are the TPU's layout parameter; the port
    keeps ``tile_m`` for the padded layout and ``tile_n`` for the
    gather-GMM gate, and its CUDA kernels choose their own tiles."""
    from rocket_tpu_torch.tune import get_config

    config = dict(get_config("moe_gmm", shape={"m": m, "k": k, "n": n}, dtype=dtype) or {})
    for key, value in (("impl", "gmm"), ("tile_m", 512), ("tile_k", 512), ("tile_n", 512)):
        config.setdefault(key, value)
    return config


class MoE(Layer):
    """Top-k routed expert FFN (drop-in for the dense MLP of a block):
    ``apply(params, x (B, T, D))`` -> ``(y (B, T, D), {"aux_loss",
    "frac_dropped"})``."""

    def __init__(self, dim: int, hidden: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dispatch: str = "einsum"):
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"MoE: top_k {top_k} must be in [1, num_experts={num_experts}]")
        if dispatch not in DISPATCHES:
            raise ValueError(f"MoE: unknown dispatch mode {dispatch!r}")
        self.dim = dim
        self.hidden = hidden
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dispatch = dispatch
        self.router = Dense(dim, num_experts, use_bias=False)

    def init_params(self, gen):
        e, d, h = self.num_experts, self.dim, self.hidden
        return {
            "router": self.router.init_params(gen),
            "experts": {
                "w_in": torch.randn((e, d, h), generator=gen) * d ** -0.5,
                "b_in": torch.zeros((e, h)),
                "w_out": torch.randn((e, h, d), generator=gen) * h ** -0.5,
                "b_out": torch.zeros((e, d)),
            },
        }

    def route(self, params, x):
        """``(gates (B, T, E) f32, top_gates (B, T, K) f32, top_idx (B, T,
        K) int64)``: f32 router logits (a bf16 router flips near-tied
        experts), softmax, the stable top k, renormalised."""
        logits = x.float() @ params["router"]["w"].float()
        gates = torch.softmax(logits, dim=-1)
        ranked, order = torch.sort(gates, dim=-1, descending=True, stable=True)
        top_gates, top_idx = ranked[..., :self.top_k], order[..., :self.top_k]
        top_gates = top_gates / torch.clamp(top_gates.sum(-1, keepdim=True), min=1e-9)
        return gates, top_gates, top_idx

    def apply(self, params, x, *, mode="train", rng=None):
        del mode, rng  # the routing is deterministic and has no dropout
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        gates, top_gates, top_idx = self.route(params, x)
        aux = self._aux_loss(gates, top_idx, e)

        if self.dispatch == "dropless":
            y = self._apply_dropless(params, x, top_gates, top_idx)
            # No capacity, no drops: every routed pair is computed.
            return y, {"aux_loss": aux, "frac_dropped": torch.zeros((), device=x.device)}

        # GShard grouped routing: each batch row is a routing group with its
        # own capacity. A pair's slot in its expert = the earlier pairs of
        # the group that chose that expert, choices ranked k-major so the
        # primary routes win slots first.
        capacity = max(1, int(self.capacity_factor * t * k / e))
        flat_idx = top_idx.transpose(1, 2).reshape(b, k * t)  # k-major
        choice_onehot = F.one_hot(flat_idx, e).to(torch.int32)  # (B, K*T, E)
        position = torch.cumsum(choice_onehot, dim=1, dtype=torch.int32) - choice_onehot
        slot = (position * choice_onehot).sum(-1)  # (B, K*T)
        keep = slot < capacity
        ex = params["experts"]
        dt = x.dtype

        if self.dispatch == "scatter":
            slot_c = torch.clamp(slot, max=capacity - 1)
            b_ix = torch.arange(b, device=x.device)[:, None].expand(b, k * t)
            xk = x.repeat(1, k, 1)  # (B, K*T, D), k-major
            upd = torch.where(keep[..., None], xk, torch.zeros((), dtype=dt, device=x.device))
            # Dropped pairs add zeros into a kept pair's slot: order-free.
            expert_in = torch.zeros((b, e, capacity, d), dtype=dt, device=x.device).index_put(
                (b_ix, flat_idx, slot_c), upd, accumulate=True).transpose(0, 1)  # (E, B, C, D)
        else:
            # F.one_hot refuses out-of-range slots where jax.nn.one_hot
            # gives zeros; the keep mask zeroes those rows either way.
            slot_onehot = (F.one_hot(torch.clamp(slot, max=capacity - 1), capacity).to(dt)
                           * keep[..., None].to(dt))  # (B, K*T, C)
            dispatch_kc = (choice_onehot.to(dt)[..., :, None]
                           * slot_onehot[..., None, :]).reshape(b, k, t, e, capacity)
            dispatch = dispatch_kc.sum(1)  # (B, T, E, C) 0/1
            combine = (dispatch_kc * top_gates.transpose(1, 2)[..., None, None].to(dt)).sum(1)
            expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)

        # The expert products accumulate in f32 (f32 operands: a bf16
        # product is exact in f32) and cast back; the dispatch/combine
        # contractions touch at most k nonzeros per output.
        h = torch.einsum("ebcd,edh->ebch", expert_in.float(), ex["w_in"].to(dt).float()).to(dt)
        h = gelu_fn(h + ex["b_in"].to(dt)[:, None, None, :])
        out = torch.einsum("ebch,ehd->ebcd", h.float(), ex["w_out"].to(dt).float()).to(dt)
        out = out + ex["b_out"].to(dt)[:, None, None, :]

        if self.dispatch == "scatter":
            picked = out.transpose(0, 1)[b_ix, flat_idx, slot_c]  # (B, K*T, D)
            picked = torch.where(keep[..., None], picked, torch.zeros((), dtype=dt,
                                                                      device=x.device))
            gates_k = top_gates.transpose(1, 2).reshape(b, k * t, 1).to(dt)
            y = (picked * gates_k).reshape(b, k, t, d).sum(1)
        else:
            y = torch.einsum("btec,ebcd->btd", combine, out)
        # The fraction of routed (token, choice) pairs that found no slot.
        frac_dropped = 1.0 - keep.float().mean()
        return y, {"aux_loss": aux, "frac_dropped": frac_dropped}

    @staticmethod
    def _aux_loss(gates, top_idx, e: int):
        """GShard eq. 4 load-balancing loss: E * sum(fraction routed as
        primary * mean gate)."""
        primary = F.one_hot(top_idx[..., 0], e).float()
        return e * (primary.mean((0, 1)) * gates.mean((0, 1))).sum()

    def _apply_dropless(self, params, x, top_gates, top_idx):
        """Sort-based dropless dispatch: flatten to N = B*T tokens and NK =
        N*k (token, choice) pairs, stable-sort the pairs by expert, run both
        expert products as grouped matmuls over the sorted rows, and add
        the gate-weighted outputs back per token."""
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        n = b * t
        x_flat = x.reshape(n, d)
        pair_expert = top_idx.reshape(n * k)  # token-major pairs
        pair_token = torch.arange(n * k, device=x.device) // k
        order = torch.argsort(pair_expert, stable=True)
        sorted_expert = pair_expert[order]
        sorted_token = pair_token[order]
        # bincount on the card reads the largest id back to the host; an
        # int32 scatter-add counts on the device (exact in any order).
        counts = torch.zeros((e,), dtype=torch.int32, device=x.device).scatter_add_(
            0, pair_expert, torch.ones_like(pair_expert, dtype=torch.int32))
        gate_sorted = top_gates.reshape(n * k)[order].to(x.dtype)
        out = self._dropless_matmuls(params, x_flat, sorted_token, sorted_expert, counts,
                                     x.dtype)
        # Each token receives its k gate-weighted rows. The CUDA index_add
        # adds them in no fixed order, which is exact for k = 2 (two adds
        # onto zero commute); a larger k could differ in its last bit.
        y = torch.zeros((n, d), dtype=x.dtype, device=x.device).index_add(
            0, sorted_token, out * gate_sorted[:, None])
        return y.reshape(b, t, d)

    def _dropless_matmuls(self, params, x_flat, sorted_token, sorted_expert, counts, dtype):
        """Both expert products over the sorted rows: gather-explicit
        (``"gmm"``) or gather-in-kernel (``"fused"``) per :func:`gmm_config`;
        ``ROCKET_TPU_MOE_GMM`` overrides it (forced, the fused path runs on
        the CPU too, through the kernel's plain version)."""
        nk = sorted_token.shape[0]
        ex = params["experts"]
        d, hidden = ex["w_in"].shape[1:]
        config = gmm_config(nk, d, hidden, dtype)
        forced = os.environ.get("ROCKET_TPU_MOE_GMM")
        impl = forced or config["impl"]
        if impl == "fused":
            on_cpu = x_flat.device.type == "cpu"
            tm = min(config["tile_m"], nk)
            tn = min(config["tile_n"], hidden)
            if gather_gmm_supported(d, hidden, tn) and (bool(forced) or not on_cpu):
                row_ids, gsz, padded_pos, m_pad = padded_group_layout(
                    counts, sorted_token, tm, nk, sorted_expert=sorted_expert)
                pos = padded_pos.long()
                # Each padded row's expert, for the bias gathers. Pad rows
                # read expert 0's bias; their outputs are never gathered back.
                pexpert = torch.zeros((m_pad,), dtype=torch.long, device=x_flat.device)
                pexpert[pos] = sorted_expert
                h = gather_gmm(x_flat, ex["w_in"].to(dtype), row_ids, gsz, tile_m=tm, tile_n=tn)
                h = gelu_fn(h + _expert_rows(ex["b_in"].to(dtype), pexpert))
                # The hidden rows are already in padded-group order: the
                # out-projection needs no gather.
                out = grouped_matmul(h, ex["w_out"].to(dtype), gsz)
                out = out + _expert_rows(ex["b_out"].to(dtype), pexpert)
                return out[pos]  # (NK, D)
        xs = x_flat[sorted_token]  # (NK, D)
        h = grouped_matmul(xs, ex["w_in"].to(dtype), counts)  # (NK, H)
        h = gelu_fn(h + _expert_rows(ex["b_in"].to(dtype), sorted_expert))
        out = grouped_matmul(h, ex["w_out"].to(dtype), counts)
        return out + _expert_rows(ex["b_out"].to(dtype), sorted_expert)  # (NK, D)

    def __repr__(self):
        return f"MoE(d={self.dim}, h={self.hidden}, E={self.num_experts}, k={self.top_k})"
