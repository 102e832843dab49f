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

Expert parallelism (an ``expert`` mesh axis; the Module's
``collectives.expert_parallel`` context, the experts laid out by
``parallel.sharding.moe_rules``): a rank holds E/n experts of the layer
(``experts/*`` shard on their E dim) and every rank of the expert row
routes the same tokens with the replicated f32 router. A rank computes its
own experts' rows only: ``einsum``/``scatter`` its ``(B, T, E/n, C)``
slice of the dispatch and combine, ``dropless`` the sorted pairs ordered
with its experts' rows first (the sort key is (not local, expert), so no
host read), its group sizes summing below NK (the products give rows past
the groups no work, and the other ranks' rows no padded row). The input
and the top-k gates enter the local experts through
``collectives.ep_enter`` (whose backward all-reduces their cotangents) and
the partial output leaves through ``collectives.ep_combine`` (an
all-reduce): the router, the aux loss and everything upstream get the
same complete gradients on every rank, and each expert's gradient is
complete on its rank. Capacity and the dropped fraction count every
expert, as on one rank. With k = 2 the dropless output is the one-rank
output bitwise (two adds onto zero commute).

Over several data ranks (the Module's ``collectives.data_mean`` context)
the aux loss is the global batch's: the routed fractions and mean gates
are averaged over the data group first.

Under a tensor-parallel context the residual stream arrives sequence
sharded: the layer gathers it at its boundary and re-shards its output
(the reference's ``apply``, ``:153-174``, through
``collectives.seq_all_gather`` / ``seq_shard``: complete gradients on every
model rank). Under ring attention (``seq``, a ``SeqSpec``) the routing
groups span the whole sequence too: ``collectives.seq_gather_sum`` gathers
it with a reduce-scatter backward and the layer keeps its block of the
output, so its gradients stay partials, as every leaf's under ``seq``
(the model counts the aux loss ``1/n`` on each rank).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from rocket_tpu_torch.nn.layers import Dense, gelu_fn
from rocket_tpu_torch.nn.module import Layer
from rocket_tpu_torch.ops.gather_gmm import gather_gmm, gather_gmm_supported, padded_group_layout
from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

__all__ = ["MoE", "DISPATCHES", "gmm_config", "ROWS"]

DISPATCHES = ("einsum", "scatter", "dropless")

#: The routed (token, choice) rows this process's experts computed in the
#: dropless dispatch, summed on the device while ``ROWS["total"]`` is a
#: tensor (None: not counted).
ROWS: dict = {"total": None}


class _ExpertRows(torch.autograd.Function):
    """``table[expert]`` with a fixed-order backward: the forward is
    ``F.embedding``'s gather; the backward sums each expert's rows in one
    f32 GEMM, ``one_hot(expert).T @ grad``. ``F.embedding``'s CUDA backward
    adds a row's duplicates in no fixed order (two runs of one MoE step
    differed in the last bit of a bias gradient on the card), and an
    indexing gather's backward adds them one after the other, slow when
    each of the E rows has thousands."""

    @staticmethod
    def forward(ctx, table, expert):
        ctx.save_for_backward(expert)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return F.embedding(expert, table)

    @staticmethod
    def backward(ctx, grad):
        (expert,) = ctx.saved_tensors
        onehot = F.one_hot(expert, ctx.rows).to(torch.float32)
        return (onehot.t() @ grad.float()).to(ctx.dtype), None


def _expert_rows(table, expert):
    """``table[expert]``: each routed row's row of an (E, F) expert table
    (the biases), gathered; its gradient summed per expert in a fixed order
    (:class:`_ExpertRows`)."""
    return _ExpertRows.apply(table, expert)


def _mine(rows, mine):
    """``rows`` with the other ranks' rows zeroed (no gradient reaches them)."""
    return torch.where(mine[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


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

    def apply(self, params, x, *, mode="train", rng=None, seq=None):
        """``x`` (B, T, D) -> ``(y, {"aux_loss", "frac_dropped"})``; under a
        TP context, or with ``seq`` (ring attention's sequence group), ``x``
        is this rank's sequence shard, gathered whole for the routing."""
        del mode, rng  # the routing is deterministic and has no dropout
        from rocket_tpu_torch.parallel import collectives as coll

        tp = coll.current_tp()
        if tp is not None:
            x = coll.seq_all_gather(tp, x)
        elif seq is not None:
            x = coll.seq_gather_sum(seq, x)
        y, aux = self._apply_whole(params, x)
        if tp is not None:
            y = coll.seq_shard(tp, y)
        elif seq is not None:
            y = y.chunk(seq.size, 1)[seq.index]
        return y, aux

    def _local(self, params):
        """``(spec, first expert, experts held)`` under expert parallelism
        with this rank's share of the experts, else None (every expert
        here)."""
        from rocket_tpu_torch.parallel.collectives import current_ep

        held = params["experts"]["w_in"].shape[0]
        spec = current_ep()
        if spec is None or held == self.num_experts:
            if held != self.num_experts:
                raise ValueError(f"MoE: {held} of {self.num_experts} experts held outside an "
                                 "expert-parallel context")
            return None
        if held * spec.size != self.num_experts:
            raise ValueError(f"MoE: {held} experts a rank over {spec.size} expert ranks, not "
                             f"the layer's {self.num_experts}")
        return spec, spec.index * held, held

    def _apply_whole(self, params, x):
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        gates, top_gates, top_idx = self.route(params, x)
        aux = self._aux_loss(gates, top_idx, e)
        local = self._local(params)
        if local is not None:
            from rocket_tpu_torch.parallel.collectives import ep_enter

            x, top_gates = ep_enter(local[0], x), ep_enter(local[0], top_gates)

        if self.dispatch == "dropless":
            y = self._apply_dropless(params, x, top_gates, top_idx, local)
            # No capacity, no drops: every routed pair is computed.
            return self._combined(y, local), {"aux_loss": aux,
                                              "frac_dropped": torch.zeros((), device=x.device)}

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
        # The fraction of routed (token, choice) pairs that found no slot.
        frac_dropped = 1.0 - keep.float().mean()
        ex = params["experts"]
        dt = x.dtype
        lo, el = (0, e) if local is None else local[1:]

        if self.dispatch == "scatter":
            slot_c = torch.clamp(slot, max=capacity - 1)
            b_ix = torch.arange(b, device=x.device)[:, None].expand(b, k * t)
            if local is not None:
                # This rank's experts' pairs only, at their local ids.
                keep = keep & (flat_idx >= lo) & (flat_idx < lo + el)
                flat_idx = torch.clamp(flat_idx - lo, 0, el - 1)
            xk = x.repeat(1, k, 1)  # (B, K*T, D), k-major
            upd = torch.where(keep[..., None], xk, torch.zeros((), dtype=dt, device=x.device))
            # Dropped pairs add zeros into a kept pair's slot: order-free.
            expert_in = torch.zeros((b, el, capacity, d), dtype=dt, device=x.device).index_put(
                (b_ix, flat_idx, slot_c), upd, accumulate=True).transpose(0, 1)  # (E, B, C, D)
        else:
            # F.one_hot refuses out-of-range slots where jax.nn.one_hot
            # gives zeros; the keep mask zeroes those rows either way.
            slot_onehot = (F.one_hot(torch.clamp(slot, max=capacity - 1), capacity).to(dt)
                           * keep[..., None].to(dt))  # (B, K*T, C)
            dispatch_kc = (choice_onehot[..., lo:lo + el].to(dt)[..., :, None]
                           * slot_onehot[..., None, :]).reshape(b, k, t, el, capacity)
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
            # In f32, rounded once after the sum over the expert group: a
            # token's k products of bf16 values are exact there, so the
            # output is the same bits on one rank and over several.
            y = torch.einsum("btec,ebcd->btd", combine.float(), out.float())
            return self._combined(y, local).to(dt), {"aux_loss": aux,
                                                     "frac_dropped": frac_dropped}
        return self._combined(y, local), {"aux_loss": aux, "frac_dropped": frac_dropped}

    @staticmethod
    def _combined(y, local):
        """The local experts' partial output summed over the expert group."""
        if local is None:
            return y
        from rocket_tpu_torch.parallel.collectives import ep_combine

        return ep_combine(local[0], y)

    @staticmethod
    def _aux_loss(gates, top_idx, e: int):
        """GShard eq. 4 load-balancing loss: E * sum(fraction routed as
        primary * mean gate), both over the global batch under the data
        context (``collectives.batch_mean``)."""
        from rocket_tpu_torch.parallel.collectives import batch_mean, current_data

        fraction = F.one_hot(top_idx[..., 0], e).float().mean((0, 1))
        mean_gate = gates.mean((0, 1))
        data = current_data()
        if data is not None:
            both = batch_mean(data, torch.cat([fraction, mean_gate]))
            fraction, mean_gate = both[:e].detach(), both[e:]
        return e * (fraction * mean_gate).sum()

    def _apply_dropless(self, params, x, top_gates, top_idx, local=None):
        """Sort-based dropless dispatch: flatten to N = B*T tokens and NK =
        N*k (token, choice) pairs, stable-sort the pairs by expert, run both
        expert products as grouped matmuls over the sorted rows, and add
        the gate-weighted outputs back per token. Under expert parallelism
        (``local``) the sort puts this rank's experts' pairs first, the
        products run over their groups only and the other pairs add
        zeros."""
        b, t, d = x.shape
        e, k = self.num_experts, self.top_k
        n = b * t
        x_flat = x.reshape(n, d)
        pair_expert = top_idx.reshape(n * k)  # token-major pairs
        pair_token = torch.arange(n * k, device=x.device) // k
        mine = None
        if local is None:
            order = torch.argsort(pair_expert, stable=True)
            sorted_expert = pair_expert[order]
            ids, groups = pair_expert, e
        else:
            lo, groups = local[1:]
            held = (pair_expert >= lo) & (pair_expert < lo + groups)
            order = torch.argsort(torch.where(held, pair_expert, pair_expert + e), stable=True)
            mine = held[order]
            ids = torch.clamp(pair_expert - lo, 0, groups - 1)
            sorted_expert = ids[order]  # the other ranks' pairs: any local id
        sorted_token = pair_token[order]
        # bincount on the card reads the largest id back to the host; an
        # int32 scatter-add counts on the device (exact in any order).
        ones = (torch.ones_like(pair_expert, dtype=torch.int32) if mine is None
                else held.to(torch.int32))
        counts = torch.zeros((groups,), dtype=torch.int32, device=x.device).scatter_add_(
            0, ids, ones)
        if ROWS["total"] is not None:
            ROWS["total"] = ROWS["total"] + counts.sum()
        gate_sorted = top_gates.reshape(n * k)[order].to(x.dtype)
        out = self._dropless_matmuls(params, x_flat, sorted_token, sorted_expert, counts,
                                     x.dtype, mine)
        # Each token receives its k gate-weighted rows. The CUDA index_add
        # adds them in no fixed order, which is exact for k = 2 (two adds
        # onto zero commute); a larger k could differ in its last bit.
        y = torch.zeros((n, d), dtype=x.dtype, device=x.device).index_add(
            0, sorted_token, out * gate_sorted[:, None])
        return y.reshape(b, t, d)

    def _dropless_matmuls(self, params, x_flat, sorted_token, sorted_expert, counts, dtype,
                          mine=None):
        """Both expert products over the sorted rows: gather-explicit
        (``"gmm"``) or gather-in-kernel (``"fused"``) per :func:`gmm_config`;
        ``ROCKET_TPU_MOE_GMM`` overrides it (forced, the fused path runs on
        the CPU too, through the kernel's plain version). ``mine`` (NK,)
        bool marks the rows of this rank's experts (the first ones; the
        groups ``counts`` cover them only): the other rows come out as
        zeros."""
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
                    counts, sorted_token, tm, nk, sorted_expert=sorted_expert, valid=mine)
                # The other ranks' rows sit at padded row m_pad (none).
                pos = padded_pos.long()
                # Each padded row's expert, for the bias gathers. Pad rows
                # read expert 0's bias; their outputs are never gathered back.
                pexpert = torch.zeros((m_pad + 1,), dtype=torch.long, device=x_flat.device)
                pexpert[pos] = sorted_expert
                pexpert = pexpert[:m_pad]
                h = gather_gmm(x_flat, ex["w_in"].to(dtype), row_ids, gsz, tile_m=tm, tile_n=tn)
                h = gelu_fn(h + _expert_rows(ex["b_in"].to(dtype), pexpert))
                # The hidden rows are already in padded-group order: the
                # out-projection needs no gather.
                out = grouped_matmul(h, ex["w_out"].to(dtype), gsz)
                out = out + _expert_rows(ex["b_out"].to(dtype), pexpert)
                if mine is None:
                    return out[pos]  # (NK, D)
                # Row m_pad - 1 lies past every group (module docstring).
                return _mine(out[torch.clamp(pos, max=m_pad - 1)], mine)
        xs = x_flat[sorted_token]  # (NK, D)
        h = grouped_matmul(xs, ex["w_in"].to(dtype), counts)  # (NK, H)
        h = gelu_fn(h + _expert_rows(ex["b_in"].to(dtype), sorted_expert))
        out = grouped_matmul(h, ex["w_out"].to(dtype), counts)
        out = out + _expert_rows(ex["b_out"].to(dtype), sorted_expert)  # (NK, D)
        return out if mine is None else _mine(out, mine)

    def __repr__(self):
        return f"MoE(d={self.dim}, h={self.hidden}, E={self.num_experts}, k={self.top_k})"
