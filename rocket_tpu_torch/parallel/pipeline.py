"""Pipeline parallelism — GPipe and 1F1B microbatched stages over a 'pipe'
mesh axis (counterpart of ``rocket_tpu/parallel/pipeline.py``).

One process a stage: stage ``s`` of ``P`` holds layers ``[s·L/P,
(s+1)·L/P)`` (``parallel.sharding.pipeline_rules`` places each
``blocks/<i>`` whole on its stage), and a microbatch's activations cross
from one stage to the next point to point over the pipe group, through
``parallel.collectives.Hop`` (over gloo a CUDA tensor is staged through
host memory). Every transfer carries a tag, its microbatch (forward) or
``M +`` its microbatch (backward), so a send always meets its receive.

* **GPipe** (:func:`pipeline_blocks`): each stage runs its layers on the
  ``M`` microbatches in order, receiving each from the stage before
  (:class:`_Recv`) and sending it on (:class:`_Send`). The two are
  autograd Functions whose backwards are the reverse transfers, so the
  autograd backward of the last stage's loss (and of the other stages'
  send tokens) runs the reverse schedule. With ``remat`` each
  microbatch's stage is one checkpoint: the forward keeps only the M
  stage inputs (the reference checkpoints each tick). Live activations
  grow with M.
* **1F1B** (:func:`pipeline_train_1f1b`): the schedule written by hand,
  as the reference writes it: at tick ``t`` stage ``s`` forwards
  microbatch ``t - s`` (under no grad, keeping only its input) and
  backwards microbatch ``t - (2(P-1) - s)``, recomputing its stage from
  the saved input; the last stage runs the tail (head and loss) on its
  fresh output and its backward in the same tick. A saved input lives
  ``2(P-1-s)`` ticks, so at most ``2P - 1`` are alive at once for any M
  (:data:`STATS` ``live_max`` counts them).

Each microbatch runs under ``nn.keys.activation_split((0, m, M))``: its
rows are chunk ``m`` of the rank's data stripe, so its dropout masks are
those of the same rows in the unpipelined run (the reference folds the
microbatch into the key instead). A stage's layers are run by
``block_apply(params, layer_index, h) -> h``.

:data:`STATS` counts the transfers (``hops``: one a tick or a Function;
``sends``: the tensors sent), their bytes and the seconds waited on them,
and the most saved stage inputs alive at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rocket_tpu_torch.nn import keys
from rocket_tpu_torch.parallel.collectives import Hop

__all__ = ["PipeSpec", "pipe_spec", "pipeline_blocks", "pipeline_train_1f1b", "finish", "STATS",
           "reset_stats"]

#: Per-process counters (module docstring).
STATS: dict = {"wait_s": 0.0, "wire_bytes": 0, "hops": 0, "sends": 0, "staged": False,
               "live_max": 0}


def reset_stats() -> None:
    STATS.update(wait_s=0.0, wire_bytes=0, hops=0, sends=0, live_max=0)


@dataclass(frozen=True)
class PipeSpec:
    """The pipe group of one rank: ``group`` its process group (None for a
    group of one), ``ranks`` its global ranks in stage order, ``index``
    this rank's stage."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def last(self) -> bool:
        return self.index == self.size - 1


def pipe_spec(runtime, axis: str = "pipe") -> PipeSpec:
    """The :class:`PipeSpec` of ``runtime``'s ``axis`` (a group of one
    where the axis has size 1)."""
    n = runtime.axis_size(axis)
    return PipeSpec(group=runtime.axis_group(axis) if n > 1 else None,
                    ranks=tuple(runtime.axis_ranks(axis)), index=runtime.axis_index(axis))


def _hop(spec: PipeSpec, sends=(), recvs=()) -> Hop:
    STATS["hops"] += 1
    STATS["sends"] += len(sends)
    return Hop(spec.group, sends, recvs, stats=STATS, what="pipeline")


#: Sends not yet waited on (a send completes once its stage received it).
_PENDING: list = []


def finish() -> None:
    """Wait on every transfer a pipelined forward or backward left in flight."""
    while _PENDING:
        _PENDING.pop(0).wait()


class _Send(torch.autograd.Function):
    """Send ``h`` (microbatch ``m``) to the next stage; returns a 0-dim
    zero token that carries the gradient: its backward receives ``dh``
    from the next stage."""

    @staticmethod
    def forward(ctx, h, spec, m, count):
        _PENDING.append(_hop(spec, sends=[(h, spec.ranks[spec.index + 1], m)]))
        ctx.spec, ctx.m, ctx.count = spec, m, count
        ctx.meta = (h.shape, h.dtype, h.device)
        return h.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _token):
        spec = ctx.spec
        shape, dtype, device = ctx.meta
        like = torch.empty(shape, dtype=dtype, device=device)
        (dh,) = _hop(spec, recvs=[(like, spec.ranks[spec.index + 1], ctx.count + ctx.m)]).wait()
        return dh, None, None, None


class _Recv(torch.autograd.Function):
    """Receive microbatch ``m`` (shaped as ``like``) from the stage before;
    its backward sends the gradient back. ``anchor`` (a 0-dim tensor that
    needs a gradient, passed to the backward's inputs) keeps the node in
    the backward graph."""

    @staticmethod
    def forward(ctx, anchor, like, spec, m, count):
        (h,) = _hop(spec, recvs=[(like, spec.ranks[spec.index - 1], m)]).wait()
        ctx.spec, ctx.m, ctx.count = spec, m, count
        return h

    @staticmethod
    def backward(ctx, dh):
        spec = ctx.spec
        _PENDING.append(_hop(spec, sends=[(dh.contiguous(), spec.ranks[spec.index - 1],
                                           ctx.count + ctx.m)]))
        return torch.zeros((), device=dh.device), None, None, None, None


def _stage(block_apply: Callable, layers: Sequence, h: torch.Tensor, m: int, count: int,
           with_aux: bool = False):
    """This stage's layers on microbatch ``m`` of ``count``; ``with_aux``:
    ``(h, the sum of the layers' aux scalars)``."""
    aux = None
    with keys.activation_split((0, m, count) if count > 1 else None):
        for idx, params in layers:
            h = block_apply(params, idx, h)
            if with_aux:
                h, a = h
                aux = a if aux is None else aux + a
    return (h, aux) if with_aux else h


def _check(x: torch.Tensor, m: int, what: str) -> None:
    if x.shape[0] % m:
        raise ValueError(f"{what}: per-shard batch {x.shape[0]} must divide into {m} "
                         "microbatches.")


def pipeline_blocks(block_apply: Callable, layers: Sequence, x: torch.Tensor, *,
                    spec: PipeSpec, num_microbatches: Optional[int] = None,
                    remat: bool = True, anchor: Optional[torch.Tensor] = None,
                    broadcast: bool = True, with_aux: bool = False):
    """Run ``x`` (this rank's ``(B, T, D)`` stripe; read on stage 0, its
    shape and dtype elsewhere) through the pipelined layers, GPipe order.
    ``layers`` are this stage's ``(global layer index, params)``; the
    default ``num_microbatches`` is ``2P``, as in the reference.

    With ``broadcast`` (eval) every stage gets the trunk output, sent on
    from the last stage. Without it (training) the last stage returns the
    output and every other stage the sum of its send tokens (a zero whose
    backward receives the gradients), and ``anchor`` must be given to the
    backward's inputs: it keeps the receives' backward sends in the graph.
    Call :func:`finish` after the backward.

    ``with_aux`` (the reference's aux channel, an MoE's load-balancing
    loss): ``block_apply`` returns ``(h, aux scalar)`` and the call returns
    ``(output, aux)``. Training: ``aux`` is this stage's share, its layers'
    sum over the microbatches divided by M, which the stage adds to its own
    loss share (the stages' shares sum, as the losses do, over the pipe
    group), so no aux crosses a hop. Eval: the sum of the shares over the
    pipe group, the same on every stage. Each microbatch is its own routing
    group, so the aux is the microbatches' mean (the unpipelined aux only
    at M = 1)."""
    p, s = spec.size, spec.index
    m = num_microbatches or 2 * p
    _check(x, m, "pipeline")
    micro = x.chunk(m, 0)
    like = torch.empty_like(micro[0])
    if anchor is None:
        anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    outs, tokens, aux = [], [], None
    for mb in range(m):
        h = micro[mb] if s == 0 else _Recv.apply(anchor, like, spec, mb, m)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_stage, block_apply, layers, h, mb, m, with_aux, use_reentrant=False)
        else:
            h = _stage(block_apply, layers, h, mb, m, with_aux)
        if with_aux:
            h, a = h
            aux = a if aux is None else aux + a
        if s < p - 1:
            tokens.append(_Send.apply(h, spec, mb, m))
        else:
            outs.append(h)
    if with_aux:
        aux = aux / m
    if not broadcast:
        out = torch.cat(outs, 0) if spec.last else torch.stack(tokens).sum()
        return (out, aux) if with_aux else out
    finish()
    if with_aux and p > 1:
        import torch.distributed as dist

        from rocket_tpu_torch.parallel.collectives import collective

        aux = aux.detach().clone()
        nbytes = 2 * (p - 1) / p * aux.numel() * aux.element_size()
        collective("all_reduce", lambda: dist.all_reduce(aux, group=spec.group, async_op=True),
                   (aux,), (aux,), nbytes, p, "pipe").wait()
    if spec.last:
        out = torch.cat(outs, 0)
        if p > 1:
            _hop(spec, sends=[(out, rank, 2 * m) for rank in spec.ranks[:-1]]).wait()
    else:
        (out,) = _hop(spec, recvs=[(x, spec.ranks[-1], 2 * m)]).wait()
    return (out, aux) if with_aux else out


def pipeline_train_1f1b(block_apply: Callable, layers: Sequence, x: torch.Tensor,
                        tail_fn: Callable, inputs: Sequence[torch.Tensor], *, spec: PipeSpec,
                        num_microbatches: Optional[int] = None):
    """One fused forward and backward over the pipelined layers, 1F1B
    (module docstring). ``x`` is this rank's ``(B, T, D)`` stripe (read on
    stage 0); ``tail_fn(h, m) -> loss`` the last stage's head and loss on
    microbatch ``m``'s output (the microbatch's mean); ``inputs`` the
    leaves to differentiate (this stage's and the tail's params).

    Returns ``(loss, grads, dx)``: the mean of the microbatches' losses on
    the last stage (0 elsewhere), the gradients of ``inputs`` (None where
    a leaf got none) and, on stage 0, the cotangent of ``x`` (None
    elsewhere), to backpropagate through the embedding."""
    p, s = spec.size, spec.index
    m = num_microbatches or 2 * p
    _check(x, m, "pipeline_train_1f1b")
    micro = x.detach().chunk(m, 0)
    like = torch.empty_like(micro[0])
    inputs = list(inputs)
    grads: list = [None] * len(inputs)
    dx: list = [None] * m
    live: dict = {}
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    fwd_in = bwd_in = None

    def backward(out, h, cotangent):
        got = torch.autograd.grad(out, [h] + inputs, cotangent, allow_unused=True)
        for i, g in enumerate(got[1:]):
            if g is not None:
                grads[i] = g if grads[i] is None else grads[i] + g
        return got[0]

    for t in range(m + 2 * p - 2):
        fi = t - s
        bi = t - (2 * (p - 1) - s)
        y = dh_prev = None
        if 0 <= fi < m:
            h_in = micro[fi] if s == 0 else fwd_in
            if spec.last:
                # Forward, tail and backward of one microbatch in this tick.
                h = h_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = _stage(block_apply, layers, h, fi, m)
                    loss_mb = tail_fn(y, fi).float()
                    dh_prev = backward(loss_mb / m, h, None)
                loss = loss + loss_mb.detach() / m
            else:
                live[fi] = h_in.detach()
                STATS["live_max"] = max(STATS["live_max"], len(live))
                with torch.no_grad():
                    y = _stage(block_apply, layers, h_in, fi, m)
        if 0 <= bi < m and not spec.last:
            h = live.pop(bi).requires_grad_(True)
            with torch.enable_grad():
                dh_prev = backward(_stage(block_apply, layers, h, bi, m), h, bwd_in)
        if 0 <= bi < m and s == 0:
            dx[bi] = dh_prev
        sends, recvs = [], []
        if 0 <= fi < m and s < p - 1:
            sends.append((y, spec.ranks[s + 1], fi))
        if 0 <= bi < m and s > 0:
            sends.append((dh_prev, spec.ranks[s - 1], m + bi))
        f_next, b_next = t + 1 - s, t + 1 - (2 * (p - 1) - s)
        want_f = s > 0 and 0 <= f_next < m
        want_b = s < p - 1 and 0 <= b_next < m
        if want_f:
            recvs.append((like, spec.ranks[s - 1], f_next))
        if want_b:
            recvs.append((like, spec.ranks[s + 1], m + b_next))
        if sends or recvs:
            got = _hop(spec, sends, recvs).wait()
            if want_f:
                fwd_in = got.pop(0)
            if want_b:
                bwd_in = got.pop(0)
    return loss, grads, (torch.cat(dx, 0) if s == 0 else None)
