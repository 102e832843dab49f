"""Optimizer factories and learning-rate schedules for the capsule API
(counterpart of ``rocket_tpu/optim.py``).

An optimizer is a **factory** ``fn(params) -> torch.optim.Optimizer``
over a param dict, built by the ``Module`` once the params exist; its
learning rate is set before every update from the ``Scheduler``'s
schedule (or the ``Optimizer`` capsule's constant), so the factories
construct with ``lr=0``. A schedule is a plain ``step -> lr`` function,
read at the count of updates made BEFORE the update it drives, as optax
reads its schedule: under :func:`warmup_cosine_lr` the first update has
lr 0. Every schedule here also takes that count as a 0-dim tensor on the
card and returns the lr as one, in f32 (optax's arithmetic).

Under the health sentinels' gate (``Runtime(health=True,
anomaly_action="skip_step"|"dump_and_halt")``) the Module updates through
:func:`gated_step` instead of ``torch.optim``'s ``step``: one foreach pass
per stage over the group's params for AdamW/Adam, Lion and SGD (with or
without momentum; :func:`gate_refusal` names what it does not take), each optimizer's count kept on the card in its
per-param state ``"step"`` (``capturable=True`` for Adam and AdamW on
CUDA, so a load keeps it there), the lr read from the schedule at that
count as a device tensor, and a step whose predicate is false leaving
every param, moment and count bitwise as it was — with no branch on a
device value: the gradients are zeroed where the step is not ok, each
moment's decay becomes 1 and its gradient weight 0, and the lr 0. The
next update's lr and bias correction then use the count of APPLIED
updates, as optax's count inside the reference's ``lax.cond`` does. Off
the gate nothing changes.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from rocket_tpu_torch.nn.module import map_params

__all__ = [
    "sgd", "momentum", "adam", "adamw", "lion", "Lion",
    "constant_lr", "step_lr", "cosine_lr", "linear_lr", "warmup_stable_decay_lr",
    "warmup_cosine_lr", "resolve", "param_leaves", "gated_step", "gate_refusal",
]

Schedule = Callable[[int], float]
Factory = Callable[[dict], torch.optim.Optimizer]


def param_leaves(params: dict) -> list:
    """The tensors of a param dict in a fixed (insertion) order."""
    leaves = []
    map_params(leaves.append, params)
    return leaves


def sgd(weight_decay: float = 0.0) -> Factory:
    """Plain SGD; ``weight_decay`` adds ``wd * p`` to every gradient, as
    optax's ``add_decayed_weights`` ahead of ``sgd`` does."""
    def make(params):
        return torch.optim.SGD(param_leaves(params), lr=0.0, weight_decay=weight_decay)

    return make


def momentum(beta: float = 0.9, nesterov: bool = False) -> Factory:
    """SGD with momentum (optax ``sgd(lr, momentum=beta, nesterov=...)``).

    ``torch.optim.SGD(momentum=beta, dampening=0)`` keeps the same trace:
    ``m_t = beta * m_{t-1} + g_t`` from ``m_1 = g_1`` (optax's trace starts
    at zero, which gives the same first step), and the update ``-lr * m_t``,
    or ``-lr * (g_t + beta * m_t)`` with ``nesterov``."""
    def make(params):
        return torch.optim.SGD(param_leaves(params), lr=0.0, momentum=beta, dampening=0.0,
                               nesterov=nesterov)

    return make


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Factory:
    def make(params):
        return torch.optim.Adam(param_leaves(params), lr=0.0, betas=(b1, b2), eps=eps)

    return make


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
          mask_1d: bool = True) -> Factory:
    """AdamW with the GPT-2/nanoGPT decay convention: with ``mask_1d``
    (default) weight decay applies only to params with ndim >= 2 (matmul
    kernels, embeddings) — two parameter groups, the 1-D params (biases,
    norm scales) with decay 0.

    ``torch.optim.AdamW`` computes optax's ``adamw`` update exactly: both
    apply the decay to the pre-update parameter (torch scales ``p`` by
    ``1 - lr * wd`` first, optax adds ``wd * p`` to the update — the same
    ``p - lr * (adam + wd * p)``), both put eps outside the square root of
    the bias-corrected second moment, and both start the bias correction
    at step 1."""
    def make(params):
        return torch.optim.AdamW(_decay_groups(param_leaves(params), weight_decay, mask_1d),
                                 lr=0.0, betas=(b1, b2), eps=eps)

    return make


def _decay_groups(leaves: list, weight_decay: float, mask_1d: bool) -> list:
    """Parameter groups under the GPT-2/nanoGPT decay convention: with
    ``mask_1d`` (and a decay) only params with ndim >= 2 decay."""
    if mask_1d and weight_decay:
        groups = [{"params": [p for p in leaves if p.ndim >= 2], "weight_decay": weight_decay},
                  {"params": [p for p in leaves if p.ndim < 2], "weight_decay": 0.0}]
        return [g for g in groups if g["params"]]
    return [{"params": leaves, "weight_decay": weight_decay}]


class Lion(torch.optim.Optimizer):
    """Lion (sign momentum) with optax's semantics (``optax.lion``): per
    step, for gradient g and moment m (state ``exp_avg``, zeros at first),

        u = sign((1 - b1) g + b1 m) + wd p,   p <- p - lr u,
        m <- (1 - b2) g + b2 m,

    the decoupled decay wd p added to the sign update as optax's
    ``add_decayed_weights`` does. One moment, so half AdamW's optimizer
    memory. Each stage is one foreach pass over the group's params, in
    optax's order of roundings."""

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0) -> None:
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            moments = []
            for p in params:
                state = self.state[p]
                if "exp_avg" not in state:
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                moments.append(state["exp_avg"])
            b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
            update = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(update, torch._foreach_mul(moments, b1))
            torch._foreach_sign_(update)
            if wd:
                torch._foreach_add_(update, torch._foreach_mul(params, wd))
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)
            new_m = torch._foreach_mul(grads, 1.0 - b2)
            torch._foreach_add_(new_m, torch._foreach_mul(moments, b2))
            torch._foreach_copy_(moments, new_m)
        return loss


def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0,
         mask_1d: bool = True) -> Factory:
    """:class:`Lion` — typically run at a 3-10x smaller lr and a 3-10x
    larger weight decay than AdamW. Decay masking follows :func:`adamw`'s
    ndim >= 2 convention."""
    def make(params):
        return Lion(_decay_groups(param_leaves(params), weight_decay, mask_1d), lr=0.0, b1=b1,
                    b2=b2)

    return make


# -- schedules (step -> lr), the optax formulas ---------------------------------
# A host int gives a float (Python arithmetic); a 0-dim tensor count gives a
# tensor in its dtype (f32 on the card, as optax evaluates its schedules).


def _clamp(x, lo=None, hi=None):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=lo, max=hi)
    x = x if lo is None else max(x, lo)
    return x if hi is None else min(x, hi)


def constant_lr(value: float) -> Schedule:
    return lambda step: value


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        count = _clamp(step, 0, transition_steps)
        return (init_value - end_value) * (1 - count / transition_steps) + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule requires positive decay_steps, got {decay_steps}")

    def schedule(step):
        count = _clamp(step, hi=decay_steps)
        angle = math.pi * count / decay_steps
        cosine = 0.5 * (1 + (torch.cos(angle) if isinstance(angle, torch.Tensor)
                             else math.cos(angle)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """optax ``join_schedules``: schedule i+1 takes over at boundary i,
    with the step counted from that boundary."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if isinstance(step, torch.Tensor):
                out = torch.where(step >= boundary, nxt(step - boundary), out)
            elif step >= boundary:
                out = nxt(step - boundary)
        return out

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch ``StepLR`` analogue (optax ``exponential_decay`` with
    ``staircase=True``): decay by ``gamma`` every ``step_size`` steps."""
    if step_size <= 0 or gamma == 0:
        return lambda step: base_lr

    def schedule(step):
        if isinstance(step, torch.Tensor):
            return torch.where(step <= 0, base_lr,
                               base_lr * gamma ** torch.floor(step / step_size))
        return base_lr if step <= 0 else base_lr * gamma ** math.floor(step / step_size)

    return schedule


def cosine_lr(base_lr: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    return _cosine(base_lr, decay_steps, alpha)


def linear_lr(base_lr: float, decay_steps: int, end_lr: float = 0.0) -> Schedule:
    """Linear ramp from ``base_lr`` to ``end_lr`` over ``decay_steps``."""
    return _linear(base_lr, end_lr, decay_steps)


def warmup_stable_decay_lr(base_lr: float, warmup_steps: int, total_steps: int, decay_steps: int,
                           end_lr: float = 0.0) -> Schedule:
    """WSD: linear warmup -> flat plateau -> linear decay over the last
    ``decay_steps``."""
    if warmup_steps + decay_steps > total_steps:
        raise ValueError(f"warmup_stable_decay_lr: warmup {warmup_steps} + decay {decay_steps} "
                         f"exceed total {total_steps}")
    return _join([_linear(0.0, base_lr, warmup_steps), constant_lr(base_lr),
                  _linear(base_lr, end_lr, decay_steps)],
                 [warmup_steps, total_steps - decay_steps])


def warmup_cosine_lr(base_lr: float, warmup_steps: int, decay_steps: int,
                     end_lr: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule`` from ``init_value=0``."""
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    return _join([_linear(0.0, base_lr, warmup_steps),
                  _cosine(base_lr, decay_steps - warmup_steps, alpha)], [warmup_steps])


# -- the health gate's update ---------------------------------------------------


def _decoupled(opt, group) -> bool:
    """Whether an Adam-family group's decay is AdamW's (added to the update),
    not Adam's L2 term (added to the gradient)."""
    return isinstance(opt, torch.optim.AdamW) or bool(group.get("decoupled_weight_decay"))


def gate_refusal(opt: torch.optim.Optimizer):
    """Why :func:`gated_step` cannot take ``opt``'s update rule, or None:
    it implements AdamW, Adam without an L2 term, Lion, and SGD with or
    without (undampened) momentum, none of them ``maximize`` or
    ``amsgrad``. A rule it would compute otherwise is refused, not run."""
    if not isinstance(opt, (torch.optim.AdamW, torch.optim.Adam, torch.optim.SGD, Lion)):
        return f"{type(opt).__name__} (AdamW, Adam, Lion, SGD have a rule)"
    name = type(opt).__name__
    for i, group in enumerate(opt.param_groups):
        if group.get("maximize"):
            return f"{name} with maximize=True (param group {i})"
        if isinstance(opt, torch.optim.Adam):
            if group.get("amsgrad"):
                return f"{name} with amsgrad=True (param group {i})"
            if group.get("weight_decay") and not _decoupled(opt, group):
                return (f"{name} with weight_decay={group['weight_decay']}, an L2 term on the "
                        f"gradient (param group {i}; AdamW's decoupled decay is taken)")
        if isinstance(opt, torch.optim.SGD) and group.get("dampening"):
            return f"{name} with dampening={group['dampening']} (param group {i})"
    return None


def _count(opt, params, device) -> torch.Tensor:
    """The optimizer's count of applied updates on ``device`` (the first
    param's ``"step"``), every param's state made where missing."""
    adam = isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
    for p in params:
        state = opt.state[p]
        if "step" not in state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=device)
        elif state["step"].device != device:  # a load onto a non-capturable group
            state["step"] = state["step"].to(device)
        if adam and "exp_avg" not in state:
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if isinstance(opt, Lion) and "exp_avg" not in state:
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if (isinstance(opt, torch.optim.SGD) and opt.defaults.get("momentum")
                and state.get("momentum_buffer") is None):
            state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return opt.state[params[0]]["step"]


@torch.no_grad()
def gated_step(opt: torch.optim.Optimizer, grads: dict, ok: torch.Tensor, schedule,
               clip_norm=None, sumsq=None) -> tuple:
    """One update of ``opt`` with the gradients ``grads`` (param -> tensor)
    if the 0-dim bool ``ok`` is true, and none at all if it is false, with
    no host read. ``clip_norm``: clip to that global norm first (optax's
    ``clip_by_global_norm``, as the Module's plain path). Returns
    ``(update_norm, lr, grad_norm)`` as 0-dim f32 tensors: ||update|| of the
    applied update (0 when held), the lr it used, and the pre-clip norm of
    the gradients it took (those of a held step are zeros). ``sumsq``:
    ``fn(params, tensors) -> Σ ||t||²`` for the two global norms, where the
    params are shards summed over the ranks (default: the local sum).

    The lr is ``schedule(count)``, count being the optimizer's applied
    updates (a device tensor, :func:`_count`). On a held step the gradients
    are zeroed (``torch.where``; they may hold NaN), each moment's decay is
    1 and its gradient weight 0, the lr 0 and the count's increment 0, so
    every param, moment and count keeps its bits. Bias corrections use the
    count after this update, as torch and optax do."""
    okf = ok.float()
    order = [p for group in opt.param_groups for p in group["params"] if p in grads]
    if not order:
        raise ValueError("gated_step: no gradient for any of the optimizer's params")
    device = order[0].device
    safe = dict(zip(order, (torch.where(ok, grads[p], 0.0) for p in order)))
    if sumsq is None:
        grad_norm = (torch.stack(torch._foreach_norm(list(safe.values()))).float().square().sum()
                     .sqrt())
    else:
        grad_norm = sumsq(order, list(safe.values())).sqrt()
    if clip_norm is not None:
        torch._foreach_mul_(list(safe.values()),
                            clip_norm / torch.clamp(grad_norm, min=clip_norm))
    count = _count(opt, order, device)
    value = schedule(count)
    lr = (value.float() if isinstance(value, torch.Tensor)
          else torch.full((), float(value), device=device))
    lr_eff = lr * okf

    def decayed(beta):  # (decay, gradient weight): (1, 0) on a held step
        return torch.where(ok, beta, 1.0), torch.where(ok, 1.0 - beta, 0.0)

    norms, stepped, moved = [], [], []
    for group in opt.param_groups:
        params = [p for p in group["params"] if p in safe]
        if not params:
            continue
        _count(opt, params, device)
        g = [safe[p] for p in params]
        states = [opt.state[p] for p in params]
        wd = group.get("weight_decay", 0.0)
        if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
            b1, b2 = group["betas"]
            m = [s["exp_avg"] for s in states]
            v = [s["exp_avg_sq"] for s in states]
            d1, w1 = decayed(b1)
            d2, w2 = decayed(b2)
            torch._foreach_mul_(m, d1)
            torch._foreach_add_(m, torch._foreach_mul(g, w1))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, w2)
            torch._foreach_mul_(v, d2)
            torch._foreach_add_(v, sq)
            t = states[0]["step"] + 1.0
            # optax: m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) [+ wd p].
            upd = torch._foreach_div(m, 1.0 - torch.pow(b1, t))
            denom = torch._foreach_sqrt(torch._foreach_div(v, 1.0 - torch.pow(b2, t)))
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(upd, denom)
            if wd and _decoupled(opt, group):
                torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        elif isinstance(opt, Lion):
            m = [s["exp_avg"] for s in states]
            upd = torch._foreach_mul(g, 1.0 - group["b1"])
            torch._foreach_add_(upd, torch._foreach_mul(m, group["b1"]))
            torch._foreach_sign_(upd)
            if wd:
                torch._foreach_add_(upd, torch._foreach_mul(params, wd))
            d2, w2 = decayed(group["b2"])
            torch._foreach_mul_(m, d2)
            torch._foreach_add_(m, torch._foreach_mul(g, w2))
        else:  # SGD: torch's trace m = beta m + g is optax's (from zeros)
            upd = torch._foreach_add(g, torch._foreach_mul(params, wd)) if wd else g
            beta = group.get("momentum", 0.0)
            if beta:
                bufs = [s["momentum_buffer"] for s in states]
                torch._foreach_mul_(bufs, torch.where(ok, beta, 1.0))
                torch._foreach_add_(bufs, torch._foreach_mul(upd, okf))
                upd = (torch._foreach_add(upd, torch._foreach_mul(bufs, beta))
                       if group.get("nesterov") else bufs)
        step = torch._foreach_mul(upd, lr_eff)
        if sumsq is None:
            norms += torch._foreach_norm(step)
        else:
            stepped += params
            moved += step
        torch._foreach_sub_(params, step)
        # A list of the 0-dim increment: foreach add with one tensor
        # operand reads it on the host (a sync); tensor lists do not.
        steps = [s["step"] for s in states]
        torch._foreach_add_(steps, [okf] * len(steps))
    if sumsq is not None:
        return sumsq(stepped, moved).sqrt(), lr, grad_norm
    return torch.stack(norms).float().square().sum().sqrt(), lr, grad_norm


def resolve(opt: Factory, params: dict) -> torch.optim.Optimizer:
    """Build the optimizer of a factory over ``params``."""
    if not callable(opt):
        raise TypeError(f"Optimizer must be a factory fn(params) -> torch.optim.Optimizer, "
                        f"got {type(opt).__name__}")
    built = opt(params)
    if not isinstance(built, torch.optim.Optimizer):
        raise TypeError(f"optimizer factory returned {type(built).__name__}, "
                        "expected a torch.optim.Optimizer")
    return built
