"""Optimizer factories and learning-rate schedules for the capsule API
(counterpart of ``rocket_tpu/optim.py``).

An optimizer is a **factory** ``fn(params) -> torch.optim.Optimizer``
over a param dict, built by the ``Module`` once the params exist; its
learning rate is set before every update from the ``Scheduler``'s
schedule (or the ``Optimizer`` capsule's constant), so the factories
construct with ``lr=0``. A schedule is a plain ``step -> lr`` function,
read at the count of updates made BEFORE the update it drives, as optax
reads its schedule: under :func:`warmup_cosine_lr` the first update has
lr 0.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from rocket_tpu_torch.nn.module import map_params

__all__ = [
    "sgd", "momentum", "adam", "adamw", "lion", "Lion",
    "constant_lr", "step_lr", "cosine_lr", "linear_lr", "warmup_stable_decay_lr",
    "warmup_cosine_lr", "resolve", "param_leaves",
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


# -- schedules (step -> lr), the optax formulas in float arithmetic ----------


def constant_lr(value: float) -> Schedule:
    return lambda step: value


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        return (init_value - end_value) * (1 - count / transition_steps) + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule requires positive decay_steps, got {decay_steps}")

    def schedule(step):
        count = min(step, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """optax ``join_schedules``: schedule i+1 takes over at boundary i,
    with the step counted from that boundary."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = nxt(step - boundary)
        return out

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch ``StepLR`` analogue (optax ``exponential_decay`` with
    ``staircase=True``): decay by ``gamma`` every ``step_size`` steps."""
    if step_size <= 0 or gamma == 0:
        return lambda step: base_lr
    return lambda step: base_lr if step <= 0 else base_lr * gamma ** math.floor(step / step_size)


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
