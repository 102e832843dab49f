"""Mixture-of-Experts char-LM with expert parallelism (counterpart of
``examples/moe_lm.py``).

Each block's MLP is the top-2 routed expert FFN (``nn/moe.py``, einsum
dispatch by default); the router's load-balancing loss rides
``batch["moe_aux_loss"]`` into ``next_token_loss``. Over an 'expert' mesh
axis (``moe_rules`` param sharding) each rank holds E/n experts of every
layer and computes their share; the ranks of one expert row read the same
batch (the reference's batch, replicated over ``expert``). The default
axis is the reference's: the widest that divides both the ranks and E.
The ranks come from ``python -m rocket_tpu_torch.launch -n N``; one
process is the reference's single-chip run (every expert local). The tree
carries a ``Profiler`` for the step clock.

    python -m rocket_tpu_torch.examples.moe_lm      # on the GPU
    python -m rocket_tpu_torch.launch -n 2 rocket_tpu_torch/examples/moe_lm.py --expert-axis 2

(``ROCKET_TPU_DIST_BACKEND=gloo`` lets two ranks share one card; ``--device
cpu`` runs them on the CPU.) Without ``data/tinyshakespeare.txt`` (or
``$TEXT_ROOT``) the corpus is the deterministic synthetic one.
"""

from __future__ import annotations

import argparse

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, tiny_shakespeare
from rocket_tpu_torch.examples.long_context import world_size
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss
from rocket_tpu_torch.parallel.sharding import moe_rules


def config_for(vocab_size: int, seq_len: int, experts: int) -> TransformerConfig:
    """The example's model: dim 128, 4 layers, 4 heads (head dim 32)."""
    return TransformerConfig(vocab_size=vocab_size, max_seq_len=seq_len, dim=128, num_layers=4,
                             num_heads=4, dropout=0.0, num_experts=experts, expert_top_k=2)


def build(train_data, config: TransformerConfig, *, batch_size: int, num_epochs: int,
          runtime, steps=None) -> dict:
    """The example's capsule tree over ``train_data``: ``{"launcher",
    "model", "module", "profiler", "trained"}``; once a step ran,
    ``trained["params"]`` holds the live params and ``trained["losses"]``
    each step's loss (device scalars, read by the caller after the run).
    The experts are laid out by ``moe_rules`` when the runtime's mesh has
    an expert axis; ``steps`` caps an epoch's steps."""
    model = TransformerLM(config)
    module = rt.Module(model, capsules=[
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.adamw(), learning_rate=1e-3),
    ], param_sharding=moe_rules() if "expert" in runtime.mesh else None)
    profiler = rt.Profiler()
    trained: dict = {"losses": []}

    class Keep(rt.Capsule):
        """A handle on the params past destroy, and the step losses."""

        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["params"] = module.state["params"]
            trained["losses"].append(attrs.step_metrics["loss"])

    launcher = rt.Launcher([rt.Looper([
        rt.Dataset(train_data, batch_size=batch_size, shuffle=True, drop_last=True),
        module,
        profiler,
        Keep(),
    ], tag="train", repeats=steps)], num_epochs=num_epochs, runtime=runtime)
    return {"launcher": launcher, "model": model, "module": module, "profiler": profiler,
            "trained": trained}


def main(num_epochs: int = 2, batch_size: int = 64, seq_len: int = 128, device=None,
         steps=None) -> dict:
    """Train on the corpus; ``device`` defaults to the GPU. Returns
    :func:`build`'s dict. The flags: ``--experts``, ``--expert-axis``
    (default the reference's rule), ``--device``, and at small sizes
    ``--epochs``, ``--batch``, ``--seq-len`` and ``--steps``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--expert-axis", type=int, default=None,
                        help="ranks on the 'expert' axis (default: the widest that divides both "
                             "the ranks and the experts)")
    parser.add_argument("--device", default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    args, _ = parser.parse_known_args()
    num_epochs = args.epochs or num_epochs
    batch_size = args.batch or batch_size
    seq_len = args.seq_len or seq_len
    steps = args.steps or steps
    device = args.device or device

    n = world_size()
    expert_ranks = args.expert_axis or max(
        w for w in range(1, n + 1) if n % w == 0 and args.experts % w == 0)
    if n % expert_ranks or args.experts % expert_ranks:
        raise SystemExit(f"--expert-axis {expert_ranks} must divide both {n} ranks and "
                         f"{args.experts} experts (one device a rank; start them with "
                         "python -m rocket_tpu_torch.launch -n N)")
    runtime = rt.Runtime(mesh_shape={"data": n // expert_ranks, "expert": expert_ranks},
                         seed=0, device=device)

    text = tiny_shakespeare()
    tok = CharTokenizer(text)
    data = TokenDataset(tok.encode(text), seq_len=seq_len)
    run = build(data, config_for(tok.vocab_size, seq_len, args.experts),
                batch_size=batch_size, num_epochs=num_epochs, runtime=runtime, steps=steps)
    run["launcher"].launch()
    losses = [float(v) for v in run["trained"]["losses"]]
    if runtime.is_main_process:
        print(f"moe_lm over {expert_ranks} expert ranks x {n // expert_ranks} data: loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f} ({len(losses)} steps)")
    return run


if __name__ == "__main__":
    main()
