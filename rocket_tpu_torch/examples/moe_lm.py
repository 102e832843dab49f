"""Mixture-of-Experts char-LM (counterpart of ``examples/moe_lm.py``).

Each block's MLP is the top-2 routed expert FFN (``nn/moe.py``, einsum
dispatch by default); the router's load-balancing loss rides
``batch["moe_aux_loss"]`` into ``next_token_loss``. On one device every
expert is local, which is the reference's single-chip behaviour; an
'expert' mesh axis (``--expert-axis`` above 1, ``moe_rules`` param
sharding) needs multi-device parallelism, not ported yet (ROADMAP Queue A
6). The tree carries a ``Profiler`` for the step clock.

    python -m rocket_tpu_torch.examples.moe_lm      # on the GPU

Without ``data/tinyshakespeare.txt`` (or ``$TEXT_ROOT``) the corpus is the
deterministic synthetic one.
"""

from __future__ import annotations

import argparse

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, tiny_shakespeare
from rocket_tpu_torch.models.transformer import TransformerConfig, TransformerLM, next_token_loss


def config_for(vocab_size: int, seq_len: int, experts: int) -> TransformerConfig:
    """The example's model: dim 128, 4 layers, 4 heads (head dim 32)."""
    return TransformerConfig(vocab_size=vocab_size, max_seq_len=seq_len, dim=128, num_layers=4,
                             num_heads=4, dropout=0.0, num_experts=experts, expert_top_k=2)


def build(train_data, config: TransformerConfig, *, batch_size: int, num_epochs: int,
          runtime) -> dict:
    """The example's capsule tree over ``train_data``: ``{"launcher",
    "model", "module", "profiler", "trained"}``; once a step ran,
    ``trained["params"]`` holds the live params and ``trained["losses"]``
    each step's loss (device scalars, read by the caller after the run)."""
    model = TransformerLM(config)
    module = rt.Module(model, capsules=[
        rt.Loss(next_token_loss()),
        rt.Optimizer(optim.adamw(), learning_rate=1e-3),
    ])
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
    ], tag="train")], num_epochs=num_epochs, runtime=runtime)
    return {"launcher": launcher, "model": model, "module": module, "profiler": profiler,
            "trained": trained}


def main(num_epochs: int = 2, batch_size: int = 64, seq_len: int = 128, device=None) -> dict:
    """Train on the corpus; ``device`` defaults to the GPU. Returns
    :func:`build`'s dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--expert-axis", type=int, default=None,
                        help="devices on the 'expert' mesh axis (one device: 1)")
    args, _ = parser.parse_known_args()
    if args.expert_axis not in (None, 1):
        raise SystemExit(f"--expert-axis {args.expert_axis}: an 'expert' mesh axis needs "
                         "expert parallelism, not ported yet (ROADMAP Queue A 6 item 5)")

    text = tiny_shakespeare()
    tok = CharTokenizer(text)
    data = TokenDataset(tok.encode(text), seq_len=seq_len)
    run = build(data, config_for(tok.vocab_size, seq_len, args.experts),
                batch_size=batch_size, num_epochs=num_epochs,
                runtime=rt.Runtime(seed=0, device=device))
    run["launcher"].launch()
    return run


if __name__ == "__main__":
    main()
