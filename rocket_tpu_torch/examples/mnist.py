"""MNIST with the canonical capsule tree (counterpart of
``examples/mnist.py``): LeNet, the whole-batch cross-entropy
(``F.cross_entropy``), AdamW (weight decay 0.01) with a step schedule from
1e-3 halving every 100 optimizer steps, gradient accumulation over 2
batches, train and val Loopers, ``Meter(Accuracy)``, a ``Checkpointer``
every 50 steps and a jsonl ``Tracker`` (``runs/mnist.jsonl``). Real MNIST
from a local torchvision copy, else ``SyntheticMNIST``.

    python -m rocket_tpu_torch.examples.mnist      # on the GPU
"""

from __future__ import annotations

import torch.nn.functional as F

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.datasets import mnist
from rocket_tpu_torch.models.lenet import LeNet
from rocket_tpu_torch.utils.metrics import Accuracy


def cross_entropy(batch):
    return F.cross_entropy(batch["logits"].float(), batch["label"].long())


def build(train_data, val_data, *, batch_size: int, num_epochs: int, out_dir: str,
          runtime) -> dict:
    """The example's capsule tree (the runtime carries the gradient
    accumulation). Returns ``{"launcher", "model", "module", "datasets",
    "accuracy", "trained"}``."""
    model = LeNet(num_classes=10)
    accuracy = Accuracy()
    module = rt.Module(model, capsules=[
        rt.Loss(cross_entropy),
        rt.Optimizer(optim.adamw(weight_decay=0.01)),
        rt.Scheduler(optim.step_lr(1e-3, step_size=100, gamma=0.5)),
    ])
    trained: dict = {}

    class Keep(rt.Capsule):
        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["state"] = module.state

    datasets = (rt.Dataset(train_data, batch_size=batch_size, shuffle=True),
                rt.Dataset(val_data, batch_size=batch_size))
    launcher = rt.Launcher(
        [
            rt.Looper([datasets[0], module, Keep(),
                       rt.Checkpointer(output_dir=out_dir, save_every=50),
                       rt.Tracker(backend="jsonl", project="mnist")], tag="train"),
            rt.Looper([datasets[1], rt.Module(model), rt.Meter(["logits", "label"], [accuracy]),
                       rt.Tracker(backend="jsonl", project="mnist")],
                      tag="val", grad_enabled=False),
        ],
        num_epochs=num_epochs,
        statefull=True,
        runtime=runtime,
    )
    return {"launcher": launcher, "model": model, "module": module, "datasets": datasets,
            "accuracy": accuracy, "trained": trained}


def main(num_epochs: int = 3, batch_size: int = 1024, out_dir: str = "checkpoints/mnist",
         device=None) -> dict:
    """Train and evaluate every epoch; ``device`` defaults to the GPU.
    Returns :func:`build`'s dict."""
    runtime = rt.Runtime(seed=0, gradient_accumulation_steps=2, device=device)
    run = build(mnist(train=True), mnist(train=False), batch_size=batch_size,
                num_epochs=num_epochs, out_dir=out_dir, runtime=runtime)
    print(run["launcher"])
    run["launcher"].launch()
    print(f"val accuracy: {run['accuracy'].value:.4f}")
    return run


if __name__ == "__main__":
    main()
