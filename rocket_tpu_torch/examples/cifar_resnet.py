"""CIFAR-10 ResNet-18 (counterpart of ``examples/cifar_resnet.py``).

Real CIFAR-10 when torchvision and a cached copy under ``$CIFAR_ROOT`` (or
``./data``) are present; otherwise the JAX example's synthetic separable
images, drawn by the same numpy code, so both packages see the same data.
SGD momentum 0.9 with cosine decay from 0.2, on-device augmentation
(random crop with 4 pixels of zero padding, horizontal flip) as the
Module's ``batch_transform``, a ``Checkpointer`` every 200 steps keeping
the last two, a jsonl ``Tracker`` (``runs/cifar_resnet18.jsonl``), and an
eval Looper with ``Meter(Accuracy)`` after every epoch.

    python -m rocket_tpu_torch.examples.cifar_resnet      # on the GPU

``ROCKET_TPU_FUSED_CONV=pallas`` runs every train-mode BatchNorm (+relu)
through the fused kernel (``ops/fused_conv.py``), as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch.nn.functional as F

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.augment import image_augment
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.models.resnet import resnet18
from rocket_tpu_torch.utils.metrics import Accuracy


def cifar10(train=True):
    try:
        from torchvision.datasets import CIFAR10

        tv = CIFAR10(root=os.environ.get("CIFAR_ROOT", "data"), train=train, download=False)
        images = tv.data.astype(np.float32) / 255.0  # (N, 32, 32, 3) NHWC already
        mean = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
        std = np.asarray([0.247, 0.243, 0.261], np.float32)
        images = (images - mean) / std
        labels = np.asarray(tv.targets, np.int32)
        return ArrayDataset(images, labels)
    except Exception:
        rng = np.random.default_rng(0 if train else 1)
        n = 50_000 if train else 10_000
        labels = rng.integers(0, 10, size=n).astype(np.int32)
        templates = np.random.default_rng(7).normal(size=(10, 32, 32, 3)).astype(np.float32)
        images = templates[labels] + rng.normal(size=(n, 32, 32, 3)).astype(np.float32) * 0.6
        return ArrayDataset(images, labels)


def cross_entropy(batch):
    return F.cross_entropy(batch["logits"].float(), batch["label"].long())


def build(train_data, val_data, *, batch_size: int, num_epochs: int, out_dir: str, runtime,
          resume_from=None) -> dict:
    """The example's capsule tree. Returns ``{"launcher", "model",
    "module", "datasets", "checkpointer", "accuracy", "trained",
    "total_steps"}``;
    ``trained["state"]`` is the live train state (``params``,
    ``model_state``, ...) once a step ran, and stays past the launch."""
    model = resnet18(num_classes=10, stem="cifar")
    accuracy = Accuracy()
    steps = max(1, len(train_data) // batch_size * num_epochs)
    module = rt.Module(
        model,
        capsules=[
            rt.Loss(cross_entropy),
            rt.Optimizer(optim.momentum(beta=0.9)),
            rt.Scheduler(optim.cosine_lr(0.2, decay_steps=steps)),
        ],
        # On-device augmentation: the host ships raw samples, each step
        # crops and flips with its own key.
        batch_transform=image_augment(crop_padding=4, flip=True),
    )
    # A handle on the train state past destroy.
    trained: dict = {}

    class Keep(rt.Capsule):
        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["state"] = module.state

    checkpointer = rt.Checkpointer(output_dir=out_dir, save_every=200, keep_last=2,
                                   resume_from=resume_from)
    datasets = (rt.Dataset(train_data, batch_size=batch_size, shuffle=True, drop_last=True),
                rt.Dataset(val_data, batch_size=batch_size))
    launcher = rt.Launcher(
        [
            rt.Looper(
                [
                    datasets[0],
                    module,
                    Keep(),
                    checkpointer,
                    rt.Tracker(backend="jsonl", project="cifar_resnet18"),
                ],
                tag="train",
            ),
            rt.Looper(
                [
                    datasets[1],
                    rt.Module(model),
                    rt.Meter(["logits", "label"], [accuracy]),
                    rt.Tracker(backend="jsonl", project="cifar_resnet18"),
                ],
                tag="val",
                grad_enabled=False,
            ),
        ],
        num_epochs=num_epochs,
        statefull=True,
        runtime=runtime,
    )
    return {"launcher": launcher, "model": model, "module": module, "datasets": datasets,
            "checkpointer": checkpointer, "accuracy": accuracy, "trained": trained,
            "total_steps": steps}


def main(num_epochs: int = 5, batch_size: int = 512, out_dir: str = "checkpoints/cifar",
         device=None) -> dict:
    """Train, evaluate every epoch and checkpoint into ``out_dir``;
    ``device`` defaults to the GPU. Returns :func:`build`'s dict."""
    runtime = rt.Runtime(seed=0, device=device)
    run = build(cifar10(train=True), cifar10(train=False), batch_size=batch_size,
                num_epochs=num_epochs, out_dir=out_dir, runtime=runtime)
    run["launcher"].launch()
    print(f"val accuracy: {run['accuracy'].value:.4f}")
    return run


if __name__ == "__main__":
    main()
