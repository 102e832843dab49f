"""CIFAR-10 Vision Transformer (counterpart of ``examples/vit_cifar.py``).

``vit_tiny`` (D=192, 9 blocks, 3 heads, 4x4 patches: 65 tokens, dropout
0.1) in bf16 compute over f32 masters, AdamW with gradient clipping at 1.0
and warmup-cosine from 3e-3, the on-device augmentation of
``cifar_resnet`` (crop with 4 pixels of zero padding, flip), a
``Checkpointer`` every 200 steps keeping the last two, a jsonl ``Tracker``
(``runs/vit_cifar.jsonl``) and an eval Looper with ``Meter(Accuracy)``
after every epoch. The data and the objective are ``cifar_resnet``'s
(real CIFAR-10 from a local copy, else the synthetic images).

    python -m rocket_tpu_torch.examples.vit_cifar      # on the GPU
"""

from __future__ import annotations

import torch

import rocket_tpu_torch as rt
from rocket_tpu_torch import optim
from rocket_tpu_torch.data.augment import image_augment
from rocket_tpu_torch.examples.cifar_resnet import cifar10, cross_entropy
from rocket_tpu_torch.models.vit import vit_tiny
from rocket_tpu_torch.utils.metrics import Accuracy


def build(train_data, val_data, *, batch_size: int, num_epochs: int, out_dir: str, runtime,
          model=None, compute_dtype=torch.bfloat16, optimizer=None, lr: float = 3e-3,
          objective=None, batch_transform=None, ema_decay=None, save_every: int = 200,
          resume_from=None, capsules=()) -> dict:
    """The example's capsule tree (``model`` defaults to the example's
    ``vit_tiny``; ``compute_dtype=None`` computes in float32). The recipe's
    parts default to the example's — ``optimizer`` AdamW, peak ``lr``,
    ``objective`` cross-entropy, ``batch_transform`` crop and flip — and
    ``ema_decay`` keeps an EMA shadow of the params that the eval Module
    then forwards with (``use_ema``); ``capsules`` join the train Looper.
    Returns ``{"launcher", "model",
    "module", "datasets", "checkpointer", "accuracy", "trained",
    "total_steps"}``; ``trained["state"]`` is the live train state once a
    step ran."""
    model = model or vit_tiny(image_size=32, patch_size=4, num_classes=10, dropout=0.1)
    accuracy = Accuracy()
    steps = max(1, len(train_data) // batch_size * num_epochs)
    module = rt.Module(
        model,
        capsules=[
            rt.Loss(objective or cross_entropy),
            rt.Optimizer(optimizer or optim.adamw(), clip_norm=1.0),
            rt.Scheduler(optim.warmup_cosine_lr(lr, warmup_steps=max(1, steps // 20),
                                                decay_steps=steps)),
        ],
        compute_dtype=compute_dtype,
        batch_transform=batch_transform or image_augment(crop_padding=4, flip=True),
        ema_decay=ema_decay,
    )
    trained: dict = {}

    class Keep(rt.Capsule):
        def __init__(self):
            super().__init__(priority=10)

        def launch(self, attrs=None):
            trained["state"] = module.state

    datasets = (rt.Dataset(train_data, batch_size=batch_size, shuffle=True, drop_last=True),
                rt.Dataset(val_data, batch_size=batch_size))
    checkpointer = rt.Checkpointer(output_dir=out_dir, save_every=save_every, keep_last=2,
                                   resume_from=resume_from)
    launcher = rt.Launcher(
        [
            rt.Looper([datasets[0], module, Keep(), *capsules, checkpointer,
                       rt.Tracker(backend="jsonl", project="vit_cifar")], tag="train"),
            rt.Looper([datasets[1], rt.Module(model, compute_dtype=compute_dtype,
                                              use_ema=ema_decay is not None),
                       rt.Meter(["logits", "label"], [accuracy]),
                       rt.Tracker(backend="jsonl", project="vit_cifar")],
                      tag="val", grad_enabled=False),
        ],
        num_epochs=num_epochs,
        statefull=True,
        runtime=runtime,
    )
    return {"launcher": launcher, "model": model, "module": module, "datasets": datasets,
            "checkpointer": checkpointer, "accuracy": accuracy, "trained": trained,
            "total_steps": steps}


def main(num_epochs: int = 5, batch_size: int = 512, out_dir: str = "checkpoints/vit_cifar",
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
