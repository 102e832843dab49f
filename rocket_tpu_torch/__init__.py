"""rocket_tpu_torch — the PyTorch/CUDA port of ``rocket_tpu`` for NVIDIA Hopper.

The JAX package ``rocket_tpu`` stays the reference; this package mirrors
its module paths (``core/``, ``nn/``, ``ops/``, ``models/``, ``serve/``,
``data/``, ``optim``, ``runtime``) so each counterpart is easy to find,
and never imports it (nor ``jax``).

Ported so far: training decoder LMs (GPT-2 124M, the Llama-style
char-LM with GQA/RoPE, the char-LM, the MoE LM with routed expert FFNs)
and image classifiers (CIFAR-10 ResNet-18 with BatchNorm state, ViT-Ti,
LeNet and the MLP on MNIST; on-device augmentation, eval through
``Meter``) over the data stack of ``data/`` (datasets kept on the device
when they fit, or streamed with read-ahead and worker processes) through
the capsule tree
``Launcher -> Looper -> Dataset, Module(Loss, Optimizer, Scheduler),
Checkpointer, Tracker, Meter, Profiler`` with checkpoints and resume
(``runtime/checkpoint_io.py``, the JAX package's format), and serving the
LMs through the paged-KV engine (``serve.ServeEngine``) and
``models.transformer.generate`` (``examples/char_lm.py``,
``examples/moe_lm.py`` and ``examples/generate.py``). The TPU kernels on
those paths — flash attention forward, fused backward and accumulating
dq, paged decode, decode attention, the fused attention half of a block,
the fused BatchNorm(+relu) epilogue, and the MoE's grouped matrix
products (gather-GMM and the megablox gmm/tgmm pair) — are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, built with ``nvcc`` into
``build/kernels/`` at first use (``ops/_build.py``).

A training script reads as the JAX one does::

    import rocket_tpu_torch as rt
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=8),
                            rt.Module(model, [rt.Loss(...), rt.Optimizer(...)])])],
                runtime=rt.Runtime()).launch()

The ops plane's training half (``obs``: telemetry, spans, goodput, the
health sentinels with their update gate, the flight recorder, the
watchdog; ``runtime.StrictMode``) turns on through the ``Runtime``'s
arguments (``telemetry=``, ``health=``, ``strict=``, ...); its live export
plane (metric shards, ``/metrics``, SLOs) through ``export=``,
``metrics_port=`` and ``slo=``. ``python -m rocket_tpu_torch.launch
--supervise`` restarts crashed or wedged workers from their last complete
checkpoint and drains them on SIGTERM (``resilience``), and
``ROCKET_TPU_FAULTS`` injects faults into the real loop.

Data parallelism: a ``Runtime`` adopts its caller's ``torch.distributed``
group or opens one from the launcher's environment; each rank trains on
its stripe of the global batch, with the bucketed gradient reduction and
the FSDP layout of ``rocket_tpu_torch.parallel`` and one checkpoint shard
file a rank.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``runtime.resolve_device``); on CPU tensors every kernel wrapper takes
its plain PyTorch version.
"""

from rocket_tpu_torch.core import (
    Attributes,
    Capsule,
    Checkpointer,
    Dataset,
    Dispatcher,
    Events,
    Launcher,
    Looper,
    Loss,
    Meter,
    Metric,
    Module,
    Optimizer,
    Profiler,
    Scheduler,
    Tracker,
    register_tracker_backend,
)
from rocket_tpu_torch import obs
from rocket_tpu_torch.runtime import Runtime

__version__ = "0.4.0"

__all__ = ["Attributes", "Capsule", "Checkpointer", "Dataset", "Dispatcher", "Events", "Launcher",
           "Looper", "Loss", "Meter", "Metric", "Module", "Optimizer", "Profiler", "Runtime",
           "Scheduler", "Tracker", "obs", "register_tracker_backend"]
