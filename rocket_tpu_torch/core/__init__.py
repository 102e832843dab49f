"""The capsule core (counterpart of ``rocket_tpu.core``): the five-event
lifecycle and the capsules of a training tree, with checkpointing,
tracking and evaluation metrics (``Meter``/``Metric``). The Profiler waits
for a later slice (ROADMAP Queue A 2)."""

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule, Events
from rocket_tpu_torch.core.checkpoint import Checkpointer
from rocket_tpu_torch.core.dataset import Dataset
from rocket_tpu_torch.core.dispatcher import Dispatcher
from rocket_tpu_torch.core.launcher import Launcher
from rocket_tpu_torch.core.loop import Looper
from rocket_tpu_torch.core.loss import Loss
from rocket_tpu_torch.core.meter import Meter, Metric
from rocket_tpu_torch.core.module import Module
from rocket_tpu_torch.core.optimizer import Optimizer
from rocket_tpu_torch.core.scheduler import Scheduler
from rocket_tpu_torch.core.tracker import Tracker, register_tracker_backend

__all__ = [
    "Attributes", "Capsule", "Checkpointer", "Dataset", "Dispatcher", "Events", "Launcher",
    "Looper", "Loss", "Meter", "Metric", "Module", "Optimizer", "Scheduler", "Tracker",
    "register_tracker_backend",
]
