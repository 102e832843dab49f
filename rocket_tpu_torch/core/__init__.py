"""The capsule core (counterpart of ``rocket_tpu.core``): the five-event
lifecycle and the capsules of a training tree, with checkpointing,
tracking, evaluation metrics (``Meter``/``Metric``) and step timing with
trace windows (``Profiler``)."""

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
from rocket_tpu_torch.core.profiler import Profiler
from rocket_tpu_torch.core.scheduler import Scheduler
from rocket_tpu_torch.core.tracker import Tracker, register_tracker_backend

__all__ = [
    "Attributes", "Capsule", "Checkpointer", "Dataset", "Dispatcher", "Events", "Launcher",
    "Looper", "Loss", "Meter", "Metric", "Module", "Optimizer", "Profiler", "Scheduler", "Tracker",
    "register_tracker_backend",
]
