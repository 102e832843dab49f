"""The capsule core (counterpart of ``rocket_tpu.core``): the five-event
lifecycle and the capsules of a training tree. Checkpointer, Meter,
Tracker and Profiler wait for later slices (ROADMAP Queue A 2, 3, 7)."""

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule, Events
from rocket_tpu_torch.core.dataset import Dataset
from rocket_tpu_torch.core.dispatcher import Dispatcher
from rocket_tpu_torch.core.launcher import Launcher
from rocket_tpu_torch.core.loop import Looper
from rocket_tpu_torch.core.loss import Loss
from rocket_tpu_torch.core.module import Module
from rocket_tpu_torch.core.optimizer import Optimizer
from rocket_tpu_torch.core.scheduler import Scheduler

__all__ = [
    "Attributes", "Capsule", "Dataset", "Dispatcher", "Events", "Launcher", "Looper", "Loss",
    "Module", "Optimizer", "Scheduler",
]
