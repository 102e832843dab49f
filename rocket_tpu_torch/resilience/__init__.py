"""Resilience (counterpart of ``rocket_tpu.resilience``): the supervising
launcher that restarts crashed generations from the last complete
checkpoint (``supervisor.py``, driven by ``python -m
rocket_tpu_torch.launch --supervise``), the cooperative SIGTERM drain the
Looper honours at wave boundaries (``faults.DrainState`` /
``GracefulDrain``), and the deterministic fault plans
(``faults.FaultPlan``, ``ROCKET_TPU_FAULTS``) that make the real
launcher, Looper and Checkpointer fail on schedule."""

from rocket_tpu_torch.resilience.faults import (
    DRAIN_ENV,
    EXIT_DRAINED,
    EXIT_WEDGED,
    FAULTS_ENV,
    GENERATION_ENV,
    SUPERVISED_ENV,
    DrainState,
    Fault,
    FaultInjector,
    FaultPlan,
    GracefulDrain,
    install_signal_drain,
)
from rocket_tpu_torch.resilience.supervisor import (
    SUPERVISOR_FILE,
    GenerationRecord,
    RestartPolicy,
    Supervisor,
    is_complete_checkpoint,
    newest_complete_step,
)

__all__ = ["DRAIN_ENV", "EXIT_DRAINED", "EXIT_WEDGED", "FAULTS_ENV", "GENERATION_ENV",
           "SUPERVISED_ENV", "SUPERVISOR_FILE", "DrainState", "Fault", "FaultInjector", "FaultPlan",
           "GenerationRecord", "GracefulDrain", "RestartPolicy", "Supervisor",
           "install_signal_drain", "is_complete_checkpoint", "newest_complete_step"]
