"""Data and tensor parallelism (counterpart of ``rocket_tpu/parallel``):
the param-sharding rule builders (``sharding``), the bucketed gradient
reduction over the process group (``grad_sync``) and the overlapped
collective matmuls of the model axis (``collectives``). Pipeline,
ring-attention and expert parallelism are ROADMAP Queue A 6 items 3-5."""

from rocket_tpu_torch.parallel.sharding import fsdp_rules, gpt2_tp_rules, make_rules

__all__ = ["fsdp_rules", "gpt2_tp_rules", "make_rules"]
