"""Data parallelism (counterpart of ``rocket_tpu/parallel``): the
param-sharding rule builders (``sharding``) and the bucketed gradient
reduction over the process group (``grad_sync``). Tensor, pipeline,
ring-attention and expert parallelism are ROADMAP Queue A 6."""

from rocket_tpu_torch.parallel.sharding import fsdp_rules, gpt2_tp_rules, make_rules

__all__ = ["fsdp_rules", "gpt2_tp_rules", "make_rules"]
