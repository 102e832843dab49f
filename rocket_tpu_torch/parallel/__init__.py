"""Multi-device parallelism (counterpart of ``rocket_tpu/parallel``): the
param-sharding rule builders (``sharding``), the bucketed gradient
reduction over the process group (``grad_sync``), the overlapped
collective matmuls of the model axis (``collectives``), ring attention
over the seq axis (``ring_attention``), the GPipe and 1F1B pipeline
over the pipe axis (``pipeline``) and the expert-group Functions of expert
parallelism (``collectives``; the MoE layer computes a rank's experts)."""

from rocket_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_sharded
from rocket_tpu_torch.parallel.sharding import fsdp_rules, gpt2_tp_rules, make_rules

__all__ = ["fsdp_rules", "gpt2_tp_rules", "make_rules", "ring_attention",
           "ring_attention_sharded"]
