"""rocket_tpu_torch.serve — continuous-batching inference over a paged KV pool.

* ``kv_pool`` — the fixed device pool and the host-side block allocator;
* ``engine`` — the fixed-shape decode dispatch and prefill chunk;
* ``scheduler`` — admission, chunked prefill, eviction and resume;
* ``api`` — the :class:`ServeEngine` facade and its ``report()``.

``python -m rocket_tpu_torch.serve run`` serves a synthetic workload.
"""

from rocket_tpu_torch.serve.api import ServeConfig, ServeEngine, StreamDetokenizer
from rocket_tpu_torch.serve.kv_pool import BlockAllocator, KVPoolSpec
from rocket_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = [
    "BlockAllocator",
    "KVPoolSpec",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "StreamDetokenizer",
]
