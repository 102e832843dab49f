"""rocket_tpu_torch — the PyTorch/CUDA port of ``rocket_tpu`` for NVIDIA Hopper.

The JAX package ``rocket_tpu`` stays the reference; this package mirrors
its module paths (``nn/``, ``ops/``, ``models/``, ``serve/``, ``data/``) so
each counterpart is easy to find, and never imports it (nor ``jax``).

What is ported so far is the serving path: GPT-2 / Llama-style decoder
LMs served through the paged-KV engine (``serve.ServeEngine``) and
``models.transformer.generate``. The two TPU kernels on that path are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built with ``nvcc``
into ``build/kernels/`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``runtime.resolve_device``); on CPU tensors every kernel wrapper takes
its plain PyTorch version.
"""

__version__ = "0.1.0"
