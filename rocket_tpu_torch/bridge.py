"""Parameter bridge: a JAX param tree (as numpy) -> the port's params.

The port's param dicts use the JAX package's names, so the copy is
rename-free. A scanned JAX tree (``blocks_stacked``, every leaf with a
leading layer dim) is unstacked into the per-layer ``blocks`` subtree the
port uses. Dtypes are kept, bfloat16 included (numpy holds it as the
``ml_dtypes`` type, which torch cannot read directly, so its bits are
reinterpreted). This module takes numpy only and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """One numpy array (bfloat16 included) -> a torch tensor of the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Convert a JAX ``TransformerLM`` param tree of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, variables["params"])``) to port params on
    ``device``."""
    tree = dict(tree)
    stacked = tree.pop("blocks_stacked", None)
    if stacked is not None:
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        tree["blocks"] = {str(i): _unstack(stacked, i) for i in range(np.shape(leaf)[0])}
    return _convert(tree, device)
