"""Parameter bridge: a JAX param tree (as numpy) -> the port's params, and
a JAX model's ``variables`` (params and state) -> the port's.

The port's param dicts use the JAX package's names, so the copy is
rename-free: the transformer's, the ResNets', ViT's bare ``cls`` and
``pos`` arrays beside its ``blocks``, and the ``Sequential`` trunks of
LeNet and the MLP under ``"0"``, ``"1"``, ... (their activations, pools
and ``Flatten`` as empty dicts, which the port's trunks also draw). A
scanned JAX tree (``blocks_stacked``, every leaf with a
leading layer dim) is unstacked into the per-layer ``blocks`` subtree the
port uses. Dtypes are kept, bfloat16 included (numpy holds it as the
``ml_dtypes`` type, which torch cannot read directly, so its bits are
reinterpreted). The model state (the ResNets' BatchNorm running
statistics) carries over beside the params, as laid out, with conv
kernels kept HWIO. This module takes numpy only and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy", "variables_from_jax"]


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
    """Convert a JAX param tree of numpy arrays (e.g. ``jax.tree.map(
    np.asarray, variables["params"])`` of a ``TransformerLM``, ``ViT``,
    ``LeNet`` or ``MLP``) to port params on ``device``."""
    tree = dict(tree)
    stacked = tree.pop("blocks_stacked", None)
    if stacked is not None:
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        tree["blocks"] = {str(i): _unstack(stacked, i) for i in range(np.shape(leaf)[0])}
    return _convert(tree, device)


def variables_from_jax(variables: dict, device="cpu") -> dict:
    """Convert a JAX model's ``{"params": ..., "state": ...}`` of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, model.init(key))``) to
    ``{"params", "state"}`` of port tensors on ``device``; a missing state
    is empty."""
    return {"params": params_from_jax(variables["params"], device),
            "state": _convert(variables.get("state", {}), device)}
