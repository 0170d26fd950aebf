"""Parameter trees between the JAX package and the port.

``Optic.build()`` in both packages produces the same nested structure: a dict
with a ``surfaces`` list of per-surface dicts and the system arrays
(``aperture_value``, ``fields``, ``vig``, ``wavelengths``). This module turns a
host copy of such a tree (numpy arrays and Python numbers, e.g. the JAX tree
mapped with ``np.asarray``) into tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device=None, dtype=torch.float64):
    """Same nested dict/list structure, every leaf a tensor on ``device``;
    floating leaves take ``dtype``, integer and boolean leaves keep theirs."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device=device)
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def params_to_numpy(tree):
    """The inverse: every tensor leaf becomes a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
