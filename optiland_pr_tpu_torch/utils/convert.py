"""Parameter trees between the JAX package and the port.

``Optic.build()`` in both packages produces the same nested structure: a dict
with a ``surfaces`` list of per-surface dicts and the system arrays
(``aperture_value``, ``fields``, ``vig``, ``wavelengths``). A surface's dict
holds its thickness (solved by ``Optic.build``'s pickups and solves,
e.g. ``image_solve``), its ``geom`` leaves (radius, conic and a sag's own leaves:
an asphere's, a freeform's or a Forbes surface's ``coefficients`` and
``norm_radius``), its ``material`` leaves and, where the surface has them,
its ``aperture`` extents and offsets, its ``coating`` factors and its ``cs``
tilts and decenters. This module turns a host copy of such a tree (numpy
arrays and Python numbers, e.g. the JAX tree mapped with ``np.asarray``)
into tensors and back; it carries weights between the two packages, leaf
for leaf. Structure is not in the tree: a telecentric launch is the model's
``obj_space_telecentric``, which the same prescription built in the port
sets.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device=None, dtype=torch.float64):
    """Same nested dict/list structure, every leaf a tensor on ``device``
    (default: the card); floating leaves take ``dtype``, integer and boolean
    leaves keep theirs."""
    device = resolve_device(device)
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
