"""Pupil sampling distributions (port of ``optiland_pr_tpu/core/distributions.py``).

The samples are made with numpy on the host, exactly as the JAX package makes
them, so both packages trace bit-identical pupils; only the final conversion
differs (a tensor on ``device`` instead of a jax array). Without a
``device`` the tensors go to the card (``config.default_device()``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_float, resolve_device

__all__ = ["generate_distribution", "gaussian_quad_weights", "DISTRIBUTIONS"]


def _line_x(n, positive_only=False):
    x = np.linspace(0 if positive_only else -1, 1, n)
    return x, np.zeros(n)


def _line_y(n, positive_only=False):
    x, y = _line_x(n, positive_only)
    return y, x


def _random(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    theta = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(theta), r * np.sin(theta)


def _uniform(n):
    """n x n grid masked to the unit disk."""
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x)
    m = X**2 + Y**2 <= 1
    return X[m], Y[m]


def _hexapolar(num_rings):
    """1 + 3*r*(r+1) points in concentric hex rings."""
    xs, ys = [0.0], [0.0]
    r = np.linspace(0, 1, num_rings + 1)
    for i in range(num_rings):
        nt = 6 * (i + 1)
        theta = np.linspace(0, 2 * np.pi, nt + 1)[:-1]
        xs.extend(r[i + 1] * np.cos(theta))
        ys.extend(r[i + 1] * np.sin(theta))
    return np.asarray(xs), np.asarray(ys)


def _cross(n):
    y_line = np.linspace(-1, 1, n)
    x_line = np.linspace(-1, 1, n)
    yx = np.zeros(n)
    if n % 2 == 1:
        x_line = np.delete(x_line, n // 2)
        xy = np.zeros(n - 1)
    else:
        xy = np.zeros(n)
    return np.concatenate([yx, x_line]), np.concatenate([y_line, xy])


def _ring(n):
    theta = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    return np.cos(theta), np.sin(theta)


# Forbes 1988 Gaussian-quadrature ring radii and weights
_GQ_RADIUS = {
    1: [0.70711],
    2: [0.45970, 0.88807],
    3: [0.33571, 0.70711, 0.94196],
    4: [0.26350, 0.57446, 0.81853, 0.96466],
    5: [0.21659, 0.48038, 0.70711, 0.87706, 0.97626],
    6: [0.18375, 0.41158, 0.61700, 0.78696, 0.91138, 0.98300],
}
_GQ_WEIGHTS = {
    1: [0.5],
    2: [0.25, 0.25],
    3: [0.13889, 0.22222, 0.13889],
    4: [0.08696, 0.16304, 0.16304, 0.08696],
    5: [0.059231, 0.11966, 0.14222, 0.11966, 0.059231],
    6: [0.04283, 0.09019, 0.11698, 0.11698, 0.09019, 0.04283],
}


def _gaussian_quad(num_rings, is_symmetric=False):
    if num_rings not in _GQ_RADIUS:
        raise ValueError("Gaussian quadrature must have between 1 and 6 rings.")
    radius = np.asarray(_GQ_RADIUS[num_rings])
    theta = np.array([0.0]) if is_symmetric else np.array(
        [-1.04719755, 0.0, 1.04719755])
    return (np.outer(radius, np.cos(theta)).ravel(),
            np.outer(radius, np.sin(theta)).ravel())


def gaussian_quad_weights(num_rings, is_symmetric=False, dtype=None,
                          device=None):
    if num_rings not in _GQ_WEIGHTS:
        raise ValueError("Gaussian quadrature must have between 1 and 6 rings.")
    w = np.asarray(_GQ_WEIGHTS[num_rings])
    w = w * 6.0 if is_symmetric else w * 2.0
    return torch.as_tensor(w, dtype=dtype or default_float(),
                           device=resolve_device(device))


DISTRIBUTIONS = {
    "line_x": _line_x,
    "line_y": _line_y,
    "positive_line_x": lambda n: _line_x(n, positive_only=True),
    "positive_line_y": lambda n: _line_y(n, positive_only=True),
    "random": _random,
    "uniform": _uniform,
    "hexapolar": _hexapolar,
    "cross": _cross,
    "ring": _ring,
    "gaussian_quad": _gaussian_quad,
}


def generate_distribution(kind: str, num_points: int, dtype=None, device=None,
                          **kw):
    """Return (Px, Py) tensors of normalized pupil coordinates on
    ``device`` (default: the card)."""
    if kind not in DISTRIBUTIONS:
        raise ValueError(f"Invalid distribution type: {kind!r}")
    x, y = DISTRIBUTIONS[kind](num_points, **kw)
    dt = dtype or default_float()
    dev = resolve_device(device)
    return (torch.as_tensor(x, dtype=dt, device=dev),
            torch.as_tensor(y, dtype=dt, device=dev))
