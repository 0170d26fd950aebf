"""optiland_pr_tpu_torch — the PyTorch and CUDA port of optiland_pr_tpu.

A second package beside the JAX one: plain PyTorch around hand-written CUDA
kernels for Hopper. It never imports JAX; the JAX package is the reference
its tests hold it against. See README.md ("The PyTorch port").
"""
from .config import default_float, set_default_float
from .core import Rays, new_rays
from .system import Optic

__version__ = "0.1.0"
__all__ = ["Optic", "Rays", "new_rays", "default_float", "set_default_float"]
