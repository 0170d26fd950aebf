from .rays import Rays, new_rays, propagate, refract, reflect, clip
from . import transforms, distributions, safe_math

__all__ = ["Rays", "new_rays", "propagate", "refract", "reflect", "clip",
           "transforms", "distributions", "safe_math"]
