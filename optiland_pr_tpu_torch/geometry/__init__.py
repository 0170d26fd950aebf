from .base import Geometry, conic_distance, normalize_normal
from .standard import Plane, StandardGeometry

__all__ = ["Geometry", "conic_distance", "normalize_normal", "Plane",
           "StandardGeometry"]
