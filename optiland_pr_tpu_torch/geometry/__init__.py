from .aspheres import EvenAsphere, OddAsphere
from .base import Geometry, conic_distance, newton_distance, normalize_normal
from .standard import Plane, StandardGeometry

__all__ = ["Geometry", "conic_distance", "newton_distance", "normalize_normal",
           "Plane", "StandardGeometry", "EvenAsphere", "OddAsphere"]
