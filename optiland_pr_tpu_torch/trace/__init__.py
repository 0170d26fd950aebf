from . import real, paraxial, raygen
from .real import trace, trace_system
from .paraxial import Paraxial

__all__ = ["real", "paraxial", "raygen", "trace", "trace_system", "Paraxial"]
