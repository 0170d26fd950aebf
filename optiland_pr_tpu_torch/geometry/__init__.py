from .aspheres import (Biconic, ChebyshevSag, EvenAsphere, OddAsphere,
                       PolynomialXY, Toroidal)
from .base import Geometry, conic_distance, newton_distance, normalize_normal
from .extras import (FresnelDesignedSag, FresnelZoneSag, PlaneGrating,
                     StandardGrating, ZernikeSag)
from .forbes import ForbesQ2d, ForbesQbfs
from .standard import Plane, StandardGeometry

__all__ = ["Geometry", "conic_distance", "newton_distance", "normalize_normal",
           "Plane", "StandardGeometry", "EvenAsphere", "OddAsphere",
           "PolynomialXY", "ChebyshevSag", "Biconic", "Toroidal", "ZernikeSag",
           "FresnelZoneSag", "FresnelDesignedSag", "ForbesQbfs", "ForbesQ2d",
           "StandardGrating", "PlaneGrating"]
