from .optic import Optic
from .model import OpticModel, SurfaceDef, positions_from_params
from .apertures import (ApertureDef, OffsetRadialAperture, RadialAperture,
                        configure_aperture)
from .coatings import CoatingDef, FresnelCoating, SimpleCoating

__all__ = ["Optic", "OpticModel", "SurfaceDef", "positions_from_params",
           "ApertureDef", "RadialAperture", "OffsetRadialAperture",
           "configure_aperture", "CoatingDef", "SimpleCoating",
           "FresnelCoating"]
