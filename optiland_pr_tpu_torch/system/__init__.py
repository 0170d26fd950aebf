from .optic import Optic
from .model import OpticModel, SurfaceDef, positions_from_params
from .apertures import (ApertureDef, OffsetRadialAperture, RadialAperture,
                        configure_aperture)
from .coatings import CoatingDef, FresnelCoating, SimpleCoating
from . import apodization
from .constraints import (ChiefRayHeightSolve, MarginalRayHeightSolve,
                          Pickup, QuickFocusSolve, apply_constraints)

__all__ = ["Optic", "OpticModel", "SurfaceDef", "positions_from_params",
           "ApertureDef", "RadialAperture", "OffsetRadialAperture",
           "configure_aperture", "CoatingDef", "SimpleCoating",
           "FresnelCoating", "apodization", "Pickup",
           "MarginalRayHeightSolve", "ChiefRayHeightSolve", "QuickFocusSolve",
           "apply_constraints"]
