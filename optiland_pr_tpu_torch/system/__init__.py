from .optic import Optic
from .model import OpticModel, SurfaceDef, positions_from_params
from .apertures import ApertureDef, RadialAperture, configure_aperture

__all__ = ["Optic", "OpticModel", "SurfaceDef", "positions_from_params",
           "ApertureDef", "RadialAperture", "configure_aperture"]
