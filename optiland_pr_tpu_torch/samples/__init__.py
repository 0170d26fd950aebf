from .catalog import (AsphericSinglet, CoatedSinglet, HubbleTelescope,
                      ObjectiveUS008879901, OddAsphereSinglet, TiltedSinglet)
from .objectives import (CookeTriplet, DoubleGauss, TripletTelescopeObjective,
                         ReverseTelephoto, TessarLens, TIRSinglet)

__all__ = ["CookeTriplet", "DoubleGauss", "TripletTelescopeObjective",
           "ReverseTelephoto", "TessarLens", "TIRSinglet", "HubbleTelescope",
           "AsphericSinglet", "ObjectiveUS008879901", "TiltedSinglet",
           "CoatedSinglet", "OddAsphereSinglet"]
