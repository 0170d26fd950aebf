from .catalog import (AsphericSinglet, CoatedSinglet, HubbleTelescope,
                      OddAsphereSinglet, TiltedSinglet)
from .objectives import (CookeTriplet, DoubleGauss, TripletTelescopeObjective,
                         ReverseTelephoto, TessarLens, TIRSinglet)

__all__ = ["CookeTriplet", "DoubleGauss", "TripletTelescopeObjective",
           "ReverseTelephoto", "TessarLens", "TIRSinglet", "HubbleTelescope",
           "AsphericSinglet", "TiltedSinglet", "CoatedSinglet",
           "OddAsphereSinglet"]
