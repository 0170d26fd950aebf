from .objectives import (CookeTriplet, DoubleGauss, TripletTelescopeObjective,
                         ReverseTelephoto, TessarLens, TIRSinglet)

__all__ = ["CookeTriplet", "DoubleGauss", "TripletTelescopeObjective",
           "ReverseTelephoto", "TessarLens", "TIRSinglet"]
