from .convert import params_from_numpy, params_to_numpy
from .hostvals import host_isinf

__all__ = ["params_from_numpy", "params_to_numpy", "host_isinf"]
