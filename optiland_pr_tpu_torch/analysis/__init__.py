from .mtf import FFTMTF
from .psf import (FFTPSF, HuygensPSF, calculate_grid_size,
                  fft_psf_from_pupil, get_working_FNO)
from .psf_mtf_extra import HuygensMTF
from .spot import SpotData, encircled_energy, spot_diagram, spot_from_rays
from .wavefront import (OPD, OPDFan, Wavefront, WavefrontData, ZernikeOPD,
                        fit_and_remove_tilt, wavefront_data, wavefront_grid)

__all__ = ["FFTMTF", "FFTPSF", "HuygensMTF", "HuygensPSF", "OPD", "OPDFan",
           "SpotData", "Wavefront", "WavefrontData", "ZernikeOPD",
           "calculate_grid_size",
           "encircled_energy", "fft_psf_from_pupil", "fit_and_remove_tilt",
           "get_working_FNO", "spot_diagram", "spot_from_rays",
           "wavefront_data", "wavefront_grid"]
