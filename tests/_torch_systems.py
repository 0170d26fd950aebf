"""Builders of the same lens in the JAX package and in the port, for the
``tests/test_torch_*.py`` comparisons."""
import math

import optiland_pr_tpu.samples.objectives as jobj
import optiland_pr_tpu_torch.samples.objectives as tobj
from optiland_pr_tpu.system.optic import Optic as JOptic


def jax_tir_singlet():
    """The JAX package's build of the port's ``TIRSinglet`` sample."""
    lens = JOptic(name="TIR singlet")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=6.0, thickness=5.0, material="N-SF11",
                     is_stop=True)
    lens.add_surface(index=2, radius=7.0, thickness=10.0)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=11.0)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0.0)
    lens.add_field(y=30.0)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def builders(name):
    """(JAX builder, port builder) of the sample ``name``."""
    if name == "TIRSinglet":
        return jax_tir_singlet, tobj.TIRSinglet
    return getattr(jobj, name), getattr(tobj, name)
