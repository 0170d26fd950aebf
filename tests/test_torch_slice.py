"""The port's first slice end to end: build -> spot diagram -> RMS radius,
against the JAX package at float64 on the CPU (rtol 1e-9: the same
computation in the same order, reduced over a few hundred rays), and the
rule that the port never imports JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import optiland_pr_tpu.samples.objectives as jobj
import optiland_pr_tpu_torch.samples.objectives as tobj
from optiland_pr_tpu.analysis.spot import encircled_energy as j_ee
from optiland_pr_tpu.analysis.spot import spot_diagram as j_spot
from optiland_pr_tpu.core.distributions import \
    generate_distribution as j_generate_distribution
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu.trace.engine import engine_override as j_engine
from optiland_pr_tpu_torch.analysis.spot import encircled_energy as t_ee
from optiland_pr_tpu_torch.analysis.spot import spot_diagram as t_spot
from optiland_pr_tpu_torch.trace.engine import engine_override as t_engine

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def spots():
    """(JAX, port) spot data for both lenses, all fields x wavelengths."""
    out = {}
    for name in ("CookeTriplet", "DoubleGauss"):
        jm, jp = getattr(jobj, name)().build()
        tm, tp = getattr(tobj, name)().build(device="cpu")
        with j_engine("xla"):
            sj = j_spot(jm, jp, num_rays=8)
        out[name] = (sj, t_spot(tm, tp, num_rays=8))
    return out


@pytest.mark.parametrize("name", ["CookeTriplet", "DoubleGauss"])
def test_spot_radii_match_jax(name, spots):
    sj, st = spots[name]
    assert st.x.shape == tuple(sj.x.shape)
    assert st.ref_wl_idx == sj.ref_wl_idx
    np.testing.assert_allclose(st.rms_spot_radius().numpy(),
                               np.asarray(sj.rms_spot_radius()), rtol=1e-9)
    np.testing.assert_allclose(st.geometric_spot_radius().numpy(),
                               np.asarray(sj.geometric_spot_radius()),
                               rtol=1e-9)
    for a, b in zip(st.centroid(), sj.centroid()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["CookeTriplet", "DoubleGauss"])
def test_encircled_energy_matches_jax(name, spots):
    sj, st = spots[name]
    radii = np.linspace(0.0, 0.05, 11)
    np.testing.assert_allclose(t_ee(st, torch.tensor(radii)).numpy(),
                               np.asarray(j_ee(sj, jnp.asarray(radii))),
                               rtol=1e-12)


def test_spot_through_kernel_plain_version_matches_eager(spots):
    """On CPU tensors the "kernel" engine runs K1's plain version at
    float32; it agrees with the float64 eager spot to float32 accuracy."""
    tm, tp = tobj.CookeTriplet().build(device="cpu")
    with t_engine("kernel"):
        sk = t_spot(tm, tp, num_rays=8)
    assert sk.x.dtype == torch.float32
    np.testing.assert_allclose(sk.rms_spot_radius().numpy(),
                               spots["CookeTriplet"][1].rms_spot_radius()
                               .numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["TripletTelescopeObjective",
                                  "ReverseTelephoto", "TessarLens"])
def test_other_conic_samples_match_jax(name):
    """``Optic.trace`` against the JAX package's XLA trace of the same
    hexapolar pupil (its ``Optic.trace`` without the jit, whose whole-trace
    compile costs more than the comparison)."""
    jlens = getattr(jobj, name)()
    tlens = getattr(tobj, name)()
    jm, jp = jlens.build()
    px, py = j_generate_distribution("hexapolar", 4)
    for hy in (0.0, 1.0):
        rj = j_real.trace(jm, jp, 0.0, hy, jlens.primary_wavelength, px, py)
        rt = tlens.trace(Hy=hy, num_rays=4, engine="eager",
                         device="cpu")
        for f in ("x", "y", "z"):
            np.testing.assert_allclose(getattr(rt, f).numpy(),
                                       np.asarray(getattr(rj, f)), rtol=0,
                                       atol=1e-9, err_msg=f"{name} {f}")
        np.testing.assert_allclose(rt.N.numpy(), np.asarray(rj.N), atol=1e-12)


def test_port_never_imports_jax():
    """Build, trace and spot the Cooke triplet, the Hubble telescope and the
    aspheric singlet (the asphere, coating and aperture modules), import K3
    and K4 and run a small Huygens PSF with the port in a fresh interpreter
    (this test process has JAX loaded by conftest.py)."""
    code = (
        "import sys\n"
        "from optiland_pr_tpu_torch.samples import CookeTriplet\n"
        "from optiland_pr_tpu_torch.analysis import spot_diagram\n"
        "from optiland_pr_tpu_torch.trace.engine import engine_override\n"
        "import optiland_pr_tpu_torch.kernels.gen_trace\n"
        "import optiland_pr_tpu_torch.kernels.gen_grad\n"
        "import optiland_pr_tpu_torch.optimize\n"
        "lens = CookeTriplet()\n"
        "model, params = lens.build(device='cpu')\n"
        "rays = lens.trace(Hy=1.0, num_rays=4, device='cpu')\n"
        "assert rays.x.shape[0] == 61\n"
        "with engine_override('kernel'):\n"
        "    s = spot_diagram(model, params, num_rays=3)\n"
        "assert s.rms_spot_radius().shape == (3, 3)\n"
        "import optiland_pr_tpu_torch.geometry.aspheres\n"
        "import optiland_pr_tpu_torch.system.coatings\n"
        "from optiland_pr_tpu_torch.samples import (AsphericSinglet,\n"
        "                                           HubbleTelescope)\n"
        "with engine_override('kernel'):\n"
        "    for lens in (HubbleTelescope(), AsphericSinglet()):\n"
        "        s = spot_diagram(*lens.build(device='cpu'), num_rays=3)\n"
        "        assert s.rms_spot_radius().isfinite().all()\n"
        "import optiland_pr_tpu_torch.kernels.huygens\n"
        "import optiland_pr_tpu_torch.kernels.trace_conic\n"
        "import optiland_pr_tpu_torch.analysis.psf_mtf_extra\n"
        "from optiland_pr_tpu_torch.analysis import HuygensMTF, HuygensPSF\n"
        "h = HuygensPSF(CookeTriplet(), (0.0, 1.0), num_rays=8,\n"
        "               image_size=4, device='cpu')\n"
        "assert h.psf.isfinite().all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('optiland_pr_tpu.') "
        "or m == 'optiland_pr_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
