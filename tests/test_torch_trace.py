"""The port's paraxial optics and eager trace against the JAX package at
float64 on the CPU.

Tolerances: paraxial values rtol 1e-10; final ray positions atol 1e-9 mm and
directions atol 1e-12 (the same formulas in the same order; the slack covers
cumulative sums and transcendental functions that round differently in the
last bits). Lost-ray (NaN) masks must be equal.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.samples.objectives as jobj
import optiland_pr_tpu_torch.samples.objectives as tobj
from _torch_systems import builders as _builders
from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
from optiland_pr_tpu.trace.paraxial import system_arrays as j_system_arrays
from optiland_pr_tpu_torch.system.optic import Optic as TOptic
from optiland_pr_tpu_torch.trace.engine import final_rays as t_final_rays
from optiland_pr_tpu_torch.trace.paraxial import Paraxial
from optiland_pr_tpu_torch.trace.paraxial import system_arrays as t_system_arrays
from optiland_pr_tpu_torch.utils.convert import params_from_numpy

F64 = torch.float64
SYSTEMS = ("CookeTriplet", "DoubleGauss")


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)



@pytest.mark.parametrize("name", SYSTEMS)
def test_paraxial_values_match_jax(name):
    jb, tb = _builders(name)
    jpar = jb().paraxial
    tpar = Paraxial(*tb().build(device="cpu"))
    for q in ("EPD", "EPL", "f2", "FNO"):
        np.testing.assert_allclose(float(getattr(tpar, q)()),
                                   float(getattr(jpar, q)()), rtol=1e-10,
                                   err_msg=q)


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_arrays_match_jax(name):
    """Radii, index after each surface and vertex positions."""
    jb, tb = _builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    for wl in (0.48, 0.6):
        for a, b in zip(t_system_arrays(tm, tp, wl),
                        j_system_arrays(jm, jp, wl)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def _compare(rt, rj, pos_atol=1e-9):
    xj = np.asarray(rj.x)
    mask_j = np.isfinite(xj)
    mask_t = np.isfinite(rt.x.numpy())
    assert np.array_equal(mask_t, mask_j)
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=pos_atol, err_msg=f)
    for f in ("L", "M", "N"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    np.testing.assert_allclose(rt.opd.numpy(), np.asarray(rj.opd), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(rt.intensity.numpy(),
                               np.asarray(rj.intensity), rtol=1e-12)
    return mask_t


@pytest.mark.parametrize("name", SYSTEMS + ("TIRSinglet",))
@pytest.mark.parametrize("hy", [0.0, 1.0])
@pytest.mark.parametrize("poly", [False, True])
def test_eager_trace_matches_jax(name, hy, poly):
    jb, tb = _builders(name)
    jlens, tlens = jb(), tb()
    jm, jp = jlens.build()
    tm, tp = tlens.build(device="cpu", dtype=F64)
    px, py = _pupil(96, seed=1)
    wl = [float(w) for w in jlens.wavelengths] if poly else \
        jlens.primary_wavelength
    # the JAX package's polychromatic result is its per-wavelength results
    # stacked wavelength-major (trace/engine.py::final_rays vmaps them);
    # stacking the calls here reuses the single-wavelength case's compiled
    # operations instead of compiling their batched forms
    per_wl = [j_final_rays(jm, jp, 0.0, hy, jnp.asarray(w), jnp.asarray(px),
                           jnp.asarray(py), engine="xla")
              for w in np.atleast_1d(wl)]
    rj = jax.tree_util.tree_map(lambda *a: jnp.concatenate(
        [jnp.atleast_1d(v) for v in a]), *per_wl)
    rt = t_final_rays(tm, tp, 0.0, hy, torch.tensor(wl, dtype=F64),
                      torch.tensor(px), torch.tensor(py), engine="eager")
    assert rt.x.shape == tuple(rj.x.shape)
    mask = _compare(rt, rj)
    if name == "TIRSinglet" and hy == 1.0:
        assert 0.05 < 1 - mask.mean() < 0.6, "premise: rays lost to TIR"


def test_field_vector_trace_matches_jax():
    """One call for all three fields (field-major output)."""
    jm, jp = jobj.CookeTriplet().build()
    tm, tp = tobj.CookeTriplet().build(device="cpu")
    px, py = _pupil(64, seed=2)
    hy = [0.0, 0.7, 1.0]
    rj = j_final_rays(jm, jp, jnp.zeros(3), jnp.asarray(hy), 0.55,
                      jnp.asarray(px), jnp.asarray(py), engine="xla")
    rt = t_final_rays(tm, tp, torch.zeros(3, dtype=F64),
                      torch.tensor(hy, dtype=F64), 0.55, torch.tensor(px),
                      torch.tensor(py), engine="eager")
    _compare(rt, rj)


def test_image_surface_state_without_final_propagation():
    jm, jp = jobj.DoubleGauss().build()
    tm, tp = tobj.DoubleGauss().build(device="cpu")
    px, py = _pupil(32, seed=3)
    rj = j_final_rays(jm, jp, 0.0, 0.5, 0.5876, jnp.asarray(px),
                      jnp.asarray(py), final_prop=False, engine="xla")
    rt = t_final_rays(tm, tp, 0.0, 0.5, 0.5876, torch.tensor(px),
                      torch.tensor(py), final_prop=False, engine="eager")
    _compare(rt, rj)


def test_converted_params_trace_equal_to_built_params():
    """JAX params through params_from_numpy trace exactly like the port's
    own build()."""
    import jax
    _, jp = jobj.CookeTriplet().build()
    tm, tp = tobj.CookeTriplet().build(device="cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    px, py = _pupil(64, seed=4)
    args = (tm, 0.0, 1.0, 0.55, torch.tensor(px), torch.tensor(py))
    a = t_final_rays(args[0], tp, *args[1:], engine="eager")
    b = t_final_rays(args[0], conv, *args[1:], engine="eager")
    for f in ("x", "y", "z", "L", "M", "N", "opd", "intensity"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_eager_trace_is_differentiable():
    """The eager path is the autograd reference: finite gradients with
    respect to radii and thicknesses, even with lost rays."""
    tm, tp = tobj.TIRSinglet().build(device="cpu")
    r1 = tp["surfaces"][1]["geom"]["radius"].requires_grad_(True)
    t2 = tp["surfaces"][2]["thickness"].requires_grad_(True)
    px, py = _pupil(64, seed=5)
    rays = t_final_rays(tm, tp, 0.0, 1.0, 0.55, torch.tensor(px),
                        torch.tensor(py), engine="eager")
    ok = torch.isfinite(rays.x)
    assert 0 < ok.sum() < ok.numel()
    merit = (torch.where(ok, rays.x, 0.0) ** 2).sum() \
        + (torch.where(ok, rays.y, 0.0) ** 2).sum()
    merit.backward()
    assert torch.isfinite(r1.grad) and torch.isfinite(t2.grad)
    assert r1.grad != 0


def test_unported_surface_types_raise():
    lens = TOptic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, surface_type="grid_sag", radius=10.0,
                     thickness=2.0, material="N-BK7",
                     sag_grid=[[0.0, 0.0], [0.0, 0.0]])
    lens.add_surface(index=2)
    with pytest.raises(NotImplementedError):
        lens.build(device="cpu")
