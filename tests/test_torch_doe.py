"""The port's diffractive surfaces (K1/K2/K3 sub-slice (f)) against the JAX
package, on the CPU: the phase profiles and the grating vector, the eager
trace's grating and phase interactions, K1's plain version against the JAX
XLA trace and the Pallas K1 in interpret mode, K2's plain version against
the Pallas K2 in interpret mode, K3's against ``pallas_trace_conic``, the
eligibility rules, the weights carried across, and the ``grating_period``
variable.

Systems (``chip_smoke.doe_systems``, built in either package): the JAX DOE
suite's six (tests/test_pallas_doe.py:75-86: a transmissive, a reflective
and a plane grating; radial, linear-grating and constant phase surfaces),
a grid-phase lens, and the JAX bench's DOE spectrometer at three
wavelengths (bench.py:135-156).

Tolerances:
- the phase profiles, the grating vector and the eager trace against the
  JAX package's, float64: rtol 1e-10 (atol 1e-12 where a value crosses 0);
- K1's plain version (float32) against the JAX XLA trace and the Pallas K1
  in interpret mode on float32 parameters: rtol and atol 2e-5, the JAX
  suite's (tests/test_pallas_doe.py:106-107);
- K2's plain version against the Pallas K2 in interpret mode on the masked
  RMS merit of the radial phase surface before the grating (the file's one
  interpreted compile, whose K1 forward also holds K1's plain version):
  the value rtol 5e-4, every leaf rtol 5e-3
  with atol 5e-3 x the leaf's scale + 1e-7 (tests/test_pallas_doe.py:
  147-150); the eager trace's autograd against ``jax.grad`` of the JAX
  eager trace at float64, rtol 1e-8;
- K3's plain version against the interpreted ``pallas_trace_conic``: the
  positions rtol 1e-4 with atol 2e-4 mm, the directions atol 1e-5, the OPD
  atol 2e-3 (tests/test_torch_huygens.py's K3 bounds).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.geometry.extras as jextras
import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.system.phase as jphase
import optiland_pr_tpu_torch.geometry.extras as textras
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.system.phase as tphase
from _torch_systems import jax_flags_as_port
from chip_smoke import (DOE_K0, FRAUNHOFER, doe_spectrometer, doe_systems,
                        grating_lens, lossy_doe, metasurface_lens,
                        polarized_grating)
from optiland_pr_tpu.core.rays import new_rays as j_new_rays
from optiland_pr_tpu.optimize.variables import \
    make_variable as j_make_variable
from optiland_pr_tpu.system.optic import Optic as JOptic
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu.trace.engine import engine_override as j_engine
from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
from optiland_pr_tpu.trace.paraxial import Paraxial as JParaxial
from optiland_pr_tpu.trace.raygen import generate_rays as j_generate_rays
from optiland_pr_tpu_torch.core.rays import new_rays
from optiland_pr_tpu_torch.kernels.trace_conic import RAY_FIELDS, trace_conic
from optiland_pr_tpu_torch.optimize.variables import make_variable
from optiland_pr_tpu_torch.system.optic import Optic as TOptic
from optiland_pr_tpu_torch.trace.engine import (engine_override, final_rays,
                                                resolve_engine)
from optiland_pr_tpu_torch.trace.paraxial import Paraxial
from optiland_pr_tpu_torch.utils.convert import params_from_numpy

F32, F64 = torch.float32, torch.float64
NAMES = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
SUITE = ("grating_transmissive", "grating_reflective", "grating_plane",
         "phase_radial", "phase_linear", "phase_constant")


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _f32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  params)


def _grid_lens(optic):
    """The suite's phase lens with an 8 x 8 grid profile (a smooth
    tabulated focusing phase over the 4 mm pupil)."""
    prof = {JOptic: jphase, TOptic: tphase}[optic].GridPhaseProfile(8, 8)
    xs = np.linspace(-2.5, 2.5, 8)
    grid = -DOE_K0 / (2 * 60.0) * (xs[None, :] ** 2 + xs[:, None] ** 2)
    lens = optic(name="grid phase surface")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, surface_type="phase", thickness=50.0,
                     is_stop=True, phase_profile=prof,
                     phase_kw=dict(x_coords=xs, y_coords=xs, phase_grid=grid))
    lens.add_surface(index=2)
    lens.set_aperture(aperture_type="EPD", value=4)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


def _builders(name):
    """(JAX lens, port lens) of a system of this file."""
    if name == "phase_grid":
        return _grid_lens(JOptic), _grid_lens(TOptic)
    if name == "spectrometer_3wl":
        return (doe_spectrometer(JOptic, FRAUNHOFER),
                doe_spectrometer(TOptic, FRAUNHOFER))
    return doe_systems(JOptic, jphase)[name], doe_systems(TOptic)[name]


# ---------------------------------------------------------------------------
# the phase profiles and the grating vector, float64
# ---------------------------------------------------------------------------

PROFILES = {
    "constant": (lambda m: m.ConstantPhaseProfile(), {"phase": 1.7}),
    "radial": (lambda m: m.RadialPhaseProfile(3),
               {"coefficients": [-30.0, 2e-2, -1e-4]}),
    "linear_grating": (lambda m: m.LinearGratingPhaseProfile(),
                       {"period": 3.0, "angle": 0.4, "order": -2}),
    "grid": (lambda m: m.GridPhaseProfile(5, 6),
             {"x_coords": np.linspace(-3, 3, 5),
              "y_coords": np.linspace(-2, 2.5, 6),
              "phase_grid": np.arange(30.0).reshape(6, 5) ** 1.5}),
}


@pytest.mark.parametrize("kind", sorted(PROFILES))
def test_phase_profile_matches_jax(kind):
    """Phase and gradient of each profile at seeded points (the pupil
    centre among them, where the radial gradient takes its safe root)."""
    make, kw = PROFILES[kind]
    jp_, tp_ = make(jphase), make(tphase)
    assert jp_.kind == tp_.kind == kind
    jpar = jp_.default_params(**kw)
    tpar = params_from_numpy(tp_.default_params(**kw), "cpu")
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-2.5, 2.5, (2, 64))
    x[0] = y[0] = 0.0
    for f in ("phase", "gradient"):
        jv = getattr(jp_, f)(jpar, jnp.asarray(x), jnp.asarray(y))
        tv = getattr(tp_, f)(tpar, torch.tensor(x), torch.tensor(y))
        for a, b in zip(np.atleast_2d(jv), [tv] if f == "phase" else tv):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                       atol=1e-12, err_msg=f"{kind} {f}")


@pytest.mark.parametrize("plane", [False, True])
def test_grating_vector_matches_jax(plane):
    """The unit grating vector of a conic (R -80 mm, conic -0.5) and of a
    plane grating, grooves at 0.7 rad."""
    kw = dict(grating_order=1, grating_period=1.5,
              groove_orientation_angle=0.7)
    if plane:
        jg, tg = jextras.PlaneGrating(), textras.PlaneGrating()
    else:
        jg, tg = jextras.StandardGrating(), textras.StandardGrating()
        kw.update(radius=-80.0, conic=-0.5)
    jpar = jg.default_params(**kw)
    tpar = params_from_numpy(tg.default_params(**kw), "cpu")
    assert sorted(jpar) == sorted(tpar)
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-10, 10, (2, 32))
    jv = jg.grating_vector(jpar, jnp.asarray(x), jnp.asarray(y))
    tv = tg.grating_vector(tpar, torch.tensor(x), torch.tensor(y))
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(sum(v.numpy() ** 2 for v in tv), 1.0,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the eager trace, float64
# ---------------------------------------------------------------------------

EAGER = SUITE + ("phase_grid", "spectrometer_3wl")


@pytest.fixture(scope="module")
def eager_references():
    """The JAX eager trace (float64) of each system of ``EAGER`` at Hy 0.7,
    every wavelength of the system, on 48 seeded pupil samples."""
    px, py = (v.astype(np.float64) for v in _pupil(48, seed=7))
    out = {}
    for name in EAGER:
        jl, _ = _builders(name)
        jm, jp = jl.build()
        out[name] = [j_real.trace(jm, jp, 0.0, 0.7, float(w), jnp.asarray(px),
                                  jnp.asarray(py))
                     for w in np.asarray(jp["wavelengths"])]
    return px, py, out


@pytest.mark.parametrize("name", EAGER)
def test_eager_trace_matches_jax(name, eager_references):
    """Every grating and phase interaction of the eager trace (a reflective
    grating's post-material index, the Plane class's normal, the
    evanescent clip, the OPD shift, the grid profile's cell lookup), and the
    spectrometer's dispersion at its three wavelengths, on each system of
    ``EAGER``."""
    px, py, ref = eager_references
    _, tl = _builders(name)
    tm, tp = tl.build(device="cpu")
    assert tm.surfaces[-2 if name == "spectrometer_3wl" else 1].interaction \
        == ("grating" if "grating_" in name or name.startswith("spec")
            else "phase")
    for w, rj in zip(tp["wavelengths"], ref[name]):
        rt = final_rays(tm, tp, 0.0, 0.7, float(w), torch.tensor(px),
                        torch.tensor(py), engine="eager")
        for f in NAMES:
            np.testing.assert_allclose(getattr(rt, f).numpy(),
                                       np.asarray(getattr(rj, f)),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=f"{name} {f} at {float(w)}")


def test_paraxial_of_doe_systems_matches_jax():
    """EPD, EPL and f2 of the spectrometer and the metasurface lens (the
    phase surface's Plane and the grating's conic substrate)."""
    for jl, tl in ((doe_spectrometer(JOptic), doe_spectrometer(TOptic)),
                   (metasurface_lens(JOptic, jphase), metasurface_lens(TOptic))):
        jpar = JParaxial(*jl.build())
        tpar = Paraxial(*tl.build(device="cpu"))
        for f in ("EPD", "EPL", "f2"):
            np.testing.assert_allclose(float(getattr(tpar, f)()),
                                       float(getattr(jpar, f)()),
                                       rtol=1e-12, err_msg=f)


# ---------------------------------------------------------------------------
# K1's plain version against the JAX package, float32
# ---------------------------------------------------------------------------

def _port_k1(name, fields, px, py, mode="plain"):
    _, tl = _builders(name)
    tm, tp = tl.build(device="cpu", dtype=F32)
    hy = torch.tensor(fields, dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, tp["wavelengths"],
                                        torch.zeros_like(hy), hy)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px, dtype=F32),
                              torch.tensor(py, dtype=F32),
                              tgt.model_flags(tm, tp), True, mode)
    return out, (tm, tp, gen, consts, acoef)


def _hold32(out, rj, what, w=0):
    """The port's [8, W, 1, n] outputs (wavelength ``w``) against a JAX ray
    bundle at the JAX suite's 2e-5."""
    for i, f in enumerate(NAMES):
        a = np.asarray(getattr(rj, f)).reshape(-1)
        b = out[i, w, 0].double().numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), f"{what} {f}"
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{what} {f}")


@pytest.mark.parametrize("name", SUITE)
def test_plain_k1_matches_jax_xla(name, eager_references):
    """Each in-kernel DOE type (the six systems of ``SUITE``): the port's
    tables and flags are the JAX entry point's, and K1's plain version
    (float32 parameters) matches the JAX XLA trace (the float64
    references) within the suite's 2e-5."""
    px, py, ref = eager_references
    out, (tm, tp, gen, consts, acoef) = _port_k1(name, [0.7], px, py)
    jm, jp = _builders(name)[0].build()
    jflags = jpt.model_flags(jm, _f32(jp))
    assert tgt.model_flags(tm, tp) == jax_flags_as_port(jflags)
    # the efficiency is the port's runtime column (the JAX kernel's is
    # static, its column 29 padding)
    keep = [j for j in range(tgt.CONST_W) if j != tgt.EFF_COL]
    np.testing.assert_allclose(
        consts[0][:, keep].numpy(), np.asarray(jpt.pack_surface_constants(
            jm, _f32(jp), 0.55))[:, keep], rtol=1e-6, atol=1e-9)
    assert float(consts[0, 0, tgt.EFF_COL]) == (
        1.0 if name.startswith("phase") else 0.0)
    _hold32(out, ref[name][0], name)


def test_plain_k1_per_wavelength_strength(eager_references):
    """One K1 call at the spectrometer's three wavelengths gives each its
    own grating strength m lambda / period (tests/test_pallas_doe.py:
    153-170): each within 2e-5 of the JAX trace at that wavelength, the
    blue and red images apart."""
    px, py, ref = eager_references
    out, _ = _port_k1("spectrometer_3wl", [0.7], px, py)
    for w, rj in enumerate(ref["spectrometer_3wl"]):
        _hold32(out, rj, f"wavelength {w}", w=w)
    y = out[1, :, 0].numpy()
    assert abs(np.nanmean(y[0]) - np.nanmean(y[2])) > 0.1


def test_plain_k1_kahan_matches_jax_xla(eager_references):
    """The compensated sum on the radial phase lens: the OPD shift enters
    it as the path lengths do; every output within the JAX suite's 2e-5 of
    the JAX trace, and the directions equal to the plain mode's."""
    px, py, ref = eager_references
    out, _ = _port_k1("phase_radial", [0.7], px, py, mode="kahan")
    plain, _ = _port_k1("phase_radial", [0.7], px, py)
    _hold32(out, ref["phase_radial"][0], "kahan")
    assert torch.equal(out[:7], plain[:7])


def _phase_and_grating(optic):
    """The suite's radial phase lens (on a plane, the Plane class) with the
    suite's grating (on a conic of R -100 mm) 20 mm behind it: both
    diffractive branches in one system, fields 0 and 2 degrees."""
    prof = {JOptic: jphase, TOptic: tphase}[optic].RadialPhaseProfile(2)
    lens = optic(name="phase surface and grating")
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, surface_type="phase", thickness=20.0,
                     is_stop=True, phase_profile=prof,
                     phase_kw={"coefficients": [-DOE_K0 / (2 * 50.0), 1e-5]})
    lens.add_surface(index=2, surface_type="grating", radius=-100.0,
                     thickness=30.0, grating_order=1, grating_period=5.0,
                     groove_orientation_angle=0.3)
    lens.add_surface(index=3)
    lens.set_aperture(aperture_type="EPD", value=4)
    lens.set_field_type(field_type="angle")
    lens.add_field(y=0)
    lens.add_field(y=2)
    lens.add_wavelength(value=0.55, is_primary=True)
    return lens


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas K2 in interpret mode; the eager
# trace's autograd against jax.grad
# ---------------------------------------------------------------------------

def _masked_rms(x, y, xp):
    ok = xp.isfinite(x) & xp.isfinite(y)
    w = ok.astype(x.dtype) if xp is jnp else ok.to(x.dtype)
    ws = xp.maximum(xp.sum(w), xp.ones_like(xp.sum(w)))
    xs = xp.where(ok, x, 0.0)
    ys = xp.where(ok, y, 0.0)
    mx = xp.sum(xs * w) / ws
    my = xp.sum(ys * w) / ws
    return xp.sqrt(xp.sum(xp.where(ok, (xs - mx) ** 2 + (ys - my) ** 2,
                                   0.0)) / ws)


def _torch_grads(tp, merit):
    """The merit's value and its gradient as a tree shaped like ``tp``
    (zeros where no gradient reaches)."""
    leaves = [t for t in jax.tree_util.tree_leaves(tp)
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    v = merit(tp)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g
    return v, jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)


def _hold_grads(gt, gj, rtol, share, floor):
    n = 0
    for (kt, lt), (kj, lj) in zip(jax.tree_util.tree_leaves_with_path(gt),
                                  jax.tree_util.tree_leaves_with_path(gj)):
        assert jax.tree_util.keystr(kt) == jax.tree_util.keystr(kj)
        lj = np.asarray(lj)
        scale = max(np.max(np.abs(lj)), floor)
        np.testing.assert_allclose(
            lt, lj, rtol=rtol, atol=share * scale + 1e-7,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(kt)}")
        n += 1
    return n


@pytest.fixture(scope="module")
def interpreted_pallas():
    """The file's one interpreted Pallas compile: the masked RMS merit of
    the radial phase surface before the grating (``_phase_and_grating``,
    float32 parameters, Hy 0.7, 256 samples) through the Pallas K1 and K2
    in interpret mode: the pupil, the merit's value, its gradient over the
    whole tree, and K1's rays."""
    jm, jp = _phase_and_grating(JOptic).build()
    jp = _f32(jp)
    flags = jpt.model_flags(jm, jp)
    px, py = _pupil(256, seed=3)

    def merit_pallas(p):
        rays = jpt.pallas_gen_trace_conic(
            jm, p, jnp.asarray(px), jnp.asarray(py), p["wavelengths"][0],
            Hx=0.0, Hy=0.7, flags=flags, final_prop=True, interpret=True,
            differentiable=True)
        return _masked_rms(rays.x, rays.y, jnp), rays

    # jitted: the interpreted kernels compile once instead of running
    # their operations one by one (~3x faster here)
    (vj, rj), gj = jax.jit(jax.value_and_grad(merit_pallas,
                                              has_aux=True))(jp)
    return px, py, vj, gj, rj


def test_plain_k1_matches_interpreted_pallas(interpreted_pallas):
    """K1's plain version against the Pallas K1 itself in interpret mode
    (the K1 forward of ``interpreted_pallas``) on a radial phase surface
    and a grating in one system."""
    px, py, _, _, rj = interpreted_pallas
    tm, tp = _phase_and_grating(TOptic).build(device="cpu", dtype=F32)
    assert [s.interaction for s in tm.surfaces[1:3]] == ["phase", "grating"]
    hy = torch.tensor([0.7], dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, 0.55, torch.zeros(1), hy)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), tgt.model_flags(tm, tp), True)
    _hold32(out, rj, "Hy 0.7")


def test_plain_k2_matches_interpreted_pallas_k2(interpreted_pallas):
    """The masked RMS merit's value and its gradient over the whole tree
    through the Pallas K1/K2 in interpret mode (``interpreted_pallas``)
    against the port's K1 and K2 plain versions: the radial phase
    coefficients' gradients (dacoef), the wavelength's (column 7, k0) and
    the grating's period among the leaves."""
    px, py, vj, gj, _ = interpreted_pallas
    tm, tp = _phase_and_grating(TOptic).build(device="cpu", dtype=F32)
    tpx, tpy = torch.tensor(px), torch.tensor(py)

    def merit(p):
        with engine_override("kernel"):
            rays = final_rays(tm, p, 0.0, 0.7, p["wavelengths"][0], tpx, tpy)
        return _masked_rms(rays.x, rays.y, torch)

    v, gt = _torch_grads(tp, merit)
    np.testing.assert_allclose(v.item(), float(vj), rtol=5e-4)
    assert _hold_grads(gt, gj, 5e-3, 5e-3, 1e-4) > 8
    assert np.abs(gt["surfaces"][1]["phase"]["coefficients"]).min() > 0
    assert abs(gt["wavelengths"][0]) > 0
    assert abs(float(gt["surfaces"][2]["geom"]["grating_period"])) > 0


def test_eager_autograd_matches_jax_grad():
    """The transmissive grating's masked RMS merit through the eager trace
    (float64, 48 samples, Hy 0.7): ``torch.autograd`` against ``jax.grad``
    of the JAX eager trace, every leaf, the grating's period, order and
    groove angle among them."""
    jl, tl = _builders("grating_transmissive")
    jm, jp = jl.build()
    px, py = (v.astype(np.float64) for v in _pupil(48, seed=9))

    def merit_j(p):
        rays = j_real.trace(jm, p, 0.0, 0.7, 0.55, jnp.asarray(px),
                            jnp.asarray(py))
        return _masked_rms(rays.x, rays.y, jnp)

    vj, gj = jax.value_and_grad(merit_j)(jp)
    tm, tp = tl.build(device="cpu")

    def merit(p):
        rays = final_rays(tm, p, 0.0, 0.7, 0.55, torch.tensor(px),
                          torch.tensor(py), engine="eager")
        return _masked_rms(rays.x, rays.y, torch)

    v, gt = _torch_grads(tp, merit)
    np.testing.assert_allclose(v.item(), float(vj), rtol=1e-10)
    _hold_grads(gt, gj, 1e-8, 1e-10, 0.0)
    geom = gt["surfaces"][1]["geom"]
    assert all(abs(float(geom[k])) > 0 for k in ("grating_period",
                                                  "grating_order",
                                                  "groove_angle"))


# ---------------------------------------------------------------------------
# K3's plain version against the interpreted pallas_trace_conic
# ---------------------------------------------------------------------------

def test_plain_k3_matches_interpreted_pallas():
    """The transmissive grating's rays from the JAX package's float64
    generate_rays (Hy 1, 512 samples) through the interpreted Pallas K3 and
    through ``trace_conic`` on CPU tensors (K3's plain version)."""
    jl, tl = _builders("grating_transmissive")
    jm, jp = jl.build()
    px, py = (v.astype(np.float64) for v in _pupil(512, seed=5))
    rays = j_generate_rays(jm, jp, jnp.zeros(512), jnp.ones(512),
                           jnp.asarray(px), jnp.asarray(py), 0.55)
    arrs = [np.asarray(getattr(rays, k), np.float32) for k in NAMES]
    jr = j_new_rays(*arrs[:7], wavelength=0.55, opd=arrs[7],
                    dtype=jnp.float32)
    flags = jpt.model_flags(jm, _f32(jp))
    ref = jax.jit(lambda p, r: jpt.pallas_trace_conic(
        jm, p, r, 0.55, block_rows=8, flags=flags, interpret=True))(
            _f32(jp), jr)
    tm, tp = tl.build(device="cpu", dtype=F32)
    out = trace_conic(tm, tp, new_rays(*[torch.tensor(a) for a in arrs[:7]],
                                       wavelength=0.55,
                                       opd=torch.tensor(arrs[7]), dtype=F32,
                                       device="cpu"), 0.55)
    for k in RAY_FIELDS:
        rtol, atol = ((1e-4, 2e-4) if k in "xyz" else (0.0, 1e-5)
                      if k in "LMN" else (1e-6, 0.0) if k == "intensity"
                      else (0.0, 2e-3))
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# eligibility, lost and clipped rays, the polarized launch
# ---------------------------------------------------------------------------

def test_grid_phase_stays_eager():
    """A grid profile needs a cell lookup per ray: ``supports_model``
    refuses it (tests/test_pallas_doe.py:173), the dispatch sends it to the
    eager trace, and the kernel engine raises."""
    tm, tp = _grid_lens(TOptic).build(device="cpu")
    assert not tgt.supports_model(tm)
    assert resolve_engine(tm, 0.0, 0.7, "cuda") == "eager"
    px, py = (torch.tensor(v, dtype=F64) for v in _pupil(16))
    with pytest.raises(ValueError, match="not eligible"):
        final_rays(tm, tp, 0.0, 0.7, 0.55, px, py, engine="kernel")
    assert bool(torch.isfinite(final_rays(tm, tp, 0.0, 0.7, 0.55, px,
                                          py).x).all())


def test_split_opd_refuses_doe_surfaces():
    """The split-OPD mode never sees a grating or phase surface: the
    eligibility, the plain version and the table checks refuse them."""
    px, py = (torch.tensor(v) for v in _pupil(16))
    for lens in doe_systems(TOptic).values():
        tm, tp = lens.build(device="cpu", dtype=F32)
        assert tgt.supports_model(tm) and not tgt.supports_split_opd(tm)
        with pytest.raises(ValueError, match="opd_split"):
            tgt.gen_trace_conic(tm, tp, px, py, 0.55, opd_split=True)
        gen, consts, acoef = tgt.gen_tables(tm, tp, 0.55)
        with pytest.raises(ValueError, match="split"):
            tgt.gen_trace_plain(gen, consts, acoef, px, py,
                                tgt.model_flags(tm, tp), True, "split")


def test_flag_words_carry_the_interaction():
    """The flag word's bits 25-29 (interaction, profile, Plane class), and
    the descriptors no kernel takes: a coated or freeform DOE surface, an
    unknown profile, terms on a profile that is not radial."""
    conic = dict(is_plane=False, is_refl=False, absorbing=False,
                 gkind="conic", nu=0, has_cs=False, has_ap=False,
                 coat="none")
    words = tgt._flag_words([
        tgt.SurfaceFlags(**conic, inter=("grating",)),
        tgt.SurfaceFlags(**{**conic, "nu": 2},
                         inter=("phase", "radial", True)),
        tgt.SurfaceFlags(**conic, inter=("phase", "linear_grating",
                                         False))])
    assert words[0] >> tgt.INTER_SHIFT == 1
    assert words[1] >> tgt.INTER_SHIFT == 2 | (1 << 2) | (1 << 4)
    assert words[2] >> tgt.INTER_SHIFT == 2 | (2 << 2)
    for bad in (dict(conic, coat="simple", inter=("grating",)),
                dict(conic, gkind="even", nu=1, inter=("grating",)),
                dict(conic, inter=("phase", "grid", True)),
                dict(conic, nu=1, inter=("phase", "constant", True)),
                dict(conic, inter=("thin_lens",))):
        with pytest.raises(ValueError, match="no kernel"):
            tgt._flag_words([tgt.SurfaceFlags(**bad)])


@pytest.mark.parametrize("kind", ["grating", "phase"])
def test_lost_and_clipped_rays_match_jax(kind):
    """A grating ray with no propagating order is lost (NaN at exactly the
    JAX trace's rays); a phase order past n2 k0 is evanescent (its
    intensity 0 at exactly the JAX trace's rays, the ray kept)."""
    px, py = _pupil(48, seed=7)
    jm, jp = lossy_doe(kind, JOptic, jphase).build()
    rj = j_real.trace(jm, jp, 0.0, 1.0, 0.55, jnp.asarray(px, jnp.float64),
                      jnp.asarray(py, jnp.float64))
    tm, tp = lossy_doe(kind, TOptic).build(device="cpu", dtype=F32)
    hy = torch.tensor([1.0])
    gen, consts, acoef = tgt.gen_tables(tm, tp, 0.55, torch.zeros(1), hy)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), tgt.model_flags(tm, tp), True)
    if kind == "grating":
        lost = np.isnan(out[0, 0, 0].numpy())
        assert 0 < lost.sum() < lost.size
        np.testing.assert_array_equal(lost, np.isnan(np.asarray(rj.x)))
    else:
        dark = out[6, 0, 0].numpy() == 0
        assert 0 < dark.sum() < dark.size
        np.testing.assert_array_equal(dark, np.asarray(rj.intensity) == 0)


def test_polarized_grating_leaves_the_evectors():
    """A grating before a Fresnel-coated singlet, linear launch at 45
    degrees (``chip_smoke.polarized_grating``): the eager trace's grating
    step leaves the chain as it is (surface by surface), and K1's plain
    version the E-vectors: its intensity, which the coated faces after the
    grating make depend on the vectors' orientation, is the eager chain's
    (rtol 5e-4, atol 5e-5, the JAX suite's kernel bound)."""
    from optiland_pr_tpu_torch.system.model import positions_from_params
    from optiland_pr_tpu_torch.trace.raygen import generate_rays
    from optiland_pr_tpu_torch.trace.real import trace_surface
    px, py = (torch.tensor(v, dtype=F64) for v in _pupil(48, seed=8))
    tm, tp = polarized_grating().build(device="cpu")
    rays = generate_rays(tm, tp, torch.zeros(48), torch.full((48,), 0.7),
                         px, py, 0.55, polarized=True)
    rays, valid = trace_surface(tm, tp, 1, rays, positions_from_params(tp))
    assert tm.surfaces[1].interaction == "grating"
    assert torch.equal(rays.p, torch.eye(3, dtype=F64).expand(48, 3, 3))
    rt = final_rays(tm, tp, 0.0, 0.7, 0.55, px, py, engine="eager")
    tm32, tp32 = polarized_grating().build(device="cpu", dtype=F32)
    with engine_override("kernel"):
        rk = final_rays(tm32, tp32, 0.0, 0.7, 0.55, px.float(), py.float())
    np.testing.assert_allclose(rk.intensity.double().numpy(),
                               rt.intensity.numpy(), rtol=5e-4, atol=5e-5)
    assert float(rk.intensity.max()) < 0.95 * 2


# ---------------------------------------------------------------------------
# the weights carried across, and the grating_period variable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grating_reflective", "phase_linear",
                                  "spectrometer_3wl"])
def test_params_from_numpy_carry_the_doe_leaves(name, eager_references):
    """The JAX package's tree, as numpy arrays, becomes the port's tree
    leaf for leaf (the grating's geometry leaves, the ``phase`` subtree),
    and the port traces the JAX package's rays from it: the reflective
    grating, the linear-grating phase lens and the spectrometer."""
    px, py, ref = eager_references
    jl, tl = _builders(name)
    jm, jp = jl.build()
    tm, tp = tl.build(device="cpu")
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(tp)]
    assert paths == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_leaves_with_path(carried)]
    assert any("phase" in p or "grating_period" in p for p in paths)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(carried)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    w = float(carried["wavelengths"][0])
    rt = final_rays(tm, carried, 0.0, 0.7, w, torch.tensor(px),
                    torch.tensor(py), engine="eager")
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(ref[name][0].y),
                               rtol=1e-10, atol=1e-12)


def test_grating_period_variable_reads_and_writes_the_geometry():
    """``grating_period`` is the grating's ``geom`` leaf in the port; the
    JAX package's variable points at ("grating", "period"), which its tree
    does not have (ROADMAP.md section 3): its ``get`` raises KeyError."""
    jm, jp = grating_lens(JOptic).build()
    with pytest.raises(KeyError, match="grating"):
        j_make_variable(jm, "grating_period", surface_number=1).get(jp)
    tm, tp = grating_lens(TOptic).build(device="cpu")
    v = make_variable(tm, "grating_period", surface_number=1)
    assert v.path == ("surfaces", 1, "geom", "grating_period")
    assert float(v.get(tp)) == 5.0
    tp2 = v.set(tp, 4.0)
    assert float(tp2["surfaces"][1]["geom"]["grating_period"]) == 4.0
    assert float(tp["surfaces"][1]["geom"]["grating_period"]) == 5.0
    px, py = (torch.tensor(a, dtype=F64) for a in _pupil(16))
    y1 = final_rays(tm, tp, 0.0, 0.0, 0.55, px, py).y
    y2 = final_rays(tm, tp2, 0.0, 0.0, 0.55, px, py).y
    assert float((y2 - y1).abs().min()) > 0.1
