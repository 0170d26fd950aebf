"""The port's launch modes (K1/K2 sub-slice (d)) against the JAX package, on
the CPU: the seven apodization profiles, the paraxial marginal and chief
rays, pickups and solves (``image_solve``), the UV projection lens, the
telecentric and apodized ray generation, the engine's eligibility, and K1's
and K2's plain versions against the Pallas kernels in interpret mode.

Systems: the UV projection lens (``samples.UVProjectionLens``, 43
surfaces, object-space telecentric, ``image_solve``), the Cooke triplet and
a small telecentric singlet (``tests/_torch_systems.py``).

Tolerances:
- profiles, paraxial rays, solves and built parameters, float64 against
  float64: rtol 1e-12 with atol 1e-12 (the same expressions in another
  order; the solved thickness through ~40 paraxial surfaces);
- ray generation and the eager trace, float64: positions atol 1e-9 mm,
  directions 1e-12, intensity 1e-12 (as tests/test_torch_trace.py);
- K1's plain version (float32) against the Pallas K1 in interpret mode on
  the UV lens: rtol 1e-5 with atol 2e-3 mm on positions, 1e-5 on
  directions, 6e-3 mm on the ~700 mm OPD (tests/test_pallas_widened.py:
  632-660); on the apodized Cooke triplet the intensity rtol 2e-5 with atol
  1e-6 and positions rtol 2e-5 with atol 2e-5 (:662-688);
- K2's plain version against the Pallas K2 in interpret mode: rtol 5e-3
  with atol 5e-3 x max|g| (``_grad_parity`` of tests/test_pallas_grad.py,
  as tests/test_torch_freeform.py holds it); the pupil centre's NaN pupil
  cotangents (both packages differentiate sqrt(Px^2 + Py^2) there) equal.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.system.apodization as japo
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.system.apodization as tapo
from _torch_systems import builders, jax_flags_as_port, jax_tables
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.system.constraints import apply_constraints as j_apply
from optiland_pr_tpu.system.constraints import (ChiefRayHeightSolve as JChief,
                                                Pickup as JPickup,
                                                QuickFocusSolve as JQuick)
from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
from optiland_pr_tpu.trace.paraxial import Paraxial as JParaxial
from optiland_pr_tpu.trace.raygen import generate_rays as j_generate_rays
from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
from optiland_pr_tpu_torch.system.constraints import apply_constraints
from optiland_pr_tpu_torch.system.constraints import (ChiefRayHeightSolve,
                                                      Pickup, QuickFocusSolve)
from optiland_pr_tpu_torch.trace.engine import (engine_override, final_rays,
                                                kernel_eligible)
from optiland_pr_tpu_torch.trace.paraxial import Paraxial
from optiland_pr_tpu_torch.trace.raygen import generate_rays
from optiland_pr_tpu_torch.utils.convert import (params_from_numpy,
                                                 params_to_numpy)

F32, F64 = torch.float32, torch.float64
PROFILES = {"UniformApodization": {}, "GaussianApodization": dict(sigma=0.7),
            "CosineSquaredApodization": dict(R=0.9),
            "HannApodization": dict(D=1.8),
            "TukeyApodization": dict(R=1.0, alpha=0.5),
            "SuperGaussianApodization": dict(w=0.8, n=4.0),
            "PolynomialApodization": dict(R=1.0, p=2.0)}
NAMES = ("x", "y", "z", "L", "M", "N", "intensity", "opd")


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _hexapolar(rings):
    pts = [(0.0, 0.0)]
    for i in range(1, rings + 1):
        for j in range(6 * i):
            th = 2 * np.pi * j / (6 * i)
            pts.append((i / rings * np.cos(th), i / rings * np.sin(th)))
    return np.asarray(pts).T


def _profiles(name):
    return (getattr(japo, name)(**PROFILES[name]),
            getattr(tapo, name)(**PROFILES[name]))


def _jax_params(p):
    return jax.tree_util.tree_map(np.asarray, p)


# ---------------------------------------------------------------------------
# the profiles, paraxial rays, solves and the UV lens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PROFILES))
def test_apodization_profiles_match_jax(name):
    """Each profile at the pupil centre, inside, on and beyond its support,
    float64; the kernel constants a profile reports are its own numbers."""
    ja, ta = _profiles(name)
    px, py = _pupil(500, seed=2)
    px = np.concatenate([[0.0, 1.0, 0.9, 0.3], 1.2 * px])
    py = np.concatenate([[0.0, 0.0, 0.0, 0.4], 1.2 * py])
    want = np.asarray(ja(jnp.asarray(px), jnp.asarray(py)))
    got = ta(torch.tensor(px), torch.tensor(py)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    code, consts = ta.kernel_params()
    assert tapo.APOD_KINDS[code] == ta.kind and len(consts) <= 4
    assert tapo.kernel_apodization(ta)


def test_plain_k1_apodization_weight_is_the_profile():
    """The plain K1's weight (``apod_weight``, float32 from the gen table's
    float32 constants) against each profile in float64: within 1e-6."""
    px, py = (torch.tensor(v) for v in _pupil(2000, seed=3))
    for name in PROFILES:
        _, ta = _profiles(name)
        code, consts = ta.kernel_params()
        cols = [torch.tensor(float(np.float32(v))) for v in consts]
        w = tgt.apod_weight(code, lambda j: cols[j], 1.3 * px, 1.3 * py)
        ref = ta(1.3 * px.double(), 1.3 * py.double())
        got = torch.ones_like(ref) if w is None else w.double()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["CookeTriplet", "UVProjectionLens",
                                  "TelecentricSinglet"])
def test_marginal_and_chief_rays_match_jax(name):
    jb, tb = builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    for f in ("marginal_ray", "chief_ray"):
        yj, uj = getattr(JParaxial(jm, jp), f)()
        yt, ut = getattr(Paraxial(tm, tp), f)()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-12,
                                   atol=1e-12, err_msg=f)


def test_uv_lens_builds_as_the_jax_package():
    """The UV projection lens's parameters at float64, its image_solve
    thickness among them, its telecentric flag and eligibility; the
    parameters carried across by params_from_numpy trace alike."""
    jb, tb = builders("UVProjectionLens")
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    assert tm.num_surfaces == jm.num_surfaces == 44
    assert tm.obj_space_telecentric and jm.obj_space_telecentric
    assert tgt.gen_eligible(tm) and jpt.gen_eligible(jm)
    assert tgt.supports_model(tm) and tgt.supports_split_opd(tm)
    a = jax.tree_util.tree_leaves(_jax_params(jp))
    b = jax.tree_util.tree_leaves(params_to_numpy(tp))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-12)
    t_img = float(tp["surfaces"][-2]["thickness"])
    assert abs(t_img - 13.07647896) > 1e-3       # the solve moved it
    carried = params_from_numpy(_jax_params(jp), "cpu", F64)
    px, py = (torch.tensor(v) for v in _hexapolar(2))
    r1 = final_rays(tm, carried, 0.0, 1.0, 0.248, px, py, engine="eager")
    r2 = final_rays(tm, tp, 0.0, 1.0, 0.248, px, py, engine="eager")
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), atol=1e-9)


def test_solves_and_pickups_match_jax():
    """A pickup, a chief-ray height solve and a quick-focus solve on the
    Cooke triplet, composed, against the JAX package's; Optic's
    add_pickup/add_solve/image_solve apply them at build time."""
    jb, tb = builders("CookeTriplet")
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    jc = [JPickup(1, "radius", 6, scale=-1.0, offset=2.0), JChief(4, 0.5),
          JQuick(Hy=0.0, num_rays=4)]
    tc = [Pickup(1, "radius", 6, scale=-1.0, offset=2.0),
          ChiefRayHeightSolve(4, 0.5), QuickFocusSolve(Hy=0.0, num_rays=4)]
    want = _jax_params(j_apply(jm, jp, jc))
    got = params_to_numpy(apply_constraints(tm, tp, tc))
    for x, y in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-12)
    jl, tl = jb(), tb()
    for lens in (jl, tl):
        lens.add_pickup(1, "conic", 2, scale=0.5)
        lens.add_solve("chief_ray_height", surface_idx=4, height=0.5)
        lens.image_solve()
    j2 = _jax_params(jl.build()[1])
    t2 = params_to_numpy(tl.build(device="cpu")[1])
    for x, y in zip(jax.tree_util.tree_leaves(j2),
                    jax.tree_util.tree_leaves(t2)):
        np.testing.assert_allclose(y, x, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown solve"):
        tl.add_solve("no_such_solve")


def test_telecentric_flag_and_apodization_rebuild():
    """Setting the telecentric flag after a build drops the cached model;
    set_apodization reaches Optic.trace, on the kernel's plain version as
    on the eager trace."""
    _, tb = builders("TelecentricSinglet")
    lens = tb()
    m1, _ = lens.build(device="cpu")
    lens.obj_space_telecentric = False
    m2, _ = lens.build(device="cpu")
    assert m1.obj_space_telecentric and not m2.obj_space_telecentric
    _, ta = _profiles("TukeyApodization")
    lens.set_apodization(ta)
    eager = lens.trace(Hy=1.0, num_rays=4, device="cpu", engine="eager")
    with engine_override("kernel"):
        kern = lens.trace(Hy=1.0, num_rays=4, device="cpu", dtype=F32)
    assert float(eager.intensity.min()) < 1.0
    np.testing.assert_allclose(kern.intensity.numpy(),
                               eager.intensity.numpy(), rtol=2e-5, atol=1e-6)


def test_eligibility_of_the_launch_modes():
    """kernel_eligible takes the seven profiles and refuses any other
    callable; a telecentric launch needs a finite object (gen_eligible, as
    pallas_trace.py:136)."""
    tm, _ = builders("CookeTriplet")[1]().build(device="cpu")
    for name in PROFILES:
        assert kernel_eligible(tm, 0.0, 0.7, _profiles(name)[1])
    assert not kernel_eligible(tm, 0.0, 0.7, lambda px, py: px * 0 + 1)
    assert tgt.gen_eligible(tm)
    _, tb = builders("CookeTriplet")
    lens = tb()
    lens.obj_space_telecentric = True
    assert not tgt.gen_eligible(lens.build(device="cpu")[0])
    with pytest.raises(ValueError, match="closed-form"):
        tgt.gen_tables(*builders("CookeTriplet")[1]().build(device="cpu"),
                       0.55, apodization=lambda px, py: px)


# ---------------------------------------------------------------------------
# ray generation and the eager trace against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,hy,profile", [
    ("UVProjectionLens", 1.0, None),
    ("TelecentricSinglet", 1.0, "TukeyApodization"),
    ("CookeTriplet", 0.7, "GaussianApodization")])
def test_generate_rays_and_eager_trace_match_jax(name, hy, profile):
    """generate_rays (telecentric aim, apodized intensity) and the eager
    trace to the image, float64, against the JAX package's."""
    jb, tb = builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    ja, ta = _profiles(profile) if profile else (None, None)
    px, py = _hexapolar(3)
    wl = float(tp["wavelengths"][tm.primary_wavelength_idx])
    n = px.shape[0]
    rj = j_generate_rays(jm, jp, jnp.zeros(n), jnp.full(n, hy),
                         jnp.asarray(px), jnp.asarray(py), wl,
                         apodization=ja)
    rt = generate_rays(tm, tp, torch.zeros(n, dtype=F64),
                       torch.full((n,), hy, dtype=F64), torch.tensor(px),
                       torch.tensor(py), wl, apodization=ta)
    for f, atol in (("x", 1e-9), ("y", 1e-9), ("z", 1e-9), ("L", 1e-12),
                    ("M", 1e-12), ("N", 1e-12), ("intensity", 1e-12)):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=atol, err_msg=f"launch {f}")
    rj = j_final_rays(jm, jp, 0.0, hy, wl, jnp.asarray(px), jnp.asarray(py),
                      engine="xla", apodization=ja)
    rt = final_rays(tm, tp, 0.0, hy, wl, torch.tensor(px), torch.tensor(py),
                    engine="eager", apodization=ta)
    for f, atol in (("x", 1e-9), ("y", 1e-9), ("z", 1e-9), ("L", 1e-12),
                    ("M", 1e-12), ("N", 1e-12), ("intensity", 1e-12),
                    ("opd", 1e-9)):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=atol, err_msg=f"trace {f}")


# ---------------------------------------------------------------------------
# K1 and K2's plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _port_tables(name, fields, apod=None):
    model, params = builders(name)[1]().build(device="cpu", dtype=F32)
    hy = torch.tensor(fields, dtype=F32)
    wl = params["wavelengths"][model.primary_wavelength_idx:][:1]
    gen, consts, acoef = tgt.gen_tables(model, params, wl,
                                        torch.zeros_like(hy), hy, apod)
    return gen, consts, acoef, tgt.model_flags(model, params)


def _interpreted(name, fields, px, py, apod=None, cot=None):
    """The Pallas K1 in interpret mode (through diff_gen_trace, with the
    model's telecentric flag and the JAX profile ``apod``) on the JAX
    entry point's tables, and with ``cot`` its jax.vjp (the Pallas K2)."""
    jm, jp = builders(name)[0]().build()
    tables = jax_tables(jm, jp, [float(jp["wavelengths"][
        jm.primary_wavelength_idx])], fields, apodization=apod)
    n = px.shape[0]
    f = diff_gen_trace(tables["flags"], n // 128, True, True, False, None,
                       False, bool(jm.obj_space_telecentric), apod)
    args = (tables["gen"], tables["consts"], tables["acoef"],
            jnp.asarray(px).reshape(-1, 128), jnp.asarray(py).reshape(-1, 128))
    if cot is None:
        return tables, f(*args), None
    outs, vjp = jax.vjp(f, *args)
    grads = vjp(tuple(jnp.asarray(c.reshape(1, len(fields), -1, 128))
                      for c in cot))
    return tables, outs, grads


def _hold_against(out, outs, tol, what):
    for i, k in enumerate(NAMES):
        rtol, atol = tol[k]
        np.testing.assert_allclose(out[i].reshape(-1).numpy(),
                                   np.asarray(outs[i]).reshape(-1),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def uv_lens_interpreted():
    """The Pallas K1 on the UV lens, Hy 0 and 1, 256 samples: the file's
    one interpreted compile of the 42-surface stack."""
    px, py = _pupil(256, seed=6)
    tables, outs, _ = _interpreted("UVProjectionLens", [0.0, 1.0], px, py)
    return tables, px, py, outs


def test_plain_k1_matches_interpreted_pallas_on_the_uv_lens(
        uv_lens_interpreted):
    """The telecentric launch (gen columns 5, 8-10) through 42 surfaces:
    the port's tables are the JAX entry point's, and the plain K1 on them
    holds the Pallas K1's outputs at the JAX suite's tolerances."""
    tables, px, py, outs = uv_lens_interpreted
    gen, consts, acoef, flags = _port_tables("UVProjectionLens", [0.0, 1.0])
    assert flags == jax_flags_as_port(tables["flags"])
    np.testing.assert_allclose(gen.numpy()[:, :10],
                               np.asarray(tables["gen"])[:, :10], rtol=1e-6)
    assert gen[:, 10].tolist() == [1.0, 1.0]
    # column 27, the split mode's vertex gap, is a difference of float32
    # cumulative sums of the thicknesses, summed in another order here: one
    # ulp of the ~750 mm positions (6.1e-5 mm)
    jc = np.asarray(tables["consts"])
    cols = [j for j in range(jc.shape[-1]) if j != 27]
    np.testing.assert_allclose(consts.numpy()[..., cols], jc[..., cols],
                               rtol=1e-6)
    np.testing.assert_allclose(consts.numpy()[..., 27], jc[..., 27],
                               rtol=0, atol=1.25e-4)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    assert bool(torch.isfinite(out).all())
    tol = {k: (1e-5, 1e-5) for k in NAMES}
    tol.update(x=(1e-5, 2e-3), y=(1e-5, 2e-3), z=(1e-5, 2e-3),
               opd=(1e-5, 6e-3), intensity=(0.0, 0.0))
    _hold_against(out, outs, tol, "UV lens")


@pytest.mark.parametrize("name", ["GaussianApodization", "TukeyApodization"])
def test_plain_k1_matches_interpreted_pallas_apodized(name):
    """The apodized Cooke triplet at Hy 0.7, 256 samples: the intensity and
    positions of the plain K1 against the Pallas K1 with the same profile
    (tests/test_pallas_widened.py:662-688)."""
    ja, ta = _profiles(name)
    px, py = _pupil(256, seed=7)
    _, outs, _ = _interpreted("CookeTriplet", [0.7], px, py, apod=ja)
    gen, consts, acoef, flags = _port_tables("CookeTriplet", [0.7], ta)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    assert float(out[6].min()) < 0.9
    tol = {k: (2e-5, 2e-5) for k in NAMES}
    tol.update(L=(0.0, 1e-5), M=(0.0, 1e-5), N=(0.0, 1e-5),
               intensity=(2e-5, 1e-6), opd=(1e-5, 2e-3))
    _hold_against(out, outs, tol, name)


def test_plain_k2_matches_interpreted_pallas_k2():
    """Autograd through the plain K1 against the Pallas K2 (the file's one
    interpreted K2) on the telecentric singlet with the Tukey apodization,
    256 samples at object heights 0 and 5 mm, the pupil centre among them:
    dgen (the telecentric aim's columns 5, 8, 9), dconsts, dPx and dPy
    through the weight's taper; at the centre both packages' pupil
    cotangents are NaN (d sqrt(Px^2 + Py^2) / d(Px^2 + Py^2) at 0), the
    other rays' finite."""
    ja, ta = _profiles("TukeyApodization")
    px, py = _pupil(256, seed=8)
    px[0] = py[0] = 0.0
    cot = np.random.default_rng(13).normal(size=(8, 1, 2, 256)).astype(
        np.float32)
    tables, _, grads = _interpreted("TelecentricSinglet", [0.0, 1.0], px, py,
                                    apod=ja, cot=cot)
    jdgen, jdconsts, jdacoef, jdpx, jdpy = (np.asarray(g) for g in grads)
    gen, consts, acoef, flags = _port_tables("TelecentricSinglet",
                                             [0.0, 1.0], ta)
    got = gen_trace_bwd_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), torch.tensor(cot), flags,
                              True)
    assert np.isnan(jdpx.reshape(-1)[0]) and np.isnan(got[3][0].item())
    assert np.isfinite(got[3][1:].numpy()).all()
    assert np.abs(jdgen[:, [5, 8, 9]]).max() > 0
    for label, g, e in (("dgen", got[0][:, :10], jdgen[:, :10]),
                        ("dconsts", got[1], jdconsts),
                        ("dPx", got[3], jdpx.reshape(-1)),
                        ("dPy", got[4], jdpy.reshape(-1))):
        scale = np.nanmax(np.abs(e))
        np.testing.assert_allclose(g.numpy(), e, rtol=5e-3,
                                   atol=5e-3 * scale, err_msg=label)
    assert float(got[0][:, 10:].abs().max()) == 0.0
