"""The port's K1/K2 sub-slices (b) and the even/odd aspheres of (c) against
the JAX package, on the CPU: tilt/decenter, radial and offset-radial
apertures, simple coatings and Newton-intersected aspheres, on the Hubble
telescope, the aspheric singlet and the JAX kernel suite's test systems
(``tests/test_pallas_widened.py``), whose JAX builders these tests call.

Tolerances (each the JAX suite's for the same comparison):
- flags and eligibility: equal; packed tables rtol 1e-6 (both float32 from
  the same float64 parameters), asphere terms equal;
- the plain K1 (float32) against the Pallas K1 in interpret mode: positions
  rtol 1e-4 / atol 2e-4 mm, directions atol 1e-5, OPD rtol 1e-5 / atol 2e-3,
  intensity rtol 1e-6, lost-ray masks equal (tests/test_pallas_widened.py:
  144-185, 238-263); Hubble against the float64 XLA trace at rtol 1e-3 /
  atol 2e-2 mm, OPD rtol 1e-5 / atol 0.2, obscuration masks differing on at
  most 2 of 1024 rays (:108-141);
- the plain K2 against the Pallas K2 in interpret mode, and the masked-RMS
  gradient through the port's kernel route against the JAX XLA trace's, both
  float32: rtol 3e-3 with atol 3e-3 x max|g| (5e-3 for the benchtop Hubble;
  tests/test_pallas_grad.py:45-112);
- float64 eager traces and the Newton intersection: positions atol 1e-9 mm,
  directions 1e-12 (as tests/test_torch_trace.py), Newton roots rtol 1e-12;
- parameters carried by ``params_from_numpy``: equal, and equal traces.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.optimize as jopt
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.optimize as topt
from _torch_systems import builders, jax_flags_as_port, jax_tables
from optiland_pr_tpu.geometry.base import newton_distance as j_newton
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
from optiland_pr_tpu_torch.geometry.base import newton_distance as t_newton
from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
from optiland_pr_tpu_torch.trace.engine import (engine_override, final_rays,
                                                resolve_engine)
from optiland_pr_tpu_torch.trace.paraxial import Paraxial
from optiland_pr_tpu_torch.utils.convert import (params_from_numpy,
                                                 params_to_numpy)

F32, F64 = torch.float32, torch.float64
SYSTEMS = ("HubbleTelescope", "TiltedSinglet", "CoatedSinglet",
           "OddAsphereSinglet", "AsphericSinglet", "Combined")


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _f32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  params)


def _primary(jparams, jmodel):
    """The JAX build's primary wavelength, as a one-element list."""
    return [float(jparams["wavelengths"][jmodel.primary_wavelength_idx])]


def _port_tables(tlens, fields, dtype=F32):
    model, params = tlens.build(device="cpu", dtype=dtype)
    hy = torch.tensor(fields, dtype=dtype)
    wl = params["wavelengths"][model.primary_wavelength_idx:][:1]
    gen, consts, acoef = tgt.gen_tables(model, params, wl,
                                        torch.zeros_like(hy), hy)
    return model, params, gen, consts, acoef, tgt.model_flags(model, params)


# ---------------------------------------------------------------------------
# eligibility, flags, tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SYSTEMS)
def test_supports_model_and_flags_match_jax(name):
    jb, tb = builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    assert tgt.supports_model(tm) and jpt.supports_model(jm)
    assert tgt.model_flags(tm, tp) == jax_flags_as_port(
        jpt.model_flags(jm, jp))
    assert resolve_engine(tm, 0.0, 0.0, "cuda") == "kernel"


def test_fresnel_coating_is_refused():
    """Refused until the polarization chain (sub-slice (e)) was ported: a
    Fresnel coating now acts on a polarized launch's chain only. Without
    one, the kernel takes the system (the coating a flag bit that no
    unpolarized variant reads), and the coating leaves the intensity as it
    is in the eager trace and in K1's plain version, as in the JAX
    package's unpolarized trace."""
    _, tb = builders("CoatedSinglet")
    lens = tb()
    lens._surfaces[1]["coating"] = "fresnel"
    lens._dirty()
    tm, tp = lens.build(device="cpu")
    assert tgt.supports_model(tm)
    assert tgt.model_flags(tm, tp)[0][7] == "fresnel"
    words = tgt._flag_words(tgt.model_flags(tm, tp))
    assert words[0] & tgt.FLAG_FRESNEL and not words[0] & tgt.FLAG_COAT
    assert resolve_engine(tm, 0.0, 0.0, "cuda") == "kernel"
    px, py = (torch.tensor(a, dtype=F64) for a in _pupil(16))
    rays = final_rays(tm, tp, 0.0, 0.0, 0.55, px, py)
    assert torch.allclose(rays.intensity, torch.full_like(px, 0.98))
    with engine_override("kernel"):
        rk = final_rays(tm, tp, 0.0, 0.0, 0.55, px.float(), py.float())
    assert torch.allclose(rk.intensity, torch.full_like(rk.x, 0.98))


@pytest.mark.parametrize("name", SYSTEMS)
def test_packed_tables_match_jax(name):
    jb, tb = builders(name)
    jm, jp = jb().build()
    fields = [0.0, 1.0]
    ref = jax_tables(jm, jp, _primary(jp, jm), fields)
    _, _, gen, consts, acoef, _ = _port_tables(tb(), fields)
    np.testing.assert_allclose(consts.numpy(), np.asarray(ref["consts"]),
                               rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(gen.numpy(), np.asarray(ref["gen"]),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(acoef.numpy(), np.asarray(ref["acoef"]))


# ---------------------------------------------------------------------------
# the plain K1 against the JAX kernel
# ---------------------------------------------------------------------------

def _hold(out, ref_rays, rtol=1e-4, atol=2e-4):
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    got = {k: out[i].numpy().reshape(-1) for i, k in enumerate(names)}
    exp = {k: np.asarray(getattr(ref_rays, k)).reshape(-1) for k in names}
    assert np.array_equal(np.isfinite(got["x"]), np.isfinite(exp["x"]))
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], exp[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for k in ("L", "M", "N"):
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["opd"], exp["opd"], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got["intensity"], exp["intensity"],
                               rtol=1e-6)
    return got


@pytest.fixture(scope="module")
def jax_k1():
    """The Pallas K1 in interpret mode on the JAX suite's singlets, all
    their fields in one call (256 pupil samples)."""
    out = {}
    px, py = _pupil(256, seed=4)
    for name in ("TiltedSinglet", "OddAsphereSinglet", "CoatedSinglet"):
        jb, _ = builders(name)
        jlens = jb()
        jm, jp = jlens.build()
        fields = [0.0, 1.0][:len(jlens.fields)]
        rays = jpt.pallas_gen_trace_conic(
            jm, _f32(jp), jnp.asarray(px), jnp.asarray(py),
            jnp.asarray([0.55], jnp.float32),
            Hx=jnp.zeros(len(fields), jnp.float32),
            Hy=jnp.asarray(fields, jnp.float32), final_prop=True,
            block_rows=2, interpret=True)
        out[name] = (fields, rays)
    return out, px, py


@pytest.mark.parametrize("name", ["TiltedSinglet", "OddAsphereSinglet",
                                  "CoatedSinglet"])
def test_plain_k1_matches_interpreted_pallas(name, jax_k1):
    refs, px, py = jax_k1
    fields, rays = refs[name]
    _, tb = builders(name)
    _, _, gen, consts, acoef, flags = _port_tables(tb(), fields)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    got = _hold(out, rays)
    if name == "CoatedSinglet":     # the two coatings are its only loss
        np.testing.assert_allclose(got["intensity"],
                                   np.full(got["intensity"].shape,
                                           0.96 * 0.98, np.float32),
                                   rtol=1e-6)


def test_hubble_plain_k1_matches_f64_xla():
    """Mirrors and the central obscuration: the plain K1 at float32 against
    the JAX XLA trace at float64 (an f32 XLA trace loses ~4 digits at
    Hubble's 5e3-mm scale; the kernel's vertex shift and root pairing keep
    it within 2e-2 mm)."""
    jb, tb = builders("HubbleTelescope")
    jm, jp = jb().build()
    px, py = _pupil(1024, seed=3)
    ref = j_final_rays(jm, jp, 0.0, 1.0, 0.55, jnp.asarray(px, jnp.float64),
                       jnp.asarray(py, jnp.float64), engine="xla")
    _, _, gen, consts, acoef, flags = _port_tables(tb(), [1.0])
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    for i, k in ((0, "x"), (1, "y")):
        np.testing.assert_allclose(out[i].reshape(-1).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-3,
                                   atol=2e-2, err_msg=k)
    np.testing.assert_allclose(out[7].reshape(-1).numpy(),
                               np.asarray(ref.opd), rtol=1e-5, atol=0.2)
    blocked_k = out[6].reshape(-1).numpy() == 0.0
    blocked_x = np.asarray(ref.intensity) == 0.0
    assert blocked_x.any() and not blocked_x.all()   # the obscuration acts
    assert int(np.sum(blocked_k != blocked_x)) <= 2


def test_hubble_paraxial_matches_jax():
    """The first reflecting system through the port's paraxial trace (negative
    thicknesses, mirrors): the launch constants EPD, EPL and f2."""
    jb, tb = builders("HubbleTelescope")
    jpar = jb().paraxial
    tpar = Paraxial(*tb().build(device="cpu"))
    for q in ("EPD", "EPL", "f2", "FNO"):
        np.testing.assert_allclose(float(getattr(tpar, q)()),
                                   float(getattr(jpar, q)()), rtol=1e-10,
                                   err_msg=q)


# ---------------------------------------------------------------------------
# the plain K2 against the JAX K2, one interpreted case for the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def combined_k2():
    """jax.vjp of diff_gen_trace (the Pallas K1 and K2 in interpret mode) on
    the combined system's tables: 2 fields x 256 samples."""
    jb, _ = builders("Combined")
    jm, jp = jb().build()
    tables = jax_tables(jm, jp, _primary(jp, jm), [0.0, 1.0])
    n = 256
    px, py = _pupil(n, seed=6)
    f = diff_gen_trace(tables["flags"], n // 128, True, True, False)
    outs, vjp = jax.vjp(f, tables["gen"], tables["consts"], tables["acoef"],
                        jnp.asarray(px).reshape(-1, 128),
                        jnp.asarray(py).reshape(-1, 128))
    cot = np.random.default_rng(12).normal(size=(8, 1, 2, n)).astype(
        np.float32)
    grads = vjp(tuple(jnp.asarray(c.reshape(1, 2, -1, 128)) for c in cot))
    return tables, px, py, cot, outs, grads


def test_plain_k1_matches_interpreted_pallas_combined(combined_k2):
    """Every feature of the slice at once; the offset aperture blocks part
    of the beam."""
    tables, px, py, _, outs, _ = combined_k2
    _, tb = builders("Combined")
    _, _, gen, consts, acoef, flags = _port_tables(tb(), [0.0, 1.0])
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    ref = type("R", (), {k: np.asarray(o).reshape(-1)
                         for k, o in zip(names, outs)})
    got = _hold(out, ref)
    blocked = got["intensity"] == 0.0
    assert blocked.any() and not blocked.all()


def test_plain_k2_matches_interpreted_pallas_k2(combined_k2):
    """dgen, dconsts (columns 0-6 and 8-19: the coating, rotation and
    translation), dacoef (both aspheres' terms), dPx and dPy."""
    tables, px, py, cot, _, grads = combined_k2
    jdgen, jdconsts, jdacoef, jdpx, jdpy = [np.asarray(g) for g in grads]
    t = [torch.tensor(np.asarray(tables[k]))
         for k in ("gen", "consts", "acoef")]
    got = gen_trace_bwd_plain(*t, torch.tensor(px), torch.tensor(py),
                              torch.tensor(cot),
                              jax_flags_as_port(tables["flags"]), True)
    cols = list(range(7)) + list(range(8, 20))
    for label, g, e in (("dgen", got[0], jdgen),
                        ("dconsts", got[1][..., cols], jdconsts[..., cols]),
                        ("dacoef", got[2], jdacoef),
                        ("dPx", got[3], jdpx.reshape(-1)),
                        ("dPy", got[4], jdpy.reshape(-1))):
        scale = max(float(np.max(np.abs(e))), 1e-30)
        np.testing.assert_allclose(g.numpy(), e, rtol=3e-3,
                                   atol=3e-3 * scale, err_msg=label)
    # cotangents land only where the features are
    assert np.count_nonzero(jdacoef[0, :2]) == 2
    assert np.count_nonzero(jdacoef[1, :3]) == 3
    assert np.count_nonzero(jdconsts[0, 0, 8:20]) == 12
    assert jdconsts[0, 0, 6] != 0
    others = [7] + list(range(20, 32))
    assert not np.any(jdconsts[..., others])
    assert not torch.any(got[1][..., others])


# ---------------------------------------------------------------------------
# gradients of the masked-RMS merit, the JAX suite's _grad_parity
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


def _benchtop(lens):
    """Hubble at benchtop scale with an under-corrected primary: at full
    scale the float32 spot is smaller than the float32 position ulp
    (tests/test_pallas_grad.py:92-112)."""
    lens.scale_system(0.02)
    lens.set_conic(-0.90, 2)
    return lens


@pytest.mark.parametrize("name,wavelength,hy,rtol", [
    ("AsphericSinglet", 0.587, 0.5, 3e-3),
    ("BenchtopHubble", 0.55, 0.3, 5e-3),
    ("TiltedSinglet", 0.55, 0.7, 3e-3)])
def test_gradient_matches_jax(name, wavelength, hy, rtol):
    """d(masked RMS)/d(every leaf) through the port's kernel route (plain K1
    and K2, float32) against jax.value_and_grad of the JAX XLA trace at
    float32: the asphere terms, and the tilt and decenter leaves."""
    jb, tb = builders("HubbleTelescope" if name == "BenchtopHubble"
                      else name)
    jlens, tlens = jb(), tb()
    if name == "BenchtopHubble":
        jlens, tlens = _benchtop(jlens), _benchtop(tlens)
    jm, jp = jlens.build()
    jp = _f32(jp)
    px, py = _pupil(512)

    def merit_xla(p):
        rays = j_real.trace(jm, p, 0.0, hy, wavelength, jnp.asarray(px),
                            jnp.asarray(py))
        return _masked_rms(rays.x, rays.y, jnp)

    vx, gx = jax.value_and_grad(merit_xla)(jp)
    tm, tp = tlens.build(device="cpu", dtype=F32)
    leaves = [t for t in jax.tree_util.tree_leaves(tp)
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    with engine_override("kernel"):
        rays = final_rays(tm, tp, 0.0, hy, wavelength, torch.tensor(px),
                          torch.tensor(py))
    v = _masked_rms(rays.x, rays.y, torch)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g
    gt = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    np.testing.assert_allclose(v.item(), float(vx), rtol=5e-4)
    checked = set()
    for (kt, lt), (kx, lx) in zip(jax.tree_util.tree_leaves_with_path(gt),
                                  jax.tree_util.tree_leaves_with_path(gx)):
        key = jax.tree_util.keystr(kt)
        assert key == jax.tree_util.keystr(kx)
        lx = np.asarray(lx)
        scale = max(np.max(np.abs(lx)), 1e-4)
        np.testing.assert_allclose(lt, lx, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"grad mismatch at {key}")
        if np.any(lx != 0):
            checked.add(key.rsplit("[", 1)[-1].strip("]'\""))
    want = {"AsphericSinglet": {"coefficients", "radius"},
            "BenchtopHubble": {"conic", "radius", "thickness"},
            "TiltedSinglet": {"rx", "dx", "ry"}}[name]
    assert want <= checked, checked


# ---------------------------------------------------------------------------
# the eager path: Newton intersection, traces, parameters, builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["even_asphere", "odd_asphere"])
def test_newton_distance_matches_jax(kind):
    """The root and its implicit-function-theorem gradient with respect to
    the asphere terms, at float64."""
    from optiland_pr_tpu.geometry.aspheres import EvenAsphere as JEven
    from optiland_pr_tpu.geometry.aspheres import OddAsphere as JOdd
    from optiland_pr_tpu_torch.geometry import EvenAsphere, OddAsphere
    coefs = [2e-4, -3e-6, 5e-8]
    tg = (EvenAsphere if kind == "even_asphere" else OddAsphere)(3)
    jg = (JEven if kind == "even_asphere" else JOdd)(3)
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-6, 6, size=(2, 64))
    z = np.full(64, -5.0)
    L, M = rng.uniform(-0.1, 0.1, size=(2, 64))
    N = np.sqrt(1 - L**2 - M**2)
    state = (x, y, z, L, M, N)

    def jax_t(c):
        p = {"radius": jnp.asarray(25.0), "conic": jnp.asarray(-0.3),
             "coefficients": c}
        return j_newton(jg, p, *(jnp.asarray(v) for v in state))

    jt = np.asarray(jax_t(jnp.asarray(coefs)))
    jgrad = np.asarray(jax.grad(lambda c: jnp.sum(jax_t(c)))(
        jnp.asarray(coefs)))
    c = torch.tensor(coefs, dtype=F64, requires_grad=True)
    p = {"radius": torch.tensor(25.0, dtype=F64),
         "conic": torch.tensor(-0.3, dtype=F64), "coefficients": c}
    tt = t_newton(tg, p, *(torch.tensor(v) for v in state))
    (tgrad,) = torch.autograd.grad(tt.sum(), c)
    np.testing.assert_allclose(tt.detach().numpy(), jt, rtol=1e-12)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-9)
    assert np.all(np.abs(jgrad) > 0)


def _compare_f64(rt, rj):
    assert np.array_equal(np.isfinite(rt.x.numpy()),
                          np.isfinite(np.asarray(rj.x)))
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    for f in ("L", "M", "N"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    np.testing.assert_allclose(rt.opd.numpy(), np.asarray(rj.opd),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(rt.intensity.numpy(),
                               np.asarray(rj.intensity), rtol=1e-12)


@pytest.mark.parametrize("name", ["AsphericSinglet", "OddAsphereSinglet",
                                  "HubbleTelescope", "Combined"])
def test_eager_trace_matches_jax(name):
    """The eager trace (Newton intersections, mirrors, the obscuration,
    tilts, the coating and the offset aperture) against the JAX XLA trace at
    float64."""
    jb, tb = builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu", dtype=F64)
    # the pupil of the Hubble forward test above: its JAX trace is this
    # one's, compiled once
    px, py = (a.astype(np.float64) for a in _pupil(1024, seed=3))
    rj = j_final_rays(jm, jp, 0.0, 1.0, 0.55, jnp.asarray(px),
                      jnp.asarray(py), engine="xla")
    rt = final_rays(tm, tp, 0.0, 1.0, 0.55, torch.tensor(px),
                    torch.tensor(py), engine="eager")
    _compare_f64(rt, rj)


@pytest.mark.parametrize("name", ["HubbleTelescope", "AsphericSinglet"])
def test_params_from_numpy_carries_jax_params(name):
    """The JAX build's parameters, carried across, are the port's own build
    leaf for leaf and trace the same."""
    jb, tb = builders(name)
    _, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    pj = jax.tree_util.tree_leaves_with_path(params_to_numpy(conv))
    pt = jax.tree_util.tree_leaves_with_path(params_to_numpy(tp))
    assert [jax.tree_util.keystr(k) for k, _ in pj] == \
        [jax.tree_util.keystr(k) for k, _ in pt]
    for (k, a), (_, b) in zip(pj, pt):
        assert np.array_equal(a, b), jax.tree_util.keystr(k)
    px, py = (torch.tensor(a, dtype=F64) for a in _pupil(64, seed=4))
    for engine in ("eager", "kernel"):
        with engine_override(engine):
            a = final_rays(tm, tp, 0.0, 1.0, 0.55, px, py)
            b = final_rays(tm, conv, 0.0, 1.0, 0.55, px, py)
        for f in ("x", "y", "z", "L", "M", "N", "opd", "intensity"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (engine, f)


def test_builder_edits_match_jax():
    """set_radius, set_conic, set_thickness, set_asphere_coeff and
    scale_system give the JAX package's parameters (the benchtop Hubble of
    the JAX gradient suite among them)."""
    cases = [("HubbleTelescope", _benchtop),
             ("AsphericSinglet", lambda lens: (
                 lens.set_radius(21.0, 1), lens.set_thickness(6.5, 1),
                 lens.set_asphere_coeff(1e-9, 1, 4),
                 lens.scale_system(1.5)))]
    for name, edit in cases:
        jb, tb = builders(name)
        jlens, tlens = jb(), tb()
        _, before = tlens.build(device="cpu")
        edit(jlens)
        edit(tlens)
        _, jp = jlens.build()
        _, tp = tlens.build(device="cpu")
        assert tp is not before                 # the edits dropped the cache
        pj = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
        pt = jax.tree_util.tree_leaves(params_to_numpy(tp))
        assert len(pj) == len(pt)
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b, a, rtol=1e-15)


def test_asphere_and_tilt_variables_match_jax():
    """asphere_coeff, tilt and decenter variables read and write the same
    leaves as the JAX package's, and their merit gradient through the
    kernel route (float32) agrees with the eager float64 one (rtol 5e-3 with
    atol 5e-3 x max|g|, tests/test_pallas_grad.py::
    test_merit_path_rides_pallas)."""
    for name, variables in (
            ("AsphericSinglet", [("radius", {}),
                                 *[("asphere_coeff", {"coeff_number": i})
                                   for i in range(3)]]),
            ("TiltedSinglet", [("tilt_x", {}), ("decenter_x", {}),
                               ("tilt_y", {})])):
        jb, tb = builders(name)
        surf = {"tilt_y": 2}
        problems = []
        for opt, lens, kw in ((jopt, jb(), {}),
                              (topt, tb(), {"device": "cpu"})):
            p = opt.OptimizationProblem(lens, **kw)
            p.add_operand("rms_spot_size", target=0.0,
                          input_data={"surface_number": -1, "Hx": 0.0,
                                      "Hy": 0.5, "num_rays": 5,
                                      "wavelength": 0.55})
            for vt, extra in variables:
                p.add_variable(vt, surface_number=surf.get(vt, 1), **extra)
            problems.append(p)
        jprob, tprob = problems
        x0 = tprob.x0()
        np.testing.assert_allclose(x0.numpy(), np.asarray(jprob.x0()),
                                   rtol=1e-15)
        x = x0 * 1.01 + 1e-3
        new_t = tprob.variables.apply(tprob.params, x)
        new_j = jprob.variables.apply(jprob.params, jnp.asarray(x.numpy()))
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                        jax.tree_util.tree_leaves(new_j)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15)
        v, g = tprob.value_and_grad(x0)
        with engine_override("kernel"):
            v_k, g_k = tprob.value_and_grad(x0)
        assert torch.all(g != 0)
        np.testing.assert_allclose(float(v_k), float(v), rtol=1e-3)
        np.testing.assert_allclose(g_k.numpy(), g.numpy(), rtol=5e-3,
                                   atol=5e-3 * float(g.abs().max()))


def test_offset_aperture_and_coating_in_the_eager_trace():
    """An offset-radial aperture clips about its own centre, and a coating on
    a mirror multiplies by its reflectance."""
    from optiland_pr_tpu_torch.system import (OffsetRadialAperture, Optic,
                                              SimpleCoating)
    ap = OffsetRadialAperture()
    p = ap.default_params(r_max=2.0, r_min=0.5, offset_x=1.0, offset_y=-1.0)
    xs = torch.tensor([1.0, 2.9, 1.2, 0.0], dtype=F64)
    ys = torch.tensor([-1.0, -1.0, -1.0, 0.0], dtype=F64)
    assert ap.contains(p, xs, ys).tolist() == [False, True, False, True]
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, thickness=30.0)
    lens.add_surface(index=2, radius=-100.0, thickness=-45.0,
                     material="mirror", is_stop=True,
                     coating=SimpleCoating(transmittance=0.1,
                                           reflectance=0.9))
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.add_field(y=0.0)
    lens.add_wavelength(0.55)
    tm, tp = lens.build(device="cpu")
    px, py = (torch.tensor(a, dtype=F64) for a in _pupil(32))
    for engine in ("eager", "kernel"):
        with engine_override(engine):
            rays = final_rays(tm, tp, 0.0, 0.0, 0.55, px, py)
        np.testing.assert_allclose(rays.intensity.numpy(), 0.9, rtol=1e-6)
