"""The port's polarization (K1/K2 sub-slice (e)) against the JAX package, on
the CPU: the Jones calculus of ``core/polarization.py``, the polarized eager
trace, the launch layout, K1's and K2's plain versions against the Pallas
kernels in interpret mode, the builder's launch state, the split wavefront
and the apodized polarized launch.

Systems (``tests/_torch_systems.py::polarized_builders``): the JAX
package's polarized double Gauss (examples/double_gauss_polarized.py: an
even asphere, Fresnel coatings on eight surfaces, a linear state), the JAX
gradient suite's coated doublet (tests/test_pallas_grad.py:160-176) with a
linear, a circular and the unpolarized state, and its kernel suite's
coated mirror relay (tests/test_pallas_widened.py:396-409, unpolarized).

Tolerances:
- ``core/polarization.py`` against the JAX module, float64: rtol 1e-12
  (atol 1e-15 for the entries that are 0 in both);
- the eager polarized trace against the JAX eager trace, float64:
  positions, directions and intensity rtol 1e-9 (atol 1e-12 where a
  coordinate crosses 0);
- K1's plain version (float32) against the Pallas K1 in interpret mode:
  positions rtol 1e-4 with atol 5e-4 mm, the intensity rtol 5e-4 with atol
  5e-5 (tests/test_pallas_widened.py:368-389);
- K2's plain version (autograd through K1's) against the Pallas K2 in
  interpret mode on the doublet's intensity-weighted merit: the value rtol
  1e-3, every leaf rtol 5e-3 with atol 5e-3 x the leaf's scale
  (tests/test_pallas_grad.py:205-211);
- the OPD modes' intensities, the split wavefront's weights: equal.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.core.polarization as jpol
import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu_torch.core.polarization as tpol
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
from _torch_systems import jax_flags_as_port, jax_tables, polarized_builders
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.system.apodization import \
    GaussianApodization as JGaussian
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu_torch.analysis.wavefront import wavefront_data
from optiland_pr_tpu_torch.system.apodization import \
    GaussianApodization as TGaussian
from optiland_pr_tpu_torch.trace.engine import (engine_override, final_rays,
                                                kernel_eligible,
                                                resolve_engine)

F32, F64 = torch.float32, torch.float64
NAMES = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
# (system, launch state) of the trace comparisons
SYSTEMS = [("DoubleGauss", "linear"), ("MirrorRelay", "unpolarized"),
           ("Doublet", "circular")]


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


def _f32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  params)


# ---------------------------------------------------------------------------
# core/polarization.py
# ---------------------------------------------------------------------------

def _directions(seed, n=16):
    """n unit directions near +z and the unit normals of a tilted surface
    at them, float64 numpy, with the last ray at exact normal incidence."""
    rng = np.random.default_rng(seed)
    k0 = np.stack([rng.normal(0, 0.2, n), rng.normal(0, 0.2, n),
                   np.ones(n)], -1)
    k0 /= np.linalg.norm(k0, axis=-1, keepdims=True)
    nrm = np.stack([rng.normal(0, 0.1, n), rng.normal(0, 0.1, n),
                    -np.ones(n)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    k0[-1] = (0.0, 0.0, 1.0)
    nrm[-1] = (0.0, 0.0, -1.0)
    return k0, nrm


def _refracted(k0, nrm, mu):
    """Snell refraction of k0 at the normal with n1 / n2 = mu."""
    dot = np.sum(k0 * nrm, -1, keepdims=True)
    s = np.sign(dot)
    disc = 1 - mu**2 * (1 - dot**2)
    return mu * k0 + nrm * (s * np.sqrt(disc) - mu * dot)


def _both(fn_j, fn_t, *args):
    """fn_j on jnp copies of the numpy args, fn_t on torch copies."""
    return (np.asarray(fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args])),
            fn_t(*[torch.tensor(a) if isinstance(a, np.ndarray) else a
                   for a in args]).numpy())


def _close12(got, exp, what):
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-15,
                               err_msg=what)


@pytest.mark.parametrize("reflect, n2", [(False, 1.52), (True, 1.52),
                                         (True, 1.0 / 1.52)])
def test_fresnel_jones_matches_jax(reflect, n2):
    """The Fresnel Jones matrices in transmission, in reflection and, from
    glass into air past the critical angle, in total internal reflection
    (the complex root: |r| = 1)."""
    aoi = np.linspace(0.0, 1.45, 24)
    j, t = _both(lambda a: jpol.fresnel_jones(1.0, n2, a, reflect),
                 lambda a: tpol.fresnel_jones(1.0, n2, a, reflect), aoi)
    _close12(t, j, "fresnel_jones")
    if n2 < 1:
        assert np.allclose(np.abs(t[aoi > math.asin(n2), 0, 0]), 1.0)


@pytest.mark.parametrize("case", ["normal", "k1", "fresnel", "reflect"])
def test_polarization_update_matrix_matches_jax(case):
    """The surface matrix O_out J O_in with s from the normal or from
    k0 x k1, bare, with a Fresnel transmission and with a mirror's
    reflection; the last ray at normal incidence takes the fallback
    s = k0 x (1, 0, 0)."""
    k0, nrm = _directions(1)
    if case == "reflect":
        k1 = k0 - 2 * np.sum(k0 * nrm, -1, keepdims=True) * nrm
    else:
        k1 = _refracted(k0, nrm, 1.0 / 1.52)
    normal = None if case == "k1" else tuple(nrm.T)
    cosi = np.abs(np.sum(k0 * nrm, -1))
    jones = None
    if case in ("fresnel", "reflect"):
        n2 = 1.0 if case == "reflect" else 1.52
        jones = (jpol.fresnel_jones(1.0, n2, jnp.arccos(cosi),
                                    case == "reflect"),
                 tpol.fresnel_jones(1.0, n2, torch.tensor(np.arccos(cosi)),
                                    case == "reflect"))
    j = jpol.polarization_update_matrix(
        *[jnp.asarray(v) for v in (*k0.T, *k1.T)],
        None if jones is None else jones[0],
        normal=None if normal is None else tuple(jnp.asarray(v)
                                                 for v in normal))
    t = tpol.polarization_update_matrix(
        *[torch.tensor(v) for v in (*k0.T, *k1.T)],
        None if jones is None else jones[1],
        normal=None if normal is None else tuple(torch.tensor(v)
                                                 for v in normal))
    _close12(t.numpy(), np.asarray(j), case)


@pytest.mark.parametrize("state", ["linear", "elliptical", "unpolarized"])
def test_chain_and_intensity_match_jax(state):
    """Two surfaces composed onto the identity chain (a Fresnel one, then a
    bare one) and the final intensity from the launch state: a linear and
    an elliptical state, and the unpolarized average with its launch
    intensity."""
    k0, nrm = _directions(2)
    k1 = _refracted(k0, nrm, 1.0 / 1.52)
    k2 = _refracted(k1, -nrm[::-1], 1.52)
    kw = {"linear": dict(is_polarized=True, Ex=0.6, Ey=0.8),
          "elliptical": dict(is_polarized=True, Ex=1.0, Ey=0.5,
                             phase_x=0.2, phase_y=1.1),
          "unpolarized": None}[state]
    i0 = np.linspace(0.5, 1.0, len(k0))
    out = []
    for mod, arr in ((jpol, jnp.asarray), (tpol, torch.tensor)):
        ks = [[arr(v) for v in k.T] for k in (k0, k1, k2)]
        cosi = np.abs(np.sum(k0 * nrm, -1))
        jones = mod.fresnel_jones(1.0, 1.52, arr(np.arccos(cosi)), False)
        eye = np.broadcast_to(np.eye(3), (len(k0), 3, 3)).copy()
        p = mod.apply_polarization_update(arr(eye), *ks[0], *ks[1], jones,
                                          normal=tuple(arr(v)
                                                       for v in nrm.T))
        p = mod.apply_polarization_update(p, *ks[1], *ks[2])
        st = None if kw is None else mod.PolarizationState(**kw)
        out.append(np.asarray(mod.update_intensity(p, st, arr(i0), *ks[0])))
    _close12(out[1], out[0], state)


def test_fixed_jones_elements_match_jax():
    """The polarizers, the diattenuator (with the reference's quirks) and
    the retarders."""
    for name in ("jones_polarizer_h", "jones_polarizer_v",
                 "jones_polarizer_l45", "jones_polarizer_l135",
                 "jones_polarizer_rcp", "jones_polarizer_lcp"):
        _close12(getattr(tpol, name)().numpy(),
                 np.asarray(getattr(jpol, name)()), name)
    for args, name in (((0.3, 0.9, 0.4), "jones_linear_diattenuator"),
                       ((1.1, 0.3), "jones_linear_retarder"),
                       ((0.25,), "jones_quarter_wave"),
                       ((-0.6,), "jones_half_wave")):
        _close12(getattr(tpol, name)(*args).numpy(),
                 np.asarray(getattr(jpol, name)(*args)), name)


# ---------------------------------------------------------------------------
# the launch layout and the eligibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", ["ignore", "unpolarized", "linear",
                                   "circular", "elliptical"])
def test_polar_launch_matches_the_jax_layout(state):
    """n_ev and the scale of ``_polar_layout``, and the launch vectors of
    ``_polar_init`` (float64), from ``polar_launch``'s amplitudes."""
    kw = {"linear": dict(is_polarized=True, Ex=0.6, Ey=0.8),
          "circular": dict(is_polarized=True, Ex=1.0, Ey=1.0,
                           phase_y=math.pi / 2),
          "elliptical": dict(is_polarized=True, Ex=1.0, Ey=0.5,
                             phase_x=0.2, phase_y=1.1)}.get(state)
    js = state if kw is None else jpol.PolarizationState(**kw)
    ts = state if kw is None else tpol.PolarizationState(**kw)
    pl = tgt.polar_launch(ts)
    n_ev, scale = jpt._polar_layout(None if state == "ignore" else js)
    if state == "ignore":
        assert pl is None and n_ev == 0
        return
    assert (pl.n_ev, pl.scale) == (n_ev, scale)
    k0, _ = _directions(3)
    jvecs, _ = jpt._polar_init(js, *[jnp.asarray(v) for v in k0.T])
    tvecs = tgt._polar_init(pl, *[torch.tensor(v) for v in k0.T], None)
    for jv, tv in zip(jvecs, tvecs):
        for a, b in zip(jv, tv):
            _close12(b.numpy(), np.asarray(a), state)


def test_fresnel_coatings_are_eligible():
    """A Fresnel coating is a flag bit of its surface (and no wider
    variant's), the polarized double Gauss runs on K1 (WIDE, for its even
    asphere) and the coated doublet on the narrow K1."""
    dg = polarized_builders("DoubleGauss")[1]().build(device="cpu")[0]
    doublet = polarized_builders("Doublet")[1]().build(device="cpu")[0]
    for model in (dg, doublet):
        assert tgt.supports_model(model)
        assert kernel_eligible(model, 0.0, 0.7)
        assert tgt.supports_split_opd(model) == (model is doublet)
    words = tgt._flag_words(tgt.model_flags(doublet))
    assert all(w & tgt.FLAG_FRESNEL for w in words[:3])
    assert not words[3] & tgt.FLAG_FRESNEL
    assert not any(w & (tgt.FLAG_CS | tgt.FLAG_AP | tgt.FLAG_COAT)
                   for w in words)


# ---------------------------------------------------------------------------
# the eager polarized trace, float64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eager_references():
    """The JAX eager trace (float64) of each system of ``SYSTEMS`` at Hy 0
    and 0.7 on a 3-ring hexapolar pupil."""
    px, py = _hexapolar(3)
    out = {}
    for name, state in SYSTEMS:
        jm, jp = polarized_builders(name, state)[0]().build()
        wl = float(jp["wavelengths"][jm.primary_wavelength_idx])
        for hy in (0.0, 0.7):
            out[name, hy] = j_real.trace(jm, jp, 0.0, hy, wl,
                                         jnp.asarray(px), jnp.asarray(py))
    return px, py, out


def _hold_eager(rt, rj, what):
    for f in ("x", "y", "z", "L", "M", "N", "intensity"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-9,
                                   atol=1e-12, err_msg=f"{what} {f}")


@pytest.mark.parametrize("name, state, hy", [
    ("DoubleGauss", "linear", 0.0), ("DoubleGauss", "linear", 0.7),
    ("MirrorRelay", "unpolarized", 0.7), ("Doublet", "circular", 0.7)])
def test_eager_trace_matches_jax(name, state, hy, eager_references):
    """The chain through every refract/reflect step (the Fresnel Jones
    matrices at the angle of incidence, the bare rotations) and the
    final intensity, float64."""
    px, py, ref = eager_references
    tm, tp = polarized_builders(name, state)[1]().build(device="cpu")
    wl = float(tp["wavelengths"][tm.primary_wavelength_idx])
    rt = final_rays(tm, tp, 0.0, hy, wl, torch.tensor(px), torch.tensor(py),
                    engine="eager")
    assert rt.p is not None and rt.p.shape == (px.shape[0], 3, 3)
    _hold_eager(rt, ref[name, hy], f"{name} {hy}")


def test_set_polarization_rebuilds_and_runs_eager_on_the_cpu(
        eager_references):
    """``Optic.set_polarization`` drops the cached build; on CPU tensors
    ``final_rays`` picks the eager trace, which matches the JAX one."""
    px, py, ref = eager_references
    lens = polarized_builders("DoubleGauss")[1]()
    state = lens.polarization
    lens.set_polarization("ignore")
    assert lens.build(device="cpu")[0].polarization == "ignore"
    lens.set_polarization(state)
    assert lens.polarization_state is state
    tm, tp = lens.build(device="cpu")
    assert tm.polarization is state
    assert resolve_engine(tm, 0.0, 0.7, "cpu") == "eager"
    wl = float(tp["wavelengths"][0])
    rt = final_rays(tm, tp, 0.0, 0.7, wl, torch.tensor(px), torch.tensor(py))
    _hold_eager(rt, ref["DoubleGauss", 0.7], "Optic")


# ---------------------------------------------------------------------------
# K1's plain version against the Pallas K1 in interpret mode, float32
# ---------------------------------------------------------------------------

def _port_tables(build, fields, apod=None):
    model, params = build().build(device="cpu", dtype=F32)
    hy = torch.tensor(fields, dtype=F32)
    wl = params["wavelengths"][model.primary_wavelength_idx:][:1]
    gen, consts, acoef = tgt.gen_tables(model, params, wl,
                                        torch.zeros_like(hy), hy, apod)
    return (gen, consts, acoef, tgt.model_flags(model, params),
            tgt.polar_launch(model.polarization))


def _interpreted_k1(jb, fields, px, py, apod=None):
    """The Pallas K1 in interpret mode on the JAX entry point's tables (its
    launch state and apodization), and those tables."""
    jm, jp = jb().build()
    tables = jax_tables(jm, jp, [float(jp["wavelengths"][
        jm.primary_wavelength_idx])], fields, apodization=apod)
    f = diff_gen_trace(tables["flags"], px.shape[0] // 128, True, True,
                       False, jm.polarization, False, False, apod)
    return tables, f(tables["gen"], tables["consts"], tables["acoef"],
                     jnp.asarray(px).reshape(-1, 128),
                     jnp.asarray(py).reshape(-1, 128))


@pytest.fixture(scope="module")
def interpreted_k1():
    """The Pallas K1 of each system of ``SYSTEMS`` at Hy 0 and 0.7, 512
    samples: one interpreted compile per system."""
    px, py = _pupil(512, seed=11)
    return px, py, {(name, state): _interpreted_k1(
        polarized_builders(name, state)[0], [0.0, 0.7], px, py)
        for name, state in SYSTEMS}


@pytest.mark.parametrize("name, state", SYSTEMS)
@pytest.mark.parametrize("field", [0, 1])
def test_plain_k1_matches_interpreted_pallas(name, state, field,
                                             interpreted_k1):
    """The E-vectors through every surface (the Rodrigues rotation, the
    s/p update with the Fresnel coefficients, the plane mirror's and the
    conic mirror's reflection) and the chain's intensity, on the port's
    tables, which are the JAX entry point's."""
    px, py, runs = interpreted_k1
    tables, outs = runs[name, state]
    gen, consts, acoef, flags, polar = _port_tables(
        polarized_builders(name, state)[1], [0.0, 0.7])
    assert flags == jax_flags_as_port(tables["flags"])
    np.testing.assert_allclose(consts.numpy(), np.asarray(tables["consts"]),
                               rtol=1e-6, atol=1e-9)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True, "plain", polar)
    for i, k in enumerate(NAMES[:7]):
        rtol, atol = {"intensity": (5e-4, 5e-5), "L": (0.0, 1e-5),
                      "M": (0.0, 1e-5), "N": (0.0, 1e-5)}.get(k, (1e-4, 5e-4))
        np.testing.assert_allclose(out[i, 0, field].numpy(),
                                   np.asarray(outs[i])[0, field].reshape(-1),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name} {k}")
    # the Fresnel losses take a few percent of the launch power
    power = polar.scale * sum(a * a + b * b for a, b in polar.coefs)
    assert float(out[6].max()) < 0.95 * power


def test_plain_k1_opd_modes_carry_the_same_chain():
    """The Kahan and split modes carry the E-vectors as the plain mode
    does: the doublet's intensity and directions equal in the Kahan mode
    (which changes the OPD sum only), within 2e-6 in the split mode (whose
    local z moves each intersection by float32 rounding)."""
    build = polarized_builders("Doublet", "circular")[1]
    gen, consts, acoef, flags, polar = _port_tables(build, [0.0, 0.7])
    model, params = build().build(device="cpu", dtype=F32)
    px, py = (torch.tensor(v) for v in _pupil(256, seed=2))
    ref = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags, True,
                              "plain", polar)
    for mode in ("kahan", "split"):
        c = tgt.split_consts(params, gen, consts) if mode == "split" \
            else consts
        out = tgt.gen_trace_plain(gen, c, acoef, px, py, flags, True, mode,
                                  polar)
        tol = 0.0 if mode == "kahan" else 2e-6
        for j in (3, 4, 5, 6):
            np.testing.assert_allclose(out[j].numpy(), ref[j].numpy(),
                                       rtol=tol, atol=tol, err_msg=mode)


def test_split_wavefront_weights_are_the_chains():
    """A polarized system's split wavefront (K1's split mode, here its
    plain version) takes its weights from the chain: the doublet's
    intensity as the split mode's launch gives it (the chief ray first),
    within 2e-6 of the plain mode's, and below the uncoated 1."""
    model, params = polarized_builders("Doublet")[1]().build(device="cpu",
                                                             dtype=F32)
    px, py = (torch.tensor(v, dtype=F32) for v in _hexapolar(4))
    pxc, pyc = torch.cat([px[:1] * 0, px]), torch.cat([py[:1] * 0, py])
    with engine_override("kernel"):
        data = wavefront_data(model, params, (0.0, 0.7), 0.5876, px, py)
        split, _ = tgt.gen_trace_conic(model, params, pxc, pyc, 0.5876,
                                       Hy=0.7, final_prop=True,
                                       opd_split=True, keep_local_z=True)
        plain = tgt.gen_trace_conic(model, params, pxc, pyc, 0.5876, Hy=0.7,
                                    final_prop=True)
    assert torch.equal(data.intensity, split.intensity[1:])
    np.testing.assert_allclose(data.intensity.numpy(),
                               plain.intensity[1:].numpy(), rtol=2e-6)
    assert float(data.intensity.max()) < 0.95


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas K2 in interpret mode, float32
# ---------------------------------------------------------------------------

def _weighted_rms(rays, xp, fields):
    """The intensity-weighted RMS spot radius of each field, summed."""
    x, y, w = (a.reshape(fields, -1) for a in (rays.x, rays.y,
                                                 rays.intensity))
    ok = xp.isfinite(x) & xp.isfinite(y)
    w = xp.where(ok, w, 0.0)
    ws = xp.sum(w, axis=-1)
    ws = xp.maximum(ws, 1e-6 * xp.ones_like(ws))
    xs = xp.where(ok, x, 0.0)
    ys = xp.where(ok, y, 0.0)
    mx = xp.sum(xs * w, axis=-1) / ws
    my = xp.sum(ys * w, axis=-1) / ws
    return xp.sum(xp.sqrt(xp.sum(w * ((xs - mx[:, None]) ** 2
                                      + (ys - my[:, None]) ** 2), axis=-1)
                          / ws))


def test_plain_k2_matches_interpreted_pallas_k2():
    """The intensity-weighted spot merit of the coated doublet (linear
    state, Hy 0 and 0.7, 256 samples, sample 0 the exact pupil centre): its
    value and gradient through the Pallas K1/K2 in interpret mode (the
    file's one interpreted K2) against the port's K1 and K2 plain versions,
    leaf by leaf and pupil sample by pupil sample; the merit's weights are
    the chain's intensity, so the gradient runs through the chain's
    adjoint. On axis at Hy 0 the centre's ray meets every surface at normal
    incidence, where k0 x n = 0 and the s basis takes its fallback: its
    cotangents are finite and the Pallas K2's."""
    jb, tb = polarized_builders("Doublet")
    fields = [0.0, 0.7]
    px, py = _pupil(256)
    px[0] = py[0] = 0.0
    jm, jp = jb().build()
    jp = _f32(jp)
    flags = jpt.model_flags(jm, jp)

    def merit_pallas(p, px_, py_):
        return _weighted_rms(jpt.pallas_gen_trace_conic(
            jm, p, px_, py_, 0.5876, Hy=jnp.asarray(fields), flags=flags,
            final_prop=True, interpret=True, differentiable=True), jnp,
            len(fields))

    vj, (gj, dpx_j, dpy_j) = jax.value_and_grad(merit_pallas, (0, 1, 2))(
        jp, jnp.asarray(px), jnp.asarray(py))
    tm, tp = tb().build(device="cpu", dtype=F32)
    leaves = [t for t in jax.tree_util.tree_leaves(tp)
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    tpx, tpy = (torch.tensor(v, requires_grad=True) for v in (px, py))
    with engine_override("kernel"):
        rays = final_rays(tm, tp, 0.0, torch.tensor(fields), 0.5876, tpx,
                          tpy)
    v = _weighted_rms(rays, torch, len(fields))
    grads = torch.autograd.grad(v, leaves + [tpx, tpy], allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g
    gt = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    np.testing.assert_allclose(v.item(), float(vj), rtol=1e-3)
    n_leaves = 0
    for (kt, lt), (kj, lj) in zip(jax.tree_util.tree_leaves_with_path(gt),
                                  jax.tree_util.tree_leaves_with_path(gj)):
        assert jax.tree_util.keystr(kt) == jax.tree_util.keystr(kj)
        lj = np.asarray(lj)
        scale = max(np.max(np.abs(lj)), 1e-3)
        np.testing.assert_allclose(
            lt, lj, rtol=5e-3, atol=5e-3 * scale,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(kt)}")
        n_leaves += 1
    assert n_leaves > 10
    for label, g, gj_ in (("Px", grads[-2], dpx_j), ("Py", grads[-1], dpy_j)):
        gj_ = np.asarray(gj_)
        assert np.isfinite(gj_).all() and bool(torch.isfinite(g).all())
        scale = np.max(np.abs(gj_))
        np.testing.assert_allclose(g.numpy(), gj_, rtol=5e-3,
                                   atol=5e-3 * scale,
                                   err_msg=f"d merit / d {label}")
        np.testing.assert_allclose(g[0].item(), gj_[0], rtol=5e-3,
                                   atol=5e-3 * scale,
                                   err_msg=f"d merit / d {label} at the "
                                   "pupil centre")


# ---------------------------------------------------------------------------
# the polarized, apodized launch: each engine of the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def apodized():
    """The coated doublet, linear state, GaussianApodization(sigma=0.7), Hy
    0.7, 128 samples: the Pallas K1 (interpret mode) and the port's plain
    K1 (float32), the JAX and the port's eager traces (float64)."""
    jb, tb = polarized_builders("Doublet")
    px, py = _pupil(128, seed=5)
    _, outs = _interpreted_k1(jb, [0.7], px, py, apod=JGaussian(sigma=0.7))
    gen, consts, acoef, flags, polar = _port_tables(
        tb, [0.7], TGaussian(sigma=0.7))
    plain = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                                torch.tensor(py), flags, True, "plain",
                                polar)
    jm, jp = jb().build()
    rj = j_real.trace(jm, jp, 0.0, 0.7, 0.5876, jnp.asarray(px, jnp.float64),
                      jnp.asarray(py, jnp.float64),
                      apodization=JGaussian(sigma=0.7))
    tm, tp = tb().build(device="cpu")
    rt = final_rays(tm, tp, 0.0, 0.7, 0.5876, torch.tensor(px, dtype=F64),
                    torch.tensor(py, dtype=F64), engine="eager",
                    apodization=TGaussian(sigma=0.7))
    return (np.asarray(outs[6]).reshape(-1), plain[6, 0, 0].numpy(),
            np.asarray(rj.intensity), rt.intensity.numpy())


def test_apodized_polarized_kernel_keeps_the_weight(apodized):
    """K1 scales the launch vectors by sqrt(w), so its intensity carries
    the apodization, as the Pallas K1's does."""
    pallas, plain, _, eager = apodized
    np.testing.assert_allclose(plain, pallas, rtol=5e-4, atol=5e-5)
    w = np.exp(-np.sum(np.square(_pupil(128, seed=5)), 0) / (2 * 0.49))
    np.testing.assert_allclose(plain / w, eager, rtol=1e-5, atol=1e-6)


def test_apodized_polarized_eager_trace_drops_the_weight(apodized):
    """The eager trace of a polarized state takes its intensity from the
    chain alone, as the JAX eager trace does (float64), so the two engines
    of either package differ by the weight (ROADMAP.md section 3)."""
    pallas, _, jeager, eager = apodized
    np.testing.assert_allclose(eager, jeager, rtol=1e-9, atol=1e-12)
    assert float(np.min(eager)) > 0.85
    assert float(np.max(np.abs(pallas - eager))) > 0.1


# ---------------------------------------------------------------------------
# chip_smoke's K2 (e) check: the pupil cotangents against the float64 plain
# version, and the slots that cancel to 0 at float32 resolution
# ---------------------------------------------------------------------------

def _grad_set(n=64, seed=4):
    rng = np.random.default_rng(seed)
    shapes = ((2, 16), (1, 3, 32), (3, 4), (n,), (n,))
    return [torch.tensor(rng.normal(size=s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("case", ["float64_passes", "float64_fails",
                                  "zero_slot_passes", "zero_slot_fails",
                                  "small_slot_is_held"])
def test_chip_smoke_polarized_grad_check(case):
    """``compare_grads(ref64=...)`` holds dPx and dPy against the float64
    plain version (with the float32 floor): a kernel on the float64 value
    passes where the float32 plain version is off by 10x the bound, and one
    off the float64 value by 1.1x the bound fails. ``zero_ulps=1`` holds a
    dconsts slot that cancels to 1e-9 of the tensor in the plain version
    within one float32 ulp of the tensor's largest (0.5 ulp passes, 2 ulps
    fail, and without the option 0.5 ulp fails), and leaves a slot above
    that ulp at its own bound."""
    from chip_smoke import GRAD_TOL, compare_grads
    ref = _grad_set()
    ref[1][0, 1, 2] = 1e-9 * float(ref[1].abs().max())
    ref[1][0, 2, 5] = 1e-5 * float(ref[1].abs().max())
    ref64 = [t.double() for t in ref]
    got = [t.clone() for t in ref]
    floor = [None] * 3 + [torch.zeros_like(ref[3]), torch.zeros_like(ref[4])]
    rtol, share = GRAD_TOL["dPx"]
    bound = (share * float(ref64[3].abs().max())
             + rtol * float(ref64[3][7].abs()))
    ulp = torch.finfo(torch.float32).eps * float(ref[1].abs().max())
    if case.startswith("float64"):
        ref[3][7] += 10 * bound                 # the float32 plain version
        if case == "float64_fails":
            got[3][7] = float(ref64[3][7]) + 1.1 * bound
        with pytest.raises(RuntimeError, match="dPx exceeds"):
            compare_grads(got, ref, case, floor)
        if case == "float64_fails":
            with pytest.raises(RuntimeError, match="dPx exceeds"):
                compare_grads(got, ref, case, floor, ref64=ref64)
        else:
            compare_grads(got, ref, case, floor, ref64=ref64)
        return
    if case == "small_slot_is_held":
        got[1][0, 2, 5] += 0.9 * ulp            # 1.8x its own bound
        with pytest.raises(RuntimeError, match="a dconsts slot exceeds"):
            compare_grads(got, ref, case, per_slot=True, zero_ulps=1)
        return
    got[1][0, 1, 2] = (0.5 if case == "zero_slot_passes" else 2.0) * ulp
    compare_grads(got, ref, case)
    with pytest.raises(RuntimeError, match="a dconsts slot exceeds"):
        compare_grads(got, ref, case, per_slot=True)
    if case == "zero_slot_passes":
        compare_grads(got, ref, case, per_slot=True, zero_ulps=1)
    else:
        with pytest.raises(RuntimeError, match="a dconsts slot exceeds"):
            compare_grads(got, ref, case, per_slot=True, zero_ulps=1)
