"""The port's Huygens path and K3 against the JAX package, on the CPU: the
plain forms of K4 (``kernels/huygens.py``), ``HuygensPSF`` and
``HuygensMTF``, and K3's plain version (``kernels/trace_conic.py``).

Tolerances:
- K4's plain forms against the JAX XLA forms, float64 on the JAX suite's
  inputs (tests/test_analysis.py:209-223): rtol 1e-9 with atol 1e-12 x the
  peak (the identity check of tests/test_analysis.py:236-237);
- the float32 re-referenced form within 2e-4 x the peak of the float64
  truth, the naive float32 form more than 100 x further off
  (tests/test_analysis.py:230-234);
- ``HuygensPSF`` and ``HuygensMTF`` float64 against the JAX package's
  float64: 1e-7 x the peak (and of the Strehl ratio; the MTF and its
  frequencies rtol 1e-7 with atol 1e-9);
- K3's plain version (float32) against ``pallas_trace_conic`` in interpret
  mode: positions rtol 1e-4 and atol 2e-4 mm, directions atol 1e-5, OPD
  atol 2e-3 mm, intensity rtol 1e-6, lost rays NaN at the same rays
  (tests/test_torch_wavefront.py's K1 tolerances);
- K4's argument reductions of a float32 phase (``reduce_phase``, the
  float64 mirror of csrc/huygens.cu): the float64 one within 1e-15 rad,
  the float32 one within 7e-8 rad, of x - n pi at 200 bits; sin and cos
  through them (``sincos_phase``) within 1e-7 of numpy's float64 sin and
  cos of x (r's rounding to float32, 9.4e-8 at |r| <= 1.58, or the float32
  reduction's error).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.huygens as jh
import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu_torch.kernels.huygens as th
from _torch_systems import builders, freeform_builders
from chip_smoke import huygens_geometry
from optiland_pr_tpu.analysis.psf import HuygensPSF as JHuygensPSF
from optiland_pr_tpu.analysis.psf_mtf_extra import HuygensMTF as JHuygensMTF
from optiland_pr_tpu.core.rays import new_rays as j_new_rays
from optiland_pr_tpu.trace.raygen import generate_rays as j_generate_rays
from optiland_pr_tpu_torch.analysis import HuygensMTF, HuygensPSF
from optiland_pr_tpu_torch.analysis.psf import _on_sphere
from optiland_pr_tpu_torch.core.rays import new_rays
from optiland_pr_tpu_torch.kernels.trace_conic import (RAY_FIELDS,
                                                       trace_conic,
                                                       trace_plain)

F32, F64 = torch.float32, torch.float64
WL = 0.55
# the JAX suite's Huygens sizes (tests/test_analysis.py:209)
P, I = 512, 256


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.fixture(scope="module")
def geometry():
    """The JAX suite's inputs as numpy float64: (px, py, pz, amp, opd, ix,
    iy, iz), k and the sphere radius."""
    g = huygens_geometry(P, I)
    return g[:8], g[8], g[9]


def _in(arrays, lib, dtype):
    if lib == "jax":
        return [jnp.asarray(a, dtype) for a in arrays]
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def test_huygens_sum_plain_matches_jax(geometry):
    """K4's own function: the plain sum against ``huygens_sum_xla``."""
    (px, py, pz, amp, opd, ix, iy, iz), k, _ = geometry
    args = (px, py, pz, opd, amp, ix, iy, iz)
    ref = np.asarray(jh.huygens_sum_xla(*_in(args, "jax", jnp.float64), k))
    got = _np(th.huygens_sum_plain(*_in(args, "torch", F64), k))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12 * ref.max())
    # the entry point takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        _np(th.huygens_sum(*_in(args, "torch", F64), k)), got)


@pytest.mark.parametrize("form", ["naive", "rereferenced"])
def test_huygens_fresnel_forms_match_jax(geometry, form):
    """The naive form against ``huygens_fresnel_xla`` and the re-referenced
    one against ``huygens_fresnel_ref``, both float64."""
    arrays, k, rp = geometry
    jfn, tfn = {"naive": (jh.huygens_fresnel_xla, th.huygens_fresnel_plain),
                "rereferenced": (jh.huygens_fresnel_ref,
                                 th.huygens_fresnel_ref)}[form]
    ref = np.asarray(jfn(*_in(arrays, "jax", jnp.float64), k, rp))
    got = _np(tfn(*_in(arrays, "torch", F64), k, rp))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12 * ref.max())


def test_rereferenced_float32_stays_at_float32_rounding(geometry):
    """The float32 plain form of the Fresnel kernel, on the tables
    re-referenced in float64, within 2e-4 x the peak of the float64 truth;
    the naive float32 form's loss pinned as the contrast."""
    arrays, k, rp = geometry
    truth = _np(th.huygens_fresnel_plain(*_in(arrays, "torch", F64), k, rp))
    a32 = _in(arrays, "torch", F32)
    naive = _np(th.huygens_fresnel_plain(*a32, k, rp))
    pupil, image = th.rereference(*a32, k, rp, F32)
    assert pupil.dtype == image.dtype == F32
    ref32 = _np(th.fresnel_sum_plain(pupil, image, k))
    np.testing.assert_array_equal(_np(th.huygens_fresnel_ref(*a32, k, rp)),
                                  ref32)
    scale = truth.max()
    err_ref = np.max(np.abs(ref32 - truth)) / scale
    err_naive = np.max(np.abs(naive - truth)) / scale
    assert err_ref < 2e-4, err_ref
    assert err_naive > 100 * err_ref, (err_naive, err_ref)


def test_rereference_runs_in_float64_before_the_cast():
    """At a telescope's scale (the pupil 6 m from the image) the residual
    phase is taken in float64 before the tables are rounded: the float32
    tables' pre + i pim agree with the float64 ones to float32 rounding,
    where the same phase from float32 distances (k |p - c| ~ 7e7 rad) is
    off by radians."""
    g = huygens_geometry(64, 16)
    arrays = list(g[:8])
    arrays[2] = np.full(64, -6000.0)
    k, rp = g[8], 6000.0
    a64 = _in(arrays, "torch", F64)
    p64, _ = th.rereference(*a64, k, rp, F64)
    p32, _ = th.rereference(*a64, k, rp, F32)
    assert float(torch.max(torch.abs(p32[4:6].double() - p64[4:6]))) < 1e-6
    c32 = [torch.mean(v.float()) for v in a64[5:8]]
    r32 = torch.sqrt(sum((v.float() - c) ** 2 for v, c in zip(a64[:3],
                                                              c32)))
    phi32 = k * (r32.double() - a64[4])
    dphi = torch.remainder(phi32 - torch.atan2(p64[5], p64[4]) + np.pi,
                           2 * np.pi) - np.pi
    assert float(dphi.abs().max()) > 0.1


# ---------------------------------------------------------------------------
# HuygensPSF and HuygensMTF against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,field", [("CookeTriplet", (0.0, 1.0)),
                                        ("HubbleTelescope", (0.0, 0.0)),
                                        ("TiltedImageSinglet", (0.0, 1.0))])
def test_huygens_psf_matches_jax(name, field):
    """The whole PSF (the uniform-pupil wavefront, the image centre, the
    extent from the working F-number and the geometric footprint, the grid
    through the image sag and pose, the sum and the normalization) and the
    Strehl ratio, float64, 16 rays and a 16 x 16 image; the third system's
    image surface is curved, tilted and decentered."""
    jb, tb = builders(name)
    j = JHuygensPSF(jb(), field, WL, num_rays=16, image_size=16)
    t = HuygensPSF(tb(), field, WL, num_rays=16, image_size=16,
                   device="cpu")
    ref = np.asarray(j.psf)
    assert t.psf.shape == ref.shape == (16, 16)
    np.testing.assert_allclose(_np(t.psf), ref, rtol=0,
                               atol=1e-7 * ref.max())
    np.testing.assert_allclose(float(t.strehl_ratio()),
                               float(j.strehl_ratio()), rtol=0,
                               atol=1e-7 * ref.max() / 100)
    np.testing.assert_allclose(float(t.pixel_pitch), float(j.pixel_pitch),
                               rtol=1e-12)


def test_huygens_mtf_matches_jax():
    """One field of the Cooke triplet: the PSF at twice the cutoff (the
    working F-number's pixel pitch), both MTF slices and the frequencies."""
    jb, tb = builders("CookeTriplet")
    kw = dict(fields=[(0.0, 1.0)], wavelength=WL, num_rays=16, image_size=16)
    j = JHuygensMTF(jb(), **kw)
    t = HuygensMTF(tb(), device="cpu", **kw)
    np.testing.assert_allclose(float(t.psf_instances[0].pixel_pitch),
                               float(j.psf_instances[0].pixel_pitch),
                               rtol=1e-12)
    for q in ("mtf_tangential", "mtf_sagittal", "freq"):
        np.testing.assert_allclose(_np(getattr(t, q)),
                                   np.asarray(getattr(j, q)), rtol=1e-7,
                                   atol=1e-9, err_msg=q)


def test_float32_pupil_samples_go_back_on_the_sphere():
    """A float32 wavefront's pupil samples are put back on the reference
    sphere in float64 along their direction from its centre; float64 ones,
    already on it, move by no more than their own rounding."""
    _, tb = builders("CookeTriplet")
    h = HuygensPSF(tb(), (0.0, 1.0), WL, num_rays=16, image_size=8,
                   device="cpu")
    d = h.get_data(h.field, WL)
    for a, b in zip(_on_sphere(d), (d.pupil_x, d.pupil_y, d.pupil_z)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12)
    d32 = dataclasses.replace(d, **{k: getattr(d, k).to(F32) for k in (
        "pupil_x", "pupil_y", "pupil_z")}, radius=d.radius.to(F32))
    p = _on_sphere(d32)
    c = [torch.as_tensor(v).double() for v in d.center]
    r = torch.sqrt(sum((a - b) ** 2 for a, b in zip(p, c)))
    ok = torch.isfinite(r)
    assert all(v.dtype == F64 for v in p)
    np.testing.assert_allclose(_np(r[ok]), float(d32.radius), rtol=1e-14)
    np.testing.assert_allclose(_np(p[0][ok]), _np(d.pupil_x[ok]), atol=1e-5)


# ---------------------------------------------------------------------------
# K4 on the card: how it takes sin and cos, and its launch plan
# ---------------------------------------------------------------------------

def _phases(limit: float, seed: int = 3) -> np.ndarray:
    """Float32 phases below ``limit``: log-uniform magnitudes from 0.125
    rad, both signs, and float32 multiples of pi/2 with their neighbours
    up to three ulp away (where sin or cos passes through 0)."""
    rng = np.random.default_rng(seed)
    mag = 2.0 ** rng.uniform(-3.0, np.log2(limit), 40_000)
    x = (mag * rng.choice([-1.0, 1.0], mag.size)).astype(np.float32)
    m = rng.integers(1, int(limit / (np.pi / 2)), 2_000)
    near = [(m * (np.pi / 2)).astype(np.float32)]
    for _ in range(3):
        near += [np.nextafter(near[-1], np.float32(np.inf)),
                 np.nextafter(near[0], np.float32(-np.inf))]
    x = np.concatenate([x] + near)
    return x[np.abs(x) < limit]


@pytest.mark.parametrize("form", ["sum", "fresnel"])
def test_kernel_sincos_matches_float64(form):
    """The kernel's reduction of float32 phases on its fast range (the
    float64 mirror ``reduce_phase``): sin and cos through it against
    numpy's float64 sin and cos of the same float32 values, and x - n pi
    against 200 bits of pi (mpmath) on a few hundred of them."""
    mpmath = pytest.importorskip("mpmath")
    x = _phases(th.FAST_LIMIT[form])
    s, c = th.sincos_phase(torch.from_numpy(x), form)
    xd = x.astype(np.float64)
    assert float(np.abs(s.numpy() - np.sin(xd)).max()) <= 1e-7
    assert float(np.abs(c.numpy() - np.cos(xd)).max()) <= 1e-7
    pick = np.concatenate([x[:150], x[-150:]])
    r, odd = th.reduce_phase(torch.from_numpy(pick), form)
    mpmath.mp.prec = 200
    for xi, ri, oi in zip(pick, r.numpy(), odd.numpy()):
        xm = mpmath.mpf(float(xi))
        n = mpmath.nint(xm / mpmath.pi)
        assert bool(oi) == (int(n) % 2 == 1)
        assert abs(float(xm - n * mpmath.pi) - float(ri)) \
            <= (1e-15 if form == "sum" else 7e-8)


def test_kernel_constants_are_the_sources():
    """The mirror's constants (the reductions and their ranges) and the
    launch plan's tile are the ones csrc/huygens.cu defines."""
    src = (Path(th.__file__).parent / "csrc" / "huygens.cu").read_text()
    val = {m.group(1): float.fromhex(m.group(2).rstrip("f")) for m in
           re.finditer(r"#define (\w+) (-?0x[0-9a-fp.+-]+f?)\b", src)}
    val.update({m.group(1): float(m.group(2)) for m in re.finditer(
        r"#define (\w+_FAST_LIMIT) ([0-9.]+)f", src)})
    assert th.REDUCE_F64 == tuple(val[k] for k in (
        "INV_PI_D", "SHIFT_D", "PI1_D", "PI2_D", "PI3_D"))
    assert th.REDUCE_F32 == tuple(val[k] for k in (
        "INV_PI_F", "SHIFT_F", "PI1_F", "PI2_F"))
    assert th.FAST_LIMIT == {"sum": val["SUM_FAST_LIMIT"],
                             "fresnel": val["FRESNEL_FAST_LIMIT"]}
    assert np.float32(np.pi) == val["PI1_D"] == val["PI1_F"]
    assert re.search(r"constexpr int TILE = (\d+);", src).group(1) \
        == str(th.TILE)


@pytest.mark.parametrize("n_pupil,n_image,slots,want", [
    (51_040, 65_536, 396, (1, 24)),     # 256/256 at 3 blocks per SM
    (12_644, 16_384, 264, (1, 66)),     # 128/128 at 2 blocks per SM
    (51_040, 1, 264, (256, 24)),        # the one-point normalization
    (51_040, 128, 264, (16, 398)),      # 128 points
    (100, 1, 264, (256, 1)),            # too few pupil points to split
    (64, 10 ** 6, 264, (1, 1))])        # enough image points alone
def test_k4_launch_plan(n_pupil, n_image, slots, want):
    """The launch plan: lanes fill one block only when the image groups
    cannot, the segments make about two waves of blocks without leaving a
    lane fewer than 8 pupil points."""
    lanes, splits = th._plan(n_pupil, n_image, slots)
    assert (lanes, splits) == want
    groups = -(-n_image // 8)
    assert lanes & (lanes - 1) == 0 and groups * lanes <= max(256, groups)
    assert splits == 1 or n_pupil // (lanes * splits) >= 8


# ---------------------------------------------------------------------------
# K3: the plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k3_cases():
    """The Cooke triplet (Hy 1, the narrow surfaces), the bench's Chebyshev
    singlet (Hy 0, FREEFORM) and the steep TIR singlet (Hy 1: 30 degrees,
    about a fifth of the rays lost to TIR) through
    ``pallas_trace_conic(..., interpret=True)``, on float32 rays from the
    JAX package's float64 ``generate_rays`` of 1024 seeded pupil samples;
    the port gets the same float32 rays."""
    rng = np.random.default_rng(5)
    n = 1024
    r = np.sqrt(rng.uniform(size=n))
    th_ = rng.uniform(0, 2 * np.pi, size=n)
    out = {}
    px, py = r * np.cos(th_), r * np.sin(th_)
    for name, (jb, tb), hy in (
            ("cooke", builders("CookeTriplet"), 1.0),
            ("chebyshev", freeform_builders("bench:cheb"), 0.0),
            ("tir_singlet", builders("TIRSinglet"), 1.0)):
        jm, jp = jb().build()
        rays = j_generate_rays(jm, jp, jnp.zeros(n), jnp.full(n, hy),
                               jnp.asarray(px), jnp.asarray(py), WL)
        arrs = [np.asarray(getattr(rays, k), np.float32) for k in
                ("x", "y", "z", "L", "M", "N", "intensity", "opd")]
        jr = j_new_rays(*arrs[:7], wavelength=WL, opd=arrs[7],
                        dtype=jnp.float32)
        p32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                     jp)
        got = jpt.pallas_trace_conic(jm, p32, jr, WL, block_rows=8,
                                     interpret=True)
        out[name] = (tb, arrs, [np.asarray(getattr(got, k)) for k in (
            "x", "y", "z", "L", "M", "N", "intensity", "opd")])
    return out


@pytest.mark.parametrize("name", ["cooke", "chebyshev", "tir_singlet"])
def test_k3_plain_matches_interpreted_pallas(k3_cases, name):
    """trace_conic on CPU tensors (K3's plain version) against the
    interpreted Pallas K3, lost rays included."""
    tb, arrs, ref = k3_cases[name]
    tm, tp = tb().build(device="cpu", dtype=F32)
    rays = new_rays(*[torch.tensor(a) for a in arrs[:7]], wavelength=WL,
                    opd=torch.tensor(arrs[7]), dtype=F32, device="cpu")
    out = trace_conic(tm, tp, rays, WL)
    got = [_np(getattr(out, k)) for k in RAY_FIELDS]
    assert np.array_equal(np.isnan(got[0]), np.isnan(ref[0]))
    if name == "tir_singlet":
        assert 0 < np.isnan(got[0]).sum() < len(got[0])
    for i, k in enumerate(RAY_FIELDS):
        if k == "intensity":
            np.testing.assert_allclose(got[i], ref[i], rtol=1e-6)
            continue
        rtol, atol = ((1e-4, 2e-4) if k in "xyz" else
                      (0.0, 1e-5) if k in "LMN" else (0.0, 2e-3))
        np.testing.assert_allclose(got[i], ref[i], rtol=rtol, atol=atol,
                                   err_msg=k)
    assert out.wavelength is rays.wavelength


def test_k3_plain_is_k1_surface_for_surface():
    """K3 with K1's launch rays is K1 without the image thickness: the
    plain K1 (final_prop=False) and the plain K3 on the rays K1's prologue
    makes agree bit for bit, lost rays (the TIR singlet) included."""
    import optiland_pr_tpu_torch.kernels.gen_trace as tgt
    _, tb = builders("TIRSinglet")
    tm, tp = tb().build(device="cpu", dtype=F32)
    px = torch.linspace(-1, 1, 301, dtype=F32)
    py = torch.linspace(1, -1, 301, dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, WL, 0.0, 1.0)
    flags = tgt.model_flags(tm, tp)
    k1 = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags, False)
    # K1's launch rays: its prologue, run as the plain version runs it
    g = gen[0]
    x = px * g[0] + g[2]
    y = py * g[1] + g[3]
    z = g[4].expand_as(x)
    dxr, dyr, dzr = px * g[8] - x, py * g[9] - y, g[5] - z
    inv = torch.reciprocal(tgt._sqrt(dxr * dxr + dyr * dyr + dzr * dzr))
    table = torch.stack([x, y, z, dxr * inv, dyr * inv, dzr * inv,
                         torch.ones_like(x), torch.zeros_like(x)])
    k3 = trace_plain(consts[0], acoef, table, flags)
    assert torch.isnan(k3[0]).any() and not torch.isnan(k3[0]).all()
    assert torch.equal(k3.nan_to_num(), k1[:, 0, 0].nan_to_num())
    assert torch.equal(k3.isnan(), k1[:, 0, 0].isnan())


def test_k3_refuses_what_it_does_not_take():
    _, tb = builders("CookeTriplet")
    tm, tp = tb().build(device="cpu")
    rays = new_rays(torch.zeros(4), torch.zeros(4), torch.zeros(4),
                    torch.zeros(4), torch.zeros(4), torch.ones(4),
                    device="cpu")
    with pytest.raises(ValueError, match="one wavelength"):
        trace_conic(tm, tp, rays, torch.tensor([0.5, 0.6]))
    with pytest.raises(ValueError, match="flags"):
        trace_plain(torch.zeros(3, 32), torch.zeros(3, 8),
                    torch.zeros(8, 4), [])
