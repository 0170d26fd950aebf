"""K1 in the port (``kernels/gen_trace.py``) against the JAX package's K1.

- The packed tables (gen, consts, acoef) and the static flags are held
  against the tables ``pallas_gen_trace_conic`` hands to its kernel, at
  float32: rtol 1e-6 (both packages compute them in float32 from the same
  float32 parameters; dispersion formulas may round differently in the last
  bit).
- The plain version of K1 on the port's tables is held against the Pallas
  kernel run in interpret mode on the JAX tables, at the tolerances the JAX
  suite uses between its kernel and XLA (tests/test_pallas_widened.py:350-353):
  positions rtol 2e-4 / atol 2e-4 mm, directions atol 1e-5, OPD rtol 1e-4 /
  atol 2e-3; intensity rtol 1e-6; lost-ray masks equal.
- The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.samples.objectives as tobj
from _torch_systems import builders as _builders
from _torch_systems import jax_flags_as_port
from optiland_pr_tpu_torch.system.optic import Optic as TOptic
from optiland_pr_tpu_torch.trace.engine import (engine_override, final_rays,
                                                kernel_eligible, resolve_engine)

F32 = torch.float32



def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _f32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  params)


def _jax_k1(name, n_rays, fields, block_rows=4, seed=7):
    """Run the JAX K1 (Pallas interpreter) through pallas_gen_trace_conic
    and capture the tables it hands to the kernel."""
    jb, _ = _builders(name)
    jlens = jb()
    model, params = jlens.build()
    params = _f32(params)
    wls = jnp.asarray(jlens.wavelengths, jnp.float32)
    px, py = _pupil(n_rays, seed)
    seen = {}
    orig = jpt._pallas_gen_trace_2d

    def capture(gen, consts, acoef, Px, Py, **kw):
        seen.update(gen=np.asarray(gen), consts=np.asarray(consts),
                    acoef=np.asarray(acoef), flags=kw["flags"])
        return orig(gen, consts, acoef, Px, Py, **kw)

    hx = jnp.zeros(len(fields), jnp.float32)
    hy = jnp.asarray(fields, jnp.float32)
    jpt._pallas_gen_trace_2d = capture
    try:
        rays = jpt.pallas_gen_trace_conic(
            model, params, jnp.asarray(px), jnp.asarray(py), wls, Hx=hx,
            Hy=hy, block_rows=block_rows, final_prop=True, interpret=True)
    finally:
        jpt._pallas_gen_trace_2d = orig
    return dict(seen, rays=rays, px=px, py=py, wls=[float(w) for w in wls],
                fields=fields)


@pytest.fixture(scope="module")
def jax_k1():
    """JAX K1 runs shared by the tests below (interpreted Pallas is slow)."""
    return {
        "CookeTriplet": _jax_k1("CookeTriplet", 512, [0.0, 0.7, 1.0]),
        "DoubleGauss": _jax_k1("DoubleGauss", 256, [0.0, 0.7, 1.0]),
        "TIRSinglet": _jax_k1("TIRSinglet", 512, [0.0, 1.0]),
    }


def _port_tables(name, ref):
    _, tb = _builders(name)
    model, params = tb().build(device="cpu", dtype=F32)
    hy = torch.tensor(ref["fields"])
    gen, consts, acoef = tgt.gen_tables(model, params,
                                        torch.tensor(ref["wls"]),
                                        torch.zeros_like(hy), hy)
    return model, params, gen, consts, acoef


SYSTEMS = ("CookeTriplet", "DoubleGauss", "TIRSinglet")


@pytest.mark.parametrize("name", SYSTEMS)
def test_model_flags_match_jax(name, jax_k1):
    _, tb = _builders(name)
    model, params = tb().build(device="cpu")
    ours = tgt.model_flags(model, params)
    theirs = jax_k1[name]["flags"]
    assert ours == jax_flags_as_port(theirs)
    # sub-slice (a) systems: no sag kind, transform, aperture or coating,
    # and the JAX fields the port does not carry are their defaults
    for f in theirs:
        assert f[3:] == ("conic", 0, 0, False, False, "none", None, None)


@pytest.mark.parametrize("name", SYSTEMS)
def test_packed_tables_match_jax(name, jax_k1):
    ref = jax_k1[name]
    _, _, gen, consts, acoef = _port_tables(name, ref)
    assert gen.dtype == consts.dtype == acoef.dtype == F32
    assert consts.shape == ref["consts"].shape
    np.testing.assert_allclose(consts.numpy(), ref["consts"], rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(gen.numpy(), ref["gen"], rtol=1e-6, atol=1e-6)
    assert np.array_equal(acoef.numpy(), ref["acoef"])


def _hold(out, ref_rays, W, F, n):
    """Compare [8, W, F, n] plain outputs with the JAX rays."""
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    got = {k: out[i].numpy().reshape(-1) for i, k in enumerate(names)}
    exp = {k: np.asarray(getattr(ref_rays, k)).reshape(-1) for k in names}
    assert got["x"].shape == (W * F * n,)
    assert np.array_equal(np.isfinite(got["x"]), np.isfinite(exp["x"]))
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], exp[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    for k in ("L", "M", "N"):
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["opd"], exp["opd"], rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(got["intensity"], exp["intensity"], rtol=1e-6)
    return np.isfinite(got["x"])


@pytest.mark.parametrize("name", SYSTEMS)
def test_plain_k1_matches_interpreted_pallas(name, jax_k1):
    """gen_trace_plain on the JAX tables, and on the port's own tables,
    against the Pallas K1 in interpret mode."""
    ref = jax_k1[name]
    W, F = ref["consts"].shape[0], ref["gen"].shape[0]
    px, py = torch.tensor(ref["px"]), torch.tensor(ref["py"])
    n = px.shape[0]
    out_j = tgt.gen_trace_plain(torch.tensor(ref["gen"]),
                                torch.tensor(ref["consts"]),
                                torch.tensor(ref["acoef"]), px, py,
                                jax_flags_as_port(ref["flags"]),
                                final_prop=True)
    _hold(out_j, ref["rays"], W, F, n)
    model, params, gen, consts, acoef = _port_tables(name, ref)
    out_t = tgt.gen_trace_plain(gen, consts, acoef, px, py,
                                tgt.model_flags(model, params),
                                final_prop=True)
    valid = _hold(out_t, ref["rays"], W, F, n)
    if name == "TIRSinglet":
        assert 0.05 < 1 - valid.reshape(W, F, n)[0, 1].mean() < 0.6


def test_gen_trace_conic_shapes_and_order(jax_k1):
    """Scalar and vector field/wavelength calls squeeze like the JAX
    entry point, and stay in (wavelength, field, pupil) order."""
    ref = jax_k1["CookeTriplet"]
    model, params = tobj.CookeTriplet().build(device="cpu", dtype=F32)
    px, py = torch.tensor(ref["px"]), torch.tensor(ref["py"])
    n = px.shape[0]
    wls = torch.tensor(ref["wls"])
    hy = torch.tensor(ref["fields"])
    full = tgt.gen_trace_conic(model, params, px, py, wls, Hx=torch.zeros(3),
                               Hy=hy, final_prop=True)
    assert full.x.shape == (9 * n,)
    grid = full.x.reshape(3, 3, n)
    one = tgt.gen_trace_conic(model, params, px, py, wls[1], Hx=0.0,
                              Hy=float(hy[2]), final_prop=True)
    assert one.x.shape == (n,)
    assert torch.equal(one.x, grid[1, 2])
    fv = tgt.gen_trace_conic(model, params, px, py, wls[0], Hx=torch.zeros(3),
                             Hy=hy, final_prop=True)
    assert torch.equal(fv.x, grid[0].reshape(-1))
    assert torch.all(full.wavelength.reshape(3, 3, n)[2] == wls[2])


def test_engine_routing_on_cpu():
    model, params = tobj.CookeTriplet().build(device="cpu")
    assert kernel_eligible(model, 0.0, torch.zeros(3))
    assert resolve_engine(model, 0.0, 0.0, "cpu") == "eager"
    assert resolve_engine(model, 0.0, 0.0, "cuda") == "kernel"
    assert resolve_engine(model, 0.0, 0.0, "cuda", mode="eager") == "eager"
    assert not kernel_eligible(model, 0.0, torch.zeros(2, 2))
    before = tgt.gen_trace_cuda.launches
    px, py = (torch.tensor(a, dtype=torch.float64) for a in _pupil(64))
    with engine_override("kernel"):     # CPU tensors: the plain version
        rk = final_rays(model, params, 0.0, 1.0, 0.55, px, py)
    re_ = final_rays(model, params, 0.0, 1.0, 0.55, px, py)
    assert rk.x.dtype == F32 and re_.x.dtype == torch.float64
    np.testing.assert_allclose(rk.x.numpy(), re_.x.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert tgt.gen_trace_cuda.launches == before


def test_ineligible_systems_are_refused():
    """An asphere with more terms than the kernels' coefficient table
    (``MAX_TERMS``) keeps a system off the kernel; the aperture, the tilt
    and (since sub-slice (e)) a Fresnel coating no longer do."""
    lens = TOptic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=20.0, thickness=3.0, material="N-BK7",
                     is_stop=True, aperture=8.0, coating="fresnel",
                     surface_type="even_asphere",
                     coefficients=[0.0] * (tgt.MAX_TERMS + 1))
    lens.add_surface(index=2, radius=-20.0, thickness=30.0, ry=0.01)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 5.0)
    lens.add_field(y=0.0)
    lens.add_wavelength(0.55)
    model, params = lens.build(device="cpu")
    assert not tgt.supports_model(model)
    with pytest.raises(ValueError):
        resolve_engine(model, 0.0, 0.0, "cpu", mode="kernel")
    with pytest.raises(ValueError):
        tgt.gen_trace_conic(model, params, torch.zeros(4), torch.zeros(4),
                            0.55)
    # the eager trace handles apertures and tilts
    rays = final_rays(model, params, 0.0, 0.0, 0.55,
                      torch.linspace(-1, 1, 9, dtype=torch.float64),
                      torch.zeros(9, dtype=torch.float64))
    assert torch.isfinite(rays.x).all()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tgt.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(tgt, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tgt._find_nvcc()


def test_unsupported_device_raises():
    model, params = tobj.CookeTriplet().build(device="cpu", dtype=F32)
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no version for device"):
        tgt.gen_trace_conic(model, params, t, t, 0.55)


@pytest.mark.parametrize("fault", [None, "position", "direction",
                                   "intensity", "lost_mask"])
def test_chip_smoke_comparison(fault):
    """The kernel-vs-plain check of chip_smoke.py, on plain outputs: equal
    outputs pass, and a fault just outside each tolerance is caught."""
    from chip_smoke import compare
    model, params = tobj.TIRSinglet().build(device="cpu", dtype=F32)
    hy = torch.tensor([0.0, 1.0])
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    px, py = (torch.tensor(a) for a in _pupil(256))
    out = tgt.gen_trace_plain(gen, consts, acoef, px, py,
                              tgt.model_flags(model, params), True)
    lost = torch.isnan(out[0])
    assert lost.any() and not lost.all()
    bad = out.clone()
    i = int(torch.nonzero(~lost.reshape(-1))[0])
    view = bad.reshape(8, -1)
    if fault == "position":
        view[0, i] += 2e-4 + 2e-4 * view[0, i].abs() + 1e-3
    elif fault == "direction":
        view[3, i] += 2e-5
    elif fault == "intensity":
        view[6, i] *= 1 - 1e-6
    elif fault == "lost_mask":
        view[:6, i] = torch.nan
    if fault is None:
        err, lost_share = compare(bad, out, px, py, "same")
        assert err == 0.0 and lost_share == float(lost.float().mean())
    else:
        with pytest.raises(RuntimeError, match="check failed"):
            compare(bad, out, px, py, fault)


def test_chip_smoke_k1_floor():
    """``k1_float32_floor`` (K1's narrow contract) on the TIR singlet's
    plain outputs at 256 rays: at least the float32 plain version's own
    distance from float64 on every element of a valid ray, above it
    somewhere (the runs at the one-ulp neighbours of the pupil samples),
    finite, and 0 on the lost rays."""
    from chip_smoke import k1_float32_floor
    model, params = tobj.TIRSinglet().build(device="cpu", dtype=F32)
    hy = torch.tensor([0.0, 1.0])
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    px, py = (torch.tensor(a) for a in _pupil(256))
    flags = tgt.model_flags(model, params)
    out = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags, True)
    out64 = tgt.gen_trace_plain(*(t.double() for t in (gen, consts, acoef,
                                                        px, py)), flags, True)
    floor = k1_float32_floor(tgt, gen, consts, acoef, px, py, flags, out,
                             out64)
    assert floor.shape == out.shape and floor.dtype == F32
    assert bool(torch.isfinite(floor).all())
    lost = torch.isnan(out[0])
    own = (out.double() - out64).abs().float()
    keep = [0, 1, 2, 3, 4, 5, 7]
    assert bool((floor[keep][:, ~lost] >= own[keep][:, ~lost]).all())
    assert bool((floor[keep][:, ~lost] > own[keep][:, ~lost]).any())
    assert bool((floor[keep][:, lost] == 0).all())


@pytest.mark.parametrize("inside", [True, False])
def test_chip_smoke_comparison_floor(inside):
    """``compare``'s per-element float32 floor (K1's narrow contract): a
    position fault beyond the bare tolerance passes within twice the
    element's floor and is caught just outside it."""
    from chip_smoke import compare
    model, params = tobj.TIRSinglet().build(device="cpu", dtype=F32)
    hy = torch.tensor([0.0, 1.0])
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    px, py = (torch.tensor(a) for a in _pupil(256))
    out = tgt.gen_trace_plain(gen, consts, acoef, px, py,
                              tgt.model_flags(model, params), True)
    lost = torch.isnan(out[0])
    i = int(torch.nonzero(~lost.reshape(-1))[0])
    floor = torch.zeros_like(out)
    floor.reshape(8, -1)[0, i] = 1e-3
    bad = out.clone()
    bound = 2e-4 + 2e-4 * float(out.reshape(8, -1)[0, i].abs())
    bad.reshape(8, -1)[0, i] += bound + (2e-3 - 1e-5 if inside else 2e-3
                                         + 1e-5)
    if inside:
        compare(bad, out, px, py, "floor", floor=floor)
    else:
        with pytest.raises(RuntimeError, match="float32 floor"):
            compare(bad, out, px, py, "floor", floor=floor)
    with pytest.raises(RuntimeError, match="check failed"):
        compare(bad, out, px, py, "no floor")


@pytest.mark.parametrize("fault", [None, "x", "y", "z", "L", "M", "N",
                                   "opd"])
def test_chip_smoke_float64_check(fault):
    """Contract (ii) of K1's narrow instance in chip_smoke.py
    (``float64_distance``), on the TIR singlet's plain outputs in float32
    and float64 at 256 rays: outputs equal to the float32 plain version's
    pass, and a fault of one ray's output just outside twice the float32
    plain version's largest distance from float64 is caught."""
    from chip_smoke import K1_OUTPUTS, float64_distance
    model, params = tobj.TIRSinglet().build(device="cpu", dtype=F32)
    hy = torch.tensor([0.0, 1.0])
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    px, py = (torch.tensor(a) for a in _pupil(256))
    flags = tgt.model_flags(model, params)
    out = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags, True)
    out64 = tgt.gen_trace_plain(*(t.double() for t in (gen, consts, acoef,
                                                        px, py)), flags, True)
    lost = torch.isnan(out[0])
    assert lost.any() and not lost.all()
    if fault is None:
        dist = float64_distance(out.clone(), out, out64, "same")
        assert set(dist) == set(K1_OUTPUTS) - {"intensity"}
        assert all(a == b == c for a, b, c in dist.values())
        assert dist["x"][1] > 0.0
        return
    j = K1_OUTPUTS.index(fault)
    ok = ~(lost | torch.isnan(out64[0]))
    dp = float((out[j].double() - out64[j])[ok].abs().max())
    bad = out.clone()
    i = int(torch.nonzero(ok.reshape(-1))[0])
    # the first float32 farther from float64 than twice the float32 plain
    # version's largest distance
    v64 = out64.reshape(8, -1)[j, i]
    v = (v64 + 2 * dp).float()
    while float(v.double() - v64) <= 2 * dp:
        v = torch.nextafter(v, torch.tensor(math.inf))
    bad.reshape(8, -1)[j, i] = v
    with pytest.raises(RuntimeError, match="more than twice"):
        float64_distance(bad, out, out64, fault)
    # a float32 floor (k1_float32_floor) above half the fault's distance
    # on any ray admits it
    floor = torch.zeros_like(out)
    floor.reshape(8, -1)[j, i] = float(v.double() - v64) / 2 * (1 + 1e-6)
    dist = float64_distance(bad, out, out64, fault, floor)
    assert dist[fault][2] > dist[fault][1]


def _tir_plain(n=256, seed=14):
    model, params = tobj.TIRSinglet().build(device="cpu", dtype=F32)
    hy = torch.tensor([0.0, 1.0])
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    px, py = (torch.tensor(a) for a in _pupil(n, seed))
    return gen, consts, acoef, px, py, tgt.model_flags(model, params)


@pytest.mark.parametrize("fault", [None, "kept", "lost"])
def test_chip_smoke_grad_masks(fault):
    """The lost-ray masks of K2's narrow instance in chip_smoke.py
    (``grad_masks``), with K1's plain version on the CPU in the place of K1
    narrow: the same masks pass with no ray differing and every ray held
    per ray, lost ones included; one ray that K1 keeps and the plain
    version loses, or the other way round, exceeds the allowance of 1e-6
    of the rays (none at 512 ray-planes)."""
    from types import SimpleNamespace

    from chip_smoke import grad_masks
    args = _tir_plain()
    out = tgt.gen_trace_plain(*args, True)
    lost = torch.isnan(out[0])
    assert lost[0, 1].any() and not lost[0, 1].all()
    bad = out.clone()
    if fault == "kept":
        i = int(torch.nonzero(lost[0, 1])[0])
        bad[:, 0, 1, i] = 0.5                  # K1 keeps a lost ray
    elif fault == "lost":
        i = int(torch.nonzero(~lost[0, 1])[0])
        bad[:6, 0, 1, i] = torch.nan           # K1 loses a kept ray
    stub = SimpleNamespace(gen_trace_cuda=lambda *a: bad,
                           gen_trace_plain=tgt.gen_trace_plain)
    if fault is None:
        lost_k, keep, n = grad_masks(stub, *args, "same")
        assert n == 0 and torch.equal(lost_k, lost)
        assert bool(keep.all())
    else:
        with pytest.raises(RuntimeError, match="masks differ"):
            grad_masks(stub, *args, fault)


def test_chip_smoke_margin_search():
    """``margin_pupils`` in chip_smoke.py, with K1's plain version on the
    CPU in the place of K1 narrow: on the TIR singlet it finds, for each of
    three Px, the float32 threshold of Py where total reflection at Hy 1
    begins (near Py 0.62 on axis), two adjacent float32 values of which one
    keeps the ray and the other loses it, at the middle of each window of
    2 MARGIN_ULPS values; the plain version's mask standing in for K1
    narrow's, no ray of the windows differs between the two."""
    from types import SimpleNamespace

    from chip_smoke import MARGIN_ULPS, grad_masks, margin_pupils
    gen, consts, acoef, _, _, flags = _tir_plain()

    def lost(px, py):
        return torch.isnan(tgt.gen_trace_plain(
            gen, consts, acoef, torch.from_numpy(px), torch.from_numpy(py),
            flags, True)[0]).numpy()
    px, py, f, n = margin_pupils(lost, 2, [0.0, 0.3, 0.6], 1.0)
    on_tir = f.reshape(n, -1)[:, 0] == 1
    assert n == len(f) // (2 * MARGIN_ULPS) and int(on_tir.sum()) == 3
    mask = lost(px, py)[0, f, np.arange(len(f))].reshape(n, -1)
    below, above = mask[:, MARGIN_ULPS - 1], mask[:, MARGIN_ULPS]
    assert (below != above).all()
    pyw = py.reshape(n, -1)
    assert (np.nextafter(pyw[:, MARGIN_ULPS - 1], np.float32(np.inf))
            == pyw[:, MARGIN_ULPS]).all()
    first = pyw[on_tir][0, MARGIN_ULPS]        # Px 0, the first lost Py
    assert 0.6 < first < 0.65 and mask[on_tir][0, MARGIN_ULPS]
    stub = SimpleNamespace(gen_trace_cuda=tgt.gen_trace_plain,
                           gen_trace_plain=tgt.gen_trace_plain)
    _, keep, n_differ = grad_masks(stub, gen, consts, acoef,
                                   torch.from_numpy(px),
                                   torch.from_numpy(py), flags, "margins")
    assert n_differ == 0 and bool(keep.all())


@pytest.mark.parametrize("fault", [None, "kept_zero", "kept_nan",
                                   "none_kept_and_lost"])
def test_chip_smoke_mask_identity_converse(fault):
    """The converse of ``grad_mask_identity`` in chip_smoke.py (``kept``),
    on the plain version's CPU outputs for the TIR singlet with
    cotangents on Hy 1 only: every ray that K1 keeps there gets finite
    pupil cotangents, not both 0, and lost rays 0. A kept ray whose pupil
    cotangents are 0 (what a K2 that took the bit-exact forward's mask gave
    a ray that K1 narrow keeps and that forward loses) or NaN is caught, and
    so is a set with no kept ray ("holds nothing")."""
    from chip_smoke import grad_mask_identity
    from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
    args = _tir_plain()
    n = args[3].shape[0]
    lost = torch.isnan(tgt.gen_trace_plain(*args, True)[0])
    cot = torch.tensor(np.random.default_rng(16).normal(
        size=(8, 1, 2, n)).astype(np.float32))
    cot[:, :, 0] = 0.0
    cot[6] = 0.0
    for j in (0, 1, 2, 3, 4, 5, 7):
        cot[j][lost] = torch.nan
    g = list(gen_trace_bwd_plain(*args[:5], cot.nan_to_num(0.0), args[5],
                                 True))
    gone = lost[0, 1]
    kept = ~gone
    i = int(torch.nonzero(kept)[0])
    if fault == "kept_zero":
        g[3], g[4] = g[3].clone(), g[4].clone()
        g[3][i] = g[4][i] = 0.0
    elif fault == "kept_nan":
        g[3] = g[3].clone()
        g[3][i] = torch.nan
    elif fault == "none_kept_and_lost":
        kept = torch.zeros_like(kept)
    if fault is None:
        grad_mask_identity(g, gone, "plain", kept)
    else:
        with pytest.raises(RuntimeError, match="check failed"):
            grad_mask_identity(g, gone, fault, kept)


def _ulps(x, n, to):
    """``x`` moved by ``n`` float32 ulps toward ``to``."""
    for _ in range(n):
        x = torch.nextafter(x, torch.full_like(x, to))
    return x


def _stand_in_narrow(fault=None):
    """Stand-ins for K1 and K2 narrow in ``narrow_margin_check``, on the
    CPU. K1: the float32 plain version's outputs, and on the rays that it
    loses and the plain version on float64 copies keeps 3 float32 ulps of
    Py nearer the axis, those float64 outputs rounded to float32 (at the
    TIR singlet's margins the float32 and float64 masks agree on every
    float32 Py, so K1 narrow's own rounding stands in as a shift). K2: the
    float32 plain version's pupil cotangents and sums on the first, and
    the float64 version's at K1's forward on the second, as K2 narrow
    differentiates a ray that K1 narrow keeps and the bit-exact forward
    loses at K1 narrow's own. ``fault`` plants an error on the second:
    their dPx and dPy negated ("sign") or tripled ("scale"), the rays
    differentiated 8 more ulps away ("tape": a forward other than K1's),
    their share of the sums negated ("sums")."""
    from types import SimpleNamespace

    from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain

    def split(gen, consts, acoef, px, py, flags, final_prop):
        o32 = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags,
                                  final_prop)
        o64 = tgt.gen_trace_plain(*(t.double() for t in (
            gen, consts, acoef, px, _ulps(py, 3, 0.0))), flags, final_prop)
        return o32, o64, torch.isnan(o32[0]) & ~torch.isnan(o64[0])

    def k1(gen, consts, acoef, px, py, flags, final_prop):
        o32, o64, own = split(gen, consts, acoef, px, py, flags, final_prop)
        return torch.where(own, o64.float(), o32)

    def k2(gen, consts, acoef, px, py, cot, flags, final_prop):
        own = split(gen, consts, acoef, px, py, flags, final_prop)[2]
        c = cot.nan_to_num(0.0)
        own = (own & (c != 0).any(0)).any(0).any(0)        # [n]
        rest = gen_trace_bwd_plain(gen, consts, acoef, px, py, c * ~own,
                                   flags, final_prop)
        py_own = _ulps(py, 3 + (8 if fault == "tape" else 0), 0.0)
        g = gen_trace_bwd_plain(*(t.double() for t in (gen, consts, acoef,
                                                        px, py_own)),
                                (c * own).double(), flags, final_prop)
        g = [t.float() for t in g]
        if fault == "sign":
            g[3], g[4] = -g[3], -g[4]
        elif fault == "scale":
            g[3], g[4] = 3 * g[3], 3 * g[4]
        elif fault == "sums":
            g[:3] = [-t for t in g[:3]]
        return tuple(a + b for a, b in zip(rest, g))

    return (SimpleNamespace(gen_trace_cuda=k1,
                            gen_trace_plain=tgt.gen_trace_plain),
            SimpleNamespace(gen_trace_bwd_cuda=k2,
                            gen_trace_bwd_plain=gen_trace_bwd_plain))


@pytest.fixture(scope="module")
def tir_margin_set():
    """The TIR singlet's margin set (``margin_set`` in chip_smoke.py) with
    the stand-in K1 of ``_stand_in_narrow``."""
    from chip_smoke import margin_set
    gen, consts, acoef, _, _, flags = _tir_plain()
    k1, _ = _stand_in_narrow()
    pxv = [0.0, 0.3, 0.6]
    px, py, f, _, _ = margin_set(k1, gen, consts, acoef, flags, pxv, 1.0)
    return gen, consts, acoef, flags, px, py, f, pxv


@pytest.mark.parametrize("fault", [None, "sign", "scale", "tape", "sums"])
def test_chip_smoke_own_ray_check(fault, tir_margin_set):
    """``narrow_margin_check`` in chip_smoke.py on the TIR singlet's margin
    set, with ``_stand_in_narrow``'s K1 and K2 (the float32 plain version,
    and the float64 one on the rays that only it keeps): the rays that K1
    keeps and the float32 plain version loses are held against the float64
    version at the points that match K1's outputs (``own_ray_check``,
    within twice ``margin_floor``); a correct K2 passes, and each planted
    fault on those rays is caught: their pupil cotangents with the sign
    flipped or tripled, a forward 8 ulps of Py away, their share of the
    sums negated."""
    from chip_smoke import narrow_margin_check
    gen, consts, acoef, flags, px, py, f, pxv = tir_margin_set
    k1, k2 = _stand_in_narrow(fault)
    args = (k1, k2, gen, consts, acoef, flags, px, py, f, fault, 2, pxv, 1.0)
    if fault is None:
        out = narrow_margin_check(*args)
        assert out["kept_lost_by_plain"] > 0
        assert out["own_matched_worst"] <= 2 * out["own_floor"]
    else:
        match = ("of the rays that K1 narrow keeps" if fault == "sums" else
                 "pupil cotangents of a ray that K1 narrow keeps")
        with pytest.raises(RuntimeError, match=match):
            narrow_margin_check(*args)


@pytest.mark.parametrize("on_kept", [False, True])
def test_chip_smoke_grad_comparison_keep(on_kept):
    """``compare_grads(keep=)``: K2's narrow instance is held per ray only
    on the rays whose lost-ray masks (K1 narrow's, its own) and the plain
    version's agree. A fault
    of 1% of max|dPx| on a ray outside ``keep`` passes; on a ray inside it
    is caught."""
    from chip_smoke import compare_grads
    from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
    args = _tir_plain()
    n = args[3].shape[0]
    cot = torch.tensor(np.random.default_rng(15).normal(
        size=(8, 1, 2, n)).astype(np.float32))
    ref = gen_trace_bwd_plain(*args[:5], cot, args[5], True)
    keep = torch.ones(n, dtype=torch.bool)
    keep[::7] = False
    i = int(torch.nonzero(keep if on_kept else ~keep)[0])
    bad = [t.clone() for t in ref]
    bad[3][i] += 0.01 * float(ref[3].abs().max())
    if on_kept:
        with pytest.raises(RuntimeError, match="dPx exceeds"):
            compare_grads(bad, ref, "kept", keep=keep)
    else:
        compare_grads(bad, ref, "not kept", keep=keep)
        with pytest.raises(RuntimeError, match="dPx exceeds"):
            compare_grads(bad, ref, "every ray")
