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
        "CookeTriplet": _jax_k1("CookeTriplet", 1024, [0.0, 0.7, 1.0]),
        "DoubleGauss": _jax_k1("DoubleGauss", 256, [0.0, 0.7, 1.0]),
        "TIRSinglet": _jax_k1("TIRSinglet", 512, [0.0, 1.0]),
    }


def _port_tables(name, ref):
    _, tb = _builders(name)
    model, params = tb().build(dtype=F32)
    hy = torch.tensor(ref["fields"])
    gen, consts, acoef = tgt.gen_tables(model, params,
                                        torch.tensor(ref["wls"]),
                                        torch.zeros_like(hy), hy)
    return model, params, gen, consts, acoef


SYSTEMS = ("CookeTriplet", "DoubleGauss", "TIRSinglet")


@pytest.mark.parametrize("name", SYSTEMS)
def test_model_flags_match_jax(name, jax_k1):
    _, tb = _builders(name)
    model, params = tb().build()
    ours = tgt.model_flags(model, params)
    theirs = jax_k1[name]["flags"]
    assert ours == tuple(tuple(f[:3]) for f in theirs)
    # the rest of the JAX flags are the defaults of sub-slice (a)
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
                                tuple(tuple(f[:3]) for f in ref["flags"]),
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
    model, params = tobj.CookeTriplet().build(dtype=F32)
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
    model, params = tobj.CookeTriplet().build()
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
    lens = TOptic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=20.0, thickness=3.0, material="N-BK7",
                     is_stop=True, aperture=8.0)
    lens.add_surface(index=2, radius=-20.0, thickness=30.0, ry=0.01)
    lens.add_surface(index=3)
    lens.set_aperture("EPD", 5.0)
    lens.add_field(y=0.0)
    lens.add_wavelength(0.55)
    model, params = lens.build()
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
    model, params = tobj.CookeTriplet().build(dtype=F32)
    t = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no version for device"):
        tgt.gen_trace_conic(model, params, t, t, 0.55)


@pytest.mark.parametrize("fault", [None, "position", "direction",
                                   "intensity", "lost_mask"])
def test_chip_smoke_comparison(fault):
    """The kernel-vs-plain check of chip_smoke.py, on plain outputs: equal
    outputs pass, and a fault just outside each tolerance is caught."""
    from chip_smoke import compare
    model, params = tobj.TIRSinglet().build(dtype=F32)
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
