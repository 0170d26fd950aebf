"""The PyTorch port's core modules against the JAX package, on the CPU.

Pupil distributions are numpy-made in both packages and must agree bit for
bit; refractive indices, transforms and ray operations are held at float64
to rtol 1e-12 (the same formulas in the same order; the slack covers pow and
transcendental implementations that differ in the last bits).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optiland_pr_tpu.core import distributions as jdist
from optiland_pr_tpu.core import rays as jrays
from optiland_pr_tpu.core import transforms as jtf
from optiland_pr_tpu.materials import catalog as jcat
from optiland_pr_tpu.materials import dispersion as jdisp
from optiland_pr_tpu_torch.core import distributions as tdist
from optiland_pr_tpu_torch.core import rays as trays
from optiland_pr_tpu_torch.core import transforms as ttf
from optiland_pr_tpu_torch.core.safe_math import nan_sqrt, safe_div, safe_sqrt
from optiland_pr_tpu_torch.materials import catalog as tcat
from optiland_pr_tpu_torch.materials import dispersion as tdisp
from optiland_pr_tpu_torch.materials.base import interp
from optiland_pr_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("kind,n", [
    ("line_x", 7), ("line_y", 8), ("positive_line_x", 5),
    ("positive_line_y", 6), ("random", 257), ("uniform", 9),
    ("hexapolar", 6), ("cross", 7), ("cross", 8), ("ring", 12),
    ("gaussian_quad", 4)])
def test_distributions_bit_equal(kind, n):
    jx, jy = jdist.generate_distribution(kind, n)
    tx, ty = tdist.generate_distribution(kind, n, dtype=F64)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jy), ty.numpy())


@pytest.mark.parametrize("rings,sym", [(3, False), (6, True)])
def test_gaussian_quad_weights_bit_equal(rings, sym):
    assert np.array_equal(np.asarray(jdist.gaussian_quad_weights(rings, sym)),
                          tdist.gaussian_quad_weights(rings, sym).numpy())


_GLASSES = [("SK16", None), ("F2", "schott"), ("N-SSK2", None),
            ("N-SK2", None), ("F5", "schott"), ("N-SK16", None),
            ("N-SF11", None)]


@pytest.mark.parametrize("name,ref", _GLASSES)
def test_refractive_index_matches_jax(name, ref):
    jm, jp = jcat.glass(name, ref)
    tm, tp = tcat.glass(name, ref)
    assert type(jm).__name__ == type(tm).__name__
    tp = params_from_numpy(tp, dtype=F64)
    wls = np.array([0.4, 0.4861, 0.55, 0.5876, 0.6563, 0.8])
    n_j = np.asarray(jm.n(jp, jnp.asarray(wls)))
    n_t = tm.n(tp, _t(wls)).numpy()
    np.testing.assert_allclose(n_t, n_j, rtol=1e-12, atol=0)
    for w in (0.48, 0.55):                     # scalar wavelengths, as traced
        np.testing.assert_allclose(float(tm.n(tp, w)), float(jm.n(jp, w)),
                                   rtol=1e-12, atol=0)
    assert jm.absorbing == tm.absorbing
    k_j = np.asarray(jm.k(jp, jnp.asarray(wls)))
    np.testing.assert_allclose(tm.k(tp, _t(wls)).numpy(), k_j, rtol=1e-12,
                               atol=1e-30)


def test_thermal_index_matches_jax():
    jm, jp = jcat.glass("N-SSK2")
    tm, tp = tcat.glass("N-SSK2")
    assert tm.has_thermal
    tp = params_from_numpy(tp, dtype=F64)
    w = np.array([0.45, 0.6])
    np.testing.assert_allclose(
        tm.n(tp, _t(w), temperature=40.0, pressure=0.9).numpy(),
        np.asarray(jm.n(jp, jnp.asarray(w), temperature=40.0, pressure=0.9)),
        rtol=1e-12)


@pytest.mark.parametrize("fid,coeffs", [
    (1, [0.0, 1.03, 0.077, 0.23, 0.14, 1.01, 10.2]),
    (2, [0.0, 1.03, 0.006, 0.23, 0.02, 1.01, 103.5]),
    (3, [2.27, -0.009, 2.0, 0.011, -2.0]),
    (4, [2.1, 0.2, 2.0, 0.3, 2.0, 0.1, 2.0, 4.0, 2.0, 0.01, 1.0]),
    (5, [1.5, 0.004, -2.0, 1e-4, -4.0]),
    (6, [5e-5, 0.02, 140.0, 0.001, 60.0]),
    (7, [1.5, 0.01, 1e-3, -1e-3, 1e-5]),
    (8, [0.3, 0.02, 0.01, -1e-3]),
    (9, [2.2, 0.02, 0.03, 0.01, 1.2, 0.04])])
def test_dispersion_formulas_match_jax(fid, coeffs):
    w = np.array([0.45, 0.55, 0.7])
    np.testing.assert_allclose(
        tdisp.evaluate_formula(fid, _t(coeffs), _t(w)).numpy(),
        np.asarray(jdisp.evaluate_formula(fid, jnp.asarray(coeffs),
                                          jnp.asarray(w))), rtol=1e-12)


def test_nair_edlen_and_interp_match_jax():
    w = np.linspace(0.4, 0.8, 5)
    np.testing.assert_allclose(tdisp.nair_edlen(_t(w), 25.0, 0.95).numpy(),
                               np.asarray(jdisp.nair_edlen(jnp.asarray(w),
                                                           25.0, 0.95)),
                               rtol=1e-14)
    xp = np.array([0.3, 0.5, 0.5, 0.9])
    fp = np.array([1.0, 2.0, 3.0, 5.0])
    x = np.array([0.1, 0.3, 0.4, 0.5, 0.7, 0.9, 1.2])
    np.testing.assert_allclose(interp(_t(x), _t(xp), _t(fp)).numpy(),
                               np.asarray(jnp.interp(x, xp, fp)), rtol=1e-15)


def test_catalog_resolution_matches_jax():
    for name, ref in _GLASSES + [("BK7", None), ("SF15", "hikari")]:
        assert tcat.find_material(name, ref) == jcat.find_material(name, ref)
    assert tcat.catalog_names() == jcat.catalog_names()
    for spec in (None, "air", 1.6, ("abbe", 1.6, 40.0)):
        tm, tp = tcat.resolve_material(spec)
        jm, jp = jcat.resolve_material(spec)
        assert type(tm).__name__ == type(jm).__name__
        n_t = tm.n(params_from_numpy(tp, dtype=F64), 0.55)
        np.testing.assert_allclose(float(n_t), float(jm.n(jp, 0.55)),
                                   rtol=1e-12)


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    ang = rng.uniform(-0.3, 0.3, 3)
    v = rng.normal(size=(6, 16))
    Rj = jtf.rotation_matrix(*ang)
    Rt = ttf.rotation_matrix(*[_t(a) for a in ang])
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-14,
                               atol=1e-16)
    t = (0.1, -0.2, 5.0)
    loc_j = jtf.localize(Rj, *t, *v)
    loc_t = ttf.localize(Rt, *t, *[_t(a) for a in v])
    for a, b in zip(loc_t, loc_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-14)
    back = ttf.globalize(Rt, *t, *loc_t)
    for a, b in zip(back, v):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-12)


def test_ray_operations_match_jax():
    rng = np.random.default_rng(5)
    n = 64
    d = rng.normal(size=(3, n)) * [[0.3], [0.3], [1.0]]
    d[2] = np.abs(d[2])
    d /= np.linalg.norm(d, axis=0)
    nrm = rng.normal(size=(3, n)) * [[0.5], [0.5], [1.0]]
    nrm /= np.linalg.norm(nrm, axis=0)
    pos = rng.normal(size=(3, n))
    jr = jrays.new_rays(*pos, *d, wavelength=0.55)
    tr = trays.new_rays(*[_t(a) for a in pos], *[_t(a) for a in d],
                        wavelength=0.55, dtype=F64)
    for n1, n2 in ((1.0, 1.5), (1.8, 1.0)):      # the second one has TIR
        rj, okj = jrays.refract(jr, *nrm, n1, n2)
        rt, okt = trays.refract(tr, *[_t(a) for a in nrm], n1, n2)
        assert np.array_equal(okt.numpy(), np.asarray(okj))
        for f in ("L", "M", "N"):
            np.testing.assert_allclose(getattr(rt, f).numpy(),
                                       np.asarray(getattr(rj, f)),
                                       rtol=1e-13, atol=1e-15)
    rj, _ = jrays.reflect(jr, *nrm)
    rt, _ = trays.reflect(tr, *[_t(a) for a in nrm])
    np.testing.assert_allclose(rt.N.numpy(), np.asarray(rj.N), atol=1e-15)
    pj = jrays.propagate(jr, 2.5, alpha=0.01)
    pt = trays.propagate(tr, 2.5, alpha=0.01)
    np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=1e-15)
    np.testing.assert_allclose(pt.intensity.numpy(),
                               np.asarray(pj.intensity), rtol=1e-14)
    blocked = _t(pos[0]) > 0
    ct = trays.clip(tr, blocked)
    assert torch.all(ct.intensity[blocked] == 0)
    assert torch.all(ct.intensity[~blocked] == 1)


def test_safe_math_guards():
    x = torch.tensor([-1.0, 0.0, 4.0], dtype=F64, requires_grad=True)
    s = safe_sqrt(x)
    assert s.tolist() == [0.0, 0.0, 2.0]
    s.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert np.isnan(nan_sqrt(x.detach())[0].item())
    den = torch.tensor([0.0, -1e-20, 2.0], dtype=F64)
    q = safe_div(torch.ones_like(den), den)
    assert torch.isfinite(q).all() and q[1] < 0


def test_params_converter_round_trip():
    from optiland_pr_tpu.samples.objectives import CookeTriplet as JCooke
    from optiland_pr_tpu_torch.samples import CookeTriplet
    import jax
    _, jp = JCooke().build()
    host = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(host, dtype=F64)
    back = params_to_numpy(tp)
    leaves_h = jax.tree_util.tree_leaves(host)
    leaves_b = jax.tree_util.tree_leaves(back)
    assert len(leaves_h) == len(leaves_b)
    for a, b in zip(leaves_h, leaves_b):
        assert np.array_equal(a, b)
    # the port's builder makes the same structure, leaf for leaf
    _, own = CookeTriplet().build(dtype=F64)
    assert (jax.tree_util.tree_structure(params_to_numpy(own))
            == jax.tree_util.tree_structure(back))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(own)),
                    leaves_b):
        assert np.array_equal(a, b)
    f32 = params_from_numpy(host, dtype=torch.float32)
    assert f32["surfaces"][1]["geom"]["radius"].dtype == torch.float32
