"""The port's freeform and Fresnel sags (K1/K2 sub-slice (c)) against the
JAX package, on the CPU: the XY polynomial, Chebyshev, biconic, toroidal
(finite and infinite rotation radius), Zernike (standard, fringe and Noll),
the Forbes Qbfs and Q2D and the two thin Fresnel surfaces, in the
geometries, ``Optic``, the eager trace, K1/K2's plain versions and the
optimizer.

Systems (``tests/_torch_systems.py``): the JAX kernel suite's freeform
singlets (tests/test_pallas_widened.py:280-312, the Forbes ones among them),
the JAX bench's Chebyshev and Zernike singlets, the 1.5 m zoned
concentrator, a stack of three Newton sags and a stack of both Fresnel
kinds and both Forbes kinds.

Tolerances:
- geometry sags and slopes, float64 against float64: rtol 1e-10 with atol
  1e-13 (the same expressions; the port's Zernike slope is in closed form
  where the JAX package takes jax.jvp);
- eager traces, float64: positions atol 1e-9 mm, directions 1e-12, as
  tests/test_torch_widened.py (the concentrator's 1.5 m scale: 1e-7 mm);
- K1's plain version (float32) against the JAX trace (float64 XLA) and
  against the Pallas K1 in interpret mode: positions rtol 1e-4 with atol
  5e-4 mm, OPD rtol 1e-5 with atol 2e-3 (tests/test_pallas_widened.py:
  329-337), directions atol 1e-5, lost-ray masks equal;
- autograd through K1's plain version against the Pallas K2 in interpret
  mode: rtol 5e-3 with atol 5e-3 x max|g| (tests/test_pallas_grad.py:
  132-148, ``north_star_sags``);
- the Forbes coefficients through the basis change, float32 products of
  float32 matrices in another summation order: rtol 1e-6 (the other sags'
  coefficients equal);
- the Zernike sag of K1's plain version against the JAX geometry, float64:
  rtol 1e-10 with atol 1e-13;
- the optimization problem, float64: value rtol 1e-8, gradient rtol 1e-6
  with atol 1e-9 x max|g| (sums of many products reordered).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu.optimize as jopt
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.optimize as topt
from _torch_systems import (FREEFORM_KW, freeform_builders,
                            jax_flags_as_port, jax_tables)
from optiland_pr_tpu.geometry.extras import ZernikeSag as JZernikeSag
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
from optiland_pr_tpu_torch.geometry import ZernikeSag as TZernikeSag
from optiland_pr_tpu_torch.kernels.gen_grad import gen_trace_bwd_plain
from optiland_pr_tpu_torch.trace.engine import engine_override, final_rays
from optiland_pr_tpu_torch.utils.convert import (params_from_numpy,
                                                 params_to_numpy)

F32, F64 = torch.float32, torch.float64
SINGLETS = tuple(f"singlet:{k}" for k in FREEFORM_KW)
CSRC = Path(tgt.__file__).resolve().parent / "csrc"
# hexapolar rings of the float64 JAX traces: one shape of bundle, so their
# eager operations compile once for the file
RINGS = 3


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _hexapolar(rings):
    pts = [(0.0, 0.0)]
    for i in range(1, rings + 1):
        r = i / rings
        for j in range(6 * i):
            th = 2 * np.pi * j / (6 * i)
            pts.append((r * np.cos(th), r * np.sin(th)))
    return np.asarray(pts).T


def _hold_k1(out, ref, what):
    """K1's [8, 1, F, n] outputs against the reference's (x, y, z, L, M, N,
    intensity, opd), each [F * n]: the JAX suite's kernel tolerances."""
    got = {k: out[i].reshape(-1).numpy() for i, k in
           enumerate(("x", "y", "z", "L", "M", "N", "intensity", "opd"))}
    lost = ~np.isfinite(np.asarray(ref["x"]))
    assert np.array_equal(~np.isfinite(got["x"]), lost), what
    ok = ~lost
    for k, rtol, atol in (("x", 1e-4, 5e-4), ("y", 1e-4, 5e-4),
                          ("z", 1e-4, 5e-4), ("L", 0, 1e-5), ("M", 0, 1e-5),
                          ("N", 0, 1e-5), ("opd", 1e-5, 2e-3),
                          ("intensity", 1e-6, 0)):
        np.testing.assert_allclose(got[k][ok], np.asarray(ref[k])[ok],
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _port_tables(tlens, fields, dtype=F32):
    model, params = tlens.build(device="cpu", dtype=dtype)
    hy = torch.tensor(fields, dtype=dtype)
    wl = params["wavelengths"][model.primary_wavelength_idx:][:1]
    gen, consts, acoef = tgt.gen_tables(model, params, wl,
                                        torch.zeros_like(hy), hy)
    return model, params, gen, consts, acoef, tgt.model_flags(model, params)


# ---------------------------------------------------------------------------
# geometry, builder, flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SINGLETS)
def test_geometry_sag_and_slopes_match_jax(name):
    """Each freeform geometry's sag and slopes at float64, at random points
    of the clear aperture, against the JAX class built from the same
    prescription; the parameters the builder makes are the JAX ones."""
    jb, tb = freeform_builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    jg, tg = jm.surfaces[1].geometry, tm.surfaces[1].geometry
    assert tg.kind == jg.kind
    jpar = jax.tree_util.tree_map(np.asarray, jp["surfaces"][1]["geom"])
    tpar = params_to_numpy(tp["surfaces"][1]["geom"])
    assert sorted(jpar) == sorted(tpar)
    for k in jpar:
        np.testing.assert_array_equal(tpar[k], jpar[k], err_msg=k)
    x, y = (7.5 * v.astype(np.float64) for v in _pupil(200, seed=4))
    sj = np.asarray(jg.sag(jp["surfaces"][1]["geom"], jnp.asarray(x),
                           jnp.asarray(y)))
    st = tg.sag(tp["surfaces"][1]["geom"], torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-10, atol=1e-13)
    gj = jg.sag_grad(jp["surfaces"][1]["geom"], jnp.asarray(x),
                     jnp.asarray(y))
    gt = tg.sag_grad(tp["surfaces"][1]["geom"], torch.tensor(x),
                     torch.tensor(y))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("name", SINGLETS + ("concentrator", "newton_stack",
                                             "fresnel_stack"))
def test_flags_and_support_match_jax(name):
    jb, tb = freeform_builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu")
    assert tgt.supports_model(tm) and jpt.supports_model(jm)
    assert tgt.model_flags(tm, tp) == jax_flags_as_port(
        jpt.model_flags(jm, jp))
    assert not tgt.supports_split_opd(tm)


def test_flag_word_layout_matches_the_cuda_header():
    """The Python and CUDA copies of the flag word's layout, the sag kinds'
    codes, the Zernike table's width and the term limit agree (read from
    csrc/gen_trace_common.cuh as text)."""
    text = (CSRC / "gen_trace_common.cuh").read_text()
    defines = {m.group(1): int(m.group(2)) for m in
               re.finditer(r"#define (\w+) (\d+)\b", text)}
    for name in ("GKIND_SHIFT", "NU_SHIFT", "NV_SHIFT", "BASIS_SHIFT",
                 "GKIND_MASK", "NTERM_MASK", "BASIS_MASK", "ZT_W",
                 "MAX_TERMS", "NEWTON_ITERS", "Q2D_ROWS"):
        assert defines[name] == getattr(tgt, name), name
    enums = {m.group(1): int(m.group(2)) for m in
             re.finditer(r"\b(GK_\w+|FLAG_\w+) = (\d+)", text)}
    cuda_kinds = {"conic": "GK_CONIC", "even": "GK_EVEN", "odd": "GK_ODD",
                  "poly": "GK_POLY", "cheb": "GK_CHEB",
                  "biconic": "GK_BICONIC", "toroidal": "GK_TORUS",
                  "toroidal_inf": "GK_TORUS_INF", "zernike": "GK_ZERNIKE",
                  "fresnel_zone": "GK_FZONE",
                  "fresnel_designed": "GK_FDESIGNED", "qbfs": "GK_QBFS",
                  "q2d": "GK_Q2D"}
    assert {k: enums[v] for k, v in cuda_kinds.items()} == tgt._GKIND_CODES
    for flag in ("PLANE", "REFL", "ABSORB", "CS", "AP", "COAT"):
        assert enums[f"FLAG_{flag}"] == getattr(tgt, f"FLAG_{flag}"), flag
    # a word round-trips through the layout
    word = tgt._flag_words([tgt.SurfaceFlags(True, False, True, "cheb", 5,
                                             True, False, "simple", 6)])[0]
    assert (word >> tgt.GKIND_SHIFT) & tgt.GKIND_MASK == 4
    assert (word >> tgt.NU_SHIFT) & tgt.NTERM_MASK == 5
    assert (word >> tgt.NV_SHIFT) & tgt.NTERM_MASK == 6
    plain = tgt.SurfaceFlags(False, False, False, "conic", 0, False, False,
                             "none")
    word = tgt._flag_words([plain._replace(gkind="zernike", nu=9,
                                           gextra="noll")])[0]
    assert (word >> tgt.BASIS_SHIFT) & tgt.BASIS_MASK == 2
    with pytest.raises(ValueError):             # 36 > MAX_TERMS coefficients
        tgt._flag_words([plain._replace(gkind="poly", nu=6, nv=6)])
    # the variants by the codes the launchers report
    variants = {m.group(1): int(m.group(2)) for m in
                re.finditer(r"\bVAR_(\w+) = (\d+)", text)}
    assert {k.lower(): v for k, v in variants.items()} == {
        v: i for i, v in enumerate(tgt.VARIANTS)}


def test_zernike_table_holds_the_term_structure():
    """The CUDA kernels' Zernike table: per basis and term (n, m), the
    normalization and the radial polynomial's powers and coefficients, as
    float32 roundings of the plain version's."""
    tab = tgt.zernike_table().numpy()
    assert tab.shape == (3, tgt.MAX_TERMS, tgt.ZT_W)
    for b, basis in enumerate(tgt.ZERNIKE_BASES):
        for j, (n, m, norm, radial) in enumerate(
                tgt.zernike_terms_table(basis, tgt.MAX_TERMS)):
            row = tab[b, j]
            assert (row[0], row[1], row[3]) == (n, m, len(radial))
            assert row[2] == np.float32(norm)
            np.testing.assert_array_equal(
                row[4:4 + 3 * len(radial)],
                np.asarray(radial, np.float64).ravel().astype(np.float32))


def test_q2d_term_structure_and_limits():
    """A Q2D surface's kernel rows (``q2d_structure``): its basis-changed
    coefficients grouped as the JAX kernel's ``_q2d_layout`` groups the
    terms, each with its group's code and the Pnm recurrence's a(n, m),
    b(n, m), c(n + 1, m) (the JAX package's ``_abc_q2d``); acoef carries
    them after the coefficients. Beyond MAX_TERMS basis-changed
    coefficients a Q2D surface is refused by supports_model and by the
    flag word."""
    from optiland_pr_tpu.geometry.forbes import _abc_q2d
    terms = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (0, -3))
    assert tgt.q2d_layout(terms) == jpt._q2d_layout(terms)
    codes, a, b, c = tgt.q2d_structure(terms)
    assert codes == (0, 0, 2, 2, 2, 2, 4, 7)
    for j, (m, n, ln) in enumerate([(1, 0, 4), (1, 1, 4), (1, 2, 4)], 2):
        assert (a[j], b[j]) == tuple(_abc_q2d(n, m)[:2])
        assert c[j] == (_abc_q2d(n + 1, m)[2] if n < ln - 2 else 0.0)
    assert a[5] == b[5] == c[5] == 0.0          # the group's last term
    _, tb = freeform_builders("fresnel_stack")
    model, params = tb().build(device="cpu", dtype=F32)
    acoef = tgt.pack_asphere_coeffs(model, params)
    np.testing.assert_array_equal(acoef[3, 8:40].numpy(), np.float32(
        np.ravel([codes, a, b, c])))
    wide = tuple((n, 1) for n in range(33))
    lens = freeform_builders("singlet:q2d")[1]()
    lens._surfaces[1]["geom_kw"].update(terms=wide, coefficients=[1e-6] * 33)
    assert not tgt.supports_model(lens.build(device="cpu")[0])
    flag = tgt.SurfaceFlags(False, False, False, "q2d", 33, False, False,
                            "none", 0, wide)
    with pytest.raises(ValueError):
        tgt._flag_words([flag])


@pytest.mark.parametrize("name,variables", [
    ("newton_stack", [("chebyshev_coeff", 1, {"coeff_index": (0, 1)}),
                      ("chebyshev_coeff", 1, {"coeff_index": [2, 1]}),
                      ("norm_x", 1, {}), ("norm_y", 1, {}),
                      ("zernike_coeff", 2, {"coeff_number": 3}),
                      ("norm_radius", 2, {})]),
    ("singlet:poly", [("polynomial_coeff", 1, {"coeff_index": (1, 1)}),
                      ("polynomial_coeff", 1, {"coeff_index": (3, 3)})]),
    ("singlet:q2d", [("asphere_coeff", 1, {"coeff_number": 2}),
                     ("asphere_coeff", 1, {"coeff_number": 5}),
                     ("norm_radius", 1, {})])])
def test_builder_and_freeform_variables_match_jax(name, variables):
    """set_norm_radius, and the polynomial_coeff, chebyshev_coeff,
    zernike_coeff, norm_radius, norm_x and norm_y variables, and the
    coefficient variable on a Forbes surface's ``geom.coefficients``, read
    and write the JAX package's leaves."""
    jb, tb = freeform_builders(name)
    jlens, tlens = jb(), tb()
    if name in ("newton_stack", "singlet:q2d"):
        k = 2 if name == "newton_stack" else 1
        for lens in (jlens, tlens):
            lens.set_norm_radius(9.0, k)
        _, tp = tlens.build(device="cpu")
        assert float(tp["surfaces"][k]["geom"]["norm_radius"]) == 9.0
    problems = []
    for opt, lens, kw in ((jopt, jlens, {}), (topt, tlens, {"device": "cpu"})):
        p = opt.OptimizationProblem(lens, **kw)
        for vt, surf, extra in variables:
            p.add_variable(vt, surface_number=surf, **extra)
        problems.append(p)
    jprob, tprob = problems
    x0 = tprob.x0()
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jprob.x0()))
    x = x0 * 1.01 + 1e-4
    new_t = tprob.variables.apply(tprob.params, x)
    new_j = jprob.variables.apply(jprob.params, jnp.asarray(x.numpy()))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                    jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15)


# ---------------------------------------------------------------------------
# the eager trace and K1's plain version against the JAX trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SINGLETS + ("bench:cheb", "bench:zernike",
                                             "concentrator"))
def test_eager_trace_and_plain_k1_match_jax(name):
    """Each freeform system at its first and last field: the port's eager
    trace against the JAX package's trace (trace/real.py through the XLA
    engine), both float64; K1's plain version (float32 tables and rays)
    against the same float64 trace at the JAX suite's kernel tolerances.
    Every sag kind passes through K1's plain version here, those that the
    interpreted stacks below leave out among them."""
    jb, tb = freeform_builders(name)
    jm, jp = jb().build()
    tm, tp = tb().build(device="cpu", dtype=F64)
    m32, p32 = tb().build(device="cpu", dtype=F32)
    scale = 1e2 if name == "concentrator" else 1.0
    # the Q2D slope's theta terms divide by r^2 + 1e-12 (both packages'
    # geometry): a chief ray through the vertex lands ~1e-13 mm off it by
    # rounding, and the two packages' roundings differ, which moves its
    # direction by ~2e-12 (the directions' atol x 100 for that case)
    dscale = 1e2 if name == "singlet:q2d" else scale
    px, py = _hexapolar(RINGS)
    hy_last = 1.0 if len(jp["fields"]) > 1 else 0.7
    for hy in (0.0, hy_last):
        rj = j_final_rays(jm, jp, 0.0, hy, 0.55, jnp.asarray(px),
                          jnp.asarray(py), engine="xla")
        rt = final_rays(tm, tp, 0.0, hy, 0.55, torch.tensor(px),
                        torch.tensor(py), engine="eager")
        assert np.array_equal(np.isfinite(rt.x.numpy()),
                              np.isfinite(np.asarray(rj.x)))
        for f, atol in (("x", 1e-9), ("y", 1e-9), ("z", 1e-9), ("L", 1e-12),
                        ("M", 1e-12), ("N", 1e-12), ("opd", 1e-9)):
            np.testing.assert_allclose(
                getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), rtol=0,
                atol=atol * (dscale if f in "LMN" else scale), err_msg=f)
        k = tgt.gen_trace_conic(m32, p32, torch.tensor(px, dtype=F32),
                                torch.tensor(py, dtype=F32), 0.55, 0.0, hy,
                                final_prop=True)
        out = torch.stack([getattr(k, f) for f in
                           ("x", "y", "z", "L", "M", "N", "intensity",
                            "opd")])
        _hold_k1(out.double(), {f: np.asarray(getattr(rj, f)) for f in
                                ("x", "y", "z", "L", "M", "N", "intensity",
                                 "opd")}, f"{name} Hy {hy}")


@pytest.mark.parametrize("basis,num_terms", [("standard", 15),
                                             ("fringe", 16),
                                             ("noll", 21)])
def test_zernike_basis_in_the_plain_kernel(basis, num_terms):
    """K1's Zernike sag (``_sag_grad``: the host table's terms, the
    multiple-angle recurrence, the curvature-form conic base) in each basis,
    float64, against the JAX geometry's sag and slopes, through the port's
    geometry parameters."""
    coefs = np.random.default_rng(num_terms).normal(size=num_terms) * 1e-4
    kw = dict(radius=60.0, conic=-0.2, coefficients=coefs, norm_radius=10.0)
    tgeo = TZernikeSag(num_terms, basis)
    tpar = params_from_numpy(tgeo.default_params(**kw), "cpu", F64)
    jgeo = JZernikeSag(num_terms, basis)
    jpar = jgeo.default_params(**kw)
    cols = {0: 1.0 / tpar["radius"], 1: tpar["conic"],
            24: tpar["norm_radius"]}
    x, y = (9.0 * v.astype(np.float64) for v in _pupil(300, seed=8))
    s, gx, gy = tgt._sag_grad("zernike", num_terms, 0, basis, cols.get,
                              list(tpar["coefficients"]), torch.tensor(x),
                              torch.tensor(y))
    sj = jgeo.sag(jpar, jnp.asarray(x), jnp.asarray(y))
    gj = jgeo.sag_grad(jpar, jnp.asarray(x), jnp.asarray(y))
    for a, b in ((s, sj), (gx, gj[0]), (gy, gj[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


# ---------------------------------------------------------------------------
# K1 and K2's plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _interpreted(name, backward: bool):
    """The Pallas K1 in interpret mode on a stack's tables (2 fields x 256
    samples) through diff_gen_trace, and with ``backward`` its jax.vjp (the
    Pallas K2 in interpret mode) for a seeded set of cotangents."""
    jb, _ = freeform_builders(name)
    jm, jp = jb().build()
    tables = jax_tables(jm, jp, [0.55], [0.0, 1.0])
    n = 256
    px, py = _pupil(n, seed=6)
    f = diff_gen_trace(tables["flags"], n // 128, True, True, False)
    args = (tables["gen"], tables["consts"], tables["acoef"],
            jnp.asarray(px).reshape(-1, 128),
            jnp.asarray(py).reshape(-1, 128))
    if not backward:
        return tables, px, py, None, f(*args), None
    outs, vjp = jax.vjp(f, *args)
    cot = np.random.default_rng(12).normal(size=(8, 1, 2, n)).astype(
        np.float32)
    grads = vjp(tuple(jnp.asarray(c.reshape(1, 2, -1, 128)) for c in cot))
    return tables, px, py, cot, outs, grads


@pytest.fixture(scope="module")
def newton_stack():
    """The Pallas K1 on the Newton stack: the file's one interpreted compile
    of K1 alone; the Newton sags' gradients are held against the JAX
    package's by the optimizer test below."""
    return _interpreted("newton_stack", backward=False)


@pytest.fixture(scope="module")
def fresnel_stack():
    """The Pallas K1 and K2 on the Fresnel and Forbes stack: the file's one
    interpreted K2."""
    return _interpreted("fresnel_stack", backward=True)


@pytest.mark.parametrize("stack", ["newton_stack", "fresnel_stack"])
def test_plain_k1_matches_interpreted_pallas(stack, request):
    """The Chebyshev grid, the Zernike sag and the toroid in one stack, and
    both Fresnel kinds with both Forbes kinds in another: the port's tables
    are the JAX entry point's, and K1's plain version on them is the Pallas
    K1's outputs."""
    tables, px, py, _, outs, _ = request.getfixturevalue(stack)
    _, tb = freeform_builders(stack)
    _, _, gen, consts, acoef, flags = _port_tables(tb(), [0.0, 1.0])
    assert flags == jax_flags_as_port(tables["flags"])
    np.testing.assert_allclose(gen.numpy(), np.asarray(tables["gen"]),
                               rtol=1e-6)
    np.testing.assert_allclose(consts.numpy(), np.asarray(tables["consts"]),
                               rtol=1e-6)
    jac = np.asarray(tables["acoef"])
    forbes = [k for k, f in enumerate(flags) if f.gkind in ("qbfs", "q2d")]
    other = [k for k in range(len(flags)) if k not in forbes]
    np.testing.assert_array_equal(acoef.numpy()[other, :jac.shape[1]],
                                  jac[other])
    for k in forbes:
        nc = tgt.n_coefs(flags[k].gkind, flags[k].nu, flags[k].nv)
        np.testing.assert_allclose(acoef.numpy()[k, :nc], jac[k, :nc],
                                   rtol=1e-6, atol=1e-12)
    out = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                              torch.tensor(py), flags, True)
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    _hold_k1(out, {k: np.asarray(o).reshape(-1) for k, o in
                   zip(names, outs)}, stack)


def test_plain_k2_matches_interpreted_pallas_k2(fresnel_stack):
    """Autograd through K1's plain version against the Pallas K2 on the
    Fresnel stack: dgen, dconsts (columns 0-5, and 24-25: the designed
    facets' focal length and index, the Forbes norm radii), dacoef, dPx and
    dPy, through the base-plane roots, the parent conic's slope, the
    designed slope and the Forbes Clenshaw sums; each Forbes surface's
    coefficient cotangents also at their own row's scale."""
    stack = "fresnel_stack"
    tables, px, py, cot, _, grads = fresnel_stack
    jdgen, jdconsts, jdacoef, jdpx, jdpy = [np.asarray(g) for g in grads]
    t = [torch.tensor(np.asarray(tables[k]))
         for k in ("gen", "consts", "acoef")]
    got = gen_trace_bwd_plain(*t, torch.tensor(px), torch.tensor(py),
                              torch.tensor(cot),
                              jax_flags_as_port(tables["flags"]), True)
    cols = list(range(6)) + [24, 25]
    assert np.abs(jdconsts[..., [24, 25]]).max() > 0
    for label, g, e in (("dgen", got[0], jdgen),
                        ("dconsts", got[1][..., cols], jdconsts[..., cols]),
                        ("dacoef", got[2], jdacoef),
                        ("dPx", got[3], jdpx.reshape(-1)),
                        ("dPy", got[4], jdpy.reshape(-1))):
        e = np.asarray(e)
        np.testing.assert_allclose(g.numpy(), e, rtol=5e-3,
                                   atol=5e-3 * np.abs(e).max(),
                                   err_msg=f"{stack} {label}")
    flags = jax_flags_as_port(tables["flags"])
    for k, f in enumerate(flags):
        if f.gkind in ("qbfs", "q2d"):
            e = jdacoef[k, :f.nu]
            assert np.abs(e).min() > 0 and abs(jdconsts[0, k, 24]) > 0
            np.testing.assert_allclose(got[2][k, :f.nu].numpy(), e,
                                       rtol=5e-3, atol=5e-3 * np.abs(e).max(),
                                       err_msg=f"{stack} {f.gkind} dacoef")


@pytest.mark.parametrize("kind,label,col", [("toroidal", "dconsts", 24),
                                             ("cheb", "dconsts", 25),
                                             ("poly", "dacoef", None)])
def test_chip_smoke_per_slot_grad_comparison(kind, label, col):
    """chip_smoke's per-slot K2 check on a freeform singlet (the plain
    version stands in for the kernel): the plain version with its backward
    rounded anew passes per slot; with one small slot zeroed (the toroid's
    rotation radius, the Chebyshev norm_y, the XY polynomial's smallest
    term) it still passes the tensor-wide check and fails the per-slot
    one."""
    from chip_smoke import GRAD_NAMES, GRAD_TOL, compare_grads
    _, _, gen, consts, acoef, flags = _port_tables(
        freeform_builders(f"singlet:{kind}")[1](), [0.0, 1.0])
    n = 2_000
    px, py = (torch.tensor(a) for a in _pupil(n, seed=8))
    cot = torch.tensor(np.random.default_rng(3).normal(
        size=(8, 1, 2, n)).astype(np.float32))
    ref = gen_trace_bwd_plain(gen, consts, acoef, px, py, cot, flags, True)
    d = 1.0 + 3 * 2.0 ** -21                     # rounds the backward anew
    again = [(t.double() / d).to(t.dtype) for t in
             gen_trace_bwd_plain(gen, consts, acoef, px, py, cot * d, flags,
                                 True)]
    compare_grads(again, ref, "re-rounded", per_slot=True)
    i = GRAD_NAMES.index(label)
    p = ref[i]
    if label == "dconsts":
        slot = (slice(None), 0, col)             # the freeform surface
    else:
        mag = torch.where(p != 0, p.abs(), torch.inf)
        slot = divmod(int(torch.argmin(mag)), p.shape[1])
    assert 0 < float(p[slot].abs().max()) \
        < GRAD_TOL[label][1] * float(p.abs().max())
    again[i][slot] = 0.0
    compare_grads(again, ref, "zeroed slot")
    with pytest.raises(RuntimeError, match=f"a {label} slot exceeds"):
        compare_grads(again, ref, "zeroed slot", per_slot=True)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _hold_problem(stack, variables):
    """An OptimizationProblem on ``stack`` (rms_spot_size at Hy 0.7, RINGS
    hexapolar rings) with ``variables`` ((type, keywords) pairs): the
    port's eager float64 value and gradient against jax.value_and_grad of
    the JAX package's merit; then the port's kernel route (K1 and K2's
    plain versions, float32) against the same at its float32 bound
    (rtol 5e-3 with atol 5e-3 x max|g|, tests/test_pallas_grad.py::
    test_merit_path_rides_pallas)."""
    jb, tb = freeform_builders(stack)
    problems = []
    for opt, lens, kw in ((jopt, jb(), {}), (topt, tb(), {"device": "cpu"})):
        p = opt.OptimizationProblem(lens, **kw)
        p.add_operand("rms_spot_size", target=0.0,
                      input_data={"surface_number": -1, "Hx": 0.0,
                                  "Hy": 0.7, "num_rays": RINGS,
                                  "wavelength": 0.55})
        for vt, extra in variables:
            p.add_variable(vt, **extra)
        problems.append(p)
    jprob, tprob = problems
    x0 = tprob.x0()
    vj, gj = jax.value_and_grad(jprob.merit_of_vector)(
        jnp.asarray(x0.numpy()))
    v, g = tprob.value_and_grad(x0)
    np.testing.assert_allclose(float(v), float(vj), rtol=1e-8)
    gj = np.asarray(gj)
    assert np.all(gj != 0)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-6,
                               atol=1e-9 * np.abs(gj).max())
    with engine_override("kernel"):
        v_k, g_k = tprob.value_and_grad(x0)
    np.testing.assert_allclose(float(v_k), float(vj), rtol=1e-3)
    np.testing.assert_allclose(g_k.numpy(), gj, rtol=5e-3,
                               atol=5e-3 * np.abs(gj).max())


def test_freeform_problem_value_and_grad_match_jax():
    """The Newton stack: the radius of surface 1, two chebyshev_coeff
    terms, its norm_x, two zernike_coeff terms, the norm radius and the
    toroid's rotation radius (a path variable) as variables
    (``_hold_problem``)."""
    _hold_problem("newton_stack", [
        ("radius", dict(surface_number=1)),
        ("chebyshev_coeff", dict(surface_number=1, coeff_index=(0, 1))),
        ("chebyshev_coeff", dict(surface_number=1, coeff_index=(1, 0))),
        ("norm_x", dict(surface_number=1)),
        ("zernike_coeff", dict(surface_number=2, coeff_number=3)),
        ("zernike_coeff", dict(surface_number=2, coeff_number=4)),
        ("norm_radius", dict(surface_number=2)),
        ("path", dict(path=("surfaces", 3, "geom", "radius_rot")))])


def test_more_freeform_leaves_value_and_grad_match_jax():
    """The leaves stack (``_hold_problem``): the XY polynomial's
    coefficients (polynomial_coeff), the biconic's radius_x and conic_x,
    the infinite toroid's y polynomial and the fringe and Noll Zernike
    terms with the Noll surface's norm radius, the leaves whose gradients
    the Newton stack leaves out."""
    _hold_problem("leaves_stack", [
        ("polynomial_coeff", dict(surface_number=1, coeff_index=(0, 2))),
        ("polynomial_coeff", dict(surface_number=1, coeff_index=(1, 1))),
        ("path", dict(path=("surfaces", 2, "geom", "radius_x"))),
        ("path", dict(path=("surfaces", 2, "geom", "conic_x"))),
        ("path", dict(path=("surfaces", 3, "geom", "coeffs_poly_y"),
                      element=(0,))),
        ("zernike_coeff", dict(surface_number=4, coeff_number=3)),
        ("zernike_coeff", dict(surface_number=5, coeff_number=4)),
        ("norm_radius", dict(surface_number=5))])
