"""K2 in the port (``kernels/gen_grad.py``) against the JAX package's K2.

- K2's plain version (autograd through K1's plain version) against
  ``jax.vjp`` of the JAX custom_vjp ``diff_gen_trace``, whose backward is the
  Pallas K2 run in interpret mode (traced once, for both cases), on the JAX
  package's own tables and flags, with the same numpy-seeded cotangents:
  dgen, dconsts columns 0-5, dPx and dPy at rtol 3e-3 with atol
  3e-3 x max|g| (float32; the JAX suite's gradient tolerances,
  tests/test_pallas_grad.py:45-76). Both put no cotangent on any other
  consts column.
- ``GenTrace`` on CPU tensors against direct autograd of the plain version:
  the same computation, so equal bit for bit.
- Lost rays: NaN cotangents on the masked outputs of rays lost to TIR give 0
  pupil cotangents and finite parameter gradients.
- The polychromatic masked-RMS gradient through the port's kernel route
  (plain K1 and K2, float32) against ``jax.value_and_grad`` of the JAX XLA
  trace, leaf by leaf (rtol 3e-3, atol 3e-3 x max|g|, as
  test_grad_parity_polychromatic).
- ``chip_smoke.compare_grads`` and ``float32_floor``, the K2 check on the
  card, on plain outputs.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu_torch.kernels.gen_grad as tgg
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.samples.objectives as tobj
from _torch_systems import builders as _builders
from _torch_systems import jax_flags_as_port, jax_tables
from optiland_pr_tpu.kernels.pallas_grad import diff_gen_trace
from optiland_pr_tpu.samples.objectives import CookeTriplet as JCooke
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu_torch.kernels.gen_grad import GenTrace, gen_trace_bwd_plain
from optiland_pr_tpu_torch.trace.engine import engine_override, final_rays

F32 = torch.float32
RTOL = 3e-3


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _f32(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  params)


def _jax_tables(name, wls, fields):
    jm, jp = _builders(name)[0]().build()
    return jax_tables(jm, jp, wls, fields)


def _jax_k2(tables, px, py, cots, block_rows):
    """jax.vjp of diff_gen_trace (the Pallas K2 in interpret mode) for each
    cotangent set in ``cots``; the interpreted kernel is traced once and
    every further set reuses it."""
    n = px.shape[0]
    rows = n // 128
    f = diff_gen_trace(tables["flags"], block_rows, True, True, False)
    _, vjp = jax.vjp(f, tables["gen"], tables["consts"], tables["acoef"],
                     jnp.asarray(px).reshape(rows, 128),
                     jnp.asarray(py).reshape(rows, 128))
    out = []
    for cot in cots:
        W, F = cot.shape[1], cot.shape[2]
        dgen, dconsts, dacoef, dpx, dpy = vjp(tuple(
            jnp.asarray(c.reshape(W, F, rows, 128)) for c in cot))
        out.append([np.asarray(a) for a in (dgen, dconsts, dacoef)] + [
            np.asarray(dpx).reshape(-1), np.asarray(dpy).reshape(-1)])
    return out


def _close(got, exp, what):
    scale = max(float(np.max(np.abs(exp))), 1e-30)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def k2_cases():
    """(tables, pupil, cotangents, JAX K2 result) for the steep N-SF11
    singlet (conic and plane refraction, absorption, rays lost to TIR at the
    outer fields; three surfaces keep the interpreted kernel's trace short)
    at 3 x 3 (wavelengths 0.48, 0.55, 0.65 um; fields 0, 0.7, 1) with 256
    samples, and the 1 x 1 case (0.55 um, Hy 0.7) of the same run with the
    other (wavelength, field) cotangents zero. The port's 1 x 1 case runs on
    that (wavelength, field)'s tables alone; the JAX gradients of the other
    fields and wavelengths are then 0, which it checks too."""
    n = 256
    tables = _jax_tables("TIRSinglet", [0.48, 0.55, 0.65], [0.0, 0.7, 1.0])
    px, py = _pupil(n, seed=3)
    rng = np.random.default_rng(11)
    cot = rng.normal(size=(8, 3, 3, n)).astype(np.float32)
    one = np.zeros_like(cot)
    one[:, 1, 1] = cot[:, 1, 1]
    full, single = _jax_k2(tables, px, py, (cot, one), block_rows=n // 128)
    sub = dict(tables, gen=tables["gen"][1:2], consts=tables["consts"][1:2])
    return {"3x3": (tables, px, py, cot, full),
            "1x1": (sub, px, py, cot[:, 1:2, 1:2], [
                single[0][1:2], single[1][1:2]] + single[2:]),
            "1x1 others": [single[0][[0, 2]], single[1][[0, 2]]]}


@pytest.mark.parametrize("case", ["1x1", "3x3"])
def test_plain_k2_matches_jax_k2(case, k2_cases):
    tables, px, py, cot, (jdgen, jdconsts, jdacoef, jdpx, jdpy) = \
        k2_cases[case]
    if case == "1x1":
        assert not any(np.any(g) for g in k2_cases["1x1 others"])
    flags = jax_flags_as_port(tables["flags"])
    t = [torch.tensor(np.asarray(tables[k]))
         for k in ("gen", "consts", "acoef")]
    dgen, dconsts, dacoef, dpx, dpy = gen_trace_bwd_plain(
        *t, torch.tensor(px), torch.tensor(py), torch.tensor(cot), flags,
        True)
    _close(dgen.numpy(), jdgen, "dgen")
    _close(dconsts[..., :6].numpy(), jdconsts[..., :6], "dconsts")
    # the column layout: no cotangent on alpha's inputs or the wavelength
    # (column 7), in either package
    assert not np.any(jdconsts[..., 6:]) and not torch.any(dconsts[..., 6:])
    assert not np.any(jdacoef) and not torch.any(dacoef)
    _close(dpx.numpy(), jdpx, "dPx")
    _close(dpy.numpy(), jdpy, "dPy")


def _port_tables(build, fields, device="cpu"):
    model, params = build().build(device=device, dtype=F32)
    hy = torch.tensor(fields)
    gen, consts, acoef = tgt.gen_tables(model, params, params["wavelengths"],
                                        torch.zeros_like(hy), hy)
    return gen, consts, acoef, tgt.model_flags(model, params)


def test_gen_trace_function_matches_direct_autograd():
    gen, consts, acoef, flags = _port_tables(tobj.DoubleGauss,
                                             [0.0, 0.7, 1.0])
    px, py = (torch.tensor(a) for a in _pupil(64, seed=4))
    cot = torch.tensor(np.random.default_rng(5).normal(
        size=(8, consts.shape[0], gen.shape[0], 64)).astype(np.float32))
    grads = []
    for fn in (GenTrace.apply, tgt.gen_trace_plain):
        leaves = [t.clone().requires_grad_(True)
                  for t in (gen, consts, px, py)]
        g, c, x, y = leaves
        fn(g, c, acoef, x, y, flags, True).backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # only the inputs that require grad get one
    g = gen.clone().requires_grad_(True)
    out = GenTrace.apply(g, consts, acoef, px, py, flags, True)
    (dg,) = torch.autograd.grad(out, g, cot)
    assert torch.equal(dg, grads[0][0])


def test_lost_rays_get_zero_cotangents():
    gen, consts, acoef, flags = _port_tables(tobj.TIRSinglet, [0.0, 1.0])
    px, py = (torch.tensor(a) for a in _pupil(512, seed=6))
    out = tgt.gen_trace_plain(gen, consts, acoef, px, py, flags, True)
    lost = torch.isnan(out[0])
    assert 0.05 < lost[0, 1].float().mean() < 0.6 and not lost[0, 0].any()
    cot = torch.tensor(np.random.default_rng(7).normal(
        size=tuple(out.shape)).astype(np.float32))
    cot[:, :, 0] = 0.0                       # nothing from the valid field
    cot[6] = 0.0                             # nor from the intensity
    for j in (0, 1, 2, 3, 4, 5, 7):          # every output the NaN step masks
        cot[j][lost] = torch.nan
    dgen, dconsts, _, dpx, dpy = gen_trace_bwd_plain(
        gen, consts, acoef, px, py, cot, flags, True)
    gone = lost[0, 1]
    assert torch.all(dpx[gone] == 0) and torch.all(dpy[gone] == 0)
    assert torch.all(dpx[~gone] != 0)
    assert torch.isfinite(dgen).all() and torch.isfinite(dconsts).all()


def test_unmasked_consumer_gradient_is_finite():
    """nansum(x^2) sends NaN cotangents into K1's lost rays; the parameter
    gradient through the kernel route stays finite and matches the eager
    float64 trace's (rtol 3e-3: float32 kernel route)."""
    px, py = (torch.tensor(a, dtype=torch.float64)
              for a in _pupil(256, seed=8))
    grads = []
    for engine, dtype in (("kernel", F32), ("eager", torch.float64)):
        model, params = tobj.TIRSinglet().build(device="cpu", dtype=dtype)
        r1 = params["surfaces"][1]["geom"]["radius"].requires_grad_(True)
        with engine_override(engine):
            rays = final_rays(model, params, 0.0, 1.0, 0.55, px, py)
        assert torch.isnan(rays.x).any()
        (g,) = torch.autograd.grad(torch.nansum(rays.x ** 2 + rays.y ** 2),
                                   r1)
        grads.append(float(g))
    assert np.isfinite(grads[0])
    np.testing.assert_allclose(grads[0], grads[1], rtol=RTOL)


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


def test_polychromatic_gradient_matches_jax():
    """The mirror of test_grad_parity_polychromatic: K2 sums the cotangents
    of three wavelengths into one dconsts/dgen."""
    wls = [0.4861, 0.5876, 0.6563]
    px, py = _pupil(256)
    jm, jp = JCooke().build()
    jp = _f32(jp)
    jwls = jnp.asarray(wls, jnp.float32)

    def merit_xla(p):
        def one(w):
            rays = j_real.trace(jm, p, 0.0, 0.7, w, jnp.asarray(px),
                                jnp.asarray(py))
            return rays.x, rays.y
        xs, ys = jax.vmap(one)(jwls)
        return _masked_rms(xs.reshape(-1), ys.reshape(-1), jnp)

    vx, gx = jax.value_and_grad(merit_xla)(jp)

    tm, tp = tobj.CookeTriplet().build(device="cpu", dtype=F32)
    leaves = [t for t in jax.tree_util.tree_leaves(tp)
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    with engine_override("kernel"):
        rays = final_rays(tm, tp, 0.0, 0.7, torch.tensor(wls),
                          torch.tensor(px), torch.tensor(py))
    v = _masked_rms(rays.x, rays.y, torch)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g
    gt = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    np.testing.assert_allclose(v.item(), float(vx), rtol=5e-4)
    for (kt, lt), (kx, lx) in zip(jax.tree_util.tree_leaves_with_path(gt),
                                  jax.tree_util.tree_leaves_with_path(gx)):
        assert jax.tree_util.keystr(kt) == jax.tree_util.keystr(kx)
        lx = np.asarray(lx)
        scale = max(np.max(np.abs(lx)), 1e-4)
        np.testing.assert_allclose(
            lt, lx, rtol=RTOL, atol=RTOL * scale,
            err_msg=f"grad mismatch at {jax.tree_util.keystr(kt)}")


@pytest.mark.parametrize("fault", [None, "dgen", "dconsts", "dPx", "nan",
                                   "dacoef", "float64_floor"])
def test_chip_smoke_grad_comparison(fault):
    """The K2-vs-plain check of chip_smoke.py, on the aspheric singlet (its
    asphere terms get cotangents): equal gradients pass, a fault just
    outside each tolerance is caught, and a per-ray float32 floor widens
    that ray's bound by twice the floor, and no other ray's."""
    from chip_smoke import GRAD_NAMES, GRAD_TOL, compare_grads
    from optiland_pr_tpu_torch.samples import AsphericSinglet
    gen, consts, acoef, flags = _port_tables(AsphericSinglet, [0.0, 1.0])
    px, py = (torch.tensor(a) for a in _pupil(128, seed=9))
    cot = torch.ones((8, consts.shape[0], gen.shape[0], 128))
    ref = gen_trace_bwd_plain(gen, consts, acoef, px, py, cot, flags, True)
    assert torch.count_nonzero(ref[2]) == 3
    bad = [t.clone() for t in ref]
    i = {"dgen": 0, "dconsts": 1, "dacoef": 2, "dPx": 3,
         "float64_floor": 3}.get(fault)
    if i is not None:
        rtol, share = GRAD_TOL[GRAD_NAMES[i]]
        flat = bad[i].reshape(-1)
        j = int(torch.argmax(flat.abs()))
        grow = 10.0 if fault == "float64_floor" else 1.01
        flat[j] += grow * (share + rtol) * flat[j].abs() + 1e-30
    elif fault == "nan":
        bad[4].reshape(-1)[0] = torch.nan
    if fault is None:
        assert compare_grads(bad, ref, "same") == 0.0
    elif fault == "float64_floor":
        # a floor of 0.6 x the fault on the faulted ray covers it ...
        size = float((bad[3] - ref[3]).abs().max())
        floor = [None] * 3 + [torch.zeros_like(ref[3]), None]
        floor[3].reshape(-1)[j] = 0.6 * size
        compare_grads(bad, ref, fault, floor=floor)
        # ... one of 0.4 x does not, nor one of 0.6 x on every other ray
        for on_j, elsewhere in ((0.4, 0.0), (0.0, 0.6)):
            floor[3] = torch.full_like(ref[3], elsewhere * size)
            floor[3].reshape(-1)[j] = on_j * size
            with pytest.raises(RuntimeError, match="check failed"):
                compare_grads(bad, ref, fault, floor=floor)
    else:
        with pytest.raises(RuntimeError, match="check failed"):
            compare_grads(bad, ref, fault)


def test_chip_smoke_float32_floor():
    """chip_smoke.float32_floor on the benchtop Hubble, the K2 case that
    uses it: a per-ray floor for dPx and dPy only, nonzero (a two-mirror
    telescope's pupil cotangents are small differences of large terms) and
    under 1e-3 x max|g| on every ray. With it, the plain version run again
    with its backward rounded anew passes compare_grads, and an error of 1%
    on every hundredth ray does not."""
    from chip_smoke import benchtop_hubble, compare_grads, float32_floor
    gen, consts, acoef, flags = _port_tables(benchtop_hubble, [0.0, 1.0])
    n = 4_000
    px, py = (torch.tensor(a) for a in _pupil(n, seed=5))
    cot = torch.tensor(np.random.default_rng(2).normal(
        size=(8, 1, 2, n)).astype(np.float32))
    ref = gen_trace_bwd_plain(gen, consts, acoef, px, py, cot, flags, True)
    floor = float32_floor(gen, consts, acoef, px, py, cot, flags, True, ref)
    assert floor[:3] == [None] * 3
    for f, p in zip(floor[3:], ref[3:]):
        assert f.shape == p.shape and f.dtype == p.dtype
        assert 0.0 < float(f.max()) < 1e-3 * float(p.abs().max())
    d = 1.0 - 5 * 2.0 ** -22                 # not one of the floor's scales
    again = [t if t is None else (t.double() / d).to(t.dtype) for t in
             gen_trace_bwd_plain(gen, consts, acoef, px, py, cot * d, flags,
                                 True)]
    compare_grads(again, ref, "re-rounded", floor)
    again[3].reshape(-1)[::100] *= 1.01
    with pytest.raises(RuntimeError, match="dPx exceeds"):
        compare_grads(again, ref, "1% off", floor)


def test_jacobian_through_kernel_dispatch():
    """The mirror of tests/test_pallas_grad.py::
    test_jacrev_through_pallas_dispatch: the Jacobian of the masked RMS
    spot with respect to surface 1's radius through ``GenTrace`` on the CPU
    (``engine_override("kernel")``: K1's plain version forward, K2's plain
    version backward), in reverse mode, against the JAX package's XLA-route
    ``jax.jacrev`` run eagerly, at 256 rays (rtol 5e-3, atol 1e-6).
    ``torch.autograd.functional.jacobian`` takes it: ``torch.func.jacrev``
    refuses an ``autograd.Function`` without a ``setup_context``, which
    ``GenTrace`` (its context saved in ``forward``) does not have."""
    from optiland_pr_tpu.trace.engine import engine_override as j_override
    from optiland_pr_tpu.trace.engine import final_rays as j_final_rays
    px, py = _pupil(256)
    jm, jp = JCooke().build()
    jp = _f32(jp)

    def resid_jax(radius):
        p = jax.tree_util.tree_map(lambda a: a, jp)
        p["surfaces"][1]["geom"]["radius"] = radius
        rays = j_final_rays(jm, p, 0.0, 0.0, 0.55, jnp.asarray(px),
                            jnp.asarray(py))
        return jnp.stack([_masked_rms(rays.x, rays.y, jnp)])

    with j_override("xla"):
        Jx = jax.jacrev(resid_jax)(jp["surfaces"][1]["geom"]["radius"])

    tm, tp = tobj.CookeTriplet().build(device="cpu", dtype=F32)

    def resid(radius):
        p = jax.tree_util.tree_map(lambda a: a, tp)
        p["surfaces"][1]["geom"]["radius"] = radius
        with engine_override("kernel"):
            rays = final_rays(tm, p, 0.0, 0.0, 0.55, torch.tensor(px),
                              torch.tensor(py))
        return torch.stack([_masked_rms(rays.x, rays.y, torch)])

    r0 = tp["surfaces"][1]["geom"]["radius"]
    J = torch.autograd.functional.jacobian(resid, r0)
    with pytest.raises(RuntimeError, match="setup_context"):
        torch.func.jacrev(resid)(r0)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jx), rtol=5e-3,
                               atol=1e-6)


def _tir_grads(n=256):
    """The TIR singlet 1 x 2 (Hy 0, 1) at ``n`` samples: its tables, the
    plain K1's lost-ray mask (the CPU stand-in for K1 narrow's) and seeded
    cotangents."""
    gen, consts, acoef, flags = _port_tables(tobj.TIRSinglet, [0.0, 1.0])
    px, py = (torch.tensor(a) for a in _pupil(n, seed=12))
    lost = torch.isnan(tgt.gen_trace_plain(gen, consts, acoef, px, py,
                                           flags, True)[0])
    assert lost.any() and not lost.all()
    cot = torch.tensor(np.random.default_rng(13).normal(
        size=(8, 1, 2, n)).astype(np.float32))
    return (gen, consts, acoef, px, py, flags), lost, cot


def _lost_cot(cot, lost):
    """The TIR set's cotangents in chip_smoke.py: NaN on the lost rays'
    masked outputs (x, y, z, L, M, N, OPD), no other cotangent on a ray
    lost in some (w, f). Returns (those cotangents, [n] those rays)."""
    gone = lost.reshape(-1, lost.shape[-1]).any(0)
    c = cot.clone()
    c[..., gone] = 0.0
    for j in (0, 1, 2, 3, 4, 5, 7):
        c[j][lost] = torch.nan
    return c, gone


@pytest.mark.parametrize("fault", [None, "nan_read", "lost_dpx",
                                   "nan_dconsts", "no_lost_ray"])
def test_chip_smoke_mask_identity(fault):
    """The mask identity check of K2's narrow instance in chip_smoke.py
    (``grad_mask_identity``), on the plain version's CPU outputs for the
    TIR singlet: NaN cotangents on the lost rays' masked outputs and none
    elsewhere on a lost ray leave every output finite and the lost rays'
    pupil cotangents exactly 0; a backward that reads one lost ray's NaN,
    a lost ray's nonzero pupil cotangent, a NaN sum, or a set with no lost
    ray to hold is caught."""
    from chip_smoke import grad_mask_identity
    args, lost, cot = _tir_grads()
    c_k, gone = _lost_cot(cot, lost)
    assert torch.isnan(c_k).any() and gone.any()
    if fault == "nan_read":
        # a backward whose mask kept one lost ray reads its NaN
        i = int(torch.nonzero(gone)[0])
        g = gen_trace_bwd_plain(*args[:5], c_k.nan_to_num(0.0), args[5],
                                True)
        g = list(g)
        g[3] = g[3].clone()
        g[3][i] = torch.nan
        g[1] = g[1] + g[3][i]
    else:
        g = list(gen_trace_bwd_plain(*args[:5], c_k, args[5], True))
    if fault == "lost_dpx":
        g[3] = g[3].clone()
        g[3][int(torch.nonzero(gone)[0])] = 1e-30
    elif fault == "nan_dconsts":
        g[1] = g[1].clone()
        g[1][0, 0, 0] = torch.nan
    elif fault == "no_lost_ray":
        gone = torch.zeros_like(gone)
    if fault is None:
        grad_mask_identity(g, gone, "plain")
        assert torch.any(g[3][~gone] != 0)
    else:
        with pytest.raises(RuntimeError, match="check failed"):
            grad_mask_identity(g, gone, fault)


@pytest.mark.parametrize("fault", [None, "dgen", "dconsts", "dPx", "dPy",
                                   "floor", "parent"])
def test_chip_smoke_grad_float64_distance(fault):
    """Contract 3 of K2's narrow instance in chip_smoke.py
    (``grad_float64_distance``), on the plain version's CPU outputs for the
    TIR singlet at 256 rays, in float32 and on float64 copies: outputs equal
    to the float32 plain version's pass; one element moved just beyond
    twice the float32 plain version's largest distance from float64 is
    caught; a float32 floor, or another kernel's distance, beyond the
    element's distance admits it."""
    from chip_smoke import GRAD_NAMES, grad_float64_distance
    args, lost, cot = _tir_grads()
    keep = ~lost.reshape(-1, lost.shape[-1]).any(0)
    cot[..., ~keep] = 0.0
    ref = gen_trace_bwd_plain(*args[:5], cot, args[5], True)
    ref64 = gen_trace_bwd_plain(*(t.double() for t in args[:5]),
                                cot.double(), args[5], True)
    if fault is None:
        dist = grad_float64_distance(ref, ref, ref64, "same", keep)
        assert set(dist) == {"dgen", "dconsts", "dPx", "dPy"}
        assert all(a == b > 0.0 and c == 2 * b for a, b, c in dist.values())
        return
    label = "dPx" if fault in ("floor", "parent") else fault
    i = GRAD_NAMES.index(label)
    k, p, r = ref[i], ref[i].double(), ref64[i]
    if label in ("dPx", "dPy"):
        p, r = p[keep], r[keep]
    dp = float((p - r).abs().max())
    bad = [t.clone() for t in ref]
    flat, flat64 = bad[i].reshape(-1), ref64[i].reshape(-1)
    j = int(torch.nonzero(keep)[0]) if label in ("dPx", "dPy") else 0
    v = (flat64[j] + 2 * dp).float()
    while float(v.double() - flat64[j]) <= 2 * dp:
        v = torch.nextafter(v, torch.tensor(np.inf))
    flat[j] = v
    if fault == "floor":
        floor = [None] * 3 + [torch.zeros_like(k), None]
        floor[3].reshape(-1)[j] = float(v.double() - flat64[j]) / 2 * 1.001
        grad_float64_distance(bad, ref, ref64, fault, keep, floor)
    elif fault == "parent":
        other = {lb: 0.0 for lb in ("dgen", "dconsts", "dPy")}
        other["dPx"] = float(v.double() - flat64[j]) * 1.001
        grad_float64_distance(bad, ref, ref64, fault, keep, parent=other)
    with pytest.raises(RuntimeError, match="float64 plain version"):
        grad_float64_distance(bad, ref, ref64, fault, keep)


@pytest.mark.parametrize("fault", [None, "masks_differ", "dPx", "dconsts",
                                   "with_floor"])
def test_chip_smoke_narrow_grad_check(fault):
    """chip_smoke.narrow_grad_check, K2 narrow's checks against the plain
    version and its float64 copy, fed the plain versions' CPU tensors for
    the TIR singlet (K1's and K2's modules as they run on the CPU): the
    plain version's own outputs pass, with and without the float32 floor;
    a ray outside ``keep`` (its masks differ) is held by neither check; a
    ray's dPx 1% of max|dPx| off, or a sum moved beyond GRAD_TOL, is
    caught."""
    from chip_smoke import narrow_grad_check
    args, lost, cot = _tir_grads()
    c_k, gone = _lost_cot(cot, lost)
    c_p = c_k.nan_to_num(0.0)
    ref = gen_trace_bwd_plain(*args[:5], c_p, args[5], True)
    keep = torch.ones_like(gone)
    got = [t.clone() for t in ref]
    i = int(torch.nonzero(~gone)[0])
    if fault == "masks_differ":
        keep[i] = False
        got[3][i] += 0.5 * float(ref[3].abs().max())
    elif fault == "dPx":
        got[3][i] += 0.01 * float(ref[3].abs().max())
    elif fault == "dconsts":
        got[1].reshape(-1)[int(ref[1].abs().argmax())] *= 1.01
    run = (lambda: narrow_grad_check(tgt, tgg, *args[:5], c_p, args[5], got,
                                     ref, keep, str(fault),
                                     floor=fault == "with_floor"))
    if fault in ("dPx", "dconsts"):
        with pytest.raises(RuntimeError, match="exceeds"):
            run()
    else:
        err, dist = run()
        assert set(dist) == {"dgen", "dconsts", "dPx", "dPy"}
        assert err == 0.0
