"""K2 in the port (``kernels/gen_grad.py``) against the JAX package's K2.

- K2's plain version (autograd through K1's plain version) against
  ``jax.vjp`` of the JAX custom_vjp ``diff_gen_trace``, whose backward is the
  Pallas K2 run in interpret mode, on the JAX package's own tables and flags,
  with the same numpy-seeded cotangents: dgen, dconsts columns 0-5, dPx and
  dPy at rtol 3e-3 with atol 3e-3 x max|g| (float32; the JAX suite's
  gradient tolerances, tests/test_pallas_grad.py:45-76). Both put no
  cotangent on any other consts column.
- ``GenTrace`` on CPU tensors against direct autograd of the plain version:
  the same computation, so equal bit for bit.
- Lost rays: NaN cotangents on the masked outputs of rays lost to TIR give 0
  pupil cotangents and finite parameter gradients.
- The polychromatic masked-RMS gradient through the port's kernel route
  (plain K1 and K2, float32) against ``jax.value_and_grad`` of the JAX XLA
  trace, leaf by leaf (rtol 3e-3, atol 3e-3 x max|g|, as
  test_grad_parity_polychromatic).
- ``chip_smoke.compare_grads``, the K2 check on the card, on plain outputs.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
import optiland_pr_tpu_torch.samples.objectives as tobj
from _torch_systems import builders as _builders
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


class _Captured(Exception):
    pass


def _jax_tables(name, wls, fields):
    """The (gen, consts, acoef, flags) the JAX entry point hands its kernel;
    the capture stops the call before the kernel runs."""
    jb, _ = _builders(name)
    model, params = jb().build()
    seen = {}

    def capture(gen, consts, acoef, Px, Py, **kw):
        seen.update(gen=gen, consts=consts, acoef=acoef, flags=kw["flags"])
        raise _Captured

    orig = jpt._pallas_gen_trace_2d
    jpt._pallas_gen_trace_2d = capture
    try:
        jpt.pallas_gen_trace_conic(
            model, _f32(params), jnp.zeros(128, jnp.float32),
            jnp.zeros(128, jnp.float32), jnp.asarray(wls, jnp.float32),
            Hx=jnp.zeros(len(fields), jnp.float32),
            Hy=jnp.asarray(fields, jnp.float32), final_prop=True)
    except _Captured:
        pass
    finally:
        jpt._pallas_gen_trace_2d = orig
    return seen


def _jax_k2(tables, px, py, cot, block_rows):
    """jax.vjp of diff_gen_trace (the Pallas K2 in interpret mode)."""
    n = px.shape[0]
    rows = n // 128
    f = diff_gen_trace(tables["flags"], block_rows, True, True, False)
    _, vjp = jax.vjp(f, tables["gen"], tables["consts"], tables["acoef"],
                     jnp.asarray(px).reshape(rows, 128),
                     jnp.asarray(py).reshape(rows, 128))
    W, F = cot.shape[1], cot.shape[2]
    cots = tuple(jnp.asarray(c.reshape(W, F, rows, 128)) for c in cot)
    dgen, dconsts, dacoef, dpx, dpy = vjp(cots)
    return [np.asarray(a) for a in (dgen, dconsts, dacoef)] + [
        np.asarray(dpx).reshape(-1), np.asarray(dpy).reshape(-1)]


def _close(got, exp, what):
    scale = max(float(np.max(np.abs(exp))), 1e-30)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def k2_cases():
    """(tables, pupil, cotangents, JAX K2 result) for the Cooke triplet at
    1 x 1 with 256 samples and 3 x 3 with 128 samples."""
    out = {}
    for label, wls, fields, n in (("1x1", [0.55], [0.7], 256),
                                  ("3x3", [0.48, 0.55, 0.65],
                                   [0.0, 0.7, 1.0], 128)):
        tables = _jax_tables("CookeTriplet", wls, fields)
        px, py = _pupil(n, seed=3)
        W, F = tables["consts"].shape[0], tables["gen"].shape[0]
        rng = np.random.default_rng(11)
        cot = rng.normal(size=(8, W, F, n)).astype(np.float32)
        out[label] = (tables, px, py, cot,
                      _jax_k2(tables, px, py, cot, block_rows=n // 128))
    return out


@pytest.mark.parametrize("case", ["1x1", "3x3"])
def test_plain_k2_matches_jax_k2(case, k2_cases):
    tables, px, py, cot, (jdgen, jdconsts, jdacoef, jdpx, jdpy) = \
        k2_cases[case]
    flags = tuple(tuple(f[:3]) for f in tables["flags"])
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
                                   "dacoef"])
def test_chip_smoke_grad_comparison(fault):
    """The K2-vs-plain check of chip_smoke.py: equal gradients pass, and a
    fault just outside each tolerance is caught."""
    from chip_smoke import GRAD_TOL, compare_grads
    gen, consts, acoef, flags = _port_tables(tobj.CookeTriplet, [0.0, 1.0])
    px, py = (torch.tensor(a) for a in _pupil(128, seed=9))
    cot = torch.ones((8, consts.shape[0], gen.shape[0], 128))
    ref = gen_trace_bwd_plain(gen, consts, acoef, px, py, cot, flags, True)
    bad = [t.clone() for t in ref]
    if fault in ("dgen", "dconsts", "dPx"):
        i = {"dgen": 0, "dconsts": 1, "dPx": 3}[fault]
        rtol, share = GRAD_TOL[fault]
        flat = bad[i].reshape(-1)
        j = int(torch.argmax(flat.abs()))
        flat[j] += 1.01 * (share + rtol) * flat[j].abs() + 1e-30
    elif fault == "nan":
        bad[4].reshape(-1)[0] = torch.nan
    elif fault == "dacoef":
        bad[2].reshape(-1)[0] = 1e-30
    if fault is None:
        assert compare_grads(bad, ref, "same") == 0.0
    else:
        with pytest.raises(RuntimeError, match="check failed"):
            compare_grads(bad, ref, fault)
