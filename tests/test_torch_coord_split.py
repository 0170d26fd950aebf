"""Sub-slice (h), the coord_split mode of K1 and K2, in the port against the
JAX package.

- K1 (h)'s plain version (``gen_trace_plain`` in the "xy" mode, float64 ray
  state) through ``gen_trace_conic(coord_split=True)`` on the full-scale
  Hubble telescope at Hy 0 and 0.3, against ``pallas_gen_trace_conic(...,
  interpret=True, coord_split=True)``: one interpreted call of both fields.
  The JAX kernel's two-float (hi, lo) float32 state differs from the same
  pipeline in double-double by at most 4.7e-10 mm or one float32 ulp in
  position, 1.9e-9 in direction and 6.0e-8 mm in OPD on these tables, so
  the bounds are positions 2e-9 mm + 2 ulp of |ref|, directions 1e-8 + 2
  ulp, the OPD deviation 2e-7 mm, base rtol 1e-6.
- The same bounds on the other systems, against the JAX kernel body
  (``_gen_pipeline(..., split="xy")``'s stages) run eagerly on the JAX
  entry's own tables, with the chief's OPD from its state: the
  benchtop Hubble, the Cooke triplet at three wavelengths, a parabola
  folded by a flat mirror, the apodized Cooke triplet, the TIR singlet
  (the lost rays NaN at exactly the JAX kernel's) and an absorbing coated
  singlet behind an annular aperture.
- ``supports_split_xy`` against the JAX one, and ``coord_split=True``
  raising where it is false.
- K2 (h)'s plain version (``GenTrace`` on CPU tensors) through the masked
  RMS spot merit: on the benchtop Hubble (Hy 0.3, 512 rays) against
  ``jax.value_and_grad`` of the JAX XLA trace in float64 (value rtol 1e-4,
  each leaf within 5e-3 x max|leaf| + 1e-8, tests/test_pallas_grad.py:
  485-525; a leaf 0 at float32 resolution, the stop plane's thickness,
  within one float32 ulp of the tree's largest: the float32 outputs and
  cotangents leave a residue there of the order of 5e-3 x 1e-6 + 1e-8
  itself) and against the port's own float64 eager trace (atol 1e-5 x
  max|g|: the kernel's float32 tables, outputs and cotangents move the
  gradient by a few 1e-6 x max|g| here); at full scale (2048 rays) the
  value within 1.5% and the cosine above 0.98 of the float64 gradient
  (:528-569; the port's eager float64 trace as the reference); d(sum of
  the OPD deviations + base)/d(params), which runs through the chief's
  chain, against the eager float64 autograd; and ``GenTrace`` against
  direct autograd of the plain version (equal).
The CUDA kernels run only on a card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optiland_pr_tpu.kernels.pallas_trace as jpt
import optiland_pr_tpu_torch.kernels.gen_trace as tgt
from _torch_systems import builders, jax_flags_as_port, jax_tables
from chip_smoke import (masked_rms, mirror_relay, polarized_doublet,
                        xy_absorbing_singlet, xy_mirror_pair)
from optiland_pr_tpu.system import apertures as japertures
from optiland_pr_tpu.system import apodization as japod
from optiland_pr_tpu.system import coatings as jcoatings
from optiland_pr_tpu.system.optic import Optic as JOptic
from optiland_pr_tpu.trace import real as j_real
from optiland_pr_tpu_torch.kernels.gen_grad import (GenTrace,
                                                     gen_trace_bwd_plain)
from optiland_pr_tpu_torch.system import apodization as tapod
from optiland_pr_tpu_torch.trace import real as t_real

F32 = torch.float32
POS_ATOL, DIR_ATOL, OPD_ATOL, BASE_RTOL = 2e-9, 1e-8, 2e-7, 1e-6


def _pupil(n, seed=0):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32))


def _f32(params):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, params)


def _hold(got, ref, what):
    """Hold the port's 8 outputs (numpy, [8, n]) against the JAX kernel's
    at the module's bounds: the lost rays equal, the intensity to 1e-6."""
    got = [np.asarray(g, np.float64) for g in got]
    ref = [np.asarray(r, np.float64) for r in ref]
    ok = np.isfinite(ref[0])
    assert np.array_equal(ok, np.isfinite(got[0])), what
    for j, name in enumerate("x y z L M N intensity opd".split()):
        g, r = got[j][ok], ref[j][ok]
        ulp = np.spacing(np.abs(r).astype(np.float32)).astype(np.float64)
        bound = {"opd": OPD_ATOL + 0 * r, "intensity": 1e-6 + 0 * r}.get(
            name, (POS_ATOL if j < 3 else DIR_ATOL) + 2 * ulp)
        worst = np.max(np.abs(g - r) - bound) if g.size else -1.0
        assert worst <= 0, (what, name, worst)


@pytest.fixture(scope="module")
def hubble_interp():
    """The JAX entry point's interpreted K1 (h) on the full-scale Hubble,
    Hy (0, 0.3), 1024 rays, float32 parameters: (rays, base, px, py). The
    entry's chief base runs op by op outside the kernel, where the
    two-float barriers change no bit (``_jax_xy``): they are left out there;
    the interpreted kernel sets its own."""
    jb, _ = builders("HubbleTelescope")
    jm, jp = jb().build()
    px, py = _pupil(1024)
    with jpt._mosaic_trace(False):
        rays, base = jpt.pallas_gen_trace_conic(
            jm, _f32(jp), jnp.asarray(px), jnp.asarray(py), 0.55,
            Hx=jnp.zeros(2, jnp.float32),
            Hy=jnp.asarray([0.0, 0.3], jnp.float32), block_rows=8,
            final_prop=True, interpret=True, coord_split=True)
    return rays, base, px, py


def test_entry_point_matches_interpreted_pallas(hubble_interp):
    """gen_trace_conic(coord_split=True) on the port's own tables: z global,
    base [F], the OPD the deviation from the chief's."""
    jr, jbase, px, py = hubble_interp
    _, tb = builders("HubbleTelescope")
    tm, tp = tb().build(device="cpu", dtype=F32)
    assert tgt.supports_split_xy(tm)
    rays, base = tgt.gen_trace_conic(
        tm, tp, torch.tensor(px), torch.tensor(py), 0.55, torch.zeros(2),
        torch.tensor([0.0, 0.3]), final_prop=True, coord_split=True)
    names = ("x", "y", "z", "L", "M", "N", "intensity", "opd")
    _hold([getattr(rays, k).numpy() for k in names],
          [np.asarray(getattr(jr, k)) for k in names], "Hubble")
    assert tuple(base.shape) == (2,)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase),
                               rtol=BASE_RTOL)
    # the chief's own deviation is 0, and z local keeps the image vertex out
    zero = torch.zeros(1)
    r0, _ = tgt.gen_trace_conic(tm, tp, zero, zero, 0.55, 0.0, 0.3,
                                final_prop=True, coord_split=True)
    assert float(r0.opd[0]) == 0.0
    loc, b1 = tgt.gen_trace_conic(tm, tp, torch.tensor(px), torch.tensor(py),
                                  0.55, 0.0, 0.3, final_prop=True,
                                  coord_split=True, keep_local_z=True)
    assert b1.ndim == 0 and float(b1) == float(base[1])
    z_img = float(tgt.positions_from_params(tp)[-1])
    np.testing.assert_allclose(loc.z.numpy() + np.float32(z_img),
                               rays.z.numpy()[1024:], rtol=1e-6)


def _jax_xy(gen_row, consts_w, acoef, px, py, flags, telecentric, apod):
    """The JAX kernel body ``_gen_pipeline(..., split="xy")`` run eagerly,
    keeping its state: (the 8 outputs, the chief's OPD). The tile's chief
    is the JAX entry's chief chain (pallas_trace.py:2440-2452) on the same
    launch, so its accumulator is the entry's base. Run op by op, each
    primitive is a computation of its own, so no simplifier sees across the
    two-float pivots: the optimization barriers (``_ob``) are left out, as
    for a compiled kernel (``_mosaic_trace(False)``), which gives the same
    bits in 60% of the time."""
    with jpt._mosaic_trace(False):
        st = jpt._gen_prologue(gen_row, px, py, kahan=False,
                               polar_state=None, split="xy",
                               telecentric=telecentric, apod=apod)
        sigma = 1.0
        for k, flag in enumerate(flags):
            st = jpt._state_step(flag, False, 0, "xy", sigma)(
                consts_w[k], acoef[k], st)
            if flag[1]:
                sigma = -sigma
        out = jpt._gen_epilogue(st, gen_row, kahan=False, n_ev=0,
                                pol_scale=1.0, final_prop=True, split="xy")
    return out, float(st[28] + st[29])


def _jax_absorbing_singlet():
    return xy_absorbing_singlet(JOptic, japertures, jcoatings)


XY_SYSTEMS = {
    # name: (JAX builder, port builder, fields Hy, wavelengths, apodization)
    "benchtop_hubble": (*builders("BenchtopHubble"), [0.3], [0.55], None),
    "cooke_3wl": (*builders("CookeTriplet"), [0.7],
                  [0.4861, 0.5876, 0.6563], None),
    "mirror_pair": (lambda: xy_mirror_pair(JOptic), xy_mirror_pair, [0.2],
                    [0.55], None),
    "cooke_apodized": (*builders("CookeTriplet"), [1.0], [0.55], "gaussian"),
    "tir_singlet": (*builders("TIRSinglet"), [1.0], [0.55], None),
    "absorbing_coated": (_jax_absorbing_singlet, xy_absorbing_singlet, [1.0],
                         [0.55], None),
}


@pytest.mark.parametrize("name", list(XY_SYSTEMS))
def test_plain_xy_matches_jax_kernel_body(name):
    """The port's plain "xy" version on the JAX entry's tables against the
    JAX kernel body, every wavelength, with the chief's base."""
    jb, tb, fields, wls, apod = XY_SYSTEMS[name]
    jm, jp = jb().build()
    tm, _ = tb().build(device="cpu")
    assert jpt.supports_split_xy(jm) and tgt.supports_split_xy(tm)
    japo = None if apod is None else japod.GaussianApodization(sigma=0.7)
    tapo = None if apod is None else tapod.GaussianApodization(sigma=0.7)
    tab = jax_tables(jm, jp, wls, fields, coord_split=True,
                     apodization=japo)
    flags = jax_flags_as_port(tab["flags"])
    assert flags == tgt.model_flags(tm)
    # the port's launch columns 10-15 (the JAX entry passes the telecentric
    # aim and the apodization to its kernel as static arguments)
    gen = torch.tensor(np.asarray(tab["gen"]))
    gen[:, 10:] = torch.tensor(tgt._launch_row(tm, tapo), dtype=F32)
    consts = torch.tensor(np.asarray(tab["consts"]))
    acoef = torch.tensor(np.asarray(tab["acoef"]))
    px, py = _pupil(1024, seed=3)
    out, base = tgt.gen_trace_plain(gen, consts, acoef, torch.tensor(px),
                                    torch.tensor(py), flags, True, "xy")
    tele = bool(jm.obj_space_telecentric)
    lost = 0.0
    for w in range(len(wls)):
        for f in range(len(fields)):
            ref, chief = _jax_xy(
                jnp.asarray(tab["gen"])[f], jnp.asarray(tab["consts"])[w],
                jnp.asarray(tab["acoef"]), jnp.asarray(px), jnp.asarray(py),
                tab["flags"], tele, japo)
            _hold(out[:, w, f].numpy(), ref, f"{name} w{w} f{f}")
            np.testing.assert_allclose(float(base[w, f]), chief,
                                       rtol=BASE_RTOL, atol=1e-9)
            lost = max(lost, float(np.mean(~np.isfinite(np.asarray(ref[0])))))
    if name == "tir_singlet":
        assert 0.0 < lost < 1.0
    if name == "absorbing_coated":
        inten = out[6].numpy()
        assert (inten == 0).any() and (inten > 0).any() and inten.max() < 1


@pytest.mark.parametrize("name", ["HubbleTelescope", "BenchtopHubble",
                                  "CookeTriplet", "DoubleGauss", "TIRSinglet",
                                  "TelecentricSinglet",
                                  "CoatedSinglet", "TiltedSinglet",
                                  "AsphericSinglet", "polarized_doublet",
                                  "fresnel_mirror_relay", "mirror_pair",
                                  "absorbing_coated"])
def test_supports_split_xy_matches_jax(name):
    """Eligibility agrees with the JAX package's, and gen_trace_conic
    refuses coord_split where it is false (a tilt, an asphere, a polarized
    launch, a Fresnel coating)."""
    extra = {"polarized_doublet": (lambda: polarized_doublet(JOptic),
                                   polarized_doublet),
             "fresnel_mirror_relay": (
                 lambda: mirror_relay(JOptic, state="ignore"),
                 lambda: mirror_relay(state="ignore")),
             "mirror_pair": (lambda: xy_mirror_pair(JOptic), xy_mirror_pair),
             "absorbing_coated": (_jax_absorbing_singlet,
                                  xy_absorbing_singlet)}
    jb, tb = extra.get(name) or builders(name)
    jm, _ = jb().build()
    tm, tp = tb().build(device="cpu", dtype=F32)
    ok = tgt.supports_split_xy(tm)
    assert ok == jpt.supports_split_xy(jm)
    if name in ("TiltedSinglet", "AsphericSinglet", "polarized_doublet",
                "fresnel_mirror_relay"):
        assert not ok
    if not ok:
        with pytest.raises(ValueError):
            tgt.gen_trace_conic(tm, tp, torch.zeros(4), torch.zeros(4), 0.55,
                                final_prop=True, coord_split=True)


def _leaves(tp):
    return [t for t in jax.tree_util.tree_leaves(tp) if t.is_floating_point()]


def _port_grad(name, px, py, merit):
    """(value, gradient leaves, leaves with paths) of ``merit(rays, base)``
    through gen_trace_conic(coord_split=True) at Hy 0.3 on float32
    parameters: the kernel route, K2 (h)'s plain version."""
    tm, tp = builders(name)[1]().build(device="cpu", dtype=F32)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    rays, base = tgt.gen_trace_conic(tm, tp, torch.tensor(px),
                                     torch.tensor(py), 0.55, 0.0, 0.3,
                                     final_prop=True, coord_split=True)
    v = merit(rays, base)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    return float(v.detach()), [torch.zeros_like(t) if g is None else g
                      for t, g in zip(leaves, grads)], tp


def _eager_grad(name, px, py, merit):
    """The same through the port's eager trace in float64 on the float32
    parameters' values (sample 0 of the pupil is the chief's centre)."""
    tm, tp = builders(name)[1]().build(device="cpu", dtype=F32)
    tp = jax.tree_util.tree_map(
        lambda t: t.double() if t.is_floating_point() else t, tp)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    rays = t_real.trace(tm, tp, 0.0, 0.3, 0.55,
                        torch.tensor(px, dtype=torch.float64),
                        torch.tensor(py, dtype=torch.float64))
    v = merit(rays)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    return float(v.detach()), [torch.zeros_like(t) if g is None else g
                      for t, g in zip(leaves, grads)]


def _jax_grad(name, px, py):
    """jax.value_and_grad of the masked RMS spot through the JAX XLA trace
    in float64 on the float32 parameters' values (eager)."""
    jm, jp = builders(name)[0]().build()
    p64 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
        _f32(jp))

    def merit(p):
        rays = j_real.trace(jm, p, 0.0, 0.3, 0.55,
                            jnp.asarray(px, jnp.float64),
                            jnp.asarray(py, jnp.float64))
        return _jax_masked_rms(rays.x, rays.y)
    v, g = jax.value_and_grad(merit)(p64)
    return float(v), g


def _jax_masked_rms(x, y):
    ok = jnp.isfinite(x) & jnp.isfinite(y)
    w = ok.astype(x.dtype)
    ws = jnp.maximum(jnp.sum(w), 1.0)
    xs = jnp.where(ok, x, 0.0)
    ys = jnp.where(ok, y, 0.0)
    mx = jnp.sum(xs * w) / ws
    my = jnp.sum(ys * w) / ws
    return jnp.sqrt(jnp.sum(jnp.where(ok, (xs - mx) ** 2 + (ys - my) ** 2,
                                      0.0)) / ws)


def _spot(rays, base=None):
    return masked_rms(rays.x, rays.y)


@pytest.fixture(scope="module")
def benchtop_grads():
    px, py = _pupil(512)
    return px, py, _port_grad("BenchtopHubble", px, py, _spot), \
        _jax_grad("BenchtopHubble", px, py)


def test_benchtop_gradient_matches_jax_float64(benchtop_grads):
    """The JAX gradient suite's benchtop check (tests/test_pallas_grad.py:
    485-525), leaf by leaf."""
    _, _, (v, grads, tp), (vj, gj) = benchtop_grads
    np.testing.assert_allclose(v, vj, rtol=1e-4)
    gt = jax.tree_util.tree_map(lambda t: t, tp)
    leaves = iter(grads)
    gt = jax.tree_util.tree_map(
        lambda t: next(leaves).numpy() if t.is_floating_point() else None, gt)
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(gt),
                     jax.tree_util.tree_leaves_with_path(gj)))
    ulp = 2.0 ** -23 * max(np.max(np.abs(np.asarray(lj)))
                           for _, (_, lj) in pairs)
    for (kt, lt), (kj, lj) in pairs:
        assert jax.tree_util.keystr(kt) == jax.tree_util.keystr(kj)
        lj = np.asarray(lj, np.float64)
        m = max(np.max(np.abs(lj)), 1e-6)
        # a leaf 0 at float32 resolution (the stop plane's thickness) within
        # one float32 ulp of the tree's largest
        atol = ulp if np.max(np.abs(lj)) <= ulp else 5e-3 * m + 1e-8
        np.testing.assert_allclose(np.asarray(lt, np.float64), lj, rtol=0,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(kt))


def test_benchtop_gradient_matches_port_eager_float64(benchtop_grads):
    """Against the port's own float64 eager trace: equal but for the
    float32 tables, outputs and cotangents (a few 1e-6 x max|g|), far
    inside the JAX kernel's 5e-3."""
    px, py, (v, grads, _), _ = benchtop_grads
    ve, ge = _eager_grad("BenchtopHubble", px, py, _spot)
    np.testing.assert_allclose(v, ve, rtol=1e-6)
    a = torch.cat([g.double().reshape(-1) for g in grads])
    b = torch.cat([g.reshape(-1) for g in ge])
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_full_scale_gradient_value_and_direction():
    """tests/test_pallas_grad.py:528-569 at full scale, 2048 rays: the value
    within 1.5% and the cosine above 0.98 of the float64 gradient (the
    port's eager trace, which the benchtop test above and the port's trace
    tests hold against the JAX package). The JAX kernel's float32
    cotangents shrink the focus-coupled leaves ~0.6x; the float64 adjoint
    keeps each leaf within 1e-3 x max|g| of its float64 value."""
    px, py = _pupil(2048)
    v, grads, _ = _port_grad("HubbleTelescope", px, py, _spot)
    ve, ge = _eager_grad("HubbleTelescope", px, py, _spot)
    assert abs(v - ve) / ve < 0.015
    a = torch.cat([g.double().reshape(-1) for g in grads]).numpy()
    b = torch.cat([g.reshape(-1) for g in ge]).numpy()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.98, cos
    assert np.max(np.abs(a - b)) <= 1e-3 * np.max(np.abs(b))


def _opd_sum(rays, base=None):
    """The sum of the valid rays' OPD deviations plus the chief's base (the
    eager trace: each ray's OPD less sample 0's, the exact centre)."""
    ok = torch.isfinite(rays.opd)
    if base is None:
        dev = rays.opd - rays.opd[0]
        return torch.sum(torch.where(ok, dev, 0.0)) + rays.opd[0]
    return torch.sum(torch.where(ok, rays.opd, 0.0)) + base


def test_chief_term_gradient_matches_eager_float64():
    """d(sum of the OPD deviations + base)/d(params): every ray's OPD
    cotangent reaches the chief's chain as minus itself, base's as itself."""
    px, py = _pupil(512, seed=5)
    px[0] = py[0] = 0.0
    v, grads, _ = _port_grad("BenchtopHubble", px, py, _opd_sum)
    ve, ge = _eager_grad("BenchtopHubble", px, py, _opd_sum)
    np.testing.assert_allclose(v, ve, rtol=1e-6)
    a = torch.cat([g.double().reshape(-1) for g in grads])
    b = torch.cat([g.reshape(-1) for g in ge])
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_gen_trace_function_matches_direct_autograd():
    """GenTrace (K2 (h)'s plain version as the backward, with base's
    cotangent) equals autograd straight through the plain version."""
    _, tb = builders("BenchtopHubble")
    tm, tp = tb().build(device="cpu", dtype=F32)
    gen, consts, acoef = tgt.gen_tables(tm, tp, 0.55, torch.zeros(2),
                                        torch.tensor([0.0, 0.3]))
    consts = tgt.split_consts(tp, gen, consts)
    flags = tgt.model_flags(tm, tp)
    px, py = (torch.tensor(v) for v in _pupil(256, seed=7))
    rng = np.random.default_rng(9)
    cot = torch.tensor(rng.normal(size=(8, 1, 2, 256)).astype(np.float32))
    cot_b = torch.tensor(rng.normal(size=(1, 2)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True)
              for t in (gen, consts, acoef, px, py)]
    out, base = GenTrace.apply(*leaves, flags, True, "xy", None)
    got = torch.autograd.grad((out, base), leaves, (cot, cot_b),
                              allow_unused=True)
    ref = gen_trace_bwd_plain(gen, consts, acoef, px, py, cot, flags, True,
                              "xy", None, cot_b)
    for g, r in zip(got, ref):
        assert torch.equal(torch.zeros_like(r) if g is None else g, r)
    # column 28 (the curvature's low word) takes column 0's cotangent
    assert torch.equal(ref[1][..., 28], ref[1][..., 0])
    assert bool((ref[1][0, 1:3, 0] != 0).all())
