"""The port's optimization modules (``optimize/``) against the JAX package's,
on the CPU.

Tolerances:
- scalers, variable vectors and the trees they write: rtol 1e-14 (the same
  arithmetic at float64);
- operand values at float64: rtol 1e-9 (the eager trace holds the JAX XLA
  trace to 1e-9 mm, tests/test_torch_trace.py);
- the merit and its gradient at float64 (eager): rtol 1e-8;
- the same merit through the kernel route (K1's and K2's plain versions,
  float32) against the JAX XLA engine at float64: rtol 5e-3 with atol
  5e-3 x max|g|, the bound of tests/test_pallas_grad.py::
  test_merit_path_rides_pallas;
- 5 Adam and 5 SGD iterates against optax's (optax.adam and optax.sgd on
  the JAX merit's jitted gradient, with the JAX optimizers' bound clip):
  rtol 1e-9 (torch.optim and optax do the same arithmetic up to rounding,
  on gradients that agree to ~1e-10).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import optiland_pr_tpu.optimize as jopt
import optiland_pr_tpu_torch.optimize as topt
from optiland_pr_tpu.samples.objectives import CookeTriplet as JCooke
from optiland_pr_tpu.trace.engine import engine_override as j_engine
from optiland_pr_tpu_torch.samples import CookeTriplet as TCooke
from optiland_pr_tpu_torch.trace.engine import engine_override as t_engine
from optiland_pr_tpu_torch.utils.convert import params_to_numpy

F64 = torch.float64
ADAM_LR = 1e-3
SGD_LR = 1e-2


def _define(problem, scalers, all_wl=True):
    """The same merit in both packages: RMS-spot operands (one at a scalar
    wavelength and, with ``all_wl``, one over all wavelengths), an f2 target
    and a total-track bound; three radii-like variables and a thickness.

    The JAX package's ``rms_spot_size(wavelength="all")`` reads the
    wavelengths with ``float()`` (optimize/operands.py:89), which fails under
    its jitted merit, so the merits held against JAX gradients leave that
    operand out; its value is held against JAX's, and its gradient against
    the port's own float64 eager trace."""
    problem.add_operand("rms_spot_size", target=0.0, weight=1.0,
                        input_data={"surface_number": -1, "Hx": 0.0,
                                    "Hy": 0.7, "num_rays": 6,
                                    "wavelength": 0.55})
    if all_wl:
        problem.add_operand("rms_spot_size", target=0.0, weight=0.5,
                            input_data={"surface_number": -1, "Hx": 0.0,
                                        "Hy": 1.0, "num_rays": 4,
                                        "wavelength": "all"})
    problem.add_operand("f2", target=50.0, weight=0.01)
    problem.add_operand("total_track", max_val=60.0, weight=0.1)
    problem.add_variable("radius", surface_number=1)
    problem.add_variable("radius", surface_number=2,
                         scaler=scalers.LinearScaler(0.01))
    problem.add_variable("thickness", surface_number=3,
                         scaler=scalers.LinearScaler(0.5, 1.0))
    problem.add_variable("radius", surface_number=6, min_val=-18.5,
                         max_val=-18.0)
    return problem


def _jax_problem(all_wl=True):
    return _define(jopt.OptimizationProblem(JCooke()), jopt, all_wl)


def _port_problem(all_wl=True):
    return _define(topt.OptimizationProblem(TCooke(), device="cpu"), topt,
                   all_wl)


def _optax_run(vg, x, opt, lo, hi, n_steps=5):
    """The loop of the JAX package's OptaxOptimizer.optimize: (history, x,
    final merit)."""
    state = opt.init(x)
    history = []
    for _ in range(n_steps):
        v, g = vg(x)
        updates, state = opt.update(g, state, x)
        x = jnp.clip(optax.apply_updates(x, updates), lo, hi)
        history.append(float(v))
    return history, np.asarray(x), float(vg(x)[0])


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's numbers for the problems above (XLA engine, f64),
    from one jitted value-and-grad."""
    with j_engine("xla"):
        p = _jax_problem(all_wl=False)
        x0 = p.x0()
        vg = jax.jit(jax.value_and_grad(p.merit_of_vector))
        v, g = vg(x0)
        lo, hi = p.variables.bounds()
        lo = jnp.asarray([-jnp.inf if b is None else b for b in lo])
        hi = jnp.asarray([jnp.inf if b is None else b for b in hi])
        adam = _optax_run(vg, x0, optax.adam(ADAM_LR), lo, hi)
        sgd = _optax_run(vg, x0, optax.sgd(SGD_LR, momentum=0.9), lo, hi)
        # the all-wavelength operand, eagerly (the merit above holds the
        # others)
        pa = _jax_problem()
        all_wl = float(pa.operands[1].value(pa.model, pa.params))
    return dict(x0=np.asarray(x0), v=float(v), g=np.asarray(g),
                all_wl=all_wl, adam=adam, sgd=sgd)


@pytest.mark.parametrize("name,args", [
    ("IdentityScaler", ()), ("LinearScaler", (2.5, -1.0)), ("LogScaler", ()),
    ("PowScaler", (3.0,)), ("ReciprocalScaler", ())])
def test_scalers_match_jax(name, args):
    v = np.array([0.25, 2.0, 7.5, 40.0])
    js, ts = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for fn in ("scale", "inverse_scale"):
        exp = np.asarray(getattr(js, fn)(jnp.asarray(v)))
        got = getattr(ts, fn)(torch.tensor(v, dtype=F64)).numpy()
        np.testing.assert_allclose(got, exp, rtol=1e-14)
    # a Python number (a bound) scales too
    np.testing.assert_allclose(float(ts.scale(2.0)),
                               float(js.scale(jnp.asarray(2.0))), rtol=1e-14)
    assert isinstance(topt.get_scaler(name.replace("Scaler", "").lower()),
                      getattr(topt, name))


def test_variable_vectors_and_apply_match_jax(jax_ref):
    jp_, tp_ = _jax_problem(), _port_problem()
    for extra in (jp_, tp_):
        extra.add_variable("reciprocal_radius", surface_number=5)
        extra.add_variable("conic", surface_number=5)
        extra.add_variable("path", path=("aperture_value",))
    x0 = tp_.x0()
    np.testing.assert_allclose(x0.numpy(), np.asarray(jp_.x0()), rtol=1e-14)
    np.testing.assert_allclose(x0.numpy()[:4], jax_ref["x0"], rtol=1e-14)
    x = x0 * (1.0 + 0.01 * torch.arange(1, 8, dtype=F64))
    new_t = tp_.variables.apply(tp_.params, x)
    new_j = jp_.variables.apply(jp_.params, jnp.asarray(x.numpy()))
    assert tp_.params["surfaces"][1]["geom"]["radius"] == 22.01359  # pure
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                    jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-14)
    assert tp_.variables.bounds() == jp_.variables.bounds()


def test_operand_values_match_jax(jax_ref):
    p = _port_problem()
    op = p.operands[1]
    assert op.input_data["wavelength"] == "all"
    np.testing.assert_allclose(float(op.value(p.model, p.params)),
                               jax_ref["all_wl"], rtol=1e-9)
    for name in ("EPD", "EPL", "f2", "FNO", "total_track"):
        t = topt.operand_registry[name](p.model, p.params)
        jm, jpp = JCooke().build()
        j = jopt.operand_registry[name](jm, jpp)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12,
                                   err_msg=name)


def test_value_and_grad_matches_jax(jax_ref):
    p = _port_problem(all_wl=False)
    v, g = p.value_and_grad(p.x0())
    assert v.dtype == g.dtype == F64
    np.testing.assert_allclose(float(v), jax_ref["v"], rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), jax_ref["g"], rtol=1e-8)
    np.testing.assert_allclose(float(p.rss()) ** 2, jax_ref["v"], rtol=1e-8)
    info = p.operand_info()
    assert [r["type"] for r in info] == ["rms_spot_size", "f2",
                                         "total_track"]
    assert [r["value"] for r in p.variable_info()] == p.x0().tolist()[:1] + [
        -435.76044, 0.99997, -18.39533]


def test_value_and_grad_through_the_kernel_route_matches_jax(jax_ref):
    """K1's and K2's plain versions (float32) under the merit, against the
    JAX XLA engine at float64."""
    with t_engine("kernel"):
        p = _port_problem(all_wl=False)
        v, g = p.value_and_grad(p.x0())
    np.testing.assert_allclose(float(v), jax_ref["v"], rtol=1e-3)
    np.testing.assert_allclose(
        g.numpy(), jax_ref["g"], rtol=5e-3,
        atol=5e-3 * max(np.max(np.abs(jax_ref["g"])), 1e-6))


def test_all_wavelength_gradient_kernel_route_matches_eager():
    """The merit with the all-wavelength operand: its gradient through the
    kernel route (float32) against the port's float64 eager trace, at the
    kernel-route bound above."""
    p = _port_problem()
    v, g = p.value_and_grad(p.x0())
    with t_engine("kernel"):
        v_k, g_k = _port_problem().value_and_grad(p.x0())
    np.testing.assert_allclose(float(v_k), float(v), rtol=1e-3)
    np.testing.assert_allclose(g_k.numpy(), g.numpy(), rtol=5e-3,
                               atol=5e-3 * float(g.abs().max()))


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_torch_optim_iterates_follow_optax(kind, jax_ref):
    p = _port_problem(all_wl=False)
    opt = topt.OptimizerAdam(p, lr=ADAM_LR) if kind == "adam" else \
        topt.OptimizerSGD(p, lr=SGD_LR)
    res = opt.optimize(n_steps=5)
    history, x, fun = jax_ref[kind]
    np.testing.assert_allclose(res.history, history, rtol=1e-9)
    np.testing.assert_allclose(res.x, x, rtol=1e-9)
    np.testing.assert_allclose(res.fun, fun, rtol=1e-9)
    assert res.fun < history[0]
    lo, hi = p.variables.bounds()
    assert lo[3] <= res.x[3] <= hi[3]
    # accept() made the result the Optic's CPU float64 build
    _, params = p.optic.build(device="cpu", dtype=F64)
    assert float(params["surfaces"][1]["geom"]["radius"]) == res.x[0]


def _paraxial_problem():
    p = topt.OptimizationProblem(TCooke(), device="cpu")
    p.add_operand("f2", target=48.0)
    p.add_operand("FNO", target=4.6, weight=0.5)
    p.add_variable("radius", surface_number=1)
    p.add_variable("radius", surface_number=6)
    return p


@pytest.mark.parametrize("optimizer", ["OptimizerGeneric", "LeastSquares"])
def test_scipy_optimizers_lower_the_merit(optimizer):
    p = _paraxial_problem()
    start = float(p.merit(p.x0()))
    opt = getattr(topt, optimizer)(p)
    x0 = p.x0()
    res = opt.optimize(maxiter=20)
    end = float(p.merit(p.x0()))
    assert end < 0.1 * start
    assert np.array_equal(p.x0().numpy(), res.x)
    opt.undo()                                   # back to the start
    assert torch.equal(p.x0(), x0)


def test_what_is_not_ported_raises():
    p = _port_problem()
    with pytest.raises(NotImplementedError, match="not ported"):
        p.add_operand("AOI", target=0.0,
                      input_data={"surface_number": 1, "Hx": 0, "Hy": 0,
                                  "Px": 0, "Py": 0, "wavelength": 0.55})
        p.fun_array()
    with pytest.raises(NotImplementedError, match="ray history"):
        topt.operand_registry["rms_spot_size"](
            p.model, p.params, surface_number=3, Hx=0.0, Hy=0.0,
            num_rays=3, wavelength=0.55)
    with pytest.raises(NotImplementedError, match="not ported"):
        p.add_variable("f", surface_number=1)
    with pytest.raises(ValueError, match="unknown variable type"):
        p.add_variable("no_such_type", surface_number=1)
    lens = TCooke()
    lens.constraints = [object()]
    with pytest.raises(NotImplementedError, match="pickups and solves"):
        topt.OptimizationProblem(lens, device="cpu")
    assert set(topt.METRIC_DICT) == set(jopt.METRIC_DICT)
    with pytest.raises(ValueError, match="already registered"):
        topt.register_operand("f2", lambda m, p: 0.0)


def test_problem_builds_on_the_card_by_default(monkeypatch):
    """Without a device the problem asks for the card: on a machine without
    one that is torch's error, never a silent CPU run."""
    seen = {}
    lens = TCooke()
    real = lens.build

    def build(device=None, dtype=None):
        seen["device"] = device
        return real(device="cpu", dtype=dtype)
    monkeypatch.setattr(lens, "build", build)
    p = topt.OptimizationProblem(lens)
    assert seen["device"] == torch.device("cuda") == p.device
    with pytest.raises((AssertionError, RuntimeError)):
        TCooke().build()
