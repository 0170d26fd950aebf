"""Optimizers (port of the local ones of
``optiland_pr_tpu/optimize/optimizers.py``).

- ``OptimizerGeneric`` / ``LeastSquares``: scipy's ``minimize`` and
  ``least_squares`` with exact torch gradients (reference
  optiland/optimization/optimizer/scipy/);
- ``TorchOptimizer`` and its ``OptimizerAdam`` / ``OptimizerSGD``: a
  gradient-descent loop on ``torch.optim.Adam`` / ``torch.optim.SGD`` in
  place of optax, with the bound clamp after each step (reference
  optimizer/torch/base.py:95-154).

The global scipy wrappers (dual annealing, differential evolution, basin
hopping, SHGO) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .problem import OptimizationProblem

__all__ = ["OptimizerGeneric", "LeastSquares", "TorchOptimizer",
           "OptimizerAdam", "OptimizerSGD", "OptimizationResult"]


@dataclasses.dataclass
class OptimizationResult:
    x: np.ndarray
    fun: float
    nit: int = 0
    success: bool = True
    message: str = ""
    history: list = dataclasses.field(default_factory=list)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class OptimizerGeneric:
    """scipy.optimize.minimize with exact torch gradients
    (reference optimizer/scipy/base.py:25-120)."""

    method = None  # scipy picks (BFGS, or L-BFGS-B with bounds)

    def __init__(self, problem: OptimizationProblem):
        self.problem = problem
        self._x_history = []

    def _fun_and_jac(self):
        def fun(x):
            v, g = self.problem.value_and_grad(x)
            return float(v), _numpy(g)
        return fun

    def _bounds(self):
        lo, hi = self.problem.variables.bounds()
        if all(b is None for b in lo) and all(b is None for b in hi):
            return None
        # bounds apply in scaled space
        out = []
        for v, low, high in zip(self.problem.variables, lo, hi):
            ls = float(v.scaler.scale(low)) if low is not None else -np.inf
            hs = float(v.scaler.scale(high)) if high is not None else np.inf
            out.append((min(ls, hs), max(ls, hs)))
        return out

    def optimize(self, maxiter: int = 1000, tol: float = 1e-10,
                 disp: bool = False):
        from scipy import optimize as sciopt
        x0 = _numpy(self.problem.x0())
        self._x_history.append(x0)
        bounds = self._bounds()
        method = self.method
        if method is None:
            method = "L-BFGS-B" if bounds is not None else "BFGS"
        res = sciopt.minimize(self._fun_and_jac(), x0, jac=True,
                              method=method, bounds=bounds, tol=tol,
                              options={"maxiter": maxiter, "disp": disp})
        self.problem.accept(res.x)
        return OptimizationResult(x=res.x, fun=float(res.fun),
                                  nit=getattr(res, "nit", 0),
                                  success=bool(res.success),
                                  message=str(res.message))

    def undo(self):
        """Revert to the previous accepted x (reference scipy/base.py:102)."""
        if self._x_history:
            self.problem.accept(self._x_history.pop())


class LeastSquares(OptimizerGeneric):
    """scipy least_squares on the weighted-delta residual vector, with the
    Jacobian by reverse mode: one backward pass per residual (reference
    optimizer/scipy/least_squares.py)."""

    def optimize(self, maxiter: int = 1000, tol: float = 1e-10,
                 disp: bool = False):
        from scipy import optimize as sciopt
        problem = self.problem

        def residuals(x):
            params = problem.variables.apply(problem.params, x)
            return torch.stack([
                torch.as_tensor(op.fun(problem.model, params),
                                dtype=problem.dtype,
                                device=problem.device).reshape(())
                for op in problem.operands])

        def res_np(x):
            with torch.no_grad():
                return _numpy(residuals(problem._vector(x)))

        def jac_np(x):
            xt = problem._vector(x).requires_grad_(True)
            r = residuals(xt)
            rows = [torch.autograd.grad(r[i], xt,
                                        retain_graph=i < r.shape[0] - 1)[0]
                    for i in range(r.shape[0])]
            return _numpy(torch.stack(rows))

        x0 = _numpy(problem.x0())
        # (the JAX package's LeastSquares skips this, so its undo() does
        # nothing)
        self._x_history.append(x0)
        lo, hi = problem.variables.bounds()
        bounds = (np.array([-np.inf if b is None else b for b in lo]),
                  np.array([np.inf if b is None else b for b in hi]))
        res = sciopt.least_squares(res_np, x0, jac=jac_np, bounds=bounds,
                                   max_nfev=maxiter, xtol=tol)
        problem.accept(res.x)
        return OptimizationResult(x=res.x, fun=float(res.cost),
                                  success=bool(res.success),
                                  message=str(res.message))


class TorchOptimizer:
    """Gradient-descent loop on the merit: gradient -> ``torch.optim`` step
    -> clamp to the bounds (given in scaled space, as the JAX package
    clamps). ``optimizer`` is a ``torch.optim`` class, ``options`` its
    keyword arguments."""

    def __init__(self, problem: OptimizationProblem,
                 optimizer=torch.optim.Adam, **options):
        self.problem = problem
        self.optimizer = optimizer
        self.options = options or {"lr": 1e-2}

    def optimize(self, n_steps: int = 100, lr: float | None = None,
                 disp: bool = False, callback=None):
        problem = self.problem
        options = dict(self.options)
        if lr is not None:
            options["lr"] = lr
        lo, hi = problem.variables.bounds()

        def bound(values, inf):
            return torch.tensor([inf if b is None else b for b in values],
                                dtype=problem.dtype, device=problem.device)
        lo, hi = bound(lo, -math.inf), bound(hi, math.inf)

        x = problem.x0().clone().requires_grad_(True)
        opt = self.optimizer([x], **options)
        history = []
        for i in range(n_steps):
            v, x.grad = problem.value_and_grad(x)
            opt.step()
            with torch.no_grad():
                x.copy_(torch.clamp(x, lo, hi))
            history.append(float(v))
            if disp and (i % 10 == 0 or i == n_steps - 1):
                print(f"step {i}: loss = {float(v):.6e}")
            if callback:
                callback(i, x.detach(), float(v))
        x = x.detach()
        problem.accept(x)
        return OptimizationResult(x=_numpy(x), fun=float(problem.merit(x)),
                                  nit=n_steps, history=history)


class OptimizerAdam(TorchOptimizer):
    """Adam (torch.optim.Adam; betas, eps and bias correction as optax.adam)."""

    def __init__(self, problem, lr: float = 1e-2):
        super().__init__(problem, torch.optim.Adam, lr=lr)


class OptimizerSGD(TorchOptimizer):
    """SGD with heavy-ball momentum (torch.optim.SGD, as optax.sgd)."""

    def __init__(self, problem, lr: float = 1e-3, momentum: float = 0.9):
        super().__init__(problem, torch.optim.SGD, lr=lr, momentum=momentum)
