"""Merit-function definition and its value and gradient (port of
``optiland_pr_tpu/optimize/problem.py``; reference
optiland/optimization/problem.py:26-170).

Operands are weighted deltas (equality targets or inequality bounds); the
merit is the sum of their squares, a function of the scaled variable vector.
``value_and_grad`` is plain torch: the vector requires grad, the merit is
computed eagerly (on the card through K1 and K2) and
``torch.autograd.grad`` returns the gradient.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import default_float, resolve_device
from .operands import operand_registry
from .variables import VariableList, make_variable

__all__ = ["Operand", "OptimizationProblem"]


@dataclasses.dataclass
class Operand:
    """(reference operand.py:155-239). Equality target or min/max bounds."""
    operand_type: str
    target: float | None = None
    min_val: float | None = None
    max_val: float | None = None
    weight: float = 1.0
    input_data: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if (self.min_val is not None and self.max_val is not None
                and self.min_val > self.max_val):
            raise ValueError(f"{self.operand_type}: min_val > max_val")
        if self.target is not None and (self.min_val is not None
                                        or self.max_val is not None):
            raise ValueError(f"{self.operand_type}: cannot mix equality and "
                             "inequality targets")

    def value(self, model, params):
        fn = operand_registry.get(self.operand_type)
        if fn is None:
            raise ValueError(f"Unknown operand type: {self.operand_type}")
        return fn(model, params, **self.input_data)

    def delta(self, model, params):
        v = self.value(model, params)
        if self.target is not None:
            return v - self.target
        lower = torch.clamp(self.min_val - v, min=0.0) \
            if self.min_val is not None else 0.0
        upper = torch.clamp(v - self.max_val, min=0.0) \
            if self.max_val is not None else 0.0
        return lower + upper

    def fun(self, model, params):
        return self.weight * self.delta(model, params)


class OptimizationProblem:
    """Operand + variable container with the merit and its gradient.

    Usage::

        problem = OptimizationProblem(optic, dtype=torch.float32)  # on the card
        problem.add_operand("f2", target=50.0, weight=1.0)
        problem.add_operand("rms_spot_size", target=0.0, weight=10,
                            input_data={"surface_number": -1, "Hx": 0, "Hy": 0,
                                        "num_rays": 5, "wavelength": 0.55})
        problem.add_variable("radius", surface_number=1)
        result = OptimizerAdam(problem).optimize(n_steps=5)

    ``device`` and ``dtype`` pick the build of ``optic`` the problem works
    on (default: the card, float64). An optic that carries pickups or solves
    is refused: ``Optic.build`` applies them, but re-applying them inside
    the merit, so that gradients flow through them, is not ported yet.
    """

    def __init__(self, optic, device=None, dtype=None):
        if getattr(optic, "constraints", None):
            raise NotImplementedError(
                "re-applying pickups and solves inside the merit "
                "(system/constraints.py) is not ported yet; this optic "
                "carries some")
        self.optic = optic
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self.model, self.params = optic.build(self.device, self.dtype)
        self.operands: list[Operand] = []
        self.variables = VariableList()
        self.initial_value = 0.0

    # -- construction ------------------------------------------------------
    def add_operand(self, operand_type=None, target=None, min_val=None,
                    max_val=None, weight=1.0, input_data=None):
        input_data = dict(input_data or {})
        input_data.pop("optic", None)   # reference-API compatibility
        op = Operand(operand_type, target, min_val, max_val, weight,
                     input_data)
        if op.target is None and op.min_val is None and op.max_val is None:
            with torch.no_grad():
                op.target = float(op.value(self.model, self.params))
        self.operands.append(op)

    def add_variable(self, variable_type, surface_number=None, scaler=None,
                     min_val=None, max_val=None, **kw):
        # tolerate the reference's add_variable(optic, type, ...) call shape
        if not isinstance(variable_type, str):
            variable_type, surface_number = surface_number, kw.pop(
                "surface_number", None)
        self.variables.append(make_variable(
            self.model, variable_type, surface_number=surface_number,
            scaler=scaler, min_val=min_val, max_val=max_val, **kw))

    def clear_operands(self):
        self.operands = []

    def clear_variables(self):
        self.variables = VariableList()

    def rebuild(self):
        """Re-derive (model, params) from the Optic after an edit."""
        self.model, self.params = self.optic.build(self.device, self.dtype)

    # -- merit function ----------------------------------------------------
    def fun_array(self, params=None):
        params = self.params if params is None else params
        if not self.operands:
            return torch.zeros(1, dtype=self.dtype, device=self.device)
        return torch.stack([
            torch.as_tensor(op.fun(self.model, params), dtype=self.dtype,
                            device=self.device).reshape(())
            for op in self.operands]) ** 2

    def sum_squared(self, params=None):
        return torch.sum(self.fun_array(params))

    def rss(self, params=None):
        return torch.sqrt(self.sum_squared(params))

    def merit_of_vector(self, x):
        """The merit as a function of the scaled variable vector."""
        return self.sum_squared(self.variables.apply(self.params, x))

    def _vector(self, x):
        return torch.as_tensor(x, dtype=self.dtype,
                               device=self.device).detach()

    def merit(self, x):
        """The merit at ``x``, without a gradient."""
        with torch.no_grad():
            return self.merit_of_vector(self._vector(x))

    def value_and_grad(self, x):
        """(merit, d merit / d x) at the scaled vector ``x``."""
        x = self._vector(x).requires_grad_(True)
        value = self.merit_of_vector(x)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    # -- state sync --------------------------------------------------------
    def x0(self):
        return self.variables.to_vector(self.params).detach()

    def accept(self, x):
        """Write the variable values ``x`` into the problem's params and
        make them the Optic's build for the problem's (device, dtype); the
        Optic's builds on other devices or dtypes are dropped."""
        self.params = self.variables.apply(self.params, self._vector(x))
        key = self.optic.cache_key(self.device, self.dtype)
        self.optic._cache = {key: (self.model, self.params)}
        return self.params

    # -- info --------------------------------------------------------------
    def operand_info(self):
        rows = []
        with torch.no_grad():
            for op in self.operands:
                rows.append({
                    "type": op.operand_type,
                    "target": op.target,
                    "min": op.min_val,
                    "max": op.max_val,
                    "weight": op.weight,
                    "value": float(op.value(self.model, self.params)),
                    "delta": float(op.delta(self.model, self.params)),
                })
        return rows

    def variable_info(self):
        return [{"name": v.name, "value": float(v.get(self.params)),
                 "min": v.min_val, "max": v.max_val}
                for v in self.variables]

    def info(self):
        import pprint
        pprint.pprint(self.operand_info())
        pprint.pprint(self.variable_info())
