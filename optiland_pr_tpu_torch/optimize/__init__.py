"""Optimization: operands, variables, the merit and its gradient, and the
local optimizers (port of ``optiland_pr_tpu/optimize``; see README.md and
ROADMAP.md for what is not ported yet)."""
from .operands import METRIC_DICT, operand_registry, register_operand
from .optimizers import (LeastSquares, OptimizationResult, OptimizerAdam,
                         OptimizerGeneric, OptimizerSGD, TorchOptimizer)
from .problem import Operand, OptimizationProblem
from .scaling import (IdentityScaler, LinearScaler, LogScaler, PowScaler,
                      ReciprocalScaler, get_scaler)
from .variables import Variable, VariableList, make_variable

__all__ = ["OptimizationProblem", "Operand", "Variable", "VariableList",
           "make_variable", "METRIC_DICT", "operand_registry",
           "register_operand", "OptimizerGeneric", "LeastSquares",
           "TorchOptimizer", "OptimizerAdam", "OptimizerSGD",
           "OptimizationResult", "IdentityScaler", "LinearScaler",
           "LogScaler", "PowScaler", "ReciprocalScaler", "get_scaler"]
