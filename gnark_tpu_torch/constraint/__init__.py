"""Constraint IR + witness solver (reference L2/L3, constraint/)."""

import os

from gnark_tpu_torch.constraint.system import (
    ConstraintSystem, Instruction, R1C, SparseR1C,
)
from gnark_tpu_torch.constraint.solver import Solution, SolverError, solve
from gnark_tpu_torch.constraint.hints import register_hint, get_hint


def solve_auto(cs, public, secret, hint_overrides=None) -> Solution:
    """Prove-path solve: route through the native C++ level-parallel
    solver when the field fits (reference solver.go:970-1077 analog);
    fall back to the Python interpreter otherwise. The Python solver
    stays the differential oracle (tests/test_native_solver.py)."""
    if os.environ.get("GNARK_TPU_NATIVE_SOLVER", "1") == "1":
        from gnark_tpu_torch import native
        if native.supports(cs):
            return native.solve_native(
                cs, public, secret, hint_overrides=hint_overrides)
    return solve(cs, public, secret, hint_overrides=hint_overrides)


__all__ = ["ConstraintSystem", "Instruction", "R1C", "SparseR1C",
           "Solution", "SolverError", "solve", "solve_auto",
           "register_hint", "get_hint"]
