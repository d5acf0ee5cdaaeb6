"""Frontend variables: immutable linear combinations over wires.

Analog of the reference's `frontend.Variable` + internal
`expr.LinearExpression` (frontend/internal/expr/linear_expression.go;
R1CS builder variables ARE linear expressions,
frontend/cs/r1cs/builder.go:44-65). Python ints are accepted anywhere
a Variable is (gnark's `Variable = interface{}` contract).
"""

from __future__ import annotations

from gnark_tpu_torch.constraint.system import ONE_WIRE


class Variable:
    """A linear combination: tuple of (coeff, wire), sorted by wire,
    coeffs in [1, q), no duplicates. The empty tuple is the constant 0."""

    __slots__ = ("e",)

    def __init__(self, e: tuple):
        self.e = e

    def __repr__(self):
        return f"Var({self.e})"


def lc_const(q: int, v: int) -> tuple:
    v = v % q
    return ((v, ONE_WIRE),) if v else ()


def lc_single(wire: int) -> tuple:
    return ((1, wire),)


def lc_merge(q: int, *lcs) -> tuple:
    """Merge sorted linexps, combining coefficients of equal wires."""
    acc: dict[int, int] = {}
    for e in lcs:
        for coeff, w in e:
            acc[w] = (acc.get(w, 0) + coeff) % q
    return tuple((c, w) for w, c in sorted(acc.items()) if c)


def lc_scale(q: int, e: tuple, k: int) -> tuple:
    k = k % q
    if k == 0:
        return ()
    if k == 1:
        return e
    return tuple(((c * k) % q, w) for c, w in e)


def lc_is_const(e: tuple):
    """Return the constant value if e is constant, else None."""
    if not e:
        return 0
    if len(e) == 1 and e[0][1] == ONE_WIRE:
        return e[0][0]
    return None


def lc_wires(e: tuple):
    return [w for _, w in e if w != ONE_WIRE]
