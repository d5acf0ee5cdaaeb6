"""Batched short-Weierstrass point arithmetic (Jacobian), plain torch.

Counterpart of gnark_tpu.ec.weierstrass for the functions the prove and
setup paths need: jac_inf, affine_to_jacobian, jac_add (complete),
jac_add_mixed (complete), jac_double, proj_to_jac and jac_to_affine.
Generic over the field object `f` (FF for G1, FF2 for G2), over int64
limbs. jac_double and jac_add_mixed are also the plain versions of
kernels K7 and K6 (ec/jac_ec.py); the rest touch a handful of points.

Formulas: EFD dbl-2009-l, add-2007-bl, madd-2007-bl (a = 0). In
jac_double and jac_add_mixed the independent products of each step go
through one batched f.mul (the plain field ops are launch-bound at small
batch); the values are those of the reference's formulas.
"""

from __future__ import annotations

import torch


def _many(f, op: str, pairs):
    """One batched call of f.op over independent operand pairs (the
    plain versions are launch-bound at small batch)."""
    shape = torch.broadcast_shapes(*(t.shape for pr in pairs for t in pr))
    A = torch.stack([x.expand(shape) for x, _ in pairs])
    B = torch.stack([y.expand(shape) for _, y in pairs])
    return getattr(f, op)(A, B).unbind(0)


def _batch_shape(f, x):
    ndims = 2 if hasattr(f, "base") else 1   # FF2 elements end in (2, L)
    return x.shape[: x.ndim - ndims]


def jac_inf(f, shape=(), device="cpu"):
    """Point at infinity: (1, 1, 0)."""
    one = f.ones(shape, device)
    return (one, one, f.zeros(shape, device))


def jac_is_inf(f, P):
    return f.is_zero(P[2])


def jac_select(f, cond, P, Q):
    return tuple(f.select(cond, a, b) for a, b in zip(P, Q))


def affine_to_jacobian(f, A):
    """(x, y, inf) -> Jacobian with Z = inf ? 0 : 1."""
    x, y, inf = A
    bshape = _batch_shape(f, x)
    one = f.ones(bshape, x.device)
    z = f.select(inf, f.zeros(bshape, x.device), one)
    return (f.select(inf, one, x), f.select(inf, one, y), z)


def jac_double(f, P):
    """dbl-2009-l (a=0): 2M + 5S. Handles inf naturally (Z3 = 0)."""
    X1, Y1, Z1 = P
    A, B, YZ = _many(f, "mul", [(X1, X1), (Y1, Y1), (Y1, Z1)])
    xb = f.add(X1, B)
    C, t = _many(f, "mul", [(B, B), (xb, xb)])
    D = f.double(f.sub(f.sub(t, A), C))
    E = f.add(f.double(A), A)
    F = f.square(E)
    X3 = f.sub(F, f.double(D))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.mul_small(C, 8))
    Z3 = f.double(YZ)
    return (X3, Y3, Z3)


def jac_add(f, P, Q):
    """Complete Jacobian + Jacobian add (add-2007-bl + selects)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = f.square(Z1)
    Z2Z2 = f.square(Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    r = f.double(f.sub(S2, S1))
    I = f.square(f.double(H))
    J = f.mul(H, I)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.square(r), J), f.double(V))
    Y3 = f.sub(f.mul(r, f.sub(V, X3)), f.double(f.mul(S1, J)))
    Z3 = f.mul(f.sub(f.sub(f.square(f.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    R = (X3, Y3, Z3)

    inf1 = f.is_zero(Z1)
    inf2 = f.is_zero(Z2)
    x_eq = f.is_zero(H)
    y_eq = f.is_zero(r)
    both = ~inf1 & ~inf2
    R = jac_select(f, both & x_eq & y_eq, jac_double(f, P), R)
    R = jac_select(f, both & x_eq & ~y_eq,
                   jac_inf(f, _batch_shape(f, X3), X3.device), R)
    R = jac_select(f, inf1, Q, R)
    R = jac_select(f, inf2, P, R)
    return R


def jac_add_mixed(f, P, A):
    """Complete Jacobian + affine add (madd-2007-bl + selects).
    A = (x2, y2, inf2) with an explicit infinity mask. The doubling
    branch is evaluated only when some row takes it."""
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    Z1Z1, yZ = _many(f, "mul", [(Z1, Z1), (y2, Z1)])
    U2, S2 = _many(f, "mul", [(x2, Z1Z1), (yZ, Z1Z1)])
    H = f.sub(U2, X1)
    r = f.double(f.sub(S2, Y1))
    HH, rr = _many(f, "mul", [(H, H), (r, r)])
    I = f.mul_small(HH, 4)
    zh = f.add(Z1, H)
    J, V, zh2 = _many(f, "mul", [(H, I), (X1, I), (zh, zh)])
    X3 = f.sub(f.sub(rr, J), f.double(V))
    rv, yj = _many(f, "mul", [(r, f.sub(V, X3)), (Y1, J)])
    Y3 = f.sub(rv, f.double(yj))
    Z3 = f.sub(f.sub(zh2, Z1Z1), HH)
    R = (X3, Y3, Z3)

    inf1 = f.is_zero(Z1)
    x_eq = f.is_zero(H)
    y_eq = f.is_zero(r)
    both = ~inf1 & ~inf2
    dbl = both & x_eq & y_eq
    if bool(dbl.any()):
        R = jac_select(f, dbl, jac_double(f, P), R)
    R = jac_select(f, both & x_eq & ~y_eq,
                   jac_inf(f, _batch_shape(f, X3), X3.device), R)
    R = jac_select(f, inf1, affine_to_jacobian(f, A), R)
    R = jac_select(f, inf2, P, R)
    return R


def proj_to_jac(f, P):
    """Homogeneous projective (X : Y : Z) -> Jacobian (X*Z, Y*Z^2, Z);
    the projective identity (0 : 1 : 0) maps to Z = 0."""
    X, Y, Z = P
    return (f.mul(X, Z), f.mul(Y, f.square(Z)), Z)


def jac_neg(f, P):
    return (P[0], f.neg(P[1]), P[2])


def jac_to_affine(f, P):
    """Batch-normalize Jacobian -> (x, y, inf), Fermat inversion."""
    X, Y, Z = P
    zi = f.inv(Z)                        # inv(0) = 0
    zi2 = f.square(zi)
    return (f.mul(X, zi2), f.mul(Y, f.mul(zi, zi2)), f.is_zero(Z))


def to_limbs(f, P):
    """Point of (..., nw) word tensors -> int64 limbs."""
    return tuple(f.from_words(a) for a in P)


def to_words(f, P):
    return tuple(f.to_words(a) for a in P)

