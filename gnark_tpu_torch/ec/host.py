"""Host-side (pure Python int) finite-field and curve arithmetic.

This is the framework's *oracle and orchestration* layer: differential
test reference for the device kernels, one-time constant derivation,
and the small host-side scalar ops a prover needs (proof assembly,
verifier pairings are built on top of these field towers).

It plays the role gnark-crypto's generic (non-asm) code paths play in
the reference (SURVEY.md §2.1 "gnark-crypto (EXTERNAL, native)") — the
hot batched paths live on TPU in gnark_tpu_torch.ff / gnark_tpu_torch.ec.weierstrass.
"""

from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


class Fp:
    """Prime field of Python ints (elements are ints in [0, p))."""

    def __init__(self, p: int):
        self.p = p
        self.zero = 0
        self.one = 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def sqr(self, a):
        return (a * a) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def is_zero(self, a):
        return a == 0

    def eq(self, a, b):
        return a == b

    def from_int(self, k: int):
        return k % self.p

    def legendre(self, a) -> int:
        if a % self.p == 0:
            return 0
        return 1 if pow(a, (self.p - 1) // 2, self.p) == 1 else -1

    def is_square(self, a) -> bool:
        return self.legendre(a) >= 0

    def sqrt(self, a):
        """Tonelli-Shanks; returns the lexicographically smaller root."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        if p % 4 == 3:
            r = pow(a, (p + 1) // 4, p)
        else:
            # general Tonelli-Shanks
            q, s = p - 1, 0
            while q % 2 == 0:
                q //= 2
                s += 1
            z = 2
            while self.legendre(z) != -1:
                z += 1
            m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
            while t != 1:
                i, tt = 0, t
                while tt != 1:
                    tt = tt * tt % p
                    i += 1
                b = pow(c, 1 << (m - i - 1), p)
                m, c = i, b * b % p
                t, r = t * c % p, r * b % p
        return min(r, p - r)

    def rand(self, rng):
        return rng.randrange(self.p)


class Fp2:
    """Quadratic extension Fp[u]/(u^2 - nr). Elements are (a0, a1) tuples."""

    def __init__(self, base: Fp, nr: int):
        self.base = base
        self.p = base.p
        self.nr = nr % base.p
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)

    def mul(self, a, b):
        p = self.p
        t0 = a[0] * b[0] % p
        t1 = a[1] * b[1] % p
        t2 = (a[0] + a[1]) * (b[0] + b[1]) % p
        return ((t0 + t1 * self.nr) % p, (t2 - t0 - t1) % p)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        p = self.p
        d = (a[0] * a[0] - self.nr * a[1] * a[1]) % p
        di = pow(d, -1, p)
        return (a[0] * di % p, (-a[1]) * di % p)

    def is_zero(self, a):
        return a[0] == 0 and a[1] == 0

    def eq(self, a, b):
        return a[0] == b[0] and a[1] == b[1]

    def from_int(self, k: int):
        return (k % self.p, 0)

    def conj(self, a):
        return (a[0], (-a[1]) % self.p)

    def norm(self, a) -> int:
        return (a[0] * a[0] - self.nr * a[1] * a[1]) % self.p

    def is_square(self, a) -> bool:
        # a square in Fp2 iff its norm is a square in Fp
        return self.is_zero(a) or Fp(self.p).legendre(self.norm(a)) == 1

    def sqrt(self, a):
        """sqrt in Fp2 via the complex method (works for any p odd)."""
        if self.is_zero(a):
            return self.zero
        if not self.is_square(a):
            return None
        base = Fp(self.p)
        if a[1] == 0:
            # sqrt of base-field element: either sqrt(a0) or sqrt(a0/nr)*u
            r = base.sqrt(a[0])
            if r is not None:
                return (r, 0)
            r = base.sqrt(a[0] * pow(self.nr, -1, self.p) % self.p)
            return (0, r)
        # alpha = norm(a); delta = (a0 + sqrt(alpha))/2 must be a square
        alpha = base.sqrt(self.norm(a))
        inv2 = pow(2, -1, self.p)
        delta = (a[0] + alpha) * inv2 % self.p
        if base.legendre(delta) != 1:
            delta = (a[0] - alpha) * inv2 % self.p
        x0 = base.sqrt(delta)
        x1 = a[1] * pow(2 * x0, -1, self.p) % self.p
        return (x0, x1)

    def rand(self, rng):
        return (rng.randrange(self.p), rng.randrange(self.p))


# ---------------------------------------------------------------------------
# short Weierstrass y^2 = x^3 + b over a generic field (a = 0 everywhere
# in the gnark curve zoo: BN254, BLS12-377/381, BW6-761, grumpkin)
# ---------------------------------------------------------------------------

INF = None  # point at infinity marker for affine host points


def ec_on_curve(f, b, P) -> bool:
    if P is INF:
        return True
    x, y = P
    return f.eq(f.sqr(y), f.add(f.mul(f.sqr(x), x), b))


def ec_neg(f, P):
    if P is INF:
        return INF
    return (P[0], f.neg(P[1]))


def ec_add(f, P, Q):
    if P is INF:
        return Q
    if Q is INF:
        return P
    x1, y1 = P
    x2, y2 = Q
    if f.eq(x1, x2):
        if f.eq(y1, y2):
            if f.is_zero(y1):
                return INF
            # doubling: lambda = 3x^2 / 2y
            lam = f.mul(f.mul(f.from_int(3), f.sqr(x1)),
                        f.inv(f.mul(f.from_int(2), y1)))
        else:
            return INF
    else:
        lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
    x3 = f.sub(f.sub(f.sqr(lam), x1), x2)
    y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
    return (x3, y3)


def ec_dbl(f, P):
    return ec_add(f, P, P)


def ec_mul(f, P, k: int):
    if k < 0:
        return ec_mul(f, ec_neg(f, P), -k)
    R = INF
    while k:
        if k & 1:
            R = ec_add(f, R, P)
        P = ec_dbl(f, P)
        k >>= 1
    return R


def ec_msm(f, points, scalars):
    """Naive host MSM (test oracle)."""
    R = INF
    for P, s in zip(points, scalars):
        R = ec_add(f, R, ec_mul(f, P, s))
    return R


def find_point(f, b, start_x: int = 0):
    """Deterministic curve point: first x >= start_x with x^3+b square."""
    x_int = start_x
    while True:
        x = f.from_int(x_int)
        rhs = f.add(f.mul(f.sqr(x), x), b)
        y = f.sqrt(rhs)
        if y is not None and not (f.is_zero(y) and f.is_zero(rhs) is False):
            return (x, y)
        x_int += 1


# ---------------------------------------------------------------------------
# point validation (untrusted input hardening)
# ---------------------------------------------------------------------------

def validate_point(curve, P, g2: bool = False) -> bool:
    """Full validation of an untrusted affine point: well-formed coords
    in [0, p), on-curve, and in the order-r subgroup.

    The reference enforces the same checks on every unmarshal
    (gnark-crypto SetBytes: on-curve + subgroup, used by
    backend/groth16/bn254/marshal.go); without them, invalid-curve /
    wrong-subgroup points reach the verifier pairing equation (forgery
    surface) or crash the Miller loop at yt = 0.
    """
    if P is INF:
        return True
    if g2:
        if curve.g2 is None:
            return False
        f = curve.host_g2_field
        b = curve.b2
        cofactor = curve.h2
    else:
        f = curve.host_fp
        b = curve.b
        cofactor = curve.h1
    if not (isinstance(P, tuple) and len(P) == 2):
        return False
    if isinstance(f, Fp2):
        if not all(isinstance(c, tuple) and len(c) == 2 and
                   all(isinstance(v, int) and 0 <= v < f.base.p for v in c)
                   for c in P):
            return False
        if not isinstance(b, tuple):
            b = (b, 0)
    else:
        if not all(isinstance(v, int) and 0 <= v < f.p for v in P):
            return False
    if not ec_on_curve(f, b, P):
        return False
    if cofactor != 1:
        # subgroup check: r*P == INF (curve.fr is the subgroup order)
        if ec_mul(f, P, curve.fr.modulus) is not INF:
            return False
    return True


def validate_points(curve, g1_points=(), g2_points=()) -> bool:
    return (all(validate_point(curve, P) for P in g1_points) and
            all(validate_point(curve, P, g2=True) for P in g2_points))
