"""Host pairings for Groth16/PLONK verification and KZG checks.

We use the **Tate pairing** with denominator elimination instead of the
optimal ate pairing gnark-crypto uses (reference call sites:
backend/groth16/bn254/verify.go:70-143 MillerLoop/FinalExponentiation).
All non-degenerate pairings on G1 x G2 are powers of one another, so a
pairing-product equation e(A,B) = e(C,D)·e(E,F) holds under Tate iff it
holds under ate — verification outcomes are identical, and the Tate
loop needs no Frobenius machinery, which keeps this host-side verifier
small and auditable. Verification cost is a few Miller loops + ONE
final exponentiation (multi-pairing), all in plain Python ints.

Tower: Fp^k = Fq[w]/(w^d - xi) with Fq = Fp2 (BN254/BLS12, k=12, d=6)
or Fq = Fp (BW6-761, k=6, d=6). G2 points untwist into the even
subalgebra Fq[w^2], whose elements die under the final exponentiation —
hence vertical lines can be dropped (denominator elimination).
"""

from __future__ import annotations

import functools

from gnark_tpu_torch.ec.curves import Curve
from gnark_tpu_torch.ec.host import INF, Fp, Fp2


class ExtField:
    """Fq[w]/(w^d - xi): elements are length-d tuples of Fq elements."""

    def __init__(self, base, d: int, xi):
        self.base = base
        self.d = d
        self.xi = xi
        self.zero = tuple(base.zero for _ in range(d))
        self.one = tuple([base.one] + [base.zero] * (d - 1))

    def from_base(self, c, power: int = 0):
        """c * w^power."""
        e = list(self.zero)
        e[power] = c
        return tuple(e)

    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        d, f = self.d, self.base
        t = [f.zero] * (2 * d - 1)
        for i, ai in enumerate(a):
            if f.is_zero(ai):
                continue
            for j, bj in enumerate(b):
                t[i + j] = f.add(t[i + j], f.mul(ai, bj))
        # reduce w^(d+i) = xi * w^i
        for i in range(2 * d - 2, d - 1, -1):
            t[i - d] = f.add(t[i - d], f.mul(t[i], self.xi))
        return tuple(t[:d])

    def sqr(self, a):
        return self.mul(a, a)

    def is_zero(self, a):
        return all(self.base.is_zero(x) for x in a)

    def eq(self, a, b):
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def pow(self, a, e: int):
        r = self.one
        base = a
        while e:
            if e & 1:
                r = self.mul(r, base)
            base = self.sqr(base)
            e >>= 1
        return r

    def _zeta6(self):
        """A primitive d-th root of unity in Fq (Galois generator for
        Fq[w]/(w^d - xi): sigma(w) = zeta*w)."""
        if hasattr(self, "_z6"):
            return self._z6
        f = self.base
        q = f.p ** 2 if isinstance(f, Fp2) else f.p
        assert (q - 1) % self.d == 0
        k = (q - 1) // self.d
        seed = 2
        while True:
            g = f.from_int(seed) if not isinstance(f, Fp2) \
                else (seed % f.base.p, 1)
            z = pow_in(f, g, k)
            # primitive iff z^(d/l) != 1 for prime l | d
            ok = not f.eq(z, f.one)
            for l in (2, 3):
                if self.d % l == 0 and f.eq(
                        pow_in(f, z, self.d // l), f.one):
                    ok = False
            if ok:
                self._z6 = z
                return z
            seed += 1

    def conjugates(self, a):
        """sigma_i(a) for i = 1..d-1 (sigma: w -> zeta*w)."""
        z = self._zeta6()
        f = self.base
        outs = []
        for i in range(1, self.d):
            e = [f.mul(aj, pow_in(f, z, (i * j) % self.d))
                 for j, aj in enumerate(a)]
            outs.append(tuple(e))
        return outs

    def inv(self, a):
        """Galois-norm inversion: inv(a) = (prod of conjugates) / N(a),
        N(a) = a * prod sigma_i(a) lies in Fq."""
        if self.is_zero(a):
            return self.zero
        prod = self.one
        for cj in self.conjugates(a):
            prod = self.mul(prod, cj)
        norm = self.mul(a, prod)
        f = self.base
        # norm must be a base-field element (w-degree 0)
        assert all(f.is_zero(c) for c in norm[1:]), "norm not in Fq"
        ninv = f.inv(norm[0])
        return tuple(f.mul(c, ninv) for c in prod)


class Pairing:
    """Tate pairing engine for one curve."""

    def __init__(self, curve: Curve):
        if curve.g2 is None:
            raise ValueError(f"{curve.name} has no G2/pairing")
        self.curve = curve
        p = curve.fp.modulus
        self.p = p
        self.r = curve.fr.modulus
        fp = Fp(p)
        self.fp = fp
        if curve.g2_over_fp2:
            fq = Fp2(fp, curve.fp2_nr)
            self.k = 12
            # twist type from b2: D if b2 == b/xi else M (xi from curve)
            xi = curve.xi if hasattr(curve, "xi") else None
        else:
            fq = fp
            self.k = 6
        self.fq = fq
        self.xi, self.d_type = self._find_xi()
        self.ext = ExtField(fq, 6, self.xi)
        self.final_exp = (p ** self.k - 1) // self.r
        # untwist exponents: D-type multiplies by w^2/w^3, M-type divides
        self._gt_one = self.ext.one

    def _find_xi(self):
        """Recover xi and twist type from b2: D-type b2 = b/xi, or
        M-type b2 = b*xi. Validated via bilinearity in pair_check."""
        c, fq = self.curve, self.fq
        b = fq.from_int(c.b)
        b2 = c.b2 if isinstance(c.b2, tuple) or not c.g2_over_fp2 else c.b2
        if c.g2_over_fp2:
            b2 = tuple(c.b2)
        else:
            b2 = c.b2 % self.p
        # D: xi = b / b2 ; M: xi = b2 / b
        xi_d = fq.mul(b, fq.inv(b2))
        xi_m = fq.mul(b2, fq.inv(b))
        # choose xi making w^6 - xi irreducible: xi must be a
        # non-square AND non-cube in Fq. Try D first (BN254/BLS12-377),
        # then M (BLS12-381, BW6-761).
        for xi, typ in ((xi_d, "D"), (xi_m, "M")):
            if self._is_valid_xi(xi):
                return xi, typ == "D"
        raise ValueError("no irreducible tower found")

    def _is_valid_xi(self, xi) -> bool:
        fq = self.fq
        q = self.p if not self.curve.g2_over_fp2 else self.p ** 2
        if fq.is_zero(xi):
            return False
        # non-square and non-cube in Fq*
        if pow_in(fq, xi, (q - 1) // 2) == fq.one:
            return False
        if (q - 1) % 3 == 0 and pow_in(fq, xi, (q - 1) // 3) == fq.one:
            return False
        return True

    # -- untwist -----------------------------------------------------------

    def untwist(self, Q):
        """E'(Fq) -> E(Fp^k): D-type (x*w^2, y*w^3), M-type (x/w^2, y/w^3).

        Both land in the even/odd w-graded components; verticals at
        even components vanish under the final exponentiation."""
        x, y = Q
        if not self.curve.g2_over_fp2:
            x, y = x % self.p, y % self.p
        ext = self.ext
        if self.d_type:
            return (ext.from_base(x, 2), ext.from_base(y, 3))
        # M-type: x/w^2 = x * w^4 / xi, y/w^3 = y * w^3 / xi
        xi_inv = self.fq.inv(self.xi)
        return (ext.from_base(self.fq.mul(x, xi_inv), 4),
                ext.from_base(self.fq.mul(y, xi_inv), 3))

    # -- Miller loop ---------------------------------------------------------

    def miller_loop(self, P, Q) -> tuple:
        """f_{r,P}(Q) without final exponentiation.

        P affine in E(Fp) (host ints), Q affine in E'(Fq) (untwisted
        internally). Verticals eliminated."""
        if P is INF or Q is INF:
            return self.ext.one
        fp, ext = self.fp, self.ext
        xq, yq = self.untwist(Q)
        xp, yp = P
        f = ext.one
        xt, yt = xp, yp
        bits = bin(self.r)[3:]  # MSB already consumed by T = P
        for b in bits:
            # tangent line at T, evaluated at Q
            lam = fp.mul(fp.mul(fp.from_int(3), fp.sqr(xt)),
                         fp.inv(fp.mul(fp.from_int(2), yt)))
            f = ext.sqr(f)
            f = ext.mul(f, self._line(lam, xt, yt, xq, yq))
            # T = 2T
            x3 = fp.sub(fp.sqr(lam), fp.mul(fp.from_int(2), xt))
            y3 = fp.sub(fp.mul(lam, fp.sub(xt, x3)), yt)
            xt, yt = x3, y3
            if b == "1":
                if fp.eq(xt, xp):
                    # adding opposite points: vertical line, eliminated.
                    # happens only at the last iteration (T = -P).
                    xt, yt = None, None
                    continue
                lam = fp.mul(fp.sub(yp, yt), fp.inv(fp.sub(xp, xt)))
                f = ext.mul(f, self._line(lam, xt, yt, xq, yq))
                x3 = fp.sub(fp.sub(fp.sqr(lam), xt), xp)
                y3 = fp.sub(fp.mul(lam, fp.sub(xt, x3)), yt)
                xt, yt = x3, y3
        return f

    def _line(self, lam, xt, yt, xq, yq):
        """(yq - yt) - lam*(xq - xt) in Fp^k, sparse."""
        ext, fq, fp = self.ext, self.fq, self.fp
        # constant term: -yt + lam*xt in Fp -> component 0
        c0 = fp.sub(fp.mul(lam, xt), yt)
        t = ext.from_base(fq.from_int(c0) if fq is not fp else c0, 0)
        t = ext.add(t, yq)
        lam_q = fq.from_int(lam) if fq is not fp else lam
        t = ext.sub(t, tuple(fq.mul(lam_q, c) for c in xq))
        return t

    # -- public API ----------------------------------------------------------

    def final_exponentiation(self, f) -> tuple:
        return self.ext.pow(f, self.final_exp)

    def pair(self, P, Q) -> tuple:
        """e(P, Q) in GT."""
        return self.final_exponentiation(self.miller_loop(P, Q))

    def pairing_product(self, pairs) -> tuple:
        """FE(prod_i ML(P_i, Q_i)) — the multi-pairing a verifier needs."""
        f = self.ext.one
        for P, Q in pairs:
            f = self.ext.mul(f, self.miller_loop(P, Q))
        return self.final_exponentiation(f)

    def gt_one(self) -> tuple:
        return self.ext.one


def pow_in(fq, x, e):
    r = fq.one
    while e:
        if e & 1:
            r = fq.mul(r, x)
        x = fq.sqr(x)
        e >>= 1
    return r


@functools.lru_cache(maxsize=None)
def get_pairing(curve_name: str) -> Pairing:
    from gnark_tpu_torch.ec.curves import CURVES
    return Pairing(CURVES[curve_name])
