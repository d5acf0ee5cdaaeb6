"""Host optimal-ate pairings (BN and BLS12 families).

The Tate engine (pairing/tate.py) is what the backends verify with; it
is pairing-product-equivalent but its GT values are NOT the ones gnark
serializes (reference gnark-crypto curve.Pair = optimal ate,
backend/groth16/bn254/verify.go:70-143). This module computes the
*ate* pairing itself, so GT artifacts (e.g. vk.e_alpha_beta) are
interoperable, and it doubles as the host oracle for the in-circuit
emulated pairing (std/algebra/pairing_bn254.py) and for
residue-witness hints.

Loop lengths: BN: 6x+2 with two psi-Frobenius correction lines
(Vercauteren, "Optimal pairings"); BLS12: x (conjugate when x < 0).

Implementation style: the Miller loop runs on the UNTWISTED point in
E(Fp^12) with generic extension-field affine arithmetic — slower than
twisted-coordinate formulas but host time is milliseconds and the code
stays auditable; psi is then literally the coordinate-wise p-power
Frobenius. Final exponentiation: easy part + plain big-int pow for the
hard part (host correctness beats host speed)."""

from __future__ import annotations

import functools

from gnark_tpu_torch.ec.curves import CURVES, Curve
from gnark_tpu_torch.ec.curves_data import CURVES_DATA
from gnark_tpu_torch.ec.host import INF
from gnark_tpu_torch.pairing.tate import Pairing, pow_in


class AtePairing:
    def __init__(self, curve: Curve):
        if curve.name not in ("bn254", "bls12_381", "bls12_377"):
            raise ValueError(f"no ate engine for {curve.name}")
        self.curve = curve
        self.tate = Pairing(curve)     # tower + untwist machinery
        self.ext = self.tate.ext
        self.fq = self.tate.fq
        self.p = self.tate.p
        self.r = self.tate.r
        self.seed = CURVES_DATA[curve.name]["seed"]
        self.is_bn = curve.name == "bn254"
        # Frobenius constants gamma_n[i] = xi^(i*(p^n-1)/6) for the
        # coordinate-wise p^n-power map on Fp12 = Fp2[w]/(w^6-xi)
        hf = self.fq
        xi = self.tate.xi
        p = self.p
        self._g1 = [pow_in(hf, xi, i * (p - 1) // 6) for i in range(6)]
        self._g2 = [pow_in(hf, xi, i * (p * p - 1) // 6)
                    for i in range(6)]
        self._g6 = [pow_in(hf, xi, i * (p ** 6 - 1) // 6)
                    for i in range(6)]
        self.final_hard = (p ** 4 - p ** 2 + 1) // self.r

    # -- Fp12 Frobenius maps --------------------------------------------------

    def _fq_frob(self, c):
        """c^p for c in Fq (= Fp2 conjugation)."""
        return self.fq.conj(c) if hasattr(self.fq, "conj") \
            else (c[0], self.fq.base.neg(c[1]))

    def frob(self, a, n: int = 1):
        """a^(p^n) coefficient-wise on Fp12, n in {1, 2, 6}."""
        g = {1: self._g1, 2: self._g2, 6: self._g6}[n]
        out = []
        for i, ai in enumerate(a):
            c = ai
            if n == 1:
                c = self._fq_frob(c)
            # p^2 and p^6 fix Fp2
            out.append(self.fq.mul(c, g[i]))
        return tuple(out)

    def conj6(self, a):
        return self.frob(a, 6)

    # -- untwisted affine point ops ------------------------------------------

    def _pt_dbl(self, T):
        ext = self.ext
        x, y = T
        lam = ext.mul(ext.mul(self._c3, ext.mul(x, x)),
                      ext.inv(ext.mul(self._c2, y)))
        x3 = ext.sub(ext.mul(lam, lam), ext.mul(self._c2, x))
        y3 = ext.sub(ext.mul(lam, ext.sub(x, x3)), y)
        return (x3, y3), lam

    def _pt_add(self, T, Q):
        ext = self.ext
        (x1, y1), (x2, y2) = T, Q
        lam = ext.mul(ext.sub(y2, y1), ext.inv(ext.sub(x2, x1)))
        x3 = ext.sub(ext.sub(ext.mul(lam, lam), x1), x2)
        y3 = ext.sub(ext.mul(lam, ext.sub(x1, x3)), y1)
        return (x3, y3), lam

    def _line(self, lam, T, P):
        """l(P) = (yp - y_T) - lam*(xp - x_T), P = (xp, yp) in Fp."""
        ext = self.ext
        xt, yt = T
        xp, yp = P
        fq = self.fq
        yp_e = ext.from_base(fq.from_int(yp) if fq is not self.tate.fp
                             else yp, 0)
        xp_e = ext.from_base(fq.from_int(xp) if fq is not self.tate.fp
                             else xp, 0)
        t = ext.sub(yp_e, yt)
        return ext.sub(t, ext.mul(lam, ext.sub(xp_e, xt)))

    # -- Miller loop ----------------------------------------------------------

    def miller_loop(self, P, Q):
        """BN: f_{6x+2,Q}(P) * psi lines; BLS12: f_{|x|,Q}(P) (conj if
        x < 0). P in G1 (host ints), Q in G2' (twist coords)."""
        if P is INF or Q is INF:
            return self.ext.one
        ext = self.ext
        self._c2 = ext.from_base(self.fq.from_int(2)
                                 if self.fq is not self.tate.fp else 2, 0)
        self._c3 = ext.from_base(self.fq.from_int(3)
                                 if self.fq is not self.tate.fp else 3, 0)
        Qe = self.tate.untwist(Q)
        P = (P[0] % self.p, P[1] % self.p)
        s = 6 * self.seed + 2 if self.is_bn else abs(self.seed)
        f = ext.one
        T = Qe
        for b in bin(s)[3:]:
            Told = T
            T, lam = self._pt_dbl(T)
            # tangent line through the PRE-doubling point
            f = ext.mul(ext.sqr(f), self._line(lam, Told, P))
            if b == "1":
                Told = T
                T, lam = self._pt_add(T, Qe)
                f = ext.mul(f, self._line(lam, Told, P))
        if self.is_bn:
            Q1 = (self.frob(Qe[0]), self.frob(Qe[1]))          # psi(Q)
            Q2 = (self.frob(Qe[0], 2), self.frob(Qe[1], 2))    # psi^2(Q)
            nQ2 = (Q2[0], ext.neg(Q2[1]))
            Told = T
            T, lam = self._pt_add(T, Q1)
            f = ext.mul(f, self._line(lam, Told, P))
            Told = T
            T, lam = self._pt_add(T, nQ2)
            f = ext.mul(f, self._line(lam, Told, P))
        elif self.seed < 0:
            f = self.conj6(f)
        return f

    # -- final exponentiation -------------------------------------------------

    def final_exponentiation(self, f):
        ext = self.ext
        # easy: f^(p^6-1) then ^(p^2+1)
        f = ext.mul(self.conj6(f), ext.inv(f))
        f = ext.mul(self.frob(f, 2), f)
        # hard: plain pow (host)
        return ext.pow(f, self.final_hard)

    def pair(self, P, Q):
        return self.final_exponentiation(self.miller_loop(P, Q))

    def pairing_product(self, pairs):
        f = self.ext.one
        for P, Q in pairs:
            f = self.ext.mul(f, self.miller_loop(P, Q))
        return self.final_exponentiation(f)

    def gt_one(self):
        return self.ext.one


@functools.lru_cache(maxsize=None)
def get_ate(curve_name: str) -> AtePairing:
    return AtePairing(CURVES[curve_name])
