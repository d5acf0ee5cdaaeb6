"""SCS (sparse R1CS / PLONKish) builder.

Copy of gnark_tpu.frontend.scs (host only; the constraint-count profile
hook is left out, as in frontend/r1cs.py). Analog of the reference's
`frontend/cs/scs` builder (builder.go:43-70, api.go; SURVEY.md §2.1
"SCS (PLONKish) builder"): variables are single affine terms
coeff*wire + const; every non-affine op emits one sparse
gate  qL*a + qR*b + qM*a*b + qO*o + qC == 0.  Add/mul gates are
deduplicated CSE-style like the reference's mAddInstructions /
mMulInstructions maps (builder.go:478-640).
"""

from __future__ import annotations

from gnark_tpu_torch.constraint.hints import get_hint  # noqa: F401
from gnark_tpu_torch.constraint.system import (
    ConstraintSystem, Instruction, ONE_WIRE, SparseR1C,
)
from gnark_tpu_torch.fields import FieldParams
from gnark_tpu_torch.frontend.variable import Variable


class Term:
    """coeff * wire + const; wire == -1 means pure constant."""
    __slots__ = ("c", "w", "k")

    def __init__(self, c: int, w: int, k: int):
        self.c, self.w, self.k = c, w, k

    @property
    def is_const(self):
        return self.w < 0 or self.c == 0


class SCSBuilder:
    def __init__(self, field: FieldParams):
        self.cs = ConstraintSystem(field, "scs")
        self.q = field.modulus
        self._booleans: set = set()
        self._cse: dict = {}
        self.deferred: list = []    # post-define callbacks (circuitdefer)

    def defer_(self, fn) -> None:
        self.deferred.append(fn)

    def commit(self, *values):
        """BSB22 commitment: records COMMITTED rows (-v + qcp*c == 0)
        for each committed wire and a COMMITMENT row (-out + qk == 0)
        for the challenge wire, exactly like the reference SCS builder
        (frontend/cs/scs/api.go AddPlonkCommitmentInputs/Outputs).
        The PLONK backend turns the row indexes into Qcp columns."""
        from gnark_tpu_torch.constraint.system import (Commitment,
                                                       COMMITTED,
                                                       COMMITMENT)
        wires = []
        seen = set()
        for v in values:
            t = self._t(v)
            if t.is_const:
                continue            # constants carry no entropy
            if not t.is_const and t.c == 1 and t.k == 0:
                w = t.w
            else:
                # materialize: c*w + k - w2 == 0
                w2 = self.cs.new_internal_wire()
                xa = t.w if not t.is_const else 0
                self._gate(xa, xa, w2, t.c if not t.is_const else 0,
                           0, self.q - 1, 0, t.k, solve_wire=w2)
                w = w2
            if w not in seen:       # dedup (Commit api.go:735-757)
                seen.add(w)
                wires.append(w)
        if not wires:
            raise ValueError("commit called with no non-constant values")
        committed_rows = []
        for w in wires:
            committed_rows.append(len(self.cs.sparse))
            self._gate(w, 0, 0, self.q - 1, 0, 0, 0, 0,
                       commitment=COMMITTED)
        cvar = self.new_hint("bsb22", 1,
                             *[Term(1, w, 0) for w in wires])[0]
        cm_row = len(self.cs.sparse)
        self._gate(cvar.w, 0, 0, self.q - 1, 0, 0, 0, 0,
                   commitment=COMMITMENT)
        self.cs.commitments.append(Commitment(
            committed_wires=tuple(wires),
            commitment_wire=cvar.w, hint_name="bsb22",
            committed_rows=tuple(committed_rows), commitment_row=cm_row))
        return cvar

    # -- compiler surface ---------------------------------------------------

    def field(self) -> int:
        return self.q

    def field_bitlen(self) -> int:
        return self.cs.field.bits

    def _t(self, v) -> Term:
        if isinstance(v, Term):
            return v
        if isinstance(v, Variable):     # from hints: single-wire lc
            e = v.e
            if len(e) == 0:
                return Term(0, -1, 0)
            if len(e) == 1:
                c, w = e[0]
                return Term(c, w, 0) if w != ONE_WIRE else Term(0, -1, c)
            raise TypeError("SCS variables are single terms")
        if isinstance(v, int):
            return Term(0, -1, v % self.q)
        raise TypeError(f"not a circuit value: {v!r}")

    def constant_value(self, v):
        t = self._t(v)
        return t.k % self.q if t.is_const else None

    def public_variable(self, name: str) -> Term:
        assert self.cs.nb_secret == 0 and self.cs.nb_internal == 0
        self.cs.public_names.append(name)
        return Term(1, self.cs.nb_public - 1, 0)

    def secret_variable(self, name: str) -> Term:
        assert self.cs.nb_internal == 0
        self.cs.secret_names.append(name)
        return Term(1, self.cs.nb_public + self.cs.nb_secret - 1, 0)

    # -- gate plumbing --------------------------------------------------------

    def _gate(self, xa, xb, xo, qL, qR, qO, qM, qC, solve_wire=None,
              cse_key=None, commitment=0):
        """Append a sparse gate; returns via CSE when identical gate exists."""
        q = self.q
        qL, qR, qO, qM, qC = qL % q, qR % q, qO % q, qM % q, qC % q
        if cse_key is not None and cse_key in self._cse:
            return self._cse[cse_key]
        cidx = len(self.cs.sparse)
        self.cs.sparse.append(SparseR1C(xa=xa, xb=xb, xo=xo, qL=qL, qR=qR,
                                        qO=qO, qM=qM, qC=qC,
                                        commitment=commitment))
        ins = {xa, xb, xo}
        if solve_wire is None:
            inst = Instruction(kind="scs", cidx=cidx)
        else:
            ins.discard(solve_wire)
            inst = Instruction(kind="scs", cidx=cidx, outputs=(solve_wire,))
        self.cs.add_instruction(inst, ins)
        if cse_key is not None:
            self._cse[cse_key] = solve_wire
        return solve_wire

    def new_hint(self, name: str, n_outputs: int, *inputs):
        get_hint(name)
        in_lcs = []
        for v in inputs:
            t = self._t(v)
            if t.is_const:
                in_lcs.append(((t.k % self.q, ONE_WIRE),) if t.k else ())
            else:
                e = [(t.c, t.w)]
                if t.k:
                    e.append((t.k, ONE_WIRE)) if t.w != ONE_WIRE else None
                in_lcs.append(tuple(sorted(e, key=lambda p: p[1])))
        outs = tuple(self.cs.new_internal_wire() for _ in range(n_outputs))
        ins = set()
        for e in in_lcs:
            ins.update(w for _, w in e if w != ONE_WIRE)
        self.cs.add_instruction(
            Instruction(kind="hint", hint_name=name, inputs=tuple(in_lcs),
                        outputs=outs), ins)
        return [Term(1, w, 0) for w in outs]

    # -- arithmetic ------------------------------------------------------------

    def add(self, a, b, *rest) -> Term:
        r = self._add2(self._t(a), self._t(b))
        for v in rest:
            r = self._add2(r, self._t(v))
        return r

    def _add2(self, ta: Term, tb: Term) -> Term:
        q = self.q
        if ta.is_const:
            if tb.is_const:
                return Term(0, -1, (ta.k + tb.k) % q)
            return Term(tb.c, tb.w, (tb.k + ta.k) % q)
        if tb.is_const:
            return Term(ta.c, ta.w, (ta.k + tb.k) % q)
        if ta.w == tb.w:
            return Term((ta.c + tb.c) % q, ta.w, (ta.k + tb.k) % q)
        # gate: ca*a + cb*b + (ka+kb) - o == 0
        key = ("add", ta.c, ta.w, tb.c, tb.w, (ta.k + tb.k) % q)
        if key in self._cse:
            return Term(1, self._cse[key], 0)
        o = self.cs.new_internal_wire()
        self._gate(ta.w, tb.w, o, ta.c, tb.c, q - 1, 0,
                   (ta.k + tb.k) % q, solve_wire=o, cse_key=key)
        return Term(1, o, 0)

    def sub(self, a, b, *rest) -> Term:
        r = self._add2(self._t(a), self._neg_t(self._t(b)))
        for v in rest:
            r = self._add2(r, self._neg_t(self._t(v)))
        return r

    def _neg_t(self, t: Term) -> Term:
        q = self.q
        return Term((q - t.c) % q if not t.is_const else 0, t.w,
                    (q - t.k) % q if t.k else 0)

    def neg(self, a) -> Term:
        return self._neg_t(self._t(a))

    def mul(self, a, b, *rest) -> Term:
        r = self._mul2(self._t(a), self._t(b))
        for v in rest:
            r = self._mul2(r, self._t(v))
        return r

    def _mul2(self, ta: Term, tb: Term) -> Term:
        q = self.q
        if ta.is_const:
            if tb.is_const:
                return Term(0, -1, ta.k * tb.k % q)
            return Term(tb.c * ta.k % q, tb.w, tb.k * ta.k % q)
        if tb.is_const:
            return Term(ta.c * tb.k % q, ta.w, ta.k * tb.k % q)
        # (ca*a+ka)(cb*b+kb): qM=ca*cb, qL=ca*kb, qR=cb*ka, qC=ka*kb
        key = ("mul", ta.c, ta.w, ta.k, tb.c, tb.w, tb.k)
        if key in self._cse:
            return Term(1, self._cse[key], 0)
        o = self.cs.new_internal_wire()
        self._gate(ta.w, tb.w, o,
                   ta.c * tb.k % q, tb.c * ta.k % q, q - 1,
                   ta.c * tb.c % q, ta.k * tb.k % q,
                   solve_wire=o, cse_key=key)
        return Term(1, o, 0)

    def mul_acc(self, a, b, c) -> Term:
        return self.add(a, self.mul(b, c))

    def div_unchecked(self, a, b) -> Term:
        ta, tb = self._t(a), self._t(b)
        if ta.is_const and tb.is_const:
            if tb.k == 0:
                if ta.k == 0:
                    return Term(0, -1, 0)
                raise ZeroDivisionError("division by constant zero")
            return Term(0, -1, ta.k * pow(tb.k, -1, self.q) % self.q)
        if tb.is_const:
            if tb.k == 0:
                raise ZeroDivisionError("division by constant zero")
            return self._mul2(ta, Term(0, -1, pow(tb.k, -1, self.q)))
        res = self.new_hint("div", 1, ta, tb)[0]
        # res * b - a == 0
        d = self.sub(self.mul(res, tb), ta)
        self.assert_is_equal(d, 0)
        return res

    def div(self, a, b) -> Term:
        return self.mul(a, self.inverse(b))

    def inverse(self, a) -> Term:
        ta = self._t(a)
        if ta.is_const:
            if ta.k == 0:
                raise ZeroDivisionError("inverse of constant zero")
            return Term(0, -1, pow(ta.k, -1, self.q))
        res = self.new_hint("inv_zero", 1, ta)[0]
        self.assert_is_equal(self.mul(ta, res), 1)
        return res

    # -- binary ---------------------------------------------------------------

    def to_binary(self, a, nbits=None):
        if nbits is None:
            nbits = self.field_bitlen()
        ta = self._t(a)
        if ta.is_const:
            if ta.k >= (1 << nbits):
                raise ValueError(f"constant {ta.k} doesn't fit {nbits} bits")
            return [Term(0, -1, (ta.k >> i) & 1) for i in range(nbits)]
        bits = self.new_hint("to_bits", nbits, ta, nbits)
        for b in bits:
            self.assert_is_boolean(b)
        acc = Term(0, -1, 0)
        for i, b in enumerate(bits):
            acc = self._add2(acc, Term((1 << i) % self.q, b.w, 0))
        self.assert_is_equal(acc, ta)
        if nbits >= self.field_bitlen():
            # pin the canonical decomposition (see r1cs.to_binary)
            self._bits_leq_const(bits, self.q - 1)
        return bits

    def from_binary(self, bits) -> Term:
        acc = Term(0, -1, 0)
        for i, b in enumerate(bits):
            self.assert_is_boolean(b)
            tb = self._t(b)
            acc = self._add2(acc, self._mul2(tb, Term(0, -1, (1 << i) % self.q)))
        return acc

    # -- booleans ---------------------------------------------------------------

    def _bkey(self, t: Term):
        return (t.c, t.w, t.k)

    def mark_boolean(self, v):
        self._booleans.add(self._bkey(self._t(v)))

    def is_boolean_marked(self, v):
        return self._bkey(self._t(v)) in self._booleans

    def assert_is_boolean(self, v):
        t = self._t(v)
        if t.is_const:
            if t.k not in (0, 1):
                raise ValueError(f"constant {t.k} is not boolean")
            return
        if self._bkey(t) in self._booleans:
            return
        self._booleans.add(self._bkey(t))
        # t*(t-1) == 0: qM = c^2, qL = c(2k-1), qC = k(k-1), xa=xb=w
        q = self.q
        self._gate(t.w, t.w, t.w,
                   t.c * (2 * t.k - 1) % q, 0, 0,
                   t.c * t.c % q, t.k * (t.k - 1) % q)

    def and_(self, a, b) -> Term:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        r = self.mul(a, b)
        self.mark_boolean(r)
        return r

    def or_(self, a, b) -> Term:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        # r = a + b - a*b
        r = self.sub(self.add(a, b), self.mul(a, b))
        self.mark_boolean(r)
        return r

    def xor(self, a, b) -> Term:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        r = self.sub(self.add(a, b), self.mul(2, a, b))
        self.mark_boolean(r)
        return r

    # -- conditionals ---------------------------------------------------------

    def select(self, cond, a, b) -> Term:
        tc = self._t(cond)
        cc = self.constant_value(tc)
        if cc is not None:
            return self._t(a) if cc == 1 else self._t(b)
        return self.add(self.mul(cond, self.sub(a, b)), b)

    def lookup2(self, b0, b1, t0, t1, t2, t3) -> Term:
        s1 = self.select(b0, t1, t0)
        s2 = self.select(b0, t3, t2)
        return self.select(b1, s2, s1)

    def is_zero(self, a) -> Term:
        ta = self._t(a)
        if ta.is_const:
            return Term(0, -1, 1 if ta.k == 0 else 0)
        m, inv = self.new_hint("is_zero", 2, ta)
        self.assert_is_equal(self.mul(ta, inv), self.sub(1, m))
        self.assert_is_equal(self.mul(ta, m), 0)
        self.mark_boolean(m)
        return m

    def cmp(self, a, b) -> Term:
        n = self.field_bitlen()
        ab = self.to_binary(a, n)
        bb = self.to_binary(b, n)
        res = Term(0, -1, 0)
        for i in range(n):
            d = self.sub(ab[i], bb[i])
            d2 = self.mul(d, d)
            res = self.select(d2, d, res)
        return res

    # -- assertions ----------------------------------------------------------

    def assert_is_equal(self, a, b):
        ta, tb = self._t(a), self._t(b)
        q = self.q
        if ta.is_const and tb.is_const:
            if ta.k % q != tb.k % q:
                raise ValueError("assert_is_equal on unequal constants")
            return
        if ta.is_const:
            ta, tb = tb, ta
        if tb.is_const:
            # ca*a + (ka - kb) == 0
            self._gate(ta.w, ta.w, ta.w, ta.c, 0, 0, 0, (ta.k - tb.k) % q)
            return
        if ta.w == tb.w:
            if (ta.c - tb.c) % q == 0:
                if (ta.k - tb.k) % q:
                    raise ValueError("assert_is_equal constants differ")
                return
            self._gate(ta.w, ta.w, ta.w, (ta.c - tb.c) % q, 0, 0, 0,
                       (ta.k - tb.k) % q)
            return
        self._gate(ta.w, tb.w, ta.w, ta.c, (q - tb.c) % q, 0, 0,
                   (ta.k - tb.k) % q)

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))

    def assert_is_crumb(self, v):
        u = self.mul(v, self.sub(v, 1))
        w = self.mul(self.sub(v, 2), self.sub(v, 3))
        self.assert_is_equal(self.mul(u, w), 0)

    def assert_is_less_or_equal(self, v, bound):
        tb = self._t(bound)
        cb = self.constant_value(tb)
        n = self.field_bitlen()
        if cb is not None:
            self._less_or_eq_const(v, cb)
            return
        vbits = self.to_binary(v, n)
        bbits = self.to_binary(bound, n)
        p = Term(0, -1, 1)
        for i in range(n - 1, -1, -1):
            pm = self.mul(p, vbits[i])
            p_next = self.select(bbits[i], pm, p)
            t = self.select(bbits[i], 0, p)
            l = self.sub(1, t, vbits[i])
            self.assert_is_equal(self.mul(l, vbits[i]), 0)
            p = p_next

    def _less_or_eq_const(self, v, bound: int):
        nbits = max(bound.bit_length(), 1)
        if bound >= (1 << self.field_bitlen()) - 1:
            return
        vbits = self.to_binary(v, nbits)
        self._bits_leq_const(vbits, bound)

    def _bits_leq_const(self, vbits, bound: int):
        p = Term(0, -1, 1)
        for i in range(len(vbits) - 1, -1, -1):
            if (bound >> i) & 1:
                p = self.mul(p, vbits[i])
            else:
                self.assert_is_equal(self.mul(p, vbits[i]), 0)

    # -- debug ------------------------------------------------------------------

    def println(self, fmt, *args):
        lcs = []
        for a in args:
            t = self._t(a)
            e = []
            if not t.is_const and t.c:
                e.append((t.c, t.w))
            if t.k:
                e.append((t.k, ONE_WIRE))
            lcs.append(tuple(sorted(e, key=lambda p: p[1])))
        self.cs.logs.append((fmt, tuple(lcs)))
        ins = set()
        for e in lcs:
            ins.update(w for _, w in e if w != ONE_WIRE)
        self.cs.add_instruction(
            Instruction(kind="log", cidx=len(self.cs.logs) - 1), ins)
