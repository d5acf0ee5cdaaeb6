"""R1CS builder: the full frontend.API over rank-1 constraints.

Analog of the reference's `frontend/cs/r1cs` builder (builder.go, api.go
— 942 LoC API impl; SURVEY.md §2.1 "R1CS builder") with the same
semantics: variables are linear expressions, multiplication by
constants is free, each var*var product costs one constraint, boolean
constraints are deduplicated via a marker set.
"""

from __future__ import annotations

from gnark_tpu_torch.constraint.hints import get_hint  # noqa: F401 (validation)
from gnark_tpu_torch.constraint.system import (
    ConstraintSystem, Instruction, R1C,
)
from gnark_tpu_torch.fields import FieldParams
from gnark_tpu_torch.frontend.variable import (
    Variable, lc_const, lc_is_const, lc_merge, lc_scale, lc_single, lc_wires,
)


import os
import traceback


def _debug_enabled() -> bool:
    """Attach source locations to assertion constraints when set
    (reference `debug` build tag; costs a stack walk per assert)."""
    return os.environ.get("GNARK_TPU_DEBUG") == "1"


def _caller_location() -> str:
    for f in reversed(traceback.extract_stack()):
        fn = f.filename
        if "gnark_tpu_torch/frontend" in fn:
            continue
        return f"{fn.rsplit('/', 1)[-1]}:{f.lineno} in {f.name}"
    return "?"


class R1CSBuilder:
    """Builds a ConstraintSystem(kind='r1cs') while serving the API."""

    def __init__(self, field: FieldParams,
                 compress_threshold: int = 300):
        self.cs = ConstraintSystem(field, "r1cs")
        self.q = field.modulus
        self.compress_threshold = compress_threshold
        self._booleans: set = set()
        self.deferred: list = []    # post-define callbacks (circuitdefer)

    def defer_(self, fn) -> None:
        """Run fn(builder) after define() returns (reference
        internal/circuitdefer; used by lookups/multicommit)."""
        self.deferred.append(fn)

    # ------------------------------------------------------------------
    # compiler surface (reference frontend/builder.go Compiler iface)
    # ------------------------------------------------------------------

    def field(self) -> int:
        return self.q

    def field_bitlen(self) -> int:
        return self.cs.field.bits

    def _lc(self, v) -> tuple:
        if isinstance(v, Variable):
            return v.e
        if isinstance(v, int):
            return lc_const(self.q, v)
        raise TypeError(f"not a circuit value: {v!r}")

    def constant_value(self, v):
        """Constant value of v, or None if not a compile-time constant."""
        return lc_is_const(self._lc(v))

    def public_variable(self, name: str) -> Variable:
        assert self.cs.nb_secret == 0 and self.cs.nb_internal == 0, \
            "public wires must be allocated first"
        self.cs.public_names.append(name)
        return Variable(lc_single(self.cs.nb_public - 1))

    def secret_variable(self, name: str) -> Variable:
        assert self.cs.nb_internal == 0, \
            "secret wires must be allocated before any constraint"
        self.cs.secret_names.append(name)
        return Variable(lc_single(self.cs.nb_public + self.cs.nb_secret - 1))

    # ------------------------------------------------------------------
    # constraint plumbing
    # ------------------------------------------------------------------

    def _add_r1c(self, l, r, o, solved_wire: int | None, debug=None):
        if debug is None and solved_wire is None and _debug_enabled():
            debug = _caller_location()
        cidx = len(self.cs.r1cs)
        self.cs.r1cs.append(R1C(l, r, o))
        ins = set(lc_wires(l)) | set(lc_wires(r)) | set(lc_wires(o))
        if solved_wire is None:
            inst = Instruction(kind="assert", cidx=cidx, debug=debug)
        else:
            ins.discard(solved_wire)
            inst = Instruction(kind="r1c", cidx=cidx,
                               outputs=(solved_wire,), debug=debug)
        self.cs.add_instruction(inst, ins)

    def new_hint(self, name: str, n_outputs: int, *inputs) -> list[Variable]:
        """Allocate n_outputs wires solved by the named hint
        (reference: constraint/solver/hint.go)."""
        get_hint(name)  # fail fast on unknown hints
        in_lcs = tuple(self._lc(v) for v in inputs)
        outs = tuple(self.cs.new_internal_wire() for _ in range(n_outputs))
        ins = set()
        for e in in_lcs:
            ins.update(lc_wires(e))
        self.cs.add_instruction(
            Instruction(kind="hint", hint_name=name, inputs=in_lcs,
                        outputs=outs), ins)
        return [Variable(lc_single(w)) for w in outs]

    # ------------------------------------------------------------------
    # arithmetic API (reference frontend/api.go:13-60)
    # ------------------------------------------------------------------

    def _compress(self, lc):
        """Replace a long linear expression by one fresh wire pinned
        with an equality R1C (reference builder.go:476-489 compress +
        frontend.CompressThreshold default 300): keeps downstream
        gates small when chained adds snowball."""
        if self.compress_threshold <= 0 or \
                len(lc) < self.compress_threshold:
            return lc
        t = self.cs.new_internal_wire()
        self._add_r1c(lc, lc_const(self.q, 1), lc_single(t), t)
        return lc_single(t)

    def add(self, a, b, *rest) -> Variable:
        return Variable(self._compress(
            lc_merge(self.q, self._lc(a), self._lc(b),
                     *(self._lc(v) for v in rest))))

    def sub(self, a, b, *rest) -> Variable:
        neg = [lc_scale(self.q, self._lc(v), self.q - 1)
               for v in (b, *rest)]
        return Variable(self._compress(
            lc_merge(self.q, self._lc(a), *neg)))

    def neg(self, a) -> Variable:
        return Variable(lc_scale(self.q, self._lc(a), self.q - 1))

    def mul(self, a, b, *rest) -> Variable:
        res = self._mul2(self._lc(a), self._lc(b))
        for v in rest:
            res = self._mul2(res, self._lc(v))
        return Variable(res)

    def _mul2(self, la, lb) -> tuple:
        ca, cb = lc_is_const(la), lc_is_const(lb)
        if ca is not None:
            return lc_scale(self.q, lb, ca)
        if cb is not None:
            return lc_scale(self.q, la, cb)
        o = self.cs.new_internal_wire()
        self._add_r1c(la, lb, lc_single(o), o)
        return lc_single(o)

    def mul_acc(self, a, b, c) -> Variable:
        return self.add(a, self.mul(b, c))

    def div_unchecked(self, a, b) -> Variable:
        """a / b with 0/0 == 0 (reference api.go DivUnchecked)."""
        la, lb = self._lc(a), self._lc(b)
        ca, cb = lc_is_const(la), lc_is_const(lb)
        if ca is not None and cb is not None:
            if cb == 0:
                if ca == 0:
                    return Variable(())
                raise ZeroDivisionError("division by constant zero")
            return Variable(lc_const(self.q, ca * pow(cb, -1, self.q)))
        if cb is not None:
            if cb == 0:
                raise ZeroDivisionError("division by constant zero")
            return Variable(lc_scale(self.q, la, pow(cb, -1, self.q)))
        # res solved by hint, then res * b == a enforced
        res = self.new_hint("div", 1, Variable(la), Variable(lb))[0]
        self._add_r1c(res.e, lb, la, None)
        return res

    def div(self, a, b) -> Variable:
        """a / b, requires b != 0."""
        return self.mul(a, self.inverse(b))

    def inverse(self, a) -> Variable:
        la = self._lc(a)
        ca = lc_is_const(la)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("inverse of constant zero")
            return Variable(lc_const(self.q, pow(ca, -1, self.q)))
        res = self.new_hint("inv_zero", 1, a)[0]
        # a * res == 1  — unsatisfiable when a == 0 (hint gives 0)
        self._add_r1c(la, res.e, lc_const(self.q, 1), None)
        return res

    # ------------------------------------------------------------------
    # binary (reference api.go:62-79)
    # ------------------------------------------------------------------

    def to_binary(self, a, nbits: int | None = None) -> list[Variable]:
        if nbits is None:
            nbits = self.field_bitlen()
        la = self._lc(a)
        ca = lc_is_const(la)
        if ca is not None:
            if ca >= (1 << nbits):
                raise ValueError(f"constant {ca} doesn't fit {nbits} bits")
            return [Variable(lc_const(self.q, (ca >> i) & 1))
                    for i in range(nbits)]
        bits = self.new_hint("to_bits", nbits, a, nbits)
        for b in bits:
            self.assert_is_boolean(b)
        # sum 2^i b_i == a
        terms = [lc_scale(self.q, b.e, 1 << i) for i, b in enumerate(bits)]
        self._add_r1c(lc_merge(self.q, *terms), lc_const(self.q, 1), la, None)
        if nbits >= self.field_bitlen():
            # 2^nbits > q: without this, v and v+q share a valid
            # decomposition, letting a malicious prover flip
            # comparisons (newer gnark comparators pin canonicity the
            # same way). Constrain bits <= q-1.
            self._bits_leq_const(bits, self.q - 1)
        return bits

    def from_binary(self, bits) -> Variable:
        for b in bits:
            self.assert_is_boolean(b)
        terms = [lc_scale(self.q, self._lc(b), 1 << i)
                 for i, b in enumerate(bits)]
        return Variable(lc_merge(self.q, *terms))

    # ------------------------------------------------------------------
    # boolean ops (inputs constrained boolean, like reference api.go)
    # ------------------------------------------------------------------

    def and_(self, a, b) -> Variable:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        r = self.mul(a, b)
        self.mark_boolean(r)
        return r

    def or_(self, a, b) -> Variable:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        la, lb = self._lc(a), self._lc(b)
        ca, cb = lc_is_const(la), lc_is_const(lb)
        if ca is not None:
            return Variable(lb) if ca == 0 else Variable(lc_const(self.q, 1))
        if cb is not None:
            return Variable(la) if cb == 0 else Variable(lc_const(self.q, 1))
        # a*b == a + b - r
        r = self.cs.new_internal_wire()
        rhs = lc_merge(self.q, la, lb, lc_scale(self.q, lc_single(r), self.q - 1))
        self._add_r1c(la, lb, rhs, r)
        self.mark_boolean(Variable(lc_single(r)))
        return Variable(lc_single(r))

    def xor(self, a, b) -> Variable:
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        la, lb = self._lc(a), self._lc(b)
        ca, cb = lc_is_const(la), lc_is_const(lb)
        if ca is not None and cb is not None:
            return Variable(lc_const(self.q, ca ^ cb))
        if ca is not None:
            return Variable(lb) if ca == 0 else self.sub(1, Variable(lb))
        if cb is not None:
            return Variable(la) if cb == 0 else self.sub(1, Variable(la))
        # 2a * b == a + b - r
        r = self.cs.new_internal_wire()
        rhs = lc_merge(self.q, la, lb, lc_scale(self.q, lc_single(r), self.q - 1))
        self._add_r1c(lc_scale(self.q, la, 2), lb, rhs, r)
        self.mark_boolean(Variable(lc_single(r)))
        return Variable(lc_single(r))

    # ------------------------------------------------------------------
    # conditionals (reference api.go:81-105)
    # ------------------------------------------------------------------

    def select(self, cond, a, b) -> Variable:
        lc_ = self._lc(cond)
        cc = lc_is_const(lc_)
        if cc is not None:
            return Variable(self._lc(a)) if cc == 1 else Variable(self._lc(b))
        # r = b + cond * (a - b)
        d = self.sub(a, b)
        m = self.mul(cond, d)
        return self.add(m, b)

    def lookup2(self, b0, b1, t0, t1, t2, t3) -> Variable:
        s1 = self.select(b0, t1, t0)
        s2 = self.select(b0, t3, t2)
        return self.select(b1, s2, s1)

    def is_zero(self, a) -> Variable:
        la = self._lc(a)
        ca = lc_is_const(la)
        if ca is not None:
            return Variable(lc_const(self.q, 1 if ca == 0 else 0))
        m, inv = self.new_hint("is_zero", 2, a)
        # a * inv == 1 - m ; a * m == 0
        one_minus_m = lc_merge(self.q, lc_const(self.q, 1),
                               lc_scale(self.q, m.e, self.q - 1))
        self._add_r1c(la, inv.e, one_minus_m, None)
        self._add_r1c(la, m.e, (), None)
        self.mark_boolean(m)
        return m

    def cmp(self, a, b) -> Variable:
        """1 if a > b, 0 if equal, -1 (mod q) if a < b — both compared
        as field_bitlen-bit integers (reference api.go Cmp)."""
        n = self.field_bitlen()
        ab = self.to_binary(a, n)
        bb = self.to_binary(b, n)
        res = Variable(())
        for i in range(n):  # LSB..MSB: MSB difference decided last
            d = self.sub(ab[i], bb[i])          # in {-1, 0, 1}
            d2 = self.mul(d, d)                 # boolean
            res = self.select(d2, d, res)
        return res

    # ------------------------------------------------------------------
    # assertions (reference api.go:107-137)
    # ------------------------------------------------------------------

    def mark_boolean(self, v) -> None:
        self._booleans.add(self._lc(v))

    def is_boolean_marked(self, v) -> bool:
        return self._lc(v) in self._booleans

    def assert_is_equal(self, a, b) -> None:
        d = lc_merge(self.q, self._lc(a),
                     lc_scale(self.q, self._lc(b), self.q - 1))
        cd = lc_is_const(d)
        if cd is not None:
            if cd != 0:
                raise ValueError("assert_is_equal on unequal constants")
            return
        # (a - b) * 1 == 0
        self._add_r1c(d, lc_const(self.q, 1), (), None)

    def assert_is_different(self, a, b) -> None:
        self.inverse(self.sub(a, b))

    def assert_is_boolean(self, v) -> None:
        lv = self._lc(v)
        cv = lc_is_const(lv)
        if cv is not None:
            if cv not in (0, 1):
                raise ValueError(f"constant {cv} is not boolean")
            return
        if lv in self._booleans:
            return
        self._booleans.add(lv)
        # v * (1 - v) == 0
        one_minus = lc_merge(self.q, lc_const(self.q, 1),
                             lc_scale(self.q, lv, self.q - 1))
        self._add_r1c(lv, one_minus, (), None)

    def assert_is_crumb(self, v) -> None:
        """v in {0,1,2,3} (reference api.go AssertIsCrumb)."""
        u = self.mul(v, self.sub(v, 1))
        w = self.mul(self.sub(v, 2), self.sub(v, 3))
        self.assert_is_equal(self.mul(u, w), 0)

    def assert_is_less_or_equal(self, v, bound) -> None:
        """v <= bound, both as unsigned integers
        (reference api_assertions.go mustBeLessOrEq{Var,Cst})."""
        lb = self._lc(bound)
        cb = lc_is_const(lb)
        n = self.field_bitlen()
        if cb is not None:
            self._less_or_eq_const(v, cb)
            return
        vbits = self.to_binary(v, n)
        bbits = self.to_binary(bound, n)
        p = Variable(lc_const(self.q, 1))  # prefix-equality accumulator
        for i in range(n - 1, -1, -1):
            pm = self.mul(p, vbits[i])
            p_next = self.select(bbits[i], pm, p)
            t = self.select(bbits[i], 0, p)
            # (1 - t - v_i) * v_i == 0: if bound bit 0 and prefix equal,
            # v_i must be 0
            l = self.sub(1, t, vbits[i])
            self.assert_is_equal(self.mul(l, vbits[i]), 0)
            p = p_next

    def _less_or_eq_const(self, v, bound: int) -> None:
        nbits = max(bound.bit_length(), 1)
        if bound >= (1 << self.field_bitlen()) - 1:
            return  # always true
        vbits = self.to_binary(v, nbits)  # also asserts v < 2^nbits
        self._bits_leq_const(vbits, bound)

    def _bits_leq_const(self, vbits, bound: int) -> None:
        """AND-chain over bound's zero bits
        (reference mustBeLessOrEqCst): value(vbits) <= bound."""
        nbits = len(vbits)
        p = Variable(lc_const(self.q, 1))
        for i in range(nbits - 1, -1, -1):
            if (bound >> i) & 1:
                p = self.mul(p, vbits[i])
            else:
                self.assert_is_equal(self.mul(p, vbits[i]), 0)

    # ------------------------------------------------------------------
    # commitments (reference frontend.Committer / builder.go:130-169)
    # ------------------------------------------------------------------

    def commit(self, *values) -> Variable:
        """BSB22 in-circuit commitment: returns a variable whose value
        is unpredictable to the prover (bound to a Pedersen commitment
        of the committed wires by the Groth16 backend)."""
        from gnark_tpu_torch.constraint.system import Commitment
        wires = []
        for v in values:
            lv = self._lc(v)
            if len(lv) == 1 and lv[0][0] == 1 and lv[0][1] != 0:
                wires.append(lv[0][1])
            else:
                # materialize the linear combination into a wire
                o = self.cs.new_internal_wire()
                self._add_r1c(lv, lc_const(self.q, 1), lc_single(o), o)
                wires.append(o)
        # public wires and prior commitment wires are hashed, not
        # Pedersen-committed: sort them first (reference
        # PublicAndCommitmentCommitted ordering, commitment.go:9-26)
        prior_cm = {c.commitment_wire for c in self.cs.commitments}
        pac = sorted(w for w in wires
                     if w < self.cs.nb_public or w in prior_cm)
        priv = sorted(w for w in wires
                      if not (w < self.cs.nb_public or w in prior_cm))
        wires = pac + priv
        cvar = self.new_hint("bsb22", 1,
                             *[Variable(lc_single(w)) for w in wires])[0]
        self.cs.commitments.append(Commitment(
            committed_wires=tuple(wires),
            commitment_wire=cvar.e[0][1], hint_name="bsb22",
            nb_public_committed=len(pac)))
        return cvar

    # ------------------------------------------------------------------
    # debug
    # ------------------------------------------------------------------

    def println(self, fmt: str, *args) -> None:
        """Deferred print: values resolved at solve time
        (reference api.go Println / solver.go:256-326)."""
        lcs = tuple(self._lc(a) for a in args)
        self.cs.logs.append((fmt, lcs))
        ins = set()
        for e in lcs:
            ins.update(lc_wires(e))
        self.cs.add_instruction(
            Instruction(kind="log", cidx=len(self.cs.logs) - 1), ins)
