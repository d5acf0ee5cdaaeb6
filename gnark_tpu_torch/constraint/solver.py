"""Host reference witness solver.

Analog of the reference's per-field solver (constraint/bn254/solver.go:
970-1077 level-parallel run loop; SURVEY.md §2.1, §3.2). v0 executes
instructions sequentially on the host with Python ints — the IR already
carries dependency levels, so per-level batched/device execution can
replace this without changing the IR (SURVEY.md §2.4 P1).

Outputs everything the provers need:
  * `values`: the full wire vector (witness),
  * for R1CS: a, b, c per-constraint evaluation vectors (built during
    solving, like solver.go:45,130-135 does),
  * for SCS: L, R, O wire-value vectors.
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.constraint.hints import get_hint
from gnark_tpu_torch.constraint.system import ConstraintSystem, Instruction


class SolverError(Exception):
    pass


@dataclasses.dataclass
class Solution:
    values: list            # all wire values (ints)
    a: list = None          # r1cs: per-constraint <L,w>
    b: list = None          # r1cs: per-constraint <R,w>
    c: list = None          # r1cs: per-constraint <O,w>

    def public(self, cs: ConstraintSystem):
        return self.values[: cs.nb_public]


def _eval_known(q, e, values):
    """Evaluate a LinExp; returns (known_sum, unknown_list[(coeff, wire)])."""
    s = 0
    unknown = []
    for coeff, w in e:
        v = values[w]
        if v is None:
            unknown.append((coeff, w))
        else:
            s = (s + coeff * v) % q
    return s, unknown


def _eval(q, e, values, what=""):
    s, unk = _eval_known(q, e, values)
    if unk:
        raise SolverError(f"unsolved wires {unk} in {what}")
    return s


def solve(cs: ConstraintSystem, public: list, secret: list,
          hint_overrides: dict | None = None) -> Solution:
    """Solve the witness. public EXCLUDES the constant-one wire."""
    q = cs.q
    if len(public) != cs.nb_public - 1:
        raise SolverError(
            f"want {cs.nb_public - 1} public values, got {len(public)}")
    if len(secret) != cs.nb_secret:
        raise SolverError(
            f"want {cs.nb_secret} secret values, got {len(secret)}")
    values: list = [None] * cs.nb_wires
    values[0] = 1
    for i, v in enumerate(public):
        values[1 + i] = v % q
    for i, v in enumerate(secret):
        values[cs.nb_public + i] = v % q

    sol = Solution(values=values)
    if cs.kind == "r1cs":
        n = len(cs.r1cs)
        sol.a, sol.b, sol.c = [0] * n, [0] * n, [0] * n

    for inst in cs.instructions:
        _run_instruction(cs, inst, sol, hint_overrides or {})

    # sanity: everything solved
    for w, v in enumerate(values):
        if v is None:
            raise SolverError(f"wire {w} never solved")
    return sol


def _run_instruction(cs, inst: Instruction, sol: Solution, overrides):
    q = cs.q
    values = sol.values
    if inst.kind == "hint":
        fn = overrides.get(inst.hint_name) or get_hint(inst.hint_name)
        ins = [_eval(q, e, values, f"hint {inst.hint_name} input")
               for e in inst.inputs]
        outs = fn(q, ins)
        if len(outs) != len(inst.outputs):
            raise SolverError(
                f"hint {inst.hint_name}: {len(outs)} outputs, "
                f"want {len(inst.outputs)}")
        for w, v in zip(inst.outputs, outs):
            values[w] = v % q
        return

    if inst.kind in ("r1c", "assert"):
        con = cs.r1cs[inst.cidx]
        la, lu = _eval_known(q, con.l, values)
        ra, ru = _eval_known(q, con.r, values)
        oa, ou = _eval_known(q, con.o, values)
        n_unknown = (len(lu) > 0) + (len(ru) > 0) + (len(ou) > 0)
        if n_unknown == 0:
            if la * ra % q != oa:
                raise SolverError(
                    f"constraint #{inst.cidx} not satisfied: "
                    f"{la} * {ra} != {oa}"
                    + (f" ({inst.debug})" if inst.debug else ""))
        elif len(lu) == 1 and not ru and not ou:
            coeff, w = lu[0]
            if ra == 0:
                if oa != 0:
                    raise SolverError(f"constraint #{inst.cidx}: 0*x = {oa}")
                values[w] = 0
            else:
                values[w] = (oa * pow(ra, -1, q) - la) * pow(coeff, -1, q) % q
            la = (la + coeff * values[w]) % q
        elif len(ru) == 1 and not lu and not ou:
            coeff, w = ru[0]
            if la == 0:
                if oa != 0:
                    raise SolverError(f"constraint #{inst.cidx}: x*0 = {oa}")
                values[w] = 0
            else:
                values[w] = (oa * pow(la, -1, q) - ra) * pow(coeff, -1, q) % q
            ra = (ra + coeff * values[w]) % q
        elif len(ou) == 1 and not lu and not ru:
            coeff, w = ou[0]
            values[w] = (la * ra - oa) * pow(coeff, -1, q) % q
            oa = (oa + coeff * values[w]) % q
        else:
            raise SolverError(
                f"constraint #{inst.cidx}: cannot solve "
                f"({len(lu)},{len(ru)},{len(ou)}) unknowns")
        if sol.a is not None:
            sol.a[inst.cidx], sol.b[inst.cidx], sol.c[inst.cidx] = la, ra, oa
        return

    if inst.kind == "scs":
        con = cs.sparse[inst.cidx]
        if con.commitment:
            # PLONK commitment rows (-v + qcp*c == 0 / -out + qk == 0)
            # only hold under the protocol's extra Qcp/qk terms; the
            # plain solver skips them (solver.go solveSparseR1C).
            return
        a_, b_, o_ = values[con.xa], values[con.xb], values[con.xo]
        known = []
        # solve for whichever wire is unsolved (output usually xo)
        if o_ is None:
            if a_ is None or b_ is None:
                raise SolverError(f"scs #{inst.cidx}: multiple unknowns")
            num = (con.qL * a_ + con.qR * b_ + con.qM * a_ * b_ + con.qC) % q
            if con.qO == 0:
                raise SolverError(f"scs #{inst.cidx}: qO == 0")
            values[con.xo] = (-num) * pow(con.qO, -1, q) % q
        elif a_ is None:
            den = (con.qL + con.qM * b_) % q
            num = (con.qR * b_ + con.qO * o_ + con.qC) % q
            if den == 0:
                raise SolverError(f"scs #{inst.cidx}: singular in xa")
            values[con.xa] = (-num) * pow(den, -1, q) % q
        elif b_ is None:
            den = (con.qR + con.qM * a_) % q
            num = (con.qL * a_ + con.qO * o_ + con.qC) % q
            if den == 0:
                raise SolverError(f"scs #{inst.cidx}: singular in xb")
            values[con.xb] = (-num) * pow(den, -1, q) % q
        else:
            tot = (con.qL * a_ + con.qR * b_ + con.qM * a_ * b_
                   + con.qO * o_ + con.qC) % q
            if tot != 0:
                raise SolverError(
                    f"sparse constraint #{inst.cidx} not satisfied"
                    + (f" ({inst.debug})" if inst.debug else ""))
        return

    if inst.kind == "log":
        fmt, args = cs.logs[inst.cidx]
        vals = [_eval(q, e, values, "log") for e in args]
        print(fmt.format(*vals))
        return

    raise SolverError(f"unknown instruction kind {inst.kind!r}")
