"""Constraint-system IR.

The analog of the reference's `constraint/` layer (constraint/core.go:
76-129 System{Instructions, Blueprints, CallData, Levels}; SURVEY.md
§2.1 "Constraint IR"), redesigned for a Python frontend + TPU backend:

  * Wires are integers: 0 .. nb_public-1 are public (wire 0 is the
    constant ONE wire), then nb_secret secret wires, then internal.
  * A LinearExpression is a tuple of (coeff, wire) pairs, coeff a
    Python int in [0, q).
  * Constraints:
      - R1CS:  L * R == O                     (r1cs.go:141-145 analog)
      - SparseR1CS: qL*a + qR*b + qM*a*b + qO*o + qC == 0
                                              (r1cs_sparse.go:125-141)
  * Instructions drive the witness solver; each is (kind, payload) and
    carries a dependency *level* so the solver can run per-level
    batches (constraint/core.go:382-421 level assignment).
  * The reference's PACKED encoding (PackedInstruction + flat CallData,
    core.go:30-129) has two analogs here: the native C++ solver
    marshals this IR into flat packed u32/u64 arrays before solving
    (native/__init__.py _marshal), and io/gnark_cs_writer.py emits
    gnark's own packed wire format; the Python objects exist only at
    compile/IO time, never in a hot loop.

The prover only needs (a) the solved witness vector and (b) per-
constraint evaluation vectors, both of which `solver.py` produces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from gnark_tpu_torch.fields import FieldParams

# linear expression: tuple[(coeff:int, wire:int), ...]
LinExp = tuple

ONE_WIRE = 0


@dataclasses.dataclass
class R1C:
    l: LinExp
    r: LinExp
    o: LinExp



# SparseR1C.commitment markers (reference constraint/r1cs_sparse.go
# CommitmentConstraint: NOT/COMMITTED/COMMITMENT)
NOT_COMMITTED = 0
COMMITTED = 1      # -v + qcp_i(X)*c_i(X) == 0 row (value feeds a commitment)
COMMITMENT = 2     # -out + qk-injected challenge == 0 row


@dataclasses.dataclass
class SparseR1C:
    """qL*xa + qR*xb + qO*xo + qM*xa*xb + qC == 0.

    Rows with commitment != NOT_COMMITTED only hold under the PLONK
    protocol's extra Qcp/qk terms; the plain solver skips checking
    them (reference constraint/bn254/solver.go solveSparseR1C)."""
    xa: int
    xb: int
    xo: int
    qL: int
    qR: int
    qO: int
    qM: int
    qC: int
    commitment: int = NOT_COMMITTED


@dataclasses.dataclass
class Instruction:
    """One solver step.

    kind:
      'r1c'    — solve the single unknown wire of constraint `cidx`
      'scs'    — solve xo of sparse constraint `cidx`
      'hint'   — run hint fn: inputs are LinExps, outputs are wires
      'assert' — constraint `cidx` has no unknown; checked at solve time
    """
    kind: str
    cidx: int = -1
    hint_name: str = ""
    inputs: tuple = ()      # LinExps (hint)
    outputs: tuple = ()     # wire ids this instruction solves
    level: int = 0
    debug: Optional[str] = None


@dataclasses.dataclass
class Commitment:
    """BSB22-style in-circuit commitment metadata
    (reference: constraint/commitment.go:9-26)."""
    committed_wires: tuple      # wires whose values get committed
    commitment_wire: int        # the wire holding the challenge value
    hint_name: str = ""
    # Groth16: the first nb_public_committed entries of
    # committed_wires are public (or prior-commitment) wires: they are
    # HASHED into the commitment wire value but not Pedersen-committed
    # (reference constraint/commitment.go NbPublicCommitted +
    # PublicAndCommitmentCommitted)
    nb_public_committed: int = 0
    # SCS/PLONK only: constraint row indexes of the COMMITTED rows
    # (one per committed wire; reference scs/api.go
    # AddPlonkCommitmentInputs) and of the COMMITMENT row
    # (AddPlonkCommitmentOutputs CommitmentIndex).
    committed_rows: tuple = ()
    commitment_row: int = -1


class ConstraintSystem:
    """Compiled circuit: constraints + leveled instruction schedule."""

    def __init__(self, field: FieldParams, kind: str):
        assert kind in ("r1cs", "scs")
        self.field = field
        self.q = field.modulus
        self.kind = kind
        self.public_names: list[str] = ["1"]   # wire 0 == constant 1
        self.secret_names: list[str] = []
        self.nb_internal = 0
        self.r1cs: list[R1C] = []
        self.sparse: list[SparseR1C] = []
        self.instructions: list[Instruction] = []
        self.commitments: list[Commitment] = []
        self.levels: list[list[int]] = []      # instruction ids per level
        self._wire_level: dict[int, int] = {}
        self.logs: list[tuple] = []            # (format, [LinExp args])

    # -- sizes ---------------------------------------------------------

    @property
    def nb_public(self) -> int:
        return len(self.public_names)

    @property
    def nb_secret(self) -> int:
        return len(self.secret_names)

    @property
    def nb_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal

    @property
    def nb_constraints(self) -> int:
        return len(self.r1cs) if self.kind == "r1cs" else len(self.sparse)

    # -- wires ---------------------------------------------------------

    def new_internal_wire(self) -> int:
        w = self.nb_public + self.nb_secret + self.nb_internal
        self.nb_internal += 1
        return w

    def wire_level(self, w: int) -> int:
        """Level of the instruction that solves w; inputs are level -1."""
        if w < self.nb_public + self.nb_secret:
            return -1
        return self._wire_level[w]

    # -- instructions ----------------------------------------------------

    def _linexp_wires(self, e: LinExp):
        return [w for _, w in e]

    def add_instruction(self, inst: Instruction, input_wires) -> None:
        lvl = 0
        for w in input_wires:
            lw = self._wire_level.get(w, -1) if w >= self.nb_public + self.nb_secret else -1
            if lw + 1 > lvl:
                lvl = lw + 1
        inst.level = lvl
        iid = len(self.instructions)
        self.instructions.append(inst)
        while len(self.levels) <= lvl:
            self.levels.append([])
        self.levels[lvl].append(iid)
        for w in inst.outputs:
            self._wire_level[w] = lvl

    def summary(self) -> str:
        return (f"{self.kind} over {self.field.name}: "
                f"{self.nb_constraints} constraints, {self.nb_wires} wires "
                f"({self.nb_public} public, {self.nb_secret} secret), "
                f"{len(self.levels)} levels")
