"""Circuit frontend: API, builders, schema (reference L1, frontend/)."""

from gnark_tpu_torch.frontend.circuit import (
    Circuit, Public, Secret, compile_circuit, witness,
)
from gnark_tpu_torch.frontend.r1cs import R1CSBuilder
from gnark_tpu_torch.frontend.variable import Variable

__all__ = ["Circuit", "Public", "Secret", "compile_circuit", "witness",
           "R1CSBuilder", "Variable"]
