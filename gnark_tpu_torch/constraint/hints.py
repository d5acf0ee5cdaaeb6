"""Hint registry.

Analog of the reference's `constraint/solver` hint system
(constraint/solver/hint.go:15-90, hint_registry.go): a hint is a host
function computing witness values outside the constraint system; its
outputs are then *constrained* by the circuit. Signature:

    hint(q: int, inputs: list[int]) -> list[int]

with q the field modulus and all values plain Python ints in [0, q).
"""

from __future__ import annotations

from typing import Callable

HINTS: dict[str, Callable] = {}


def register_hint(name: str):
    def deco(fn):
        if name in HINTS and HINTS[name] is not fn:
            raise ValueError(f"hint {name!r} already registered")
        HINTS[name] = fn
        return fn
    return deco


def get_hint(name: str) -> Callable:
    try:
        return HINTS[name]
    except KeyError:
        raise KeyError(f"unknown hint {name!r}; registered: {sorted(HINTS)}")


# -- built-in hints ----------------------------------------------------------

@register_hint("to_bits")
def _to_bits(q, inputs):
    """inputs: [x, nbits] -> nbits little-endian bits of x."""
    x, n = inputs[0], inputs[1]
    return [(x >> i) & 1 for i in range(n)]


@register_hint("inv_zero")
def _inv_zero(q, inputs):
    """x^-1, or 0 when x == 0 (reference: solver.go native invZeroHint)."""
    x = inputs[0] % q
    return [0 if x == 0 else pow(x, -1, q)]


@register_hint("is_zero")
def _is_zero(q, inputs):
    """-> [m, xinv]: m = (x == 0), xinv = x^-1 or 0."""
    x = inputs[0] % q
    return [1 if x == 0 else 0, 0 if x == 0 else pow(x, -1, q)]


@register_hint("bsb22")
def _bsb22(q, inputs):
    """Default commitment-wire hint: deterministic stand-in used by the
    test engine and bare solving (sha256 of the committed values). The
    Groth16 prover OVERRIDES this with hash-to-field of the real
    Pedersen commitment (reference: backend/groth16/bn254/prove.go:72-99
    solver override of the Bsb22 hint)."""
    import hashlib
    h = hashlib.sha256(b"bsb22-default")
    nb = -(-q.bit_length() // 8)
    for v in inputs:
        h.update((v % q).to_bytes(nb, "big"))
    return [int.from_bytes(h.digest(), "big") % q]


@register_hint("div")
def _div(q, inputs):
    """a/b with 0/0 = 0 (DivUnchecked semantics)."""
    a, b = inputs[0] % q, inputs[1] % q
    if b == 0:
        return [0]
    return [a * pow(b, -1, q) % q]
