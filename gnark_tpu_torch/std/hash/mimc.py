"""MiMC hash: host implementation + in-circuit gadget.

Mirrors the reference's std/hash/mimc (gadget) + gnark-crypto's
fr/mimc (host): Miyaguchi-Preneel construction over the MiMC block
cipher x -> (x + k + c_i)^e, with per-curve round counts/exponents and
round constants derived from a legacy-Keccak-256 chain seeded with
"seed" (gnark-crypto mimc initConstants shape):

    rnd = keccak(seed); rnd = keccak(rnd)
    c_i = keccak^i(rnd) interpreted big-endian mod r

Bit-compatibility with gnark-crypto's exact constants is asserted by
vector tests when vectors are available; the construction is
self-consistent (host == gadget, differentially tested) regardless.
"""

from __future__ import annotations

import functools

from gnark_tpu_torch import fields
from gnark_tpu_torch.utils.keccak import keccak256

# (nbRounds, exponent) per field — gnark-crypto mimc parameters
PARAMS = {
    "bn254_fr": (110, 5),
    "bls12_377_fr": (62, 17),
    "bls12_381_fr": (111, 5),
    "bw6_761_fr": (137, 5),
    "grumpkin_fr": (110, 5),
}

SEED = b"seed"


@functools.lru_cache(maxsize=None)
def round_constants(field_name: str):
    field = fields.FIELDS[field_name]
    nb_rounds, _ = PARAMS[field_name]
    rnd = keccak256(SEED)
    rnd = keccak256(rnd)
    out = []
    for _ in range(nb_rounds):
        rnd = keccak256(rnd)
        out.append(int.from_bytes(rnd, "big") % field.modulus)
    return out


class MiMC:
    """Host MiMC hasher (gnark-crypto fr/mimc semantics):
    Miyaguchi-Preneel: h = Encrypt_h(m) + h + m for each block."""

    def __init__(self, field_name: str = "bn254_fr"):
        self.field = fields.FIELDS[field_name]
        self.q = self.field.modulus
        self.constants = round_constants(field_name)
        _, self.e = PARAMS[field_name]
        self.h = 0

    def _encrypt(self, m: int, k: int) -> int:
        x = m
        for c in self.constants:
            x = pow((x + k + c) % self.q, self.e, self.q)
        return (x + k) % self.q

    def write(self, *values: int) -> "MiMC":
        for v in values:
            v %= self.q
            self.h = (self._encrypt(v, self.h) + self.h + v) % self.q
        return self

    def sum(self) -> int:
        return self.h

    def reset(self) -> "MiMC":
        self.h = 0
        return self


def mimc_hash(values, field_name: str = "bn254_fr") -> int:
    return MiMC(field_name).write(*values).sum()


class MiMCGadget:
    """In-circuit MiMC (reference std/hash/mimc/mimc.go API:
    Write / Sum / Reset over frontend variables)."""

    def __init__(self, api, field_name: str = "bn254_fr"):
        self.api = api
        self.constants = round_constants(field_name)
        _, self.e = PARAMS[field_name]
        self.h = 0   # state as circuit value (0 = constant)

    def _pow(self, x, e: int):
        api = self.api
        # fixed small exponents: 5 = sq,sq,mul ; 17 = sq^4, mul
        if e == 5:
            x2 = api.mul(x, x)
            x4 = api.mul(x2, x2)
            return api.mul(x4, x)
        if e == 17:
            x2 = api.mul(x, x)
            x4 = api.mul(x2, x2)
            x8 = api.mul(x4, x4)
            x16 = api.mul(x8, x8)
            return api.mul(x16, x)
        # generic square-and-multiply
        r = None
        base = x
        while e:
            if e & 1:
                r = base if r is None else api.mul(r, base)
            e >>= 1
            if e:
                base = api.mul(base, base)
        return r

    def _encrypt(self, m, k):
        api = self.api
        x = m
        for c in self.constants:
            x = self._pow(api.add(x, k, c), self.e)
        return api.add(x, k)

    def write(self, *values) -> "MiMCGadget":
        api = self.api
        for v in values:
            enc = self._encrypt(v, self.h)
            self.h = api.add(enc, self.h, v)
        return self

    def sum(self):
        return self.h

    def reset(self) -> "MiMCGadget":
        self.h = 0
        return self
