"""Fiat-Shamir transcript (SHA-256), and the recursion-friendly MiMC one.

Copy of gnark_tpu.backend.transcript (host only), with the limb layout of
gnark_tpu.std.math.emulated that MimcTranscript.coord_fes needs kept
here (EMU_B, EMU_K, EMU_MASK). Analog of gnark-crypto's
fiat-shamir.Transcript as used by PLONK (reference:
backend/plonk/bn254/prove.go:217 challenge order
"gamma","beta","alpha","zeta"; verify.go:88-125). Byte conventions are
our own (documented here) — gnark-bit-compat serialization is a
follow-up interop task:

  * field elements bind as 32/48/96-byte big-endian (fr.bits//8 rounded)
  * G1/G2 affine points bind as x||y (Fp2 coords as c0||c1)
  * challenge = SHA256(name || prev_challenge || bound_data) mod r
"""

from __future__ import annotations

import hashlib

from gnark_tpu_torch import fields
from gnark_tpu_torch.std.hash.mimc import PARAMS, MiMC

# std/math/emulated's limb layout: LSB-first limbs of B bits, K of them
EMU_B = 64
EMU_K = 4
EMU_MASK = (1 << EMU_B) - 1


class Transcript:
    def __init__(self, q: int, names: list[str]):
        self.q = q
        self.nbytes = -(-q.bit_length() // 8)
        self.names = list(names)
        self._data: dict[str, bytes] = {n: b"" for n in names}
        self._value: dict[str, int] = {}
        self._done: list[str] = []

    def fe_bytes(self, v: int) -> bytes:
        return (v % self.q).to_bytes(self.nbytes, "big")

    def point_bytes(self, P, p_mod: int) -> bytes:
        """Affine host point (or INF) over Fp or Fp2."""
        nb = -(-p_mod.bit_length() // 8)
        if P is None:
            return b"\x00" * (2 * nb)
        def coord(c):
            if isinstance(c, tuple):
                return c[0].to_bytes(nb, "big") + c[1].to_bytes(nb, "big")
            return c.to_bytes(nb, "big")
        return coord(P[0]) + coord(P[1])

    def bind(self, name: str, data: bytes) -> None:
        assert name in self._data and name not in self._value, name
        self._data[name] += data

    def challenge(self, name: str) -> int:
        assert name not in self._value
        idx = self.names.index(name)
        assert len(self._done) == idx, \
            f"challenges must be derived in order: {self.names}"
        h = hashlib.sha256()
        h.update(name.encode())
        if self._done:
            h.update(self.fe_bytes(self._value[self._done[-1]]))
        h.update(self._data[name])
        v = int.from_bytes(h.digest(), "big") % self.q
        self._value[name] = v
        self._done.append(name)
        return v


class MimcTranscript:
    """Recursion-friendly transcript: MiMC over the OUTER field of a
    2-chain (= the curve's base field), so an in-circuit verifier can
    recompute challenges natively (reference std/recursion NewShort +
    backend.WithProverChallengeHashFunction).

    Same interface as Transcript, but bound data are FIELD ELEMENTS
    (lists of ints) instead of bytes, and challenges are truncated to
    q.bit_length()-8 bits so they embed soundly in the inner scalar
    field regardless of the outer modulus."""

    def __init__(self, q: int, names: list[str], mimc_field: str):
        self._mk = lambda: MiMC(mimc_field)
        self.q = q
        self.mimc_q = fields.FIELDS[mimc_field].modulus
        self.mask = (1 << (q.bit_length() - 8)) - 1
        self.names = list(names)
        self._data: dict[str, list] = {n: [] for n in names}
        self._value: dict[str, int] = {}
        self._done: list[str] = []

    def fe_bytes(self, v: int):
        return [v % self.q]

    def coord_fes(self, c: int, p_mod: int):
        """One curve coordinate as MiMC-field elements. 2-chain case
        (p_mod <= transcript field): bind directly. Emulated /
        self-recursion case (e.g. bn254 fp under a bn254_fr MiMC):
        split into the std/math/emulated limb layout (LSB-first
        B=64-bit limbs) — exactly the limb VARIABLES an in-circuit
        verifier holds, so it can recompute the transcript natively."""
        if p_mod <= self.mimc_q:
            return [c % p_mod]
        c %= p_mod
        return [(c >> (EMU_B * i)) & EMU_MASK for i in range(EMU_K)]

    def point_bytes(self, P, p_mod: int):
        if P is None:
            return self.coord_fes(0, p_mod) * 2
        out = []
        for c in P:
            if isinstance(c, tuple):
                out += self.coord_fes(c[0], p_mod) \
                    + self.coord_fes(c[1], p_mod)
            else:
                out += self.coord_fes(c, p_mod)
        return out

    def bind(self, name: str, data) -> None:
        assert name in self._data and name not in self._value, name
        self._data[name].extend(data)

    def challenge(self, name: str) -> int:
        assert name not in self._value
        idx = self.names.index(name)
        assert len(self._done) == idx, \
            f"challenges must be derived in order: {self.names}"
        h = self._mk()
        h.write(int.from_bytes(name.encode(), "big"))
        if self._done:
            h.write(self._value[self._done[-1]])
        h.write(*self._data[name])
        v = h.sum() & self.mask
        self._value[name] = v
        self._done.append(name)
        return v


def mimc_point_writes(curve, point, mode=True) -> list:
    """Field elements a recursion-friendly hash-to-field writes for an
    affine point (None/INF -> zero coords), with the same coordinate
    limb-splitting rule as MimcTranscript.coord_fes."""
    mimc_q = fields.FIELDS[outer_mimc_field(curve, mode)].modulus
    p_mod = curve.fp.modulus
    coords = [0, 0] if point is None else [point[0], point[1]]

    def fes(c):
        if p_mod <= mimc_q:
            return [c % p_mod]
        c %= p_mod
        return [(c >> (EMU_B * i)) & EMU_MASK for i in range(EMU_K)]
    return [v for c in coords for v in fes(c)]


def outer_mimc_field(curve, mode=True) -> str:
    """Field-registry name of the field recursion-friendly transcripts
    hash over, per recursion mode:

    mode True ("outer"): the curve's BASE field — the natural choice
      when the outer circuit's scalar field equals the inner fp, i.e.
      a 2-chain (bls12-377 in bw6-761) or a 2-cycle (bn254 in
      grumpkin); coordinates bind directly, one element each.
    mode "self": the curve's own SCALAR field — emulated
      self-recursion (e.g. bn254 inside a bn254-fr circuit);
      coordinates then bind as emulated limbs, see
      MimcTranscript.coord_fes."""
    def named(modulus):
        for n, f in fields.FIELDS.items():
            if f.modulus == modulus and n in PARAMS:
                return n
        return None
    if mode == "self":
        n = named(curve.fr.modulus)
    else:
        n = named(curve.fp.modulus) or named(curve.fr.modulus)
    if n is None:
        raise ValueError(f"no MiMC params for {curve.name} ({mode})")
    return n
