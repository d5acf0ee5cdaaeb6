"""Prime-field parameter registry.

Host-side (Python-int) description of every field the framework supports,
plus the derived Montgomery constants used by the TPU limb kernels in
`gnark_tpu_torch.ff`.

Mirrors the role of gnark-crypto's per-field packages (the reference
imports `gnark-crypto/ecc/<curve>/fr` ~200x; see SURVEY.md §2.1
"gnark-crypto (EXTERNAL, native)").  Field list mirrors
`gnark.Curves()` / `internal/smallfields` in the reference
(reference: doc.go:22-32, internal/smallfields/smallfields.go).

Device representation: little-endian 16-bit limbs stored in uint32 lanes,
values kept in Montgomery form with R = 2**(16*nlimbs).  16-bit limbs are
chosen because the TPU has no 64-bit integer multiplier: a 16x16 product
fits exactly in a uint32 lane and lo/hi halves can be accumulated with
ample headroom (see ff/mont.py).
"""

from __future__ import annotations

import dataclasses
import functools

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _two_adicity(n: int) -> int:
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """All host-side constants for one prime field."""

    name: str
    modulus: int
    # pinned small multiplicative-group generator (non-residue); used for
    # FFT cosets and 2-adic roots. Verified at construction.
    generator: int

    # ---- derived ----
    @functools.cached_property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @functools.cached_property
    def nlimbs(self) -> int:
        return -(-self.bits // LIMB_BITS)

    @functools.cached_property
    def R(self) -> int:  # Montgomery radix
        return 1 << (LIMB_BITS * self.nlimbs)

    @functools.cached_property
    def R_mod(self) -> int:
        return self.R % self.modulus

    @functools.cached_property
    def R2_mod(self) -> int:
        return (self.R * self.R) % self.modulus

    @functools.cached_property
    def R3_mod(self) -> int:
        return (self.R2_mod * self.R_mod) % self.modulus

    @functools.cached_property
    def n0inv(self) -> int:
        """-modulus^{-1} mod 2^LIMB_BITS (the Montgomery REDC constant)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def two_adicity(self) -> int:
        return _two_adicity(self.modulus - 1)

    @functools.cached_property
    def two_adic_root(self) -> int:
        """Primitive 2^two_adicity-th root of unity."""
        odd = (self.modulus - 1) >> self.two_adicity
        return pow(self.generator, odd, self.modulus)

    def root_of_unity(self, order: int) -> int:
        """Primitive `order`-th root of unity (order a power of two)."""
        s = _two_adicity(order)
        if order != 1 << s:
            raise ValueError(f"order {order} not a power of two")
        if s > self.two_adicity:
            raise ValueError(
                f"{self.name}: no 2^{s} root (2-adicity {self.two_adicity})"
            )
        return pow(self.two_adic_root, 1 << (self.two_adicity - s), self.modulus)

    def __post_init__(self):
        p, g = self.modulus, self.generator
        if p % 2 == 1 and p > 3:
            # generator must be a quadratic non-residue so that
            # g^((p-1)/2^s) has exact order 2^s.
            if pow(g, (p - 1) // 2, p) != p - 1:
                raise ValueError(f"{self.name}: {g} is a QR, bad generator")

    # ---- conversions (host) ----
    def to_limbs(self, x: int) -> list[int]:
        """Raw little-endian limb split (no modular reduction; 0 <= x < R)."""
        if not 0 <= x < self.R:
            raise ValueError("value out of limb range")
        return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.nlimbs)]

    def from_limbs(self, limbs) -> int:
        return sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(limbs))

    def to_mont(self, x: int) -> int:
        return (x * self.R) % self.modulus

    def from_mont(self, x: int) -> int:
        return (x * pow(self.R, -1, self.modulus)) % self.modulus


# ---------------------------------------------------------------------------
# Registry.  Moduli/generators match gnark-crypto's pinned values
# (generators double-checked as non-residues in __post_init__).
# ---------------------------------------------------------------------------

BN254_FR = FieldParams(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
)

BN254_FP = FieldParams(
    name="bn254_fp",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
)

BLS12_381_FR = FieldParams(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
)

BLS12_381_FP = FieldParams(
    name="bls12_381_fp",
    modulus=4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    generator=2,
)

BLS12_377_FR = FieldParams(
    name="bls12_377_fr",
    modulus=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
)

BLS12_377_FP = FieldParams(
    name="bls12_377_fp",
    modulus=258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    generator=15,
)

BW6_761_FR = FieldParams(  # == BLS12_377_FP
    name="bw6_761_fr",
    modulus=BLS12_377_FP.modulus,
    generator=15,
)

BW6_761_FP = FieldParams(
    name="bw6_761_fp",
    modulus=6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299,
    generator=2,
)

GRUMPKIN_FR = FieldParams(  # grumpkin fr == bn254 fp
    name="grumpkin_fr",
    modulus=BN254_FP.modulus,
    generator=3,
)

# small fields (reference: internal/smallfields, constraint/{tinyfield,babybear,koalabear})
TINYFIELD = FieldParams(name="tinyfield", modulus=0x2F, generator=5)
BABYBEAR = FieldParams(name="babybear", modulus=0x78000001, generator=31)
KOALABEAR = FieldParams(name="koalabear", modulus=0x7F000001, generator=3)

FIELDS: dict[str, FieldParams] = {
    f.name: f
    for f in [
        BN254_FR, BN254_FP,
        BLS12_381_FR, BLS12_381_FP,
        BLS12_377_FR, BLS12_377_FP,
        BW6_761_FR, BW6_761_FP,
        GRUMPKIN_FR,
        TINYFIELD, BABYBEAR, KOALABEAR,
    ]
}
