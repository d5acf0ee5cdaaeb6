"""Curve registry: the 5 gnark curves with validated constants.

Mirrors `gnark.Curves()` (reference: doc.go:22-32) — BN254, BLS12-377,
BLS12-381, BW6-761 as full pairing curves plus Grumpkin (no pairing,
2-cycle partner of BN254). Constants are generated/validated by
tools/derive_curve_constants.py into curves_data.py.
"""

from __future__ import annotations

import dataclasses
import functools

from gnark_tpu_torch import fields
from gnark_tpu_torch.ec.curves_data import CURVES_DATA
from gnark_tpu_torch.ec.host import Fp, Fp2


@dataclasses.dataclass(frozen=True)
class Curve:
    name: str
    fp: fields.FieldParams       # base field
    fr: fields.FieldParams       # scalar field
    b: int                       # G1: y^2 = x^3 + b
    h1: int                      # G1 cofactor
    g1: tuple                    # G1 generator (affine, ints)
    # G2 (None for grumpkin). For bw6_761 the twist lives over fp itself
    # (fp2_nr is None); otherwise over Fp2 = fp[u]/(u^2 - fp2_nr).
    fp2_nr: int | None
    b2: object                   # int (bw6) or (c0, c1) tuple (Fp2)
    h2: int | None
    g2: tuple | None
    trace: int                   # Frobenius trace of E/Fp

    @functools.cached_property
    def host_fp(self) -> Fp:
        return Fp(self.fp.modulus)

    @functools.cached_property
    def host_g2_field(self):
        """Host field G2 lives over: Fp2, or Fp itself for bw6_761."""
        if self.g2 is None:
            return None
        if self.fp2_nr is None:
            return self.host_fp
        return Fp2(self.host_fp, self.fp2_nr)

    @property
    def g2_over_fp2(self) -> bool:
        return self.g2 is not None and self.fp2_nr is not None


def _mk(name: str, fp: fields.FieldParams, fr: fields.FieldParams) -> Curve:
    d = CURVES_DATA[name]
    assert d["fp"] == fp.modulus and d["fr"] == fr.modulus
    return Curve(
        name=name, fp=fp, fr=fr, b=d["b"], h1=d["h1"], g1=d["g1"],
        fp2_nr=d["fp2_nr"], b2=d["b2"], h2=d["h2"], g2=d["g2"], trace=d["t"],
    )


BN254 = _mk("bn254", fields.BN254_FP, fields.BN254_FR)
BLS12_381 = _mk("bls12_381", fields.BLS12_381_FP, fields.BLS12_381_FR)
BLS12_377 = _mk("bls12_377", fields.BLS12_377_FP, fields.BLS12_377_FR)
BW6_761 = _mk("bw6_761", fields.BW6_761_FP, fields.BW6_761_FR)
GRUMPKIN = _mk("grumpkin", fields.BN254_FR, fields.BN254_FP)

CURVES: dict[str, Curve] = {
    c.name: c for c in [BN254, BLS12_381, BLS12_377, BW6_761, GRUMPKIN]
}
