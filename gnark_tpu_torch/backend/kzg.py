"""KZG polynomial commitments on the card.

Counterpart of gnark_tpu.backend.kzg (gnark-crypto's kzg package; the
commitment layer of PLONK):

  SRS:     [g1, tau*g1, tau^2*g1, ...], [g2, tau*g2]
  Commit:  C = sum_i p_i * [tau^i]g1                 (routed device MSM)
  Open:    quotient q(x) = (p(x) - p(z)) / (x - z), proof = Commit(q)
  Verify:  e(C - [p(z)]g1 + z H, g2) == e(H, [tau]g2)     (host pairing)
  Batch:   fold the polynomials with a challenge, then open the fold
           (gnark-crypto BatchOpenSinglePoint)

setup_srs runs the powers of tau through the fixed-base ladder (one
launch of csrc/ladder.cu) and its affine conversion (one launch of K1's
affine kernel), as Groth16's setup does; the powers stay on the device.
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.backend.groth16 import (_encode_affine_host, _mark_fn,
                                             _msm_affine_host, _scalar_words)
from gnark_tpu_torch.cuda import check_curve, resolve_device
from gnark_tpu_torch.ec import curves as curves_mod
from gnark_tpu_torch.ec import host
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.logger import get_logger
from gnark_tpu_torch.msm.bucket import group_b3
from gnark_tpu_torch.msm.fixed_base import batch_scalar_mul, jac_to_affine
from gnark_tpu_torch.pairing import get_pairing


@dataclasses.dataclass
class SRS:
    curve: curves_mod.Curve
    g1_powers: tuple       # device affine (x words, y words, inf), length n
    g2_gen: tuple          # host G2 affine
    g2_tau: tuple          # host G2 affine

    @property
    def device(self):
        return self.g1_powers[0].device

    def to(self, device) -> "SRS":
        return dataclasses.replace(
            self, g1_powers=tuple(a.to(device) for a in self.g1_powers))


def setup_srs(curve_name: str, size: int, tau: int | None = None,
              rng=None, device=None,
              timings: dict | None = None) -> SRS:
    """Insecure single-party SRS (reference test/unsafekzg analog) on
    `device` (None: the card). The same tau, or rng seed, as the
    reference's gives the same points.

    timings: if a dict, filled with seconds per phase (powers: tau^i on
    the host and their upload; ladder; affine; host: tau g2)."""
    import secrets
    curve = curves_mod.CURVES[curve_name]
    dev = resolve_device(device)
    check_curve(curve, dev)
    mark = _mark_fn(timings, dev, get_logger("gnark_tpu_torch"), "srs")
    q = curve.fr.modulus
    if tau is None:
        tau = (rng.randrange(q) if rng else secrets.randbelow(q)) or 1
    ffp, ffr = get_ff(curve.fp.name), get_ff(curve.fr.name)
    powers = []
    acc = 1
    for _ in range(size):
        powers.append(acc)
        acc = acc * tau % q
    base = _encode_affine_host(ffp, [curve.g1], dev)[:2]
    sc = _scalar_words(powers, ffr.nw, dev)
    mark("powers")
    R = batch_scalar_mul(ffp, base, curve.fr.bits, sc)
    mark("ladder")
    pts = jac_to_affine(ffp, R)
    del R
    mark("affine")
    f2 = curve.host_g2_field
    srs = SRS(curve=curve, g1_powers=pts, g2_gen=curve.g2,
              g2_tau=host.ec_mul(f2, curve.g2, tau))
    mark("host")
    return srs


def commit_affine(srs: SRS, coeffs_plain):
    """Commit to a polynomial given PLAIN (non-Montgomery) coefficient
    words (n, nw) on the SRS's device: the routed MSM over the first n
    powers, as a host affine point (host.INF for none)."""
    curve = srs.curve
    n = coeffs_plain.shape[0]
    return _msm_affine_host(get_ff(curve.fp.name), curve.host_fp,
                            tuple(a[:n] for a in srs.g1_powers),
                            coeffs_plain, curve.fr.bits, group_b3(curve))


def commit(srs: SRS, coeffs: list) -> tuple:
    """Commit to host int coefficients; returns a host affine point."""
    nw = get_ff(srs.curve.fr.name).nw
    q = srs.curve.fr.modulus
    return commit_affine(srs, _scalar_words([c % q for c in coeffs], nw,
                                            srs.device))


def _poly_eval(coeffs, z, q):
    r = 0
    for c in reversed(coeffs):
        r = (r * z + c) % q
    return r


def _synthetic_div(coeffs, z, q):
    """(p(x) - p(z)) / (x - z) via Horner; returns quotient coeffs."""
    n = len(coeffs)
    out = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % q
        out[i - 1] = acc
    return out


@dataclasses.dataclass
class OpeningProof:
    h: tuple               # commitment to quotient (host affine)
    claimed_value: int


def open_at(srs: SRS, coeffs: list, z: int) -> OpeningProof:
    q = srs.curve.fr.modulus
    v = _poly_eval(coeffs, z, q)
    quot = _synthetic_div(coeffs, z, q)
    if not quot:
        quot = [0]
    return OpeningProof(h=commit(srs, quot), claimed_value=v)


def verify_opening(srs: SRS, commitment, proof: OpeningProof, z: int) -> bool:
    """e(C - v*g1 + z*H, g2) == e(H, tau*g2)  (gnark-crypto kzg.Verify
    algebra, rearranged to two Miller loops + one final exp)."""
    curve = srs.curve
    q = curve.fr.modulus
    f1 = curve.host_fp
    p = host.ec_add(f1, commitment,
                    host.ec_neg(f1, host.ec_mul(f1, curve.g1,
                                                proof.claimed_value % q)))
    p = host.ec_add(f1, p, host.ec_mul(f1, proof.h, z % q))
    pairing = get_pairing(curve.name)
    res = pairing.pairing_product([
        (p, srs.g2_gen),
        (host.ec_neg(f1, proof.h), srs.g2_tau),
    ])
    return pairing.ext.eq(res, pairing.ext.one)


@dataclasses.dataclass
class BatchOpeningProof:
    h: tuple
    claimed_values: list


def batch_open_single_point(srs: SRS, polys: list, z: int,
                            challenge: int) -> BatchOpeningProof:
    """Fold polys with powers of `challenge`, open the fold at z
    (gnark-crypto kzg.BatchOpenSinglePoint shape)."""
    q = srs.curve.fr.modulus
    values = [_poly_eval(p, z, q) for p in polys]
    m = max(len(p) for p in polys)
    folded = [0] * m
    ch = 1
    for p in polys:
        for i, c in enumerate(p):
            folded[i] = (folded[i] + ch * c) % q
        ch = ch * challenge % q
    quot = _synthetic_div(folded, z, q) or [0]
    return BatchOpeningProof(h=commit(srs, quot), claimed_values=values)


def batch_verify_single_point(srs: SRS, commitments: list,
                              proof: BatchOpeningProof, z: int,
                              challenge: int) -> bool:
    curve = srs.curve
    q = curve.fr.modulus
    f1 = curve.host_fp
    folded_c = host.INF
    folded_v = 0
    ch = 1
    for c, v in zip(commitments, proof.claimed_values):
        folded_c = host.ec_add(f1, folded_c, host.ec_mul(f1, c, ch))
        folded_v = (folded_v + ch * v) % q
        ch = ch * challenge % q
    return verify_opening(
        srs, folded_c, OpeningProof(h=proof.h, claimed_value=folded_v), z)
