"""BLS12-381 in gnark_tpu_torch, against the reference and the host:
the kernels' field table and build variants (a 12-word Fp, the sound
class of csrc/mont.cuh for the scalar field, whose 4r > R), the plain
twins of the kernels at 12 words and on scalar-field operands at 2p - 1
(the value a lazy product of two such operands gets wrong) against the
reference's FF, the bucket MSM and the ladder against the host oracle,
the NTT against the reference's Domain, and a CPU Groth16 proof that the
reference's verify accepts; BLS12-377's G2 affine conversion on the
CPU. Slow tier: BLS12-381 Groth16 and PLONK proofs and BLS12-377's
Groth16 proof equal to the reference's byte for byte (the circuits and
seeds of tests/test_multicurve.py).

Sizes stay small (at most 2^10 points or a 2^10 domain, ladders at 16
bits); the reference is called for small FF / NTT calls and verify
only, outside the slow tier. Tolerance: exact equality (canonical
Montgomery words, host affine points, proof bytes)."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import groth16 as ref_groth16
from gnark_tpu.ec import curves as ref_curves
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch import cuda, fields
from gnark_tpu_torch.backend import groth16
from gnark_tpu_torch.backend.plonk_num import numerator_plain
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.proj_ec import kernel_field
from gnark_tpu_torch.ff import get_ff, ops
from gnark_tpu_torch.ff.mont_mul import (mont_mul, mont_mul_plain,
                                         mont_mul_sub_mul_plain)
from gnark_tpu_torch.frontend import Circuit, Public, Secret
from gnark_tpu_torch.frontend import compile_circuit, witness
from gnark_tpu_torch.msm import msm
from gnark_tpu_torch.msm import fixed_base
from gnark_tpu_torch.msm.bucket import group_b3
from gnark_tpu_torch.ntt import Domain

torch.set_num_threads(2)

CURVE = curves.CURVES["bls12_381"]
FP, FR = CURVE.fp.name, CURVE.fr.name
R = CURVE.fr.modulus


class Cubic(Circuit):
    x: Secret
    y: Public

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


class RefCubic(RefCircuit):
    x: RefSecret
    y: RefPublic

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


def _raw(ff, vals):
    """Ints below 2^(32 nw) as (n, nw) words, as they are (a lazy value
    in [p, 2p) is not reduced)."""
    buf = b"".join(v.to_bytes(4 * ff.nw, "little") for v in vals)
    return torch.as_tensor(np.frombuffer(buf, dtype="<i4").copy()
                           ).reshape(len(vals), ff.nw)


def _mont(ff, vals):
    """Montgomery representatives of vals (canonical)."""
    q = ff.p.modulus
    return [v * ff.p.R_mod % q for v in vals]


def _lazy_case(ff, n, seed):
    """(canonical Montgomery ints, the same values as lazy words): row 0
    is 2p - 1 as words, row 1 p, every other row from the second half
    lifted into [p, 2p)."""
    q = ff.p.modulus
    rng = random.Random(seed)
    canon = [q - 1, 0] + [rng.randrange(q) for _ in range(n - 2)]
    lazy = [v + q if (i < 2 or (i >= n // 2 and i % 2)) else v
            for i, v in enumerate(canon)]
    return canon, _raw(ff, lazy)


def _plain(ff, canon):
    """Canonical Montgomery ints -> the field values they stand for."""
    q = ff.p.modulus
    rinv = pow(ff.p.R, -1, q)
    return [v * rinv % q for v in canon]


def _ref_words(rf, canon):
    """The reference's limbs of canonical Montgomery ints."""
    return jnp.asarray(np.asarray(
        [[(v >> (16 * i)) & 0xFFFF for i in range(rf.n)] for v in canon],
        dtype=np.uint32))


def _words_of_ref(ff, limbs):
    return ff.to_words(torch.as_tensor(np.asarray(limbs).astype(np.int64)))


# ---------------------------------------------------------------------------
# the field table, the constants and the builds
# ---------------------------------------------------------------------------

def test_kernel_fields_and_builds():
    """Each kernel field's words and class follow from its modulus; the
    builds are one library a source and variant (BN254's two fields
    and BLS12-377's scalar field share theirs, BW6-761's scalar field
    BLS12-381's Fp's 12-word mont_mul), each with its own name and
    hash."""
    for name, kf in cuda.KERNEL_FIELDS.items():
        p, big = fields.FIELDS[name], 1 << (32 * kf.nw)
        assert p.R == big and 2 * p.modulus < big, name
        assert kf.sound == (4 * p.modulus >= big), name
    assert cuda.KERNEL_FIELDS[FR].sound and cuda.KERNEL_FIELDS[FR].nw == 8
    assert cuda.KERNEL_FIELDS[FP].nw == 12 and cuda.KERNEL_FIELDS[FP].nr == -1
    assert not any(cuda.KERNEL_FIELDS[f].sound
                   for f in ("bn254_fp", "bn254_fr", FP))
    pairs = cuda.builds()
    assert len(pairs) == len(set(pairs)) == 35
    assert cuda.variant("bn254_fp") == cuda.variant("bn254_fr")
    assert {s for s, v in pairs if v == cuda.variant("bn254_fr")} == \
        set(cuda.SOURCES)
    assert {s for s, v in pairs if v == cuda.variant(FP)} == \
        set(cuda.BASE_SOURCES) | set(cuda.sources("bw6_761_fr"))
    assert cuda.variant(FP) == cuda.variant("bw6_761_fr")
    assert {s for s, v in pairs if v == cuda.variant(FR)} == \
        set(cuda.SCALAR_SOURCES)
    targets = [cuda._target(s, v) for s, v in pairs]
    assert len(set(targets)) == len(targets)
    assert "-DGT_NW=12" in cuda.variant(FP).flags
    assert "-DGT_SOUND=1" in cuda.variant(FR).flags


@pytest.mark.parametrize("name", [FP, FR])
def test_field_consts_layout(name):
    """FieldC at 4 nw + 1 words: p | 2p | R mod p | n0 | R^3 mod p, n0
    the 32-bit REDC constant (p n0 = -1 mod 2^32), R = 2^(32 nw)."""
    nw = cuda.KERNEL_FIELDS[name].nw
    c = cuda.field_consts(name)
    p = fields.FIELDS[name].modulus
    assert c.shape == (4 * nw + 1,)

    def val(i):
        return sum(int(c[i * nw + k]) << (32 * k) for k in range(nw))
    big = 1 << (32 * nw)
    assert (val(0), val(1), val(2)) == (p, 2 * p, big % p)
    assert int(c[3 * nw]) * p % (1 << 32) == (1 << 32) - 1
    r3 = sum(int(c[3 * nw + 1 + k]) << (32 * k) for k in range(nw))
    assert r3 == pow(big, 3, p)


def test_the_card_takes_bls12_381_only_beside_bn254():
    """The card takes BLS12-381 beside BN254 (and BLS12-377, and
    BW6-761 for Groth16): only a card request for PLONK over BW6-761
    raises before any work; the CPU takes every curve. BLS12-381's Fp2
    kernels take u^2 = -1 only."""
    card, cpu = torch.device("cuda"), torch.device("cpu")
    with pytest.raises(ValueError):
        cuda.check_curve(curves.CURVES["bw6_761"], card, plonk=True)
    for name in ("bn254", "bls12_381", "bls12_377", "bw6_761"):
        cuda.check_curve(curves.CURVES[name], cpu, plonk=True)
        cuda.check_curve(curves.CURVES[name], card)
    for name in ("bn254", "bls12_381", "bls12_377"):
        cuda.check_curve(curves.CURVES[name], card, plonk=True)
    with pytest.raises(ValueError):
        cuda.field_consts("babybear")
    with pytest.raises(ValueError):
        kernel_field(get_ff2(FP, -5))
    assert kernel_field(get_ff2(FP, -1)).shape == (49,)


# ---------------------------------------------------------------------------
# the twins against the reference's FF
# ---------------------------------------------------------------------------

def test_fp_twins_at_12_words_match_reference():
    """The plain field ops and K1's twin at 12 words against the
    reference's FF on bls12_381_fp, K1 also on operands in [p, 2p)."""
    f, rf = get_ff(FP), ref_get_ff(FP)
    q = f.p.modulus
    rng = random.Random(3)
    a = [rng.randrange(q) for _ in range(40)] + [0, 1, q - 1]
    b = [rng.randrange(q) for _ in range(40)] + [q - 1, 2, q - 1]
    A, B = torch.as_tensor(f.encode(a)), torch.as_tensor(f.encode(b))
    rA, rB = jnp.asarray(rf.encode(a)), jnp.asarray(rf.encode(b))
    for op in ("add", "sub", "mul"):
        assert np.array_equal(getattr(f, op)(A, B).numpy(),
                              np.asarray(getattr(rf, op)(rA, rB))), op
    for op in ("neg", "square"):
        assert np.array_equal(getattr(f, op)(A).numpy(),
                              np.asarray(getattr(rf, op)(rA))), op
    ca, wa = _lazy_case(f, 32, 4)
    cb, wb = _lazy_case(f, 32, 5)
    want = rf.mul(_ref_words(rf, ca), _ref_words(rf, cb))
    assert torch.equal(mont_mul_plain(f, wa, wb), _words_of_ref(f, want))


def _twin_cases(f, rf, wa, wb, ca, cb):
    """(name, twin's words, want): K1 and K10 against the reference's FF
    (its limbs), K11-K13 against host ints (canonical Montgomery)."""
    q = f.p.modulus
    ra, rb = _ref_words(rf, ca), _ref_words(rf, cb)
    va, vb = _plain(f, ca), _plain(f, cb)
    pre, acc = [], 1
    for v in va:
        acc = acc * v % q
        pre.append(acc)

    def dot(x, y):
        return sum(u * v for u, v in zip(x, y)) % q

    def ints(vals):
        return _raw(f, _mont(f, vals))
    return [
        ("K1 mont_mul", mont_mul_plain(f, wa, wb),
         _words_of_ref(f, rf.mul(ra, rb))),
        ("K1 mont_mul_sub_mul", mont_mul_sub_mul_plain(f, wa, wb, wb, wa),
         _words_of_ref(f, rf.mul(rf.sub(rf.mul(ra, rb), rb), ra))),
        ("K10 add", ops.add_plain(f, wa, wb),
         _words_of_ref(f, rf.add(ra, rb))),
        ("K10 sub", ops.sub_plain(f, wa, wb),
         _words_of_ref(f, rf.sub(ra, rb))),
        ("K11 batch_inv", ops.batch_inv_plain(f, wa),
         ints([pow(v, -1, q) if v else 0 for v in va])),
        ("K12 scan_mul", ops.scan_mul_plain(f, wa), ints(pre)),
        ("K13 dot", ops.dot_plain(f, wa, wb), ints([dot(va, vb)])),
        ("K13 sum", ops.dot_plain(f, wa), ints([sum(va) % q])),
        ("K13 dot_many", ops.dot_many_plain(f, [wa, wb[:-3]], wb),
         ints([dot(va, vb), dot(vb[:-3], vb)])),
    ]


def test_scalar_field_twins_are_sound_at_2p_minus_1():
    """K1 and K10-K13's twins on BLS12-381's scalar field (4r ~ 1.81 R),
    fed operands in [p, 2p) with both operands of row 0 at 2p - 1, equal
    the reference's FF on the canonical values. A twin in the lazy class
    (one conditional subtract after a product) fails here: 2p - 1
    squared reaches ~2.81 p."""
    f, rf = get_ff(FR), ref_get_ff(FR)
    ca, wa = _lazy_case(f, 16, 6)
    cb, wb = _lazy_case(f, 16, 7)
    for name, got, want in _twin_cases(f, rf, wa, wb, ca, cb):
        assert torch.equal(got, want), name
    # the value at stake: (2p - 1)^2 R^-1 as a canonical word row
    sq = mont_mul_plain(f, wa[:1], wa[:1])
    rinv = pow(f.p.R, -1, R)
    assert int(f.decode_words(sq, mont=False)[0]) == (R - 1) ** 2 * rinv % R


def test_numerator_twin_sound_at_2p_minus_1():
    """K14's twin on lazy columns (2p - 1 in every column's row 0)
    equals the numerator computed on host ints."""
    f = get_ff(FR)
    n = 8
    names = ("l", "r", "o", "z", "zs", "ql", "qr", "qm", "qo", "qk", "s1",
             "s2", "s3")
    cols, vals = {}, {}
    for j, k in enumerate(names + ("x",)):
        canon, words = _lazy_case(f, n, 20 + j)
        vals[k] = _plain(f, canon)
        cols[k] = words
    rng = random.Random(8)
    s = {k: rng.randrange(R) for k in ("beta", "gamma", "alpha", "u",
                                       "Ninv")}
    s.update(alpha2=s["alpha"] ** 2 % R, u2=s["u"] ** 2 % R)
    zh = [rng.randrange(1, R) for _ in range(n)]
    xd = cols.pop("x")
    got = numerator_plain(f, cols, xd, _raw(f, _mont(f, zh)),
                          _raw(f, _mont(f, [pow(z, -1, R) for z in zh])), s)
    v = vals
    want = []
    for i in range(n):
        x, b, g = v["x"][i], s["beta"], s["gamma"]
        gate = (v["ql"][i] * v["l"][i] + v["qr"][i] * v["r"][i]
                + v["qm"][i] * v["l"][i] * v["r"][i] + v["qo"][i] * v["o"][i]
                + v["qk"][i])
        idp = (v["l"][i] + b * x + g) * (v["r"][i] + b * s["u"] * x + g) * \
            (v["o"][i] + b * s["u2"] * x + g)
        sp = (v["l"][i] + b * v["s1"][i] + g) * \
            (v["r"][i] + b * v["s2"][i] + g) * (v["o"][i] + b * v["s3"][i] + g)
        order = sp * v["zs"][i] - idp * v["z"][i]
        local = pow(x - 1, -1, R) * zh[i] * s["Ninv"] * (v["z"][i] - 1)
        num = gate + s["alpha"] * order + s["alpha2"] * local
        want.append(num * pow(zh[i], -1, R) % R)
    assert [int(t) for t in f.decode_words(got)] == want


# ---------------------------------------------------------------------------
# the MSM, the ladder and the NTT
# ---------------------------------------------------------------------------

def _points(g2, n, seed):
    """n points of G1 (or G2) with infinity, duplicates, and scalars
    with a zero, r - 1 and 1."""
    rng = random.Random(seed)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    pts = [host.ec_mul(hf, gen, rng.randrange(1, 1 << 16)) for _ in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    pts[1] = host.INF
    ks[2], ks[3], ks[6] = 0, R - 1, 1
    pts[4], ks[4] = pts[5], ks[5]
    return hf, gen, pts, ks


def _encode_points(ff, pts, g2):
    zero = (0, 0) if g2 else 0
    x = ff.encode_words([zero if p is host.INF else p[0] for p in pts])
    y = ff.encode_words([zero if p is host.INF else p[1] for p in pts])
    return (torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor([p is host.INF for p in pts]))


@pytest.mark.parametrize("g2", [False, True])
def test_bucket_msm_against_host(g2, monkeypatch):
    """The bucket MSM's plain path (K4's and K9's twins, 255-bit scalars
    in 8 words, 12-word points) against host.ec_msm, at c = 4 (the plain
    epilogue walks every bucket: 2^(c-1) a window)."""
    monkeypatch.setenv("GNARK_TPU_MSM_C", "4")
    ff = get_ff2(FP, CURVE.fp2_nr) if g2 else get_ff(FP)
    hf, _, pts, ks = _points(g2, 12, 40 + g2)
    P = _encode_points(ff, pts, g2)
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    J = msm(ff, P, sc, CURVE.fr.bits, device="cpu",
            b3=group_b3(CURVE, g2))
    got = groth16._to_affine_host(ff, hf, "jac", tuple(a[None] for a in J))
    assert got == host.ec_msm(hf, pts, ks)


@pytest.mark.parametrize("g2", [False, True])
def test_ladder_at_16_bits_against_host(g2):
    """The ladder's twin (the per-bit plain K7 + K6) at 16 bits, then the
    affine kernel's twin, against host scalar multiplications."""
    ff = get_ff2(FP, CURVE.fp2_nr) if g2 else get_ff(FP)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    ks = [0, 1, 2, (1 << 16) - 1, 12345, 40000]
    base = tuple(a.reshape(1, -1) for a in _encode_points(ff, [gen], g2)[:2])
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    x, y, inf = fixed_base.batch_scalar_mul_affine(ff, base, 16, sc)
    shape = (-1, 2, ff.nw) if g2 else (-1, ff.nw)
    got = groth16._host_points(ff, x.reshape(shape), y.reshape(shape), inf)
    assert got == [host.ec_mul(hf, gen, k) for k in ks]


def test_ntt_matches_reference_domain():
    """Domain.fft / ifft, plain and coset, at 2^10 over BLS12-381's
    scalar field against the reference's Domain."""
    f, rf = get_ff(FR), ref_get_ff(FR)
    n = 1 << 10
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(n)]
    dom, ref = Domain(f, n, "cpu"), RefDomain(rf, n)
    x, rx = torch.as_tensor(f.encode_words(vals)), jnp.asarray(rf.encode(vals))
    for coset in (False, True):
        for fn, rfn in ((dom.fft, ref.fft), (dom.ifft, ref.ifft)):
            assert torch.equal(fn(x, coset=coset),
                               _words_of_ref(f, rfn(rx, coset=coset)))


# ---------------------------------------------------------------------------
# Groth16 on the CPU, verified by the reference
# ---------------------------------------------------------------------------

def _host_ladder(ff, base_affine, nbits, scalars):
    """batch_scalar_mul's result from host scalar multiplications (the
    generator is setup's only base): Jacobian words, Z = 1 or infinity
    (1, 1, 0)."""
    g2 = hasattr(ff, "base")
    gen, hf = (CURVE.g2, CURVE.host_g2_field) if g2 else \
        (CURVE.g1, CURVE.host_fp)
    ks = [int(k) for k in get_ff(FR).decode_words(scalars, mont=False)]
    pts = [host.ec_mul(hf, gen, k) for k in ks]
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    X = [one if p is host.INF else p[0] for p in pts]
    Y = [one if p is host.INF else p[1] for p in pts]
    Z = [zero if p is host.INF else one for p in pts]
    n = len(pts)
    return tuple(torch.as_tensor(ff.encode_words(v)).reshape(n, -1)
                 for v in (X, Y, Z))


def test_groth16_cpu_proof_accepted_by_reference_verify(monkeypatch):
    """A CPU setup (its ladders on the host, to keep the tier fast),
    a CPU prove, and the reference's verify: accepted, and refused for a
    wrong public value. The MSMs at c = 4, as above."""
    monkeypatch.setattr(groth16, "batch_scalar_mul", _host_ladder)
    monkeypatch.setenv("GNARK_TPU_MSM_C", "4")
    cs = compile_circuit(Cubic(), fields.BLS12_381_FR)
    pk, vk = groth16.setup(cs, "bls12_381", rng=random.Random(11),
                           device="cpu")
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proof = groth16.prove(cs, pk, pub, sec, rng=random.Random(12),
                          device="cpu")
    rvk = ref_groth16.VerifyingKey(
        curve=ref_curves.CURVES["bls12_381"],
        **{f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
           if f.name != "curve"})
    rproof = ref_groth16.Proof(ar=proof.ar, krs=proof.krs, bs=proof.bs)
    assert ref_groth16.verify(rproof, rvk, pub)
    assert not ref_groth16.verify(rproof, rvk, [36])


class _Stop(Exception):
    pass


def test_srs_scalars_take_the_scalar_fields_words(monkeypatch):
    """kzg.setup_srs hands the ladder tau^i as words of the scalar field
    (8 on BLS12-381, whose base field takes 12): the card's ladder
    refuses any other width."""
    from gnark_tpu_torch.backend import kzg
    seen = {}

    def ladder(ff, base, nbits, sc):
        seen["shape"] = tuple(sc.shape)
        raise _Stop
    monkeypatch.setattr(kzg, "batch_scalar_mul", ladder)
    with pytest.raises(_Stop):
        kzg.setup_srs("bls12_381", 4, tau=5, device="cpu")
    assert seen["shape"] == (4, 8)


# ---------------------------------------------------------------------------
# BLS12-377 on the CPU
# ---------------------------------------------------------------------------

def test_bls12_377_g2_affine_on_the_cpu():
    """The plain jac_to_affine over BLS12-377's Fp2 (u^2 = -5) equals
    the host's affine points; the card's path takes that Fp2 (its
    12-word constants) and refuses one with u^2 = -1 over the same Fp."""
    c = curves.CURVES["bls12_377"]
    ff = get_ff2(c.fp.name, c.fp2_nr)
    hf = c.host_g2_field
    rng = random.Random(13)
    q = c.fp.modulus
    pts = [host.ec_mul(hf, c.g2, rng.randrange(1, 1 << 16))
           for _ in range(6)] + [host.INF]
    X, Y, Z = [], [], []
    for p in pts:
        if p is host.INF:
            X.append((1, 0))
            Y.append((1, 0))
            Z.append((0, 0))
            continue
        z = (rng.randrange(1, q), rng.randrange(q))
        z2 = hf.mul(z, z)
        X.append(hf.mul(p[0], z2))
        Y.append(hf.mul(p[1], hf.mul(z2, z)))
        Z.append(z)
    P = tuple(torch.as_tensor(ff.encode_words(v)).reshape(len(pts), -1)
              for v in (X, Y, Z))
    x, y, inf = fixed_base.jac_to_affine(ff, P)
    shape = (-1, 2, ff.nw)
    assert groth16._host_points(ff, x.reshape(shape), y.reshape(shape),
                                inf) == pts
    assert kernel_field(ff).shape == (49,)
    with pytest.raises(ValueError):
        fixed_base._affine_card(get_ff2(c.fp.name, -1), P)


# ---------------------------------------------------------------------------
# slow tier: proofs equal to the reference's byte for byte
# ---------------------------------------------------------------------------

def _groth16_equal(curve_name, fr, ref_fr, seed):
    """The reference's setup and prove under one random.Random(seed), and
    the port's on the CPU under another: equal proofs, accepted by the
    reference's verify."""
    rcs = ref_compile(RefCubic(), ref_fr)
    rng = random.Random(seed)
    rpk, rvk = ref_groth16.setup(rcs, curve_name, rng=rng)
    pub, sec = ref_witness(RefCubic(x=3, y=35), rcs)
    want = ref_groth16.prove(rcs, rpk, pub, sec, rng=rng)
    cs = compile_circuit(Cubic(), fr)
    rng = random.Random(seed)
    pk, vk = groth16.setup(cs, curve_name, rng=rng, device="cpu")
    got = groth16.prove(cs, pk, pub, sec, rng=rng, device="cpu")
    assert (got.ar, got.krs, got.bs, got.commitments, got.poks) == \
        (want.ar, want.krs, want.bs, want.commitments, want.poks)
    assert ref_groth16.verify(want, rvk, pub)
    assert groth16.verify(got, vk, pub) and not groth16.verify(got, vk, [36])


@pytest.mark.slow
def test_groth16_bls12_381_equals_reference():
    _groth16_equal("bls12_381", fields.BLS12_381_FR,
                   ref_fields.BLS12_381_FR, 11)


@pytest.mark.slow
def test_groth16_bls12_377_cpu_equals_reference():
    """BLS12-377 (u^2 = -5) on the port's CPU path: the proof the
    reference gives, byte for byte."""
    _groth16_equal("bls12_377", fields.BLS12_377_FR,
                   ref_fields.BLS12_377_FR, 21)


@pytest.mark.slow
def test_plonk_bls12_381_equals_reference():
    """PLONK over BLS12-381 (tests/test_multicurve.py's seeds): the
    port's SRS, setup and prove on the CPU give the reference's vk and
    proof; both verifiers accept it and refuse a wrong public value."""
    from gnark_tpu.backend import kzg as ref_kzg
    from gnark_tpu.backend import plonk as ref_plonk
    from gnark_tpu.frontend.scs import SCSBuilder as RefSCSBuilder
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.frontend.scs import SCSBuilder
    rcs = ref_compile(RefCubic(), ref_fields.BLS12_381_FR,
                      builder_cls=RefSCSBuilder)
    rsrs = ref_kzg.setup_srs("bls12_381", 64, rng=random.Random(23))
    rpk, rvk = ref_plonk.setup(rcs, rsrs)
    pub, sec = ref_witness(RefCubic(x=3, y=35), rcs)
    want = ref_plonk.prove(rcs, rpk, pub, sec, rng=random.Random(24))
    cs = compile_circuit(Cubic(), fields.BLS12_381_FR,
                         builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bls12_381", 64, rng=random.Random(23),
                        device="cpu")
    pk, vk = plonk.setup(cs, srs)
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(24), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
            if f.name != "curve"} == \
        {f.name: getattr(rvk, f.name) for f in dataclasses.fields(rvk)
         if f.name != "curve"}
    assert ref_plonk.verify(want, rvk, pub)
    assert plonk.verify(got, vk, pub) and not plonk.verify(got, vk, [36])
