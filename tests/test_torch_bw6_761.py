"""BW6-761 in gnark_tpu_torch, against the reference and the host: the
MSM's routes in G1 and in G2, which lies over Fp itself (each group's
own 3 b in the bucket route's complete formulas: G1's b = -1, G2's b2 =
4, one Fp), the kernels' field table and build variants (a 24-word Fp
with no Fp2 code and 12-word scalars, GT_SW; a 12-word scalar field that
builds Groth16's kernels only and shares BLS12-381's 12-word mont_mul
library), the field constants, what the card takes (Groth16) and refuses
before any work (PLONK: K11's inverse is 8 words only), the bindings
each wrapper reaches, the 16-bit ladder, K2's and K5's plain twins at 12
words against the reference's Domain, K2's shared memory at 8 and 12
words, and the Groth16 keys' G2 columns over Fp. Slow tier: Groth16 on
examples/cubic.py's circuit, the port's keys and proof equal to the
reference's byte for byte, both verifiers accepting the proof.

Sizes stay small (at most 2^10 points or a 2^10 domain, ladders at 16
bits). Tolerance: exact equality (canonical Montgomery words, host
affine points, key words, proof points)."""

import dataclasses
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import groth16 as ref_groth16
from gnark_tpu.ec.weierstrass import jac_to_affine as ref_jac_to_affine
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.msm import msm as ref_msm
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch import cuda, fields
from gnark_tpu_torch.backend import groth16, groth16_check, plonk
from gnark_tpu_torch.backend import plonk_device, plonk_num
from gnark_tpu_torch.ec import curves, host, jac_ec, proj_ec
from gnark_tpu_torch.ec.proj_ec import lib_field
from gnark_tpu_torch.ff import get_ff, mont_mul, ops
from gnark_tpu_torch.frontend import Circuit, Public, Secret
from gnark_tpu_torch.frontend import compile_circuit
from gnark_tpu_torch.msm import bucket, fixed_base, msm
from gnark_tpu_torch.ntt import Domain, fourstep, radix2

torch.set_num_threads(2)

CURVE = curves.CURVES["bw6_761"]
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


# ---------------------------------------------------------------------------
# the MSM in G1 and in G2 over Fp, both routes
# ---------------------------------------------------------------------------

def _points(g2, n, seed, bits=16):
    """n points of G1 (or G2) with infinity, duplicates and a zero
    scalar; scalars of `bits` bits."""
    rng = random.Random(seed)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    pts = [host.ec_mul(hf, gen, rng.randrange(1, 1 << 16)) for _ in range(n)]
    ks = [rng.randrange(1 << bits) for _ in range(n)]
    pts[1] = host.INF
    ks[2] = 0
    pts[4], ks[4] = pts[5], ks[5]
    return hf, pts, ks


def _encode(pts):
    ff = get_ff(FP)
    x = ff.encode_words([0 if p is host.INF else p[0] for p in pts])
    y = ff.encode_words([0 if p is host.INF else p[1] for p in pts])
    return (torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor([p is host.INF for p in pts]))


def _msm_host(g2, pts, ks, nbits):
    ff = get_ff(FP)
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    J = msm(ff, _encode(pts), sc, nbits, device="cpu",
            b3=bucket.group_b3(CURVE, g2))
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    return groth16._to_affine_host(ff, hf, "jac", tuple(a[None] for a in J))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("impl", ["bucket", "scan"])
def test_msm_both_routes_against_host(impl, g2, monkeypatch):
    """G1 and G2 (both over the one 24-word Fp) through the bucket route
    (K4's and K9's plain twins: complete formulas, each group's own 3 b)
    and the scan route (Jacobian, no b), 16-bit scalars at c = 4,
    against host.ec_msm. The bucket route's G2 gave a wrong sum when 3 b
    was taken by the base field's name (G1's b = -1 for G2's b2 = 4)."""
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", impl)
    monkeypatch.setenv("GNARK_TPU_MSM_C", "4")
    hf, pts, ks = _points(g2, 6, 5 + g2)
    assert bucket.group_b3(CURVE, g2) == (12 if g2 else CURVE.fp.modulus - 3)
    assert _msm_host(g2, pts, ks, 16) == host.ec_msm(hf, pts, ks)


@pytest.mark.slow
def test_g2_msm_against_reference(monkeypatch):
    """The same G2 inputs through the port's bucket route and the
    reference's gnark_tpu.msm.msm on the CPU (its scan path): one
    point. Slow tier: the reference's 48-limb compile takes ~27 s alone
    on one core."""
    monkeypatch.setenv("GNARK_TPU_MSM_C", "4")
    hf, pts, ks = _points(True, 6, 6)
    got = _msm_host(True, pts, ks, 16)
    rf, rfr = ref_get_ff(FP), ref_get_ff(FR)
    x, y, inf = _encode(pts)
    rx, ry, rinf = ref_jac_to_affine(rf, ref_msm(
        rf, (jnp.asarray(get_ff(FP).from_words(x).numpy().astype(np.uint32)),
             jnp.asarray(get_ff(FP).from_words(y).numpy().astype(np.uint32)),
             jnp.asarray(inf.numpy())),
        jnp.asarray(rfr.encode(ks, mont=False)), 16))
    want = host.INF if bool(rinf) else (int(rf.decode(np.asarray(rx))),
                                        int(rf.decode(np.asarray(ry))))
    assert got == want == host.ec_msm(hf, pts, ks)


# ---------------------------------------------------------------------------
# the field table, the constants, the builds and the bindings
# ---------------------------------------------------------------------------

def test_kernel_fields_variants_and_builds():
    """BW6-761's Fp: 24 words, lazy (4p < 2^768), no Fp2 (GT_NR_ABS =
    0), 12-word scalars (GT_SW = 12); its Fr: 12 words, lazy, Groth16's
    sources only, mont_mul on BLS12-381's Fp's w12 library; 35 builds,
    each with its own name and hash."""
    fp, fr = cuda.KERNEL_FIELDS[FP], cuda.KERNEL_FIELDS[FR]
    assert (fp.nw, fp.sound, fp.base, fp.nr, fp.sw) == (24, False, True,
                                                        None, 12)
    assert (fr.nw, fr.sound, fr.base) == (12, False, False)
    assert 4 * CURVE.fp.modulus < 1 << 768 and 4 * R < 1 << 384
    v = cuda.variant(FP)
    assert v == cuda.Variant(24, False, 0, 12) and v.tag == "w24-sw12-nofp2"
    assert {"-DGT_NW=24", "-DGT_NR_ABS=0", "-DGT_SW=12"} <= set(v.flags)
    assert cuda.variant(FR) == cuda.variant("bls12_381_fp") == \
        cuda.Variant(12, False, 1, 8)
    assert "-DGT_SW=8" in cuda.variant("bn254_fp").flags
    assert cuda.sources(FP) == cuda.BASE_SOURCES
    assert cuda.sources(FR) == ("mont_mul", "row_fft", "butterfly")
    pairs = cuda.builds()
    assert len(pairs) == len(set(pairs)) == 35
    names = [cuda._target(s, v).name for s, v in pairs]
    assert len(set(names)) == 35
    assert len({n.rsplit("-", 1)[1] for n in names}) == 35      # hashes
    assert cuda.builds([FP]) == [(s, v) for s in cuda.BASE_SOURCES]
    # mont_mul w12 is BLS12-381's Fp's: BW6-761's Fr adds two libraries
    assert cuda.builds([FR]) == [(s, cuda.variant(FR))
                                 for s in cuda.sources(FR)]
    assert ("mont_mul", cuda.variant(FR)) in cuda.builds(["bls12_381_fp"])
    before = cuda.builds([f for f in cuda.KERNEL_FIELDS
                          if not f.startswith("bw6")])
    assert len(before) == 27
    assert [b for b in cuda.builds([FP, FR]) if b not in before] == \
        [(s, v) for s in cuda.BASE_SOURCES] + \
        [("row_fft", cuda.variant(FR)), ("butterfly", cuda.variant(FR))]


@pytest.mark.parametrize("name", [FP, FR])
def test_field_consts_layout(name):
    """FieldC at 4 nw + 1 words (97 at 24 words, 49 at 12): p | 2p | R
    mod p | n0 | R^3 mod p, n0 the 32-bit REDC constant (p n0 = -1 mod
    2^32), R = 2^(32 nw)."""
    nw = cuda.KERNEL_FIELDS[name].nw
    c = cuda.field_consts(name)
    p = fields.FIELDS[name].modulus
    assert c.shape == (4 * nw + 1,) == ({FP: 97, FR: 49}[name],)
    assert c.dtype == np.uint32

    def val(i):
        return sum(int(c[i * nw + k]) << (32 * k) for k in range(nw))
    big = 1 << (32 * nw)
    assert (val(0), val(1), val(2)) == (p, 2 * p, big % p)
    assert int(c[3 * nw]) * p % (1 << 32) == (1 << 32) - 1
    r3 = sum(int(c[3 * nw + 1 + k]) << (32 * k) for k in range(nw))
    assert r3 == pow(big, 3, p)


def test_the_card_takes_bw6_761_groth16():
    """check_curve takes BW6-761 on the card for Groth16 (G2 over Fp:
    the base field's own build, no Fp2) and refuses it for PLONK; the
    curves over Fp2 keep their u^2 check, and a G2 over Fp2 is refused
    over a field built with none."""
    card = torch.device("cuda")
    for name in ("bn254", "bls12_381", "bls12_377", "bw6_761"):
        cuda.check_curve(curves.CURVES[name], card)
    for name in ("bn254", "bls12_381", "bls12_377"):
        cuda.check_curve(curves.CURVES[name], card, plonk=True)
    with pytest.raises(ValueError, match="by_inv"):
        cuda.check_curve(CURVE, card, plonk=True)
    cuda.check_curve(CURVE, torch.device("cpu"), plonk=True)
    fake = dataclasses.replace(curves.CURVES["bls12_377"], fp=CURVE.fp)
    with pytest.raises(ValueError, match="no Fp2"):
        cuda.check_curve(fake, card)
    assert groth16._g2_field(CURVE) is get_ff(FP)
    assert proj_ec.kernel_field(get_ff(FP)).shape == (97,)


def test_plonk_over_bw6_761_on_the_card_raises_before_any_work(monkeypatch):
    """plonk.setup, plonk.keys_from_arrays and the prove raise on a card
    request over BW6-761 before any work (no build, no launch), naming
    K11's inverse; a binding of PLONK's kernels for its 12-word Fr
    raises before any build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def no_build(*a):
        raise AssertionError("a build was started")
    monkeypatch.setattr(cuda, "_lib", no_build)
    cs = compile_circuit(Cubic(), fields.BW6_761_FR)
    cs.kind = "scs"
    srs = types.SimpleNamespace(curve=CURVE, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="by_inv"):
        plonk.setup(cs, srs)
    with pytest.raises(ValueError, match="by_inv"):
        plonk.keys_from_arrays({}, "bw6_761", device="cuda")
    vk = types.SimpleNamespace(curve=CURVE, size=8, generator=1,
                               coset_shift=1)
    with pytest.raises(ValueError, match="by_inv"):
        plonk_device.prove(cs, types.SimpleNamespace(vk=vk), [35], [3],
                           device="cuda")
    for mod, binder, args in ((ops, "_fn", ("gt_batch_inv",)),
                              (plonk_num, "_fn", ())):
        with pytest.raises(ValueError, match="no .* kernels for"):
            getattr(mod, binder).__wrapped__(*args, FR)


class _Lib:
    """A stand-in for a loaded library: every entry point a no-op."""

    def __getattr__(self, name):
        def fn(*args):
            return 0
        return fn


BINDERS = [  # (module, binder, arguments before the field, base field)
    (mont_mul, "_fn", (), False), (mont_mul, "_sub_fn", (), False),
    (fixed_base, "_affine_fn", (), True), (fixed_base, "_ladder_fn", (), True),
    (proj_ec, "_add_fn", (), True), (proj_ec, "_dbl_fn", (), True),
    (jac_ec, "_madd_fn", (), True), (jac_ec, "_dbl_fn", (), True),
    (jac_ec, "_add_fn", (), True), (jac_ec, "_fold_fn", (), True),
    (bucket, "_k4", ("gt_bucket_acc",), True),
    (bucket, "_digits_fn", (), True), (bucket, "_k9", (), True),
    (fourstep, "_seg_fn", (), False), (fourstep, "_pass_fn", (), False),
    (radix2, "_seg_fn", (), False), (radix2, "_pass_fn", (), False),
]


def test_every_binding_reaches_a_bw6_761_build(monkeypatch):
    """Each Groth16 wrapper's binding, for the field its wrapper passes
    over BW6-761 (lib_field of Fp, G1's and G2's, for the point kernels;
    the scalar field's name for the others), loads the w24-sw12-nofp2
    library of its source, or the w12 one."""
    seen = []

    def lib(name, v):
        seen.append((name, v.tag))
        return _Lib()
    monkeypatch.setattr(cuda, "_lib", lib)
    assert lib_field(groth16._g2_field(CURVE)) == lib_field(get_ff(FP))
    for mod, binder, args, base in BINDERS:
        fn = getattr(mod, binder).__wrapped__
        seen.clear()
        fn(*args, lib_field(get_ff(FP)) if base else FR)
        assert seen == [(seen[0][0], "w24-sw12-nofp2" if base else "w12")], \
            (mod.__name__, binder)


# ---------------------------------------------------------------------------
# the ladder, the NTT, K2's shared memory and the keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_ladder_at_16_bits_against_host(g2):
    """The ladder's twin (the per-bit plain K7 + K6 at 24 words) at 16
    bits on 12-word scalars, then the affine kernel's twin, in G1 and in
    G2 over Fp, against host scalar multiplications."""
    ff = get_ff(FP)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    ks = [0, 1, 2, (1 << 16) - 1, 12345, 40000]
    base = tuple(a.reshape(1, -1) for a in _encode([gen])[:2])
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    assert tuple(sc.shape) == (6, 12)
    x, y, inf = fixed_base.batch_scalar_mul_affine(ff, base, 16, sc)
    assert groth16._host_points(ff, x, y, inf) == \
        [host.ec_mul(hf, gen, k) for k in ks]


def _words_of_ref(ff, limbs):
    return ff.to_words(torch.as_tensor(np.asarray(limbs).astype(np.int64)))


def test_ntt_plain_at_12_words_matches_reference_domain(monkeypatch):
    """Domain.fft / ifft, plain and coset, over BW6-761's 12-word scalar
    field against the reference's Domain: at 2^10 on the radix-2 plan
    (K5's twin) and on the four-step plan forced small (K2's twin)."""
    f, rf = get_ff(FR), ref_get_ff(FR)
    n = 1 << 10
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(n)]
    x, rx = torch.as_tensor(f.encode_words(vals)), jnp.asarray(rf.encode(vals))
    ref = RefDomain(rf, n)
    want = {(fwd, coset): _words_of_ref(f, (ref.fft if fwd else ref.ifft)(
        rx, coset=coset)) for fwd in (True, False) for coset in (False, True)}
    for plan in ("14", "5"):
        monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", plan)
        dom = Domain(f, n, "cpu")
        for (fwd, coset), w in want.items():
            assert torch.equal((dom.fft if fwd else dom.ifft)(
                x, coset=coset), w), (plan, fwd, coset)


def test_seg_smem_bytes_at_8_and_12_words():
    """K2's segment block: at 8 words 2^12 points fit (SMEM_LOG); at 12
    words 2^12 would take 319,488 B, past a block's 232,448, so rows
    past 2^11 (159,744 B) take a global pass first; every planned
    segment fits."""
    assert fourstep.seg_smem_bytes(12) == fourstep.seg_smem_bytes(12, 8)
    assert fourstep.seg_smem_bytes(12, 12) == 319488
    assert fourstep.seg_smem_bytes(11, 12) == 159744
    assert (fourstep.seg_log(8), fourstep.seg_log(12)) == (12, 11)
    assert fourstep.row_plan(1 << 10, 12) == ((), 10)
    assert fourstep.row_plan(1 << 12, 12) == ((1,), 11)
    assert fourstep.row_plan(1 << 12, 8) == ((), 12)
    for nw in (8, 12):
        for L in range(1, 16):
            passes, G = fourstep.row_plan(1 << L, nw)
            assert sum(passes) + G == L
            assert fourstep.seg_smem_bytes(G, nw) <= fourstep.SMEM_LIMIT


def test_keys_take_g2_over_fp():
    """dummy_setup and the known-log key (proving_key_from_arrays) keep
    G2's columns as (n, 24) Fp words, beside G1's."""
    cs = compile_circuit(Cubic(), fields.BW6_761_FR)
    pk = groth16.dummy_setup(cs, "bw6_761", device="cpu")
    assert tuple(pk.g2_b[0].shape) == tuple(pk.g1_a[0].shape) == \
        (cs.nb_wires, 24)
    assert groth16._host_points(get_ff(FP), *(a[:1] for a in pk.g2_b)) == \
        [CURVE.g2]
    kl = groth16_check.known_log_key(cs, CURVE, device="cpu")
    assert tuple(kl.g2_b[0].shape) == (cs.nb_wires, 24)
    off = groth16_check.OFFSETS["g2_b"]
    assert groth16._host_points(get_ff(FP), *(a[:2] for a in kl.g2_b)) == \
        [host.ec_mul(CURVE.host_fp, CURVE.g2, off + k) for k in (1, 2)]


# ---------------------------------------------------------------------------
# slow tier: Groth16 keys and proof equal to the reference's
# ---------------------------------------------------------------------------

def _key_words(pk, words):
    """ProvingKey columns as numpy words (the reference's 16-bit limbs
    packed in pairs when words is False)."""
    out = []
    for k in ("g1_a", "g1_b", "g1_z", "g1_k", "g2_b"):
        x, y, inf = getattr(pk, k)
        if words:
            out.append((np.asarray(x), np.asarray(y), np.asarray(inf)))
        else:
            out.append((groth16._words_from_limbs(x),
                        groth16._words_from_limbs(y), np.asarray(inf)))
    return out


@pytest.mark.slow
def test_groth16_bw6_761_equals_reference():
    """Groth16 over BW6-761 on examples/cubic.py's circuit: the port's
    setup and prove on the CPU give the reference's keys and proof under
    the same random.Random seed (the reference's test_multicurve seed);
    both verifiers accept the proof and refuse a wrong public value."""
    seed = 22
    rcs = ref_compile(RefCubic(), ref_fields.BW6_761_FR)
    rng = random.Random(seed)
    rpk, rvk = ref_groth16.setup(rcs, "bw6_761", rng=rng)
    pub, sec = ref_witness(RefCubic(x=3, y=35), rcs)
    want = ref_groth16.prove(rcs, rpk, pub, sec, rng=rng)
    cs = compile_circuit(Cubic(), fields.BW6_761_FR)
    rng = random.Random(seed)
    pk, vk = groth16.setup(cs, "bw6_761", rng=rng, device="cpu")
    got = groth16.prove(cs, pk, pub, sec, rng=rng, device="cpu")
    for g, w in zip(_key_words(pk, True), _key_words(rpk, False)):
        for a, b in zip(g, w):
            assert np.array_equal(a.reshape(b.shape), b)
    for k in ("g1_alpha", "g1_beta", "g1_delta", "g2_beta", "g2_delta"):
        assert getattr(pk, k) == getattr(rpk, k), k
    for k in ("g1_k", "g2_gamma_neg", "g2_delta_neg", "e_alpha_beta",
              "g1_alpha", "g2_beta", "g2_gamma", "g2_delta"):
        assert getattr(vk, k) == getattr(rvk, k), k
    assert (got.ar, got.krs, got.bs, got.commitments, got.poks) == \
        (want.ar, want.krs, want.bs, want.commitments, want.poks)
    assert ref_groth16.verify(want, rvk, pub)
    assert not ref_groth16.verify(want, rvk, [36])
    assert groth16.verify(got, vk, pub) and not groth16.verify(got, vk, [36])
