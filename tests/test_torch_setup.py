"""gnark_tpu_torch Groth16 setup and verify, on the CPU:
  * setup of examples/cubic.py: every key and vk point equals
    host.ec_mul(generator, scalar) for the scalars recomputed from the
    same seed;
  * verify accepts a proof made with the trapdoor of that setup and
    rejects the probes of the verify skill (wrong public value, fields of
    two proofs mixed, a point off the curve, a public-count mismatch);
    a vk with a commitment refuses a proof without one, and with the
    recursion-friendly commitment hashes refuses a bogus committed
    proof; those hashes raise NotImplementedError on public committed
    wires, as the reference's (BSB22 commitments themselves:
    tests/test_torch_bsb22.py);
  * the copied ate pairing gives the reference's GT value;
  * the Merkle membership circuit compiles to the reference's R1CS;
  * slow tier: the port's keys equal the reference setup's under the
    same random.Random seed, and a real prove verifies (cubic; depth-2
    Merkle membership).
Tolerance: exact equality (affine host ints, Montgomery words, GT
tuples)."""

import random

import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import groth16 as ref_groth16
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.pairing.ate import get_ate as ref_get_ate
from gnark_tpu.std import merkle as ref_merkle
from gnark_tpu.std.hash.mimc import mimc_hash as ref_mimc_hash
from gnark_tpu_torch import fields
from gnark_tpu_torch.backend import groth16
from gnark_tpu_torch.backend.groth16_check import (Membership,
                                                   membership_assignment)
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                      compile_circuit, witness)
from gnark_tpu_torch.pairing.ate import get_ate

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
SEED = 42


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


@pytest.fixture(scope="module")
def cubic():
    cs = compile_circuit(Cubic(), fields.BN254_FR)
    pk, vk = groth16.setup(cs, "bn254", rng=random.Random(SEED),
                           device="cpu")
    return cs, pk, vk, groth16.setup_scalars(cs, CURVE, random.Random(SEED))


def _column(pk, name):
    ff = groth16._g2_field(CURVE) if name == "g2_b" else \
        get_ff(CURVE.fp.name)
    return groth16._host_points(ff, *getattr(pk, name))


def test_setup_key_points_equal_host(cubic):
    cs, pk, vk, s = cubic
    f1, f2 = CURVE.host_fp, CURVE.host_g2_field
    g1, g2 = s["g1"], s["g2"]
    nw, npub, N = cs.nb_wires, cs.nb_public, s["N"]
    assert (pk.domain_n, N) == (4, 4)
    assert len(g1) == 3 + 3 * nw + N and len(g2) == 3 + nw
    o_vk = 3 + 2 * nw + N
    for name, sc, f, gen in (
            ("g1_a", g1[3:3 + nw], f1, CURVE.g1),
            ("g1_b", g1[3 + nw:3 + 2 * nw], f1, CURVE.g1),
            ("g1_z", g1[3 + 2 * nw:o_vk], f1, CURVE.g1),
            ("g1_k", g1[o_vk + npub:], f1, CURVE.g1),
            ("g2_b", g2[3:], f2, CURVE.g2)):
        assert _column(pk, name) == [host.ec_mul(f, gen, k) for k in sc], name
    assert vk.g1_k == [host.ec_mul(f1, CURVE.g1, k)
                       for k in g1[o_vk:o_vk + npub]]
    assert (pk.g1_alpha, pk.g1_beta, pk.g1_delta) == tuple(
        host.ec_mul(f1, CURVE.g1, s[k]) for k in ("alpha", "beta", "delta"))
    assert (pk.g2_beta, pk.g2_delta, vk.g2_gamma) == tuple(
        host.ec_mul(f2, CURVE.g2, s[k]) for k in ("beta", "delta", "gamma"))
    assert vk.g2_delta_neg == host.ec_neg(f2, vk.g2_delta)
    assert vk.g2_gamma_neg == host.ec_neg(f2, vk.g2_gamma)
    # a zero scalar is the point at infinity, encoded as x = y = 0
    x, y, inf = pk.g1_a
    assert [bool(v) for v in inf] == [k == 0 for k in g1[3:3 + nw]]
    assert all(bool((x[i] == 0).all() and (y[i] == 0).all())
               for i in range(nw) if bool(inf[i]))


def _trapdoor_proof(cs, s, public, rng):
    """A proof made with the toxic waste instead of a witness: Ar = a G1,
    Bs = b G2, Krs = (a b - alpha beta - gamma sum w_i vkK_i) / delta G1.
    It verifies exactly when the vk is right."""
    q = CURVE.fr.modulus
    o_vk = 3 + 2 * cs.nb_wires + s["N"]
    vkk = s["g1"][o_vk:o_vk + cs.nb_public]
    k = sum(w * v for w, v in zip([1] + list(public), vkk)) % q
    a, b = rng.randrange(1, q), rng.randrange(1, q)
    c = (a * b - s["alpha"] * s["beta"] - s["gamma"] * k) * \
        pow(s["delta"], -1, q) % q
    f1 = CURVE.host_fp
    return groth16.Proof(ar=host.ec_mul(f1, CURVE.g1, a),
                         krs=host.ec_mul(f1, CURVE.g1, c),
                         bs=host.ec_mul(CURVE.host_g2_field, CURVE.g2, b))


def test_verify_accepts_and_rejects(cubic):
    cs, pk, vk, s = cubic
    pub, _ = witness(Cubic(x=3, y=35), cs)
    p1 = _trapdoor_proof(cs, s, pub, random.Random(1))
    p2 = _trapdoor_proof(cs, s, pub, random.Random(2))
    assert groth16.verify(p1, vk, pub)
    assert not groth16.verify(p1, vk, [36])
    assert not groth16.verify(
        groth16.Proof(ar=p1.ar, krs=p2.krs, bs=p1.bs), vk, pub)
    assert not groth16.verify(
        groth16.Proof(ar=(1, 1), krs=p1.krs, bs=p1.bs), vk, pub)
    assert not groth16.verify(
        groth16.Proof(ar=p1.ar, krs=p1.krs, bs=p1.bs,
                      commitments=[CURVE.g1]), vk, pub)
    with pytest.raises(ValueError):
        groth16.verify(p1, vk, pub + [1])


class Committed(Circuit):
    x: Secret
    y: Public

    def define(self, api):
        c = api.commit(self.x)
        api.assert_is_equal(api.mul(self.x, c), api.mul(c, self.y))


def test_commitments_raise(cubic):
    """What is left of the commitment raises: public committed wires
    under the MiMC hash modes of recursion-friendly proofs (the modes
    themselves are ported: verify refuses a bogus committed proof)."""
    cs = compile_circuit(Committed(), fields.BN254_FR)
    assert cs.commitments
    _, _, vk, _ = cubic
    vk2 = groth16.VerifyingKey(**{**vk.__dict__,
                                  "commitment_g2_sigma": [CURVE.g2]})
    assert not groth16.verify(groth16.Proof(ar=CURVE.g1, krs=CURVE.g1,
                                            bs=CURVE.g2), vk2, [35])
    cm = groth16.Proof(ar=CURVE.g1, krs=CURVE.g1, bs=CURVE.g2,
                       commitments=[CURVE.g1], poks=[CURVE.g1])
    for mode in (True, "self"):
        assert not groth16.verify(cm, vk2, [], recursion_friendly=mode)
        with pytest.raises(NotImplementedError):
            groth16._hash_to_field(CURVE, CURVE.g1, mode,
                                   public_committed=(1,))


def test_ate_copy_matches_reference():
    """The Tate copy is held against the reference through vk.e_alpha_beta
    (slow test) and through every verify here."""
    g1 = host.ec_mul(CURVE.host_fp, CURVE.g1, 5)
    assert get_ate("bn254").pair(g1, CURVE.g2) == \
        ref_get_ate("bn254").pair(g1, CURVE.g2)


class RefMembership(RefCircuit):
    root: RefPublic
    leaf: RefSecret
    path: list[RefSecret]
    dirs: list[RefSecret]

    def __init__(self, depth, **kw):
        self.path = [None] * depth
        self.dirs = [None] * depth
        super().__init__(**kw)

    def define(self, api):
        ref_merkle.verify_proof(api, self.root, self.leaf, self.path,
                                self.dirs)


def _r1cs(cs):
    return ([(c.l, c.r, c.o) for c in cs.r1cs],
            (cs.nb_public, cs.nb_secret, cs.nb_internal))


def test_merkle_circuit_same_r1cs_as_reference():
    """The merkle_d12 configuration's circuit (7,957 constraints) and, at
    depth 3, the example's witness."""
    cs = compile_circuit(Membership(12), fields.BN254_FR)
    ref = ref_compile(RefMembership(12), ref_fields.BN254_FR)
    assert _r1cs(cs) == _r1cs(ref)
    assert (cs.nb_constraints, cs.nb_wires) == (7957, 7971)
    cs3 = compile_circuit(Membership(3), fields.BN254_FR)
    ref3 = ref_compile(RefMembership(3), ref_fields.BN254_FR)
    leaves = [ref_mimc_hash([i + 1000]) for i in range(8)]
    root, proof = ref_merkle.host_merkle_root(leaves)
    rc = RefMembership(3, root=root, leaf=leaves[5])
    rc.path, rc.dirs = proof(5)
    assert witness(membership_assignment(3, 5), cs3) == \
        ref_witness(rc, ref3)


def _key_data(pk, words):
    """ProvingKey columns as numpy arrays of words (the reference's 16-bit
    limbs packed in pairs when words is False)."""
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
def test_setup_equals_reference_and_proofs_verify(cubic):
    """Slow tier: the reference setup compiles its fixed-base ladder."""
    cs, pk, vk, _ = cubic
    ref_cs = ref_compile(RefCubic(), ref_fields.BN254_FR)
    rpk, rvk = ref_groth16.setup(ref_cs, "bn254", rng=random.Random(SEED))
    for got, want in zip(_key_data(pk, True), _key_data(rpk, False)):
        for g, w in zip(got, want):
            assert np.array_equal(g.reshape(w.shape), w)
    for k in ("g1_alpha", "g1_beta", "g1_delta", "g2_beta", "g2_delta"):
        assert getattr(pk, k) == getattr(rpk, k), k
    for k in ("g1_k", "g2_gamma_neg", "g2_delta_neg", "e_alpha_beta",
              "g1_alpha", "g2_beta", "g2_gamma", "g2_delta"):
        assert getattr(vk, k) == getattr(rvk, k), k
    pub, sec = witness(Cubic(x=3, y=35), cs)
    p1 = groth16.prove(cs, pk, pub, sec, rng=random.Random(1), device="cpu")
    p2 = groth16.prove(cs, pk, pub, sec, rng=random.Random(2), device="cpu")
    assert groth16.verify(p1, vk, pub)
    assert ref_groth16.verify(
        ref_groth16.Proof(ar=p1.ar, krs=p1.krs, bs=p1.bs), rvk, pub)
    assert not groth16.verify(
        groth16.Proof(ar=p1.ar, krs=p2.krs, bs=p1.bs), vk, pub)


@pytest.mark.slow
def test_merkle_depth2_setup_prove_verify():
    """Slow tier: ~3 minutes of plain ladders and MSM epilogues."""
    cs = compile_circuit(Membership(2), fields.BN254_FR)
    pk, vk = groth16.setup(cs, "bn254", rng=random.Random(0), device="cpu")
    pub, sec = witness(membership_assignment(2, 3), cs)
    proof = groth16.prove(cs, pk, pub, sec, rng=random.Random(1),
                          device="cpu")
    assert groth16.verify(proof, vk, pub)
    assert not groth16.verify(proof, vk, [pub[0] + 1])
