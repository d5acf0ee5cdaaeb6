"""BSB22 commitments in gnark_tpu_torch's Groth16, on the CPU:
  * the copied gnark_fs (transcript, point marshals, hash-to-field) and
    the backend's _pac_indices and _hash_to_field (default and "evm"
    modes) give the reference's values on fixed inputs;
  * setup_scalars places the commitment scalars as the reference's setup
    does, and verify accepts a committed proof made with the trapdoor of
    those scalars and refuses tampered ones (commitment and PoK swapped,
    a tampered PoK, missing commitments, a wrong PoK count);
  * the recursion-friendly hash modes (MiMC, True and "self") give the
    reference's values, and a proof made under the default hash fails
    verification under them;
  * slow tier: on a key carried across from the reference's setup, the
    port's prove gives the reference's Proof byte for byte (commit
    circuit and lookup circuit of tests/test_groth16.py); the port's
    setup gives the reference's keys, commitment keys included; its
    proof verifies; the scan path gives the same proof.
Tolerance: exact equality (host ints, Montgomery limbs, bytes)."""

import random

import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import gnark_fs as ref_fs
from gnark_tpu.backend import groth16 as ref_groth16
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.std.lookup import Table as RefTable
from gnark_tpu.utils.hash_to_field import hash_to_field as ref_htf
from gnark_tpu_torch import fields
from gnark_tpu_torch.backend import gnark_fs, groth16
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                      compile_circuit, witness)
from gnark_tpu_torch.std.lookup import Table
from gnark_tpu_torch.utils.hash_to_field import hash_to_field

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
Q = CURVE.fr.modulus
SBOX = [((7 * i + 3) ** 2) % 251 for i in range(16)]


def _commit_circuit(Base, Pub, Sec):
    """tests/test_groth16.py's CommitCircuit for either frontend."""
    class CommitCircuit(Base):
        x: Sec
        y: Pub

        def define(self, api):
            x2 = api.mul(self.x, self.x)
            c = api.commit(self.x, x2)
            api.assert_is_equal(x2, self.y)
            t = api.mul(c, api.sub(self.x, self.y))
            api.assert_is_equal(t, api.sub(api.mul(c, self.x),
                                           api.mul(c, self.y)))
    return CommitCircuit


def _lookup_circuit(Base, Pub, Sec, Tab):
    """tests/test_groth16.py's lookup circuit (commits wires out of
    allocation order)."""
    class LookupCircuit(Base):
        x: Sec
        y: Pub

        def define(self, api):
            t = Tab(api)
            for v in SBOX:
                t.insert(v)
            api.assert_is_equal(t.lookup(self.x)[0], self.y)
    return LookupCircuit


def _two_commits(Base, Pub, Sec):
    """Two commitments: the first hashes the public y, the second hashes
    the first's value (prior commitment)."""
    class TwoCommits(Base):
        x: Sec
        y: Pub

        def define(self, api):
            c1 = api.commit(self.x, self.y)
            c2 = api.commit(c1, self.x)
            api.assert_is_equal(api.mul(c1, c2), api.mul(c2, c1))
            api.assert_is_equal(api.mul(self.x, self.x), self.y)
    return TwoCommits


CommitCircuit = _commit_circuit(Circuit, Public, Secret)
RefCommitCircuit = _commit_circuit(RefCircuit, RefPublic, RefSecret)
LookupCircuit = _lookup_circuit(Circuit, Public, Secret, Table)
RefLookupCircuit = _lookup_circuit(RefCircuit, RefPublic, RefSecret,
                                   RefTable)
TwoCommits = _two_commits(Circuit, Public, Secret)
RefTwoCommits = _two_commits(RefCircuit, RefPublic, RefSecret)


def test_gnark_fs_matches_reference():
    f1, f2 = CURVE.host_fp, CURVE.host_g2_field
    p1 = host.ec_mul(f1, CURVE.g1, 12345)
    p2 = host.ec_mul(f2, CURVE.g2, 678)
    for P in (p1, None):
        assert gnark_fs.g1_raw_bytes(CURVE, P) == ref_fs.g1_raw_bytes(CURVE, P)
        assert gnark_fs.bsb22_plonk_value(CURVE, P, Q) == \
            ref_fs.bsb22_plonk_value(CURVE, P, Q)
        for pub in ([], [3, Q - 1]):
            assert gnark_fs.bsb22_groth16_value(CURVE, P, pub, Q) == \
                ref_fs.bsb22_groth16_value(CURVE, P, pub, Q)
    for P in (p2, None):
        assert gnark_fs.g2_raw_bytes(CURVE, P) == ref_fs.g2_raw_bytes(CURVE, P)
    for vals in ([], [1], [5, Q - 2, 7]):
        assert gnark_fs.groth16_fold_challenge(vals, Q) == \
            ref_fs.groth16_fold_challenge(vals, Q)
    assert gnark_fs.kzg_fold_challenge(CURVE, Q, 9, [p1, None], [4, 5],
                                       b"x") == \
        ref_fs.kzg_fold_challenge(CURVE, Q, 9, [p1, None], [4, 5], b"x")
    ts, rts = (m.GnarkTranscript(Q, ["a", "b"]) for m in (gnark_fs, ref_fs))
    for t in (ts, rts):
        t.bind("a", t.fe_bytes(11))
        t.bind("b", gnark_fs.g1_raw_bytes(CURVE, p1))
    assert (ts.challenge("a"), ts.challenge("b")) == \
        (rts.challenge("a"), rts.challenge("b"))
    for msg, dst, n in ((b"", b"d", 1), (b"abc" * 50, b"G16-BSB22", 3)):
        assert hash_to_field(msg, dst, n, Q) == ref_htf(msg, dst, n, Q)


def test_pac_indices_and_hash_to_field_match_reference():
    cs = compile_circuit(TwoCommits(), fields.BN254_FR)
    ref = ref_compile(RefTwoCommits(), ref_fields.BN254_FR)
    assert [(c.committed_wires, c.commitment_wire, c.nb_public_committed)
            for c in cs.commitments] == \
        [(c.committed_wires, c.commitment_wire, c.nb_public_committed)
         for c in ref.commitments]
    pac = groth16._pac_indices(cs, cs.nb_public)
    assert pac == ref_groth16._pac_indices(ref, ref.nb_public)
    assert pac == [(1,), (2,)]            # y, then the first commitment
    P = host.ec_mul(CURVE.host_fp, CURVE.g1, 99)
    for pt in (P, host.INF):
        for pub in ((), (36,), (1, 2)):
            assert groth16._hash_to_field(CURVE, pt, public_committed=pub) \
                == ref_groth16._hash_to_field(CURVE, pt,
                                              public_committed=pub)
        assert groth16._hash_to_field(CURVE, pt, "evm") == \
            ref_groth16._hash_to_field(CURVE, pt, "evm")
    for mode in (True, "self"):
        for pt in (P, host.INF):
            assert groth16._hash_to_field(CURVE, pt, mode) == \
                ref_groth16._hash_to_field(CURVE, pt, mode)
        with pytest.raises(NotImplementedError):
            groth16._hash_to_field(CURVE, P, mode, public_committed=(1,))
    with pytest.raises(NotImplementedError):
        groth16._hash_to_field(CURVE, P, "evm", public_committed=(1,))


def _trapdoor_vk_and_proof(cs, s, public, rng):
    """The vk of setup_scalars' scalars s, and a committed proof made
    with the toxic waste: C = c G1, PoK = sigma C, Ar = a G1, Bs = b G2,
    Krs = (a b - alpha beta - gamma (sum of the extended public vector
    times vkK + c)) / delta G1. It verifies exactly when setup_scalars,
    _pac_indices, _hash_to_field and verify agree."""
    f1, f2 = CURVE.host_fp, CURVE.host_g2_field
    nb_pub, ncm = cs.nb_public, len(cs.commitments)
    o_vk = 3 + 2 * cs.nb_wires + s["N"]
    vkk = s["g1"][o_vk:o_vk + nb_pub + ncm]
    g2 = {k: host.ec_mul(f2, CURVE.g2, s[k])
          for k in ("beta", "gamma", "delta")}
    from gnark_tpu_torch.pairing import get_pairing
    vk = groth16.VerifyingKey(
        curve=CURVE, g1_k=[host.ec_mul(f1, CURVE.g1, k) for k in vkk],
        g2_gamma_neg=host.ec_neg(f2, g2["gamma"]),
        g2_delta_neg=host.ec_neg(f2, g2["delta"]),
        e_alpha_beta=get_pairing("bn254").pair(
            host.ec_mul(f1, CURVE.g1, s["alpha"]), g2["beta"]),
        g1_alpha=None, g2_beta=g2["beta"], g2_gamma=g2["gamma"],
        g2_delta=g2["delta"],
        commitment_g2_sigma=[host.ec_mul(f2, CURVE.g2, sg)
                             for sg in s["sigmas"]],
        commitment_pac=groth16._pac_indices(cs, nb_pub))
    assert ncm == 1
    c = rng.randrange(1, Q)
    C = host.ec_mul(f1, CURVE.g1, c)
    ext = [1] + list(public)
    ext.append(groth16._hash_to_field(
        CURVE, C, public_committed=[ext[i] for i in vk.commitment_pac[0]]))
    k = (sum(v * w for v, w in zip(ext, vkk)) + c) % Q
    a, b = rng.randrange(1, Q), rng.randrange(1, Q)
    krs = (a * b - s["alpha"] * s["beta"] - s["gamma"] * k) * \
        pow(s["delta"], -1, Q) % Q
    proof = groth16.Proof(
        ar=host.ec_mul(f1, CURVE.g1, a), krs=host.ec_mul(f1, CURVE.g1, krs),
        bs=host.ec_mul(f2, CURVE.g2, b), commitments=[C],
        poks=[host.ec_mul(f1, C, s["sigmas"][0])])
    return vk, proof


def test_setup_scalars_and_verify_with_commitment():
    cs = compile_circuit(CommitCircuit(), fields.BN254_FR)
    s = groth16.setup_scalars(cs, CURVE, random.Random(9))
    nw, nb_pub = cs.nb_wires, cs.nb_public
    cm = cs.commitments[0]
    assert cm.nb_public_committed == 0 and len(s["sigmas"]) == 1
    # rng order: t, alpha, beta, gamma, delta, then one sigma
    r = random.Random(9)
    draws = [r.randrange(Q) or 1 for _ in range(6)]
    assert [s[k] for k in ("alpha", "beta", "gamma", "delta")] + \
        s["sigmas"] == draws[1:]
    o_vk = 3 + 2 * nw + s["N"]
    o_pk = o_vk + nb_pub + 1
    pkk = s["g1"][o_pk:o_pk + nw - nb_pub]
    ck = s["g1"][o_pk + nw - nb_pub:]
    assert s["ck_sizes"] == [len(cm.committed_wires)]
    assert len(ck) == 2 * len(cm.committed_wires)
    assert [ck[len(ck) // 2 + i] for i in range(len(ck) // 2)] == \
        [v * s["sigmas"][0] % Q for v in ck[:len(ck) // 2]]
    for w in cm.committed_wires + (cm.commitment_wire,):
        assert pkk[w - nb_pub] == 0
    assert s["g2"][3] == s["sigmas"][0] and len(s["g2"]) == 4 + nw

    pub, _ = witness(CommitCircuit(x=6, y=36), cs)
    vk, proof = _trapdoor_vk_and_proof(cs, s, pub, random.Random(1))
    assert groth16.verify(proof, vk, pub)
    f1 = CURVE.host_fp
    C, pok = proof.commitments[0], proof.poks[0]
    for bad in (
            dict(commitments=[pok], poks=[C]),            # swapped
            dict(poks=[host.ec_add(f1, pok, CURVE.g1)]),  # tampered PoK
            dict(commitments=[], poks=[]),
            dict(poks=[pok, pok])):
        assert not groth16.verify(groth16.Proof(**{**proof.__dict__, **bad}),
                                  vk, pub)
    # the MiMC commitment hash gives another commitment value
    for mode in (True, "self"):
        assert not groth16.verify(groth16.Proof(**{**proof.__dict__}), vk,
                                  pub, recursion_friendly=mode)


def _ref_key_arrays(pk):
    """The reference ProvingKey as plain data, commitment keys included."""
    d = {k: getattr(pk, k) for k in ("domain_n", "g1_alpha", "g1_beta",
                                     "g1_delta", "g2_beta", "g2_delta")}
    for k in ("g1_a", "g1_b", "g1_z", "g1_k", "g2_b"):
        d[k] = tuple(np.asarray(a) for a in getattr(pk, k))
    ffp = ref_get_ff(CURVE.fp.name)
    d["commitment_keys"] = [dict(
        wires=ck.wires, g2_sigma=ck.g2_sigma, nb_public=ck.nb_public,
        **{k: tuple(np.asarray(a) for a in ref_groth16._encode_affine_host(
            ffp, getattr(ck, k))) for k in ("basis", "basis_exp_sigma")})
        for ck in pk.commitment_keys]
    return d


CASES = {"commit": (CommitCircuit, RefCommitCircuit, dict(x=6, y=36), 9),
         "lookup": (LookupCircuit, RefLookupCircuit, dict(x=9, y=SBOX[9]),
                    5)}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_committed_prove_equals_reference(case):
    """Reference setup -> the port's prove on the carried-over key -> the
    reference's Proof, commitments and folded PoK included."""
    port_cls, ref_cls, assign, seed = CASES[case]
    ref_cs = ref_compile(ref_cls(), ref_fields.BN254_FR)
    pk, vk = ref_groth16.setup(ref_cs, "bn254", rng=random.Random(seed))
    pub, sec = ref_witness(ref_cls(**assign), ref_cs)
    want = ref_groth16.prove(ref_cs, pk, pub, sec, rng=random.Random(1))
    cs = compile_circuit(port_cls(), fields.BN254_FR)
    tpk = groth16.proving_key_from_arrays(_ref_key_arrays(pk), device="cpu")
    got = groth16.prove(cs, tpk, pub, sec, rng=random.Random(1),
                        device="cpu")
    assert (got.ar, got.krs, got.bs, got.commitments, got.poks) == \
        (want.ar, want.krs, want.bs, want.commitments, want.poks)
    assert len(got.commitments) == len(got.poks) == 1
    assert ref_groth16.verify(ref_groth16.Proof(**got.__dict__), vk, pub)


@pytest.mark.slow
def test_committed_setup_equals_reference_and_verifies(monkeypatch):
    """The port's setup under the reference's seed gives its keys,
    commitment keys and vk included; the port's proof verifies, the scan
    path gives the same proof, and tampered proofs are refused."""
    ref_cs = ref_compile(RefCommitCircuit(), ref_fields.BN254_FR)
    rpk, rvk = ref_groth16.setup(ref_cs, "bn254", rng=random.Random(9))
    cs = compile_circuit(CommitCircuit(), fields.BN254_FR)
    pk, vk = groth16.setup(cs, "bn254", rng=random.Random(9), device="cpu")
    d = _ref_key_arrays(rpk)
    for k in ("g1_a", "g1_b", "g1_z", "g1_k", "g2_b"):
        for got, want in zip(getattr(pk, k), d[k]):
            want = groth16._words_from_limbs(want) if want.dtype != bool \
                else want
            assert np.array_equal(np.asarray(got).reshape(want.shape), want)
    ffp = groth16.get_ff(CURVE.fp.name)
    (ck,), (rck,) = pk.commitment_keys, rpk.commitment_keys
    assert (ck.wires, ck.nb_public, ck.g2_sigma) == \
        (rck.wires, rck.nb_public, rck.g2_sigma)
    assert groth16._host_points(ffp, *ck.basis) == rck.basis
    assert groth16._host_points(ffp, *ck.basis_exp_sigma) == \
        rck.basis_exp_sigma
    for k in ("g1_k", "g2_gamma_neg", "g2_delta_neg", "e_alpha_beta",
              "commitment_g2_sigma", "commitment_pac"):
        assert getattr(vk, k) == getattr(rvk, k), k
    pub, sec = witness(CommitCircuit(x=6, y=36), cs)
    proof = groth16.prove(cs, pk, pub, sec, rng=random.Random(3),
                          device="cpu")
    assert groth16.verify(proof, vk, pub)
    assert ref_groth16.verify(ref_groth16.Proof(**proof.__dict__), rvk, pub)
    assert not groth16.verify(proof, vk, [35])
    swapped = groth16.Proof(ar=proof.ar, krs=proof.krs, bs=proof.bs,
                            commitments=proof.poks, poks=proof.commitments)
    assert not groth16.verify(swapped, vk, pub)
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", "scan")
    assert groth16.prove(cs, pk, pub, sec, rng=random.Random(3),
                         device="cpu") == proof
