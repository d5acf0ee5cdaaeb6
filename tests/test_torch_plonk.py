"""gnark_tpu_torch's PLONK against the reference, on the CPU:
  * the SCS frontend gives the reference's sparse constraints, wires,
    instructions and commitments (Cubic, the MiMC preimage circuit);
  * the transcripts (gnark's sha256 one, the MiMC one, the MiMC point
    writes) give the reference's challenges on fixed inputs;
  * the cubic PLONK, set up and proved by the port (one module fixture):
    the reference's host-only verify accepts the proof through a vk
    carried across, the port's verify too; both refuse a tampered
    claimed value, a tampered commitment and a wrong public value; the
    rho path of the quotient gives the coset path's coefficients;
    keys_from_arrays rebuilds the port's keys field by field from plain
    arrays;
  * slow tier: on the reference's keys carried across, the port's proof
    equals the reference's byte for byte (cubic on both quotient paths,
    a BSB22 circuit), and the two setups give the same vk; Groth16's
    recursion-friendly commitment hashes give the reference's proofs.
Tolerance: exact equality (host ints, points, words)."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import plonk as ref_plonk
from gnark_tpu.backend import transcript as ref_transcript
from gnark_tpu.ec import curves as ref_curves
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.frontend.scs import SCSBuilder as RefSCSBuilder
from gnark_tpu.std.hash.mimc import MiMCGadget as RefMiMCGadget
from gnark_tpu_torch import fields
from gnark_tpu_torch.backend import kzg, plonk, transcript
from gnark_tpu_torch.backend import plonk_device as pdev
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                      compile_circuit, witness)
from gnark_tpu_torch.frontend.scs import SCSBuilder
from gnark_tpu_torch.ntt import get_domain
from gnark_tpu_torch.std.hash.mimc import MiMCGadget

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
Q = CURVE.fr.modulus


def _cubic(Base, Pub, Sec):
    class Cubic(Base):
        x: Sec
        y: Pub

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(api.add(x3, self.x, 5), self.y)
    return Cubic


def _mimc_pre(Base, Pub, Sec, Gadget):
    class MimcPre(Base):
        pre: Sec
        h: Pub

        def define(self, api):
            g = Gadget(api)
            g.write(self.pre)
            api.assert_is_equal(g.sum(), self.h)
    return MimcPre


def _two_commits(Base, Pub, Sec):
    class TwoCommits(Base):
        a: Sec
        b: Sec
        s: Pub

        def define(self, api):
            c1 = api.commit(self.a)
            c2 = api.commit(self.b, c1)
            api.assert_is_different(c1, 0)
            api.assert_is_different(c2, 0)
            api.assert_is_equal(api.add(self.a, self.b), self.s)
    return TwoCommits


Cubic = _cubic(Circuit, Public, Secret)
RefCubic = _cubic(RefCircuit, RefPublic, RefSecret)
MimcPre = _mimc_pre(Circuit, Public, Secret, MiMCGadget)
RefMimcPre = _mimc_pre(RefCircuit, RefPublic, RefSecret, RefMiMCGadget)
TwoCommits = _two_commits(Circuit, Public, Secret)
RefTwoCommits = _two_commits(RefCircuit, RefPublic, RefSecret)

CIRCUITS = {"cubic": (Cubic, RefCubic), "mimc": (MimcPre, RefMimcPre),
            "two_commits": (TwoCommits, RefTwoCommits)}


def _scs_view(cs):
    return (
        [dataclasses.astuple(c) for c in cs.sparse],
        (cs.nb_public, cs.nb_secret, cs.nb_internal, cs.kind),
        [(i.kind, i.cidx, i.outputs, getattr(i, "inputs", None),
          getattr(i, "hint", None)) for i in cs.instructions],
        [dataclasses.astuple(c) for c in cs.commitments])


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_scs_matches_reference(name):
    port, ref = CIRCUITS[name]
    cs = compile_circuit(port(), fields.BN254_FR, builder_cls=SCSBuilder)
    rcs = ref_compile(ref(), ref_fields.BN254_FR, builder_cls=RefSCSBuilder)
    assert _scs_view(cs) == _scs_view(rcs)


def test_transcripts_match_reference():
    f1 = CURVE.host_fp
    P1 = host.ec_mul(f1, CURVE.g1, 777)
    rc = ref_curves.CURVES["bn254"]
    for mode in (True, "self"):
        assert transcript.outer_mimc_field(CURVE, mode) == \
            ref_transcript.outer_mimc_field(rc, mode)
        for P in (P1, None):
            assert transcript.mimc_point_writes(CURVE, P, mode) == \
                ref_transcript.mimc_point_writes(rc, P, mode)
    names = ["gamma", "beta", "alpha"]
    p_mod = CURVE.fp.modulus
    for make in (
            lambda m: m.Transcript(Q, names),
            lambda m: m.MimcTranscript(Q, names, "bn254_fr"),
            lambda m: m.MimcTranscript(
                Q, names, m.outer_mimc_field(
                    (CURVE if m is transcript else rc), True))):
        got, want = [], []
        for m, out in ((transcript, got), (ref_transcript, want)):
            ts = make(m)
            ts.bind("gamma", ts.fe_bytes(Q + 5))
            ts.bind("gamma", ts.point_bytes(P1, p_mod))
            out.append(ts.challenge("gamma"))
            out.append(ts.challenge("beta"))
            ts.bind("alpha", ts.point_bytes(None, p_mod))
            out.append(ts.challenge("alpha"))
        assert got == want


# ---------------------------------------------------------------------------
# the cubic PLONK on the port (one setup and one prove for the module)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cubic():
    cs = compile_circuit(Cubic(), fields.BN254_FR, builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bn254", 64, rng=random.Random(33), device="cpu")
    pk, vk = plonk.setup(cs, srs)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proof = plonk.prove(cs, pk, pub, sec, rng=random.Random(1),
                        device="cpu")
    return cs, pk, vk, pub, sec, proof


def ref_vk(vk):
    """The port's PlonkVerifyingKey as the reference's."""
    return ref_plonk.PlonkVerifyingKey(
        curve=ref_curves.CURVES[vk.curve.name],
        **{f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
           if f.name != "curve"})


def ref_proof(proof):
    return ref_plonk.PlonkProof(**dataclasses.asdict(proof))


def _tampered(proof):
    f1 = CURVE.host_fp
    return {
        "claimed": dataclasses.replace(
            proof, claimed=[(proof.claimed[0] + 1) % Q]
            + list(proof.claimed[1:])),
        "commitment": dataclasses.replace(
            proof, z=host.ec_add(f1, proof.z, CURVE.g1)),
    }


def test_cubic_proof_accepted_by_both_verifiers(cubic):
    cs, pk, vk, pub, sec, proof = cubic
    assert vk.size == 8 and vk.nb_public == 2
    assert plonk.verify(proof, vk, pub)
    assert ref_plonk.verify(ref_proof(proof), ref_vk(vk), pub)


def test_cubic_tampered_refused_by_both_verifiers(cubic):
    """A tampered claimed value, a tampered commitment, a wrong public
    value."""
    cs, pk, vk, pub, sec, proof = cubic
    cases = [(pub, p) for p in _tampered(proof).values()] + [([36], proof)]
    for bad, p in cases:
        assert not plonk.verify(p, vk, bad)
        assert not ref_plonk.verify(ref_proof(p), ref_vk(vk), bad)


def test_rho_path_gives_the_same_proof(cubic):
    """The quotient's two paths (the 4N coset, the four N-point shifts)
    give the same coefficients on the cubic's keys with random blinded
    columns and challenges; the whole proof on the rho path is held
    against the reference's in the slow tier."""
    cs, pk, vk, pub, sec, proof = cubic
    ff = get_ff(CURVE.fr.name)
    N = vk.size
    rng = random.Random(7)
    dom = get_domain(ff, N, "cpu")
    dom4 = get_domain(ff, 4 * N, "cpu")

    def col(n):
        return pdev.enc(ff, [rng.randrange(Q) for _ in range(n)], "cpu")

    z = col(N + 3)
    cols = dict(l=col(N + 2), r=col(N + 2), o=col(N + 2), z=z,
                zs=pdev.ff_scale_powers(ff, z, vk.generator),
                ql=pk.ql_coeffs, qr=pk.qr_coeffs, qm=pk.qm_coeffs,
                qo=pk.qo_coeffs, s1=pk.s1_coeffs, s2=pk.s2_coeffs,
                s3=pk.s3_coeffs)
    scal = {k: rng.randrange(Q) for k in ("beta", "gamma", "alpha", "u")}
    scal.update(alpha2=scal["alpha"] ** 2 % Q, u2=scal["u"] ** 2 % Q,
                Ninv=pow(N, -1, Q))
    qkc = col(N)
    coset = pdev._s3_quotient(ff, dom4, cols, qkc, [], [], scal, 4)
    rho = pdev._rho_quotient(ff, dom, dom4, cols, qkc, pk, [], 4, N, scal)
    assert coset.shape == (4 * N, ff.nw)
    assert torch.equal(rho, coset)


def _limbs(ff, w):
    return ff.from_words(w).numpy()


def key_arrays_of_port(pk, vk):
    """The port's keys as the plain data keys_from_arrays takes."""
    ff = get_ff(CURVE.fr.name)
    ffp = get_ff(CURVE.fp.name)
    x, y, inf = pk.srs.g1_powers
    d = {k: _limbs(ff, getattr(pk, k)) for k in
         ("ql", "qr", "qm", "qo", "qk", "s1_vals", "s2_vals", "s3_vals")
         + tuple(f"{k}_coeffs" for k in ("ql", "qr", "qm", "qo", "qk",
                                         "s1", "s2", "s3"))}
    d["perm"] = [int(v) for v in pk.perm]
    d["qcp_coeffs"] = [_limbs(ff, c) for c in pk.qcp_coeffs]
    d["srs"] = dict(g1_powers=(_limbs(ffp, x), _limbs(ffp, y),
                               inf.numpy()),
                    g2_gen=pk.srs.g2_gen, g2_tau=pk.srs.g2_tau)
    d["vk"] = {f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
               if f.name != "curve"}
    return d


def test_keys_from_arrays_round_trip(cubic):
    cs, pk, vk, pub, sec, proof = cubic
    pk2, vk2 = plonk.keys_from_arrays(key_arrays_of_port(pk, vk),
                                      device="cpu")
    assert vk2 == vk
    for f in dataclasses.fields(pk):
        a, b = getattr(pk, f.name), getattr(pk2, f.name)
        if f.name == "srs":
            for u, v in zip(a.g1_powers, b.g1_powers):
                assert torch.equal(u, v)
            assert (a.g2_gen, a.g2_tau) == (b.g2_gen, b.g2_tau)
        elif f.name == "vk":
            continue
        elif f.name == "perm":
            assert np.array_equal(a, b)
        elif f.name == "qcp_coeffs":
            assert len(a) == len(b) and all(map(torch.equal, a, b))
        else:
            assert torch.equal(a, b), f.name


# ---------------------------------------------------------------------------
# slow tier: the reference's keys and proofs
# ---------------------------------------------------------------------------

def key_arrays_of_ref(pk, vk):
    """The reference's SRS and PLONK keys as plain data."""
    ff = ref_get_ff(CURVE.fr.name)
    d = {k: np.asarray(ff.encode(getattr(pk, k))) for k in
         ("ql", "qr", "qm", "qo", "qk", "s1_vals", "s2_vals", "s3_vals")
         + tuple(f"{k}_coeffs" for k in ("ql", "qr", "qm", "qo", "qk",
                                         "s1", "s2", "s3"))}
    d["perm"] = list(pk.perm)
    d["qcp_coeffs"] = [np.asarray(ff.encode(c)) for c in pk.qcp_coeffs]
    d["srs"] = dict(g1_powers=tuple(np.asarray(a)
                                    for a in pk.srs.g1_powers),
                    g2_gen=pk.srs.g2_gen, g2_tau=pk.srs.g2_tau)
    d["vk"] = {f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
               if f.name != "curve"}
    return d


SLOW_CASES = {"cubic": (dict(x=3, y=35), 64, None),
              "cubic_rho": (dict(x=3, y=35), 64, 1),
              "two_commits": (dict(a=3, b=4, s=7), 64, None)}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_proof_equals_reference(case, monkeypatch):
    """Reference SRS and setup -> the port's prove on the carried keys
    gives the reference's proof; the port's own SRS and setup from the
    same seed give the reference's vk."""
    from gnark_tpu.backend import kzg as ref_kzg
    name = case.split("_rho")[0]
    assign, srs_n, rho = SLOW_CASES[case]
    if rho:        # the reference reads it at each prove
        monkeypatch.setenv("GNARK_TPU_PLONK_RHO_LOG", str(rho))
        monkeypatch.setattr(pdev, "RHO_MIN_LOG", rho)
    port, ref = CIRCUITS[name]
    rcs = ref_compile(ref(), ref_fields.BN254_FR, builder_cls=RefSCSBuilder)
    rsrs = ref_kzg.setup_srs("bn254", srs_n, rng=random.Random(33))
    rpk, rvk = ref_plonk.setup(rcs, rsrs)
    pub, sec = ref_witness(ref(**assign), rcs)
    want = ref_plonk.prove(rcs, rpk, pub, sec, rng=random.Random(1))
    cs = compile_circuit(port(), fields.BN254_FR, builder_cls=SCSBuilder)
    pk, vk = plonk.keys_from_arrays(key_arrays_of_ref(rpk, rvk),
                                    device="cpu")
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(1), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ref_plonk.verify(ref_proof(got), rvk, pub)
    srs = kzg.setup_srs("bn254", srs_n, rng=random.Random(33), device="cpu")
    _, vk2 = plonk.setup(cs, srs)
    assert dataclasses.asdict(ref_vk(vk2)) == dataclasses.asdict(rvk)


@pytest.mark.slow
@pytest.mark.parametrize("mode", [True, "self"])
def test_groth16_recursion_hashes_equal_reference(mode):
    """Groth16 with one BSB22 commitment under the MiMC commitment
    hashes: the port's proof on the reference's keys equals the
    reference's, and both verify it."""
    from gnark_tpu.backend import groth16 as ref_groth16
    from gnark_tpu_torch.backend import groth16
    from tests.test_torch_bsb22 import (CommitCircuit, RefCommitCircuit,
                                        _ref_key_arrays)
    rcs = ref_compile(RefCommitCircuit(), ref_fields.BN254_FR)
    rpk, rvk = ref_groth16.setup(rcs, "bn254", rng=random.Random(5))
    pub, sec = ref_witness(RefCommitCircuit(x=6, y=36), rcs)
    want = ref_groth16.prove(rcs, rpk, pub, sec, rng=random.Random(2),
                             recursion_friendly=mode)
    cs = compile_circuit(CommitCircuit(), fields.BN254_FR)
    pk = groth16.proving_key_from_arrays(_ref_key_arrays(rpk), device="cpu")
    got = groth16.prove(cs, pk, pub, sec, rng=random.Random(2),
                        recursion_friendly=mode, device="cpu")
    assert (got.ar, got.krs, got.bs, got.commitments, got.poks) == \
        (want.ar, want.krs, want.bs, want.commitments, want.poks)
    assert ref_groth16.verify(want, rvk, pub, recursion_friendly=mode)
    _, vk = groth16.setup(cs, "bn254", rng=random.Random(5), device="cpu")
    assert groth16.verify(got, vk, pub, recursion_friendly=mode)
    assert not groth16.verify(got, vk, pub)
