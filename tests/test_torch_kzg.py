"""gnark_tpu_torch's KZG (backend/kzg.py) on the CPU, at a fixed tau:
  * the SRS points equal the reference's host scalar multiplications of
    the powers of tau (gnark_tpu/ec/host.py), G2's tau point too;
  * an opening and a batch opening made by the port are accepted by the
    reference's host verify_opening / batch_verify_single_point, and
    refused with a tampered claimed value;
  * commit of a zero polynomial is the point at infinity.
Tolerance: exact equality (host affine points)."""

import random

import pytest
import torch

from gnark_tpu.backend import kzg as ref_kzg
from gnark_tpu.ec import curves as ref_curves
from gnark_tpu.ec import host as ref_host
from gnark_tpu_torch.backend import kzg
from gnark_tpu_torch.backend.groth16 import _host_points
from gnark_tpu_torch.ec import curves
from gnark_tpu_torch.ff import get_ff

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
REF = ref_curves.CURVES["bn254"]
Q = CURVE.fr.modulus
TAU = 0x1234567890ABCDEF1234567890ABCDEF
SIZE = 8


@pytest.fixture(scope="module")
def srs():
    return kzg.setup_srs("bn254", SIZE, tau=TAU, device="cpu")


def _ref_srs(srs):
    return ref_kzg.SRS(curve=REF, g1_powers=None, g1_host=None,
                       g2_gen=srs.g2_gen, g2_tau=srs.g2_tau)


def test_srs_equals_host_powers(srs):
    want = [ref_host.ec_mul(REF.host_fp, REF.g1, pow(TAU, i, Q))
            for i in range(SIZE)]
    assert _host_points(get_ff(CURVE.fp.name), *srs.g1_powers) == want
    assert srs.g2_tau == ref_host.ec_mul(REF.host_g2_field, REF.g2, TAU)
    assert srs.g2_gen == REF.g2
    assert srs.g1_powers[0].shape == (SIZE, 8)
    assert not srs.g1_powers[2].any()


def test_openings_accepted_by_reference(srs):
    rng = random.Random(3)
    polys = [[rng.randrange(Q) for _ in range(n)] for n in (SIZE, 5, 1)]
    z, ch = rng.randrange(Q), rng.randrange(Q)
    comms = [kzg.commit(srs, p) for p in polys]
    rsrs = _ref_srs(srs)
    op = kzg.open_at(srs, polys[0], z)
    assert op.claimed_value == ref_kzg._poly_eval(polys[0], z, Q)
    assert ref_kzg.verify_opening(
        rsrs, comms[0], ref_kzg.OpeningProof(op.h, op.claimed_value), z)
    assert kzg.verify_opening(srs, comms[0], op, z)
    assert not ref_kzg.verify_opening(
        rsrs, comms[0], ref_kzg.OpeningProof(op.h, op.claimed_value + 1), z)
    bop = kzg.batch_open_single_point(srs, polys, z, ch)
    assert ref_kzg.batch_verify_single_point(
        rsrs, comms, ref_kzg.BatchOpeningProof(bop.h, bop.claimed_values),
        z, ch)
    assert kzg.batch_verify_single_point(srs, comms, bop, z, ch)
    bad = list(bop.claimed_values)
    bad[1] = (bad[1] + 1) % Q
    assert not ref_kzg.batch_verify_single_point(
        rsrs, comms, ref_kzg.BatchOpeningProof(bop.h, bad), z, ch)
    assert kzg.commit(srs, [0, 0, 0]) is ref_host.INF
