"""gnark_tpu_torch.msm, continued: G2 over Fp2 and the chunked MSM
against host.ec_msm, and G1 against the reference msm at n = 64 (slow:
the reference compiles its scan kernel). Results are compared as affine
points (exact)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.msm import msm as ref_msm
from gnark_tpu.ec.weierstrass import jac_to_affine as ref_jac_to_affine
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.weierstrass import jac_to_affine, to_limbs
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm import msm
from gnark_tpu_torch.msm.bucket import group_b3, msm_bucket_chunked

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
R = CURVE.fr.modulus


def _g1_case(n, seed):
    rng = random.Random(seed)
    fh = CURVE.host_fp
    pts = [host.ec_mul(fh, CURVE.g1, rng.randrange(1, 1 << 16))
           for _ in range(n)]
    ks = [rng.randrange(0, R) for _ in range(n)]
    if n > 2:
        pts[1] = host.INF     # infinity input point
        ks[2] = 0             # zero scalar
    if n > 5:
        pts[4] = pts[5]       # duplicate points (bucket doubling path)
        ks[4] = ks[5]
    return pts, ks


def _g1_inputs(pts, ks):
    ffp, ffr = get_ff(CURVE.fp.name), get_ff(CURVE.fr.name)
    x = torch.as_tensor(ffp.encode_words(
        [0 if p is host.INF else p[0] for p in pts]))
    y = torch.as_tensor(ffp.encode_words(
        [0 if p is host.INF else p[1] for p in pts]))
    inf = torch.as_tensor([p is host.INF for p in pts])
    return (x, y, inf), torch.as_tensor(ffr.encode_words(ks, mont=False))


def _affine(ff, P):
    x, y, inf = jac_to_affine(ff, to_limbs(ff, tuple(a[None] for a in P)))
    if bool(inf[0]):
        return host.INF
    xs, ys = ff.decode(x[0]), ff.decode(y[0])
    if np.ndim(xs):
        return (tuple(int(c) for c in xs), tuple(int(c) for c in ys))
    return (int(xs), int(ys))


@pytest.mark.slow
def test_msm_g1_matches_reference():
    n = 64
    pts, ks = _g1_case(n, 31)
    points, sc = _g1_inputs(pts, ks)
    ffp = get_ff(CURVE.fp.name)
    got = _affine(ffp, msm(ffp, points, sc, CURVE.fr.bits, device="cpu",
                           b3=group_b3(CURVE)))
    rffp, rffr = ref_get_ff(CURVE.fp.name), ref_get_ff(CURVE.fr.name)
    rpts = tuple(jnp.asarray(ffp.from_words(a).numpy().astype(np.uint32))
                 for a in points[:2]) + (jnp.asarray(points[2].numpy()),)
    rx, ry, rinf = ref_jac_to_affine(rffp, ref_msm(
        rffp, rpts, jnp.asarray(rffr.encode(ks, mont=False)),
        CURVE.fr.bits))
    want = host.INF if bool(rinf) else (int(rffp.decode(np.asarray(rx))),
                                        int(rffp.decode(np.asarray(ry))))
    assert got == want


def test_msm_g2_matches_host():
    ff2 = get_ff2(CURVE.fp.name, CURVE.fp2_nr)
    f2h = CURVE.host_g2_field
    rng = random.Random(41)
    n = 17
    pts = [host.ec_mul(f2h, CURVE.g2, rng.randrange(1, 1 << 16))
           for _ in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    ks[3] = 0
    x = torch.as_tensor(ff2.encode_words([p[0] for p in pts]))
    y = torch.as_tensor(ff2.encode_words([p[1] for p in pts]))
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False))
    got = _affine(ff2, msm(ff2, (x, y, torch.zeros(n, dtype=torch.bool)),
                           sc, CURVE.fr.bits, device="cpu",
                           b3=group_b3(CURVE, g2=True)))
    assert got == host.ec_msm(f2h, pts, ks)


def test_msm_chunked_matches_host():
    pts, ks = _g1_case(12, 51)
    points, sc = _g1_inputs(pts, ks)
    ffp = get_ff(CURVE.fp.name)
    chunked = _affine(ffp, msm_bucket_chunked(ffp, points, sc,
                                              CURVE.fr.bits, chunk=7,
                                              b3=group_b3(CURVE)))
    assert chunked == host.ec_msm(CURVE.host_fp, pts, ks)
