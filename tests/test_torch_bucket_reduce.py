"""The bucket MSM's epilogue (bucket_reduce, kernel K9, in its plain
version) and the bucket path at window widths other than 8, on the CPU.

bucket_reduce_plain is held against the reference's host oracle
(gnark_tpu/ec/host.py) on the same bucket sums, in G1 and G2 at
c in {4, 8, 11}; msm on the bucket path at c in {8, 11, 13}
(GNARK_TPU_MSM_C; 64-bit scalars at 13) against it too, with infinity
points, zero scalars and duplicate points (the cases tests/test_msm.py
pins); in the slow tier the
port at c = 11 against the reference's msm at its default (it compiles
for ~30 s). Inputs come from numpy seeds. Tolerance: exact, as affine
group elements."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ec import host as ref_host
from gnark_tpu.ec.weierstrass import jac_to_affine as ref_jac_to_affine
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.msm import msm as ref_msm
from gnark_tpu_torch.backend.groth16 import _to_affine_host
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm import msm
from gnark_tpu_torch.msm.bucket import (bucket_reduce, digit_count, group_b3,
                                        reduce_geometry, window_bits)

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
R = CURVE.fr.modulus


def _group(g2):
    if g2:
        return (get_ff2(CURVE.fp.name, CURVE.fp2_nr), CURVE.host_g2_field,
                CURVE.g2)
    return get_ff(CURVE.fp.name), CURVE.host_fp, CURVE.g1


def _b3(g2):
    return group_b3(CURVE, g2)


def _big(rng, q):
    """A random integer in [1, q) from the numpy generator."""
    return int.from_bytes(rng.bytes(40), "little") % (q - 1) + 1


def _rand(rng, g2):
    q = CURVE.fp.modulus
    v = [_big(rng, q) for _ in range(2 if g2 else 1)]
    return tuple(v) if g2 else v[0]


def _bucket_words(ff, hf, pts, rng, g2):
    """Host affine points (host.INF for an empty bucket) -> projective
    (x z, y z, z) words with a random z; the identity is (0, 1, 0)."""
    zero, one = ((0, 0), (1, 0)) if g2 else (0, 1)
    X, Y, Z = [], [], []
    for P in pts:
        if P is host.INF:
            X.append(zero)
            Y.append(one)
            Z.append(zero)
            continue
        z = _rand(rng, g2)
        X.append(hf.mul(P[0], z))
        Y.append(hf.mul(P[1], z))
        Z.append(z)
    n = len(pts)
    return tuple(torch.as_tensor(ff.encode_words(v)).reshape(n, -1)
                 for v in (X, Y, Z))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("c,W,filled", [(4, 5, 40), (8, 4, 30),
                                        (11, 3, 25)])
def test_bucket_reduce_plain_matches_host(g2, c, W, filled):
    """sum_w 2^(c w) sum_j (j+1) P_{w,j} on buckets with empty ones,
    equal neighbours (the doubling case of the running sums) and points
    in several windows."""
    ff, hf, gen = _group(g2)
    rng = np.random.default_rng(100 * c + g2)
    B = 1 << (c - 1)
    pool = [host.ec_mul(hf, gen, int(k))
            for k in rng.integers(1, 1 << 40, size=6)]
    pts = [host.INF] * (W * B)
    rows = rng.choice(W * B, size=filled, replace=False)
    for i, r in enumerate(rows):
        pts[r] = pool[int(rng.integers(len(pool)))]
        if i % 5 == 0 and r + 1 < W * B:
            pts[r + 1] = pts[r]
    P = _bucket_words(ff, hf, pts, rng, g2)
    got = _to_affine_host(ff, hf, "proj", bucket_reduce(ff, _b3(g2), P, W, c))
    live = [(i, p) for i, p in enumerate(pts) if p is not host.INF]
    want = ref_host.ec_msm(hf, [p for _, p in live],
                           [(i % B + 1) << (c * (i // B)) for i, _ in live])
    assert got == want


def test_bucket_reduce_all_empty():
    ff, hf, _ = _group(False)
    c, W = 6, 3
    P = _bucket_words(ff, hf, [host.INF] * (W << (c - 1)),
                      np.random.default_rng(0), False)
    got = bucket_reduce(ff, _b3(False), P, W, c)
    assert _to_affine_host(ff, hf, "proj", got) == host.INF


def test_reduce_geometry_and_window_bits(monkeypatch):
    for c in range(2, 17):
        L, T, nblk = reduce_geometry(c)
        assert L * T * nblk == 1 << (c - 1)
        assert 1 <= T <= 128 and T & (T - 1) == 0 and L <= 32
    monkeypatch.delenv("GNARK_TPU_MSM_C", raising=False)
    assert window_bits(1 << 20, "cpu") == 8
    assert 2 <= window_bits(1 << 20, "cuda") <= 16
    monkeypatch.setenv("GNARK_TPU_MSM_C", "11")
    assert window_bits(5, "cpu") == window_bits(5, "cuda") == 11
    monkeypatch.setenv("GNARK_TPU_MSM_C", "17")
    with pytest.raises(ValueError):
        window_bits(5, "cpu")
    assert [digit_count(254, c) for c in (8, 11, 13, 16)] == [32, 24, 20, 16]


def _g1_case(n, seed, nbits=CURVE.fr.bits):
    rng = np.random.default_rng(seed)
    fh = CURVE.host_fp
    pts = [host.ec_mul(fh, CURVE.g1, int(k))
           for k in rng.integers(1, 1 << 16, size=n)]
    ks = [_big(rng, R) % (1 << nbits) for _ in range(n)]
    pts[1] = host.INF         # infinity input point
    ks[2] = 0                 # zero scalar
    pts[4] = pts[5]           # duplicate points (bucket doubling path)
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


def _msm_host(points, sc, c, monkeypatch, nbits=CURVE.fr.bits):
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", "bucket")
    monkeypatch.setenv("GNARK_TPU_MSM_C", str(c))
    ffp = get_ff(CURVE.fp.name)
    P = msm(ffp, points, sc, nbits, device="cpu", b3=_b3(False))
    return _to_affine_host(ffp, CURVE.host_fp, "jac",
                           tuple(a[None] for a in P))


@pytest.mark.parametrize("c,n,nbits", [
    pytest.param(8, 48, 254, id="8-48"), pytest.param(11, 32, 254, id="11-32"),
    # 64-bit scalars (as rc_20's range-checked values): 6 windows, not 20,
    # since the plain epilogue's cost is W * 2^(c-1) whatever n is
    pytest.param(13, 20, 64, id="13-20")])
def test_msm_bucket_width_matches_host(c, n, nbits, monkeypatch):
    pts, ks = _g1_case(n, c, nbits)
    points, sc = _g1_inputs(pts, ks)
    assert _msm_host(points, sc, c, monkeypatch, nbits) == \
        ref_host.ec_msm(CURVE.host_fp, pts, ks)


@pytest.mark.slow
def test_msm_width_matches_reference(monkeypatch):
    """The port at c = 11 equals the reference's msm at its default."""
    n = 16
    pts, ks = _g1_case(n, 5)
    points, sc = _g1_inputs(pts, ks)
    got = _msm_host(points, sc, 11, monkeypatch)
    rffp, rffr = ref_get_ff(CURVE.fp.name), ref_get_ff(CURVE.fr.name)
    ffp = get_ff(CURVE.fp.name)
    rpts = tuple(jnp.asarray(ffp.from_words(a).numpy().astype(np.uint32))
                 for a in points[:2]) + (jnp.asarray(points[2].numpy()),)
    rx, ry, rinf = ref_jac_to_affine(rffp, ref_msm(
        rffp, rpts, jnp.asarray(rffr.encode(ks, mont=False)),
        CURVE.fr.bits))
    want = host.INF if bool(rinf) else (int(rffp.decode(np.asarray(rx))),
                                        int(rffp.decode(np.asarray(ry))))
    assert got == want
