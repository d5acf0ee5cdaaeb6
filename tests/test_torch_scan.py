"""gnark_tpu_torch's scan-path MSM and the plain K8 (weierstrass.jac_add),
on the CPU:
  * the scan path (plain versions of K6, K8, K7) equals host.ec_msm on the
    reference's MSM edge cases (tests/test_msm.py: an infinity input, a
    zero scalar, duplicate points with equal scalars, which reach the
    doubling branch of the mixed add), for G1 here and, in the slow
    tier, for G2 and against the bucket path and the reference's scan
    path;
  * GNARK_TPU_MSM_IMPL routes as documented;
  * the plain K8 equals the reference's gnark_tpu.ec.weierstrass.jac_add
    on K8's edge cases (P == Q with another Z, P == -Q, either or both
    at infinity);
  * the group fold's plain twin (jac_fold_plain, left to right) equals
    the halving tree of plain K8 adds that it replaced and the host's
    sums, in G1 and G2, on columns of equal points (the doubling
    branch), of P and -P, and all at infinity.
Tolerance: exact (affine host ints; canonical Montgomery limbs)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ec import weierstrass as ref_weierstrass
from gnark_tpu.ec.weierstrass import jac_to_affine as ref_jac_to_affine
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.msm import msm as ref_msm
from gnark_tpu_torch.backend.groth16 import _to_affine_host
from gnark_tpu_torch.ec import curves, host, weierstrass
from gnark_tpu_torch.ec.jac_ec import jac_add_plain, jac_fold, jac_fold_plain
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm import pippenger
from gnark_tpu_torch.msm.bucket import group_b3
from gnark_tpu_torch.msm.pippenger import msm_raw

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
R = CURVE.fr.modulus


def _group(g2):
    if g2:
        return (get_ff2(CURVE.fp.name, CURVE.fp2_nr), CURVE.host_g2_field,
                CURVE.g2)
    return get_ff(CURVE.fp.name), CURVE.host_fp, CURVE.g1


def _case(g2, n, seed):
    """The reference's edge cases (tests/test_msm.py:23-45)."""
    _, hf, gen = _group(g2)
    rng = random.Random(seed)
    pts = [host.ec_mul(hf, gen, rng.randrange(1, 1 << 16)) for _ in range(n)]
    ks = [rng.randrange(0, R) for _ in range(n)]
    if n > 2:
        pts[1] = host.INF     # infinity input point
        ks[2] = 0             # zero scalar
    if n > 5:
        pts[4] = pts[5]       # duplicate points (mixed-add doubling path)
        ks[4] = ks[5]
    return pts, ks


def _inputs(ff, pts, ks):
    zero = (0, 0) if hasattr(ff, "base") else 0
    x, y = (torch.as_tensor(ff.encode_words(
        [zero if p is host.INF else p[i] for p in pts])) for i in (0, 1))
    inf = torch.as_tensor([p is host.INF for p in pts])
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False))
    return (x, y, inf), sc


def _msm(g2, pts, ks, impl, monkeypatch, c=None, groups=None):
    ff, hf, _ = _group(g2)
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", impl)
    points, sc = _inputs(ff, pts, ks)
    kind, P = msm_raw(ff, points, sc, CURVE.fr.bits, c, groups,
                      b3=group_b3(CURVE, g2))
    assert kind == ("jac" if impl == "scan" else "proj")
    return _to_affine_host(ff, hf, kind, P)


@pytest.mark.parametrize("n,c,g", [
    (40, None, None),
    pytest.param(7, 4, 2, marks=pytest.mark.slow),
    pytest.param(3, 8, 1, marks=pytest.mark.slow)])
def test_scan_g1_matches_host(n, c, g, monkeypatch):
    pts, ks = _case(False, n, n)
    if n == 3:
        ks = [0, 0, 0]                            # the sum is infinity
    assert _msm(False, pts, ks, "scan", monkeypatch, c, g) == \
        host.ec_msm(CURVE.host_fp, pts, ks)


def test_routing(monkeypatch):
    """bucket and auto take the bucket path (on the CPU too), scan the
    scan path, anything else raises; a group given no b3 (no a = 0
    curve) takes the scan path."""
    calls = []
    monkeypatch.setattr(pippenger, "_msm_scan",
                        lambda *a: calls.append("scan") or "S")
    import gnark_tpu_torch.msm.bucket as bucket
    monkeypatch.setattr(bucket, "msm_proj",
                        lambda *a, **k: calls.append("bucket") or "B")
    ff, _, _ = _group(False)
    b3 = group_b3(CURVE)
    points, sc = _inputs(ff, *_case(False, 3, 2))
    for impl, want in (("auto", "proj"), ("bucket", "proj"),
                       ("scan", "jac")):
        monkeypatch.setenv("GNARK_TPU_MSM_IMPL", impl)
        assert msm_raw(ff, points, sc, CURVE.fr.bits, b3=b3)[0] == want
    monkeypatch.delenv("GNARK_TPU_MSM_IMPL")
    assert msm_raw(ff, points, sc, CURVE.fr.bits, b3=b3)[0] == "proj"
    assert msm_raw(ff, points, sc, CURVE.fr.bits, b3=None)[0] == "jac"
    assert calls == ["bucket", "bucket", "scan", "bucket", "scan"]
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", "pallas")
    with pytest.raises(ValueError):
        msm_raw(ff, points, sc, CURVE.fr.bits, b3=b3)


def test_pick_params_matches_reference():
    from gnark_tpu.msm.pippenger import _pick_params as ref_pick
    for k in range(6, 23):
        assert pippenger._pick_params(1 << k, 254) == ref_pick(1 << k, 254)


def _jac_coords(ff, hf, pts, rng):
    """Host affine points -> Jacobian coordinates (X, Y, Z lists) with a
    random Z; infinity (1, 1, 0)."""
    g2 = hasattr(ff, "base")
    q = CURVE.fp.modulus
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    cols = ([], [], [])
    for P in pts:
        if P is host.INF:
            vals = (one, one, zero)
        else:
            z = (rng.randrange(1, q), rng.randrange(q)) if g2 else \
                rng.randrange(1, q)
            z2 = hf.mul(z, z)
            vals = (hf.mul(P[0], z2), hf.mul(P[1], hf.mul(z2, z)), z)
        for c, v in zip(cols, vals):
            c.append(v)
    return cols


def _k8_case(g2):
    """K8's edge cases: P + inf, inf + Q, inf + inf, P + P (another Z),
    P + (-P), and two ordinary pairs; Jacobian coordinates with random
    Z."""
    ff, hf, gen = _group(g2)
    rng = random.Random(5)
    base = [host.ec_mul(hf, gen, k) for k in (1, 2, 3, 5, 7)]
    P = [base[0], host.INF, host.INF, base[1], base[2], base[3], base[4]]
    Q = [host.INF, base[2], host.INF, base[1], host.ec_neg(hf, base[2]),
         base[0], base[4]]
    return P, Q, _jac_coords(ff, hf, P, rng), _jac_coords(ff, hf, Q, rng)


def _plain_k8(g2):
    ff, hf, _ = _group(g2)
    P, Q, A, B = _k8_case(g2)
    got = weierstrass.jac_add(
        ff, tuple(torch.as_tensor(ff.encode(a)) for a in A),
        tuple(torch.as_tensor(ff.encode(b)) for b in B))
    return got, P, Q, A, B


@pytest.mark.parametrize("g2", [False, True])
def test_jac_add_plain_matches_host(g2):
    ff, hf, _ = _group(g2)
    got, P, Q, _, _ = _plain_k8(g2)
    for i in range(len(P)):
        got_i = _to_affine_host(ff, hf, "jac", tuple(
            ff.to_words(a[i:i + 1]) for a in got))
        assert got_i == host.ec_add(hf, P[i], Q[i])


@pytest.mark.slow
@pytest.mark.parametrize("g2", [False, True])
def test_jac_add_plain_matches_reference(g2):
    """Slow tier: the reference's jnp formula runs eagerly (~25 s for G1
    and ~80 s for G2 on a CPU)."""
    if g2:
        from gnark_tpu.ec.fp2 import get_ff2 as ref_get_ff2
        rff = ref_get_ff2(CURVE.fp.name, CURVE.fp2_nr)
    else:
        rff = ref_get_ff(CURVE.fp.name)
    got, _, _, A, B = _plain_k8(g2)
    want = ref_weierstrass.jac_add(
        rff, tuple(jnp.asarray(rff.encode(a)) for a in A),
        tuple(jnp.asarray(rff.encode(b)) for b in B))
    for u, v in zip(got, want):
        assert np.array_equal(u.numpy(), np.asarray(v).astype(np.int64))


@pytest.mark.slow
def test_scan_g2_matches_host_and_bucket(monkeypatch):
    pts, ks = _case(True, 17, 3)
    want = host.ec_msm(CURVE.host_g2_field, pts, ks)
    assert _msm(True, pts, ks, "scan", monkeypatch, 6, 4) == want
    assert _msm(True, pts, ks, "scan", monkeypatch) == want
    assert _msm(True, pts, ks, "bucket", monkeypatch) == want


@pytest.mark.slow
@pytest.mark.parametrize("n,c,g", [(1, None, None), (64, 8, 4),
                                   (200, 8, 8)])
def test_scan_g1_matches_bucket_and_reference(n, c, g, monkeypatch):
    """Slow tier: the reference compiles its scan kernel."""
    pts, ks = _case(False, n, 100 + n)
    got = _msm(False, pts, ks, "scan", monkeypatch, c, g)
    assert got == _msm(False, pts, ks, "bucket", monkeypatch)
    assert got == host.ec_msm(CURVE.host_fp, pts, ks)
    rff, rfr = ref_get_ff(CURVE.fp.name), ref_get_ff(CURVE.fr.name)
    zero = [0 if p is host.INF else p for p in pts]
    x = jnp.asarray(rff.encode([0 if p == 0 else p[0] for p in zero]))
    y = jnp.asarray(rff.encode([0 if p == 0 else p[1] for p in zero]))
    inf = jnp.asarray(np.array([p is host.INF for p in pts]))
    monkeypatch.setenv("GNARK_TPU_MSM_IMPL", "scan")
    Rj = ref_msm(rff, (x, y, inf), jnp.asarray(rfr.encode(ks, mont=False)),
                 CURVE.fr.bits, c=c, groups=g)
    rx, ry, rinf = ref_jac_to_affine(rff, Rj)
    ref = host.INF if bool(rinf) else (int(rff.decode(np.asarray(rx))),
                                       int(rff.decode(np.asarray(ry))))
    assert got == ref


@pytest.mark.parametrize("g2", [False, True])
def test_jac_fold_plain_matches_tree_and_host(g2):
    """W = 2 windows, G = 4 groups, B = 8 buckets, group-major rows
    (w*G + g)*B + b as _msm_scan holds them."""
    ff, hf, gen = _group(g2)
    W, G, B = 2, 4, 8
    rng = random.Random(21 + g2)
    base = [host.ec_mul(hf, gen, k) for k in range(1, 9)]
    pts = [base[rng.randrange(8)] for _ in range(W * G * B)]

    def row(w, g, b):
        return (w * G + g) * B + b

    for g in range(G):
        pts[row(0, g, 1)] = base[2]                 # equal: doubling
        pts[row(1, g, 3)] = host.INF                # all at infinity
    pts[row(0, 0, 2)], pts[row(0, 1, 2)] = base[5], host.ec_neg(hf, base[5])
    pts[row(0, 2, 2)] = pts[row(0, 3, 2)] = host.INF    # P + (-P) + inf
    pts[row(1, 2, 0)] = host.INF
    P = tuple(torch.as_tensor(ff.encode_words(c)).reshape(W * G * B, -1)
              for c in _jac_coords(ff, hf, pts, rng))
    got = jac_fold(ff, P, G, B)                     # CPU: the plain twin
    assert all(torch.equal(u, v)
               for u, v in zip(got, jac_fold_plain(ff, P, G, B)))
    Lw = P[0].shape[1]
    T = tuple(a.reshape(W, G, B, Lw) for a in P)
    g = G
    while g > 1:                                    # the halving tree
        h = g // 2
        R = jac_add_plain(ff, tuple(a[:, :h].reshape(-1, Lw) for a in T),
                          tuple(a[:, h:g].reshape(-1, Lw) for a in T))
        T = tuple(a.reshape(W, h, B, Lw) for a in R)
        g = h
    for w in range(W):
        for b in range(B):
            i = w * B + b
            want = host.INF
            for gg in range(G):
                want = host.ec_add(hf, want, pts[row(w, gg, b)])
            assert _to_affine_host(ff, hf, "jac", tuple(
                a[i:i + 1] for a in got)) == want == _to_affine_host(
                ff, hf, "jac", tuple(a[w, 0, b][None] for a in T))
    assert _to_affine_host(ff, hf, "jac", tuple(
        a[2:3] for a in got)) is host.INF
