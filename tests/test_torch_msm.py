"""gnark_tpu_torch.msm against the reference and the host oracle:
signed and window digits bit-exact against the reference; the bucket
MSM (kernel K4 and the K3 epilogue, in their plain versions) against
host.ec_msm with infinity inputs, zero scalars and duplicate points, as
tests/test_msm.py pins them (G2, chunking and the reference msm:
test_torch_msm_more.py). Results are compared as affine points
(exact)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.msm import window_digits as ref_window_digits
from gnark_tpu.msm.bucket_kernel import signed_digits as ref_signed_digits
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.weierstrass import jac_to_affine, to_limbs
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm import msm, window_digits
from gnark_tpu_torch.msm.bucket import (SEG, group_b3, group_pairs,
                                        signed_digits)
from gnark_tpu_torch.msm.pippenger import scalar_limbs

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


def test_digits_match_reference():
    ffr, rffr = get_ff(CURVE.fr.name), ref_get_ff(CURVE.fr.name)
    rng = random.Random(21)
    ks = [rng.randrange(R) for _ in range(40)] + [0, 1, R - 1, (1 << 253)]
    limbs = ffr.encode(ks, mont=False)
    for c in (4, 8, 13):
        got = window_digits(torch.as_tensor(limbs), CURVE.fr.bits, c)
        want = ref_window_digits(jnp.asarray(limbs), CURVE.fr.bits, c)
        assert np.array_equal(got.numpy(), np.asarray(want))
        got = signed_digits(torch.as_tensor(limbs), CURVE.fr.bits, c)
        want = ref_signed_digits(jnp.asarray(limbs), CURVE.fr.bits, c)
        assert np.array_equal(got.numpy(), np.asarray(want))
    words = torch.as_tensor(ffr.encode_words(ks, mont=False))
    assert np.array_equal(scalar_limbs(words).numpy(), limbs)


def test_group_pairs_segments():
    rng = random.Random(22)
    n = 300
    digits = torch.as_tensor(
        [[rng.randrange(-128, 129) for _ in range(n)] for _ in range(32)],
        dtype=torch.int32)
    digits[3, :100] = 1                      # one skewed bucket
    inf = torch.zeros(n, dtype=torch.bool)
    inf[7] = True
    ent, start, length, off = group_pairs(digits, inf)
    valid = (digits != 0) & ~inf[None, :]
    assert ent.numel() == int(valid.sum()) == int(length.sum())
    assert int(length.max()) <= SEG and int(length.min()) >= 1
    assert off.numel() == 32 * 128 + 1 and int(off[-1]) == start.numel()
    # every pair lands in its (window, |digit|) bucket with its sign
    for b in (3 * 128 + 0, 5 * 128 + 17):
        w, j = divmod(b, 128)
        got = []
        for s in range(int(off[b]), int(off[b + 1])):
            got += ent[int(start[s]):int(start[s]) + int(length[s])].tolist()
        want = [2 * i + int(digits[w, i] < 0) for i in range(n)
                if abs(int(digits[w, i])) == j + 1 and not bool(inf[i])]
        assert sorted(got) == sorted(want)


@pytest.mark.parametrize("n", [1, 7, 64, 200])
def test_msm_g1_matches_host(n):
    pts, ks = _g1_case(n, 23 + n)
    points, sc = _g1_inputs(pts, ks)
    ffp = get_ff(CURVE.fp.name)
    got = _affine(ffp, msm(ffp, points, sc, CURVE.fr.bits, device="cpu",
                           b3=group_b3(CURVE)))
    assert got == host.ec_msm(CURVE.host_fp, pts, ks)
