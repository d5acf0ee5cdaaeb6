"""gnark_tpu_torch.ec against the reference: plain Fp2 against FF2,
the plain version of kernel K3 against the reference formulas
(_proj_add_t / _proj_dbl_t + canon, run as plain JAX on (L, T) limb
arrays) bit for bit, and against the host oracle in affine form, for G1
and G2; the plain Jacobian helpers against the host. Tolerance: exact
equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ec.fp2 import get_ff2 as ref_get_ff2
from gnark_tpu.ec.pallas_ec import _proj_add_t, _proj_dbl_t
from gnark_tpu.fields import FIELDS as REF_FIELDS
from gnark_tpu.ff.pallas_fp2 import TFF2
from gnark_tpu.ff.pallas_mont import TFF
from gnark_tpu_torch.backend.groth16 import _to_affine_host
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.proj_ec import (proj_add, proj_add_plain,
                                        proj_double, proj_double_plain)
from gnark_tpu_torch.ec.weierstrass import (jac_add, jac_inf,
                                            jac_to_affine, proj_to_jac,
                                            to_limbs)
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm.bucket import group_b3

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
Q = CURVE.fp.modulus


def _group(g2):
    ff = get_ff2(CURVE.fp.name, CURVE.fp2_nr) if g2 else get_ff(CURVE.fp.name)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    b3 = group_b3(CURVE, g2)
    return ff, hf, b3, (CURVE.g2 if g2 else CURVE.g1)


def _elem(g2, rng):
    return (rng.randrange(Q), rng.randrange(Q)) if g2 else rng.randrange(Q)


def test_ff2_matches_reference():
    f, r = get_ff2(CURVE.fp.name, CURVE.fp2_nr), \
        ref_get_ff2(CURVE.fp.name, CURVE.fp2_nr)
    rng = random.Random(11)
    a = [_elem(True, rng) for _ in range(24)] + [(0, 0), (1, 0), (0, 1)]
    b = [_elem(True, rng) for _ in range(27)]
    A, B = torch.as_tensor(f.encode(a)), torch.as_tensor(f.encode(b))
    rA, rB = jnp.asarray(r.encode(a)), jnp.asarray(r.encode(b))
    for op in ("add", "sub", "mul"):
        got = getattr(f, op)(A, B).numpy()
        assert np.array_equal(got, np.asarray(getattr(r, op)(rA, rB))), op
    for op in ("neg", "square", "double"):
        got = getattr(f, op)(A).numpy()
        assert np.array_equal(got, np.asarray(getattr(r, op)(rA))), op
    hf = CURVE.host_g2_field
    inv = f.decode(f.inv(A[:5])).reshape(-1, 2)
    assert [tuple(int(c) for c in v) for v in inv] == \
        [hf.inv(v) if v != (0, 0) else (0, 0) for v in a[:5]]


def _ref_field(g2):
    base = TFF(REF_FIELDS[CURVE.fp.name])
    return TFF2(base, CURVE.fp2_nr) if g2 else base


def _to_ref(ff, w, g2):
    """(n, Lw) words -> the reference's (L or 2L, n) limb block."""
    limbs = ff.from_words(w.reshape(w.shape[0], 2, ff.nw) if g2 else w)
    return jnp.asarray(limbs.reshape(w.shape[0], -1).numpy().T
                       .astype(np.uint32))


@pytest.mark.parametrize("g2", [False, True])
def test_proj_plain_matches_reference_formulas(g2):
    """Plain K3 == _proj_add_t / _proj_dbl_t + canon, bit for bit, on
    arbitrary field elements (the formulas are algebra)."""
    ff, _, b3, _ = _group(g2)
    rng = random.Random(12 + g2)
    n = 6
    P = tuple(torch.as_tensor(ff.encode_words(
        [_elem(g2, rng) for _ in range(n)])).reshape(n, -1)
        for _ in range(3))
    Qp = tuple(torch.as_tensor(ff.encode_words(
        [_elem(g2, rng) for _ in range(n)])).reshape(n, -1)
        for _ in range(3))
    f = _ref_field(g2)
    b3col = f.mont_col2(*b3) if g2 else f.mont_col(b3)
    rP = tuple(_to_ref(ff, a, g2) for a in P)
    rQ = tuple(_to_ref(ff, a, g2) for a in Qp)
    want_add = [np.asarray(f.canon(a)) for a in _proj_add_t(f, rP, rQ, b3col)]
    want_dbl = [np.asarray(f.canon(a)) for a in _proj_dbl_t(f, rP, b3col)]
    got_add = proj_add_plain(ff, b3, P, Qp)
    got_dbl = proj_double_plain(ff, b3, P)
    for g, w in zip(got_add + got_dbl, want_add + want_dbl):
        assert np.array_equal(np.asarray(_to_ref(ff, g, g2)), w)


def _proj_words(ff, hf, pts, g2, rng):
    X, Y, Z = [], [], []
    for p in pts:
        if p is host.INF:
            X.append((0, 0) if g2 else 0)
            Y.append((1, 0) if g2 else 1)
            Z.append((0, 0) if g2 else 0)
            continue
        z = (rng.randrange(1, Q), 0) if g2 else rng.randrange(1, Q)
        X.append(hf.mul(p[0], z))
        Y.append(hf.mul(p[1], z))
        Z.append(z)
    n = len(pts)
    return tuple(torch.as_tensor(ff.encode_words(v)).reshape(n, -1)
                 for v in (X, Y, Z))


@pytest.mark.parametrize("g2", [False, True])
def test_proj_plain_matches_host(g2):
    """Complete formulas: identity, P + P, P + (-P), in affine form."""
    ff, hf, b3, gen = _group(g2)
    rng = random.Random(13 + g2)
    P = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(6)]
    Qs = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(6)]
    P[0] = host.INF
    Qs[1] = host.INF
    Qs[2] = P[2]
    Qs[3] = host.ec_neg(hf, P[3])
    A = _proj_words(ff, hf, P, g2, rng)
    B = _proj_words(ff, hf, Qs, g2, rng)
    S = proj_add(ff, b3, A, B)               # CPU tensors: plain version
    D = proj_double(ff, b3, A)
    for i in range(6):
        assert _to_affine_host(ff, hf, "proj", tuple(a[i:i + 1] for a in S)) \
            == host.ec_add(hf, P[i], Qs[i])
        assert _to_affine_host(ff, hf, "proj", tuple(a[i:i + 1] for a in D)) \
            == host.ec_add(hf, P[i], P[i])


def _affine(ff, R):
    x, y, inf = jac_to_affine(ff, R)
    out = []
    for i in range(x.shape[0]):
        if bool(inf[i]):
            out.append(host.INF)
            continue
        xs, ys = ff.decode(x[i]), ff.decode(y[i])
        if np.ndim(xs):
            out.append((tuple(int(c) for c in xs), tuple(int(c) for c in ys)))
        else:
            out.append((int(xs), int(ys)))
    return out


@pytest.mark.parametrize("g2", [False, True])
def test_jacobian_ops_match_host(g2):
    ff, hf, b3, gen = _group(g2)
    rng = random.Random(14 + g2)
    P = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(4)]
    Qs = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(4)]
    P[0] = host.INF
    Qs[1] = P[1]
    Qs[2] = host.ec_neg(hf, P[2])
    shape = (4, 2, ff.nw) if g2 else (4, ff.nw)
    A = to_limbs(ff, tuple(a.reshape(shape)
                           for a in _proj_words(ff, hf, P, g2, rng)))
    B = to_limbs(ff, tuple(a.reshape(shape)
                           for a in _proj_words(ff, hf, Qs, g2, rng)))
    got = _affine(ff, jac_add(ff, proj_to_jac(ff, A), proj_to_jac(ff, B)))
    assert got == [host.ec_add(hf, p, q) for p, q in zip(P, Qs)]
    assert _affine(ff, jac_inf(ff, (1,))) == [host.INF]
