"""Kernels K6 jac_add_mixed and K7 jac_double in their plain versions,
the fixed-base ladder built on them, and the affine conversion of its
result, for G1 and G2:
  * against the host oracle, with the edge cases of a complete add (an
    accumulator at infinity, a masked affine operand, R == A, R == -A,
    inputs in [p, 2p));
  * the ladder's masked mixed add (inf2 = ~bit) against the reference's
    explicit select(bit, R + base, R), word for word;
  * against the reference's jac_add_mixed_p / jac_double_p in Pallas
    interpret mode, G1 (slow tier: it compiles the interpret-mode
    kernels; the reference defines them for G1 only).
Tolerance: exact equality (canonical Montgomery words, affine host
ints)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import config
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.jac_ec import jac_add_mixed, jac_double
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm.fixed_base import (batch_scalar_mul,
                                            jac_infinity_words,
                                            jac_to_affine)

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
Q = CURVE.fp.modulus


def _group(g2):
    if g2:
        return (get_ff2(CURVE.fp.name, CURVE.fp2_nr), CURVE.host_g2_field,
                CURVE.g2)
    return get_ff(CURVE.fp.name), CURVE.host_fp, CURVE.g1


def _elem_words(ff, vals, g2, lazy=0):
    """Host field elements -> (n, Lw) Montgomery words; the first `lazy`
    rows pushed into [p, 2p)."""
    base = ff.base if g2 else ff
    flat = [c for v in vals for c in v] if g2 else list(vals)
    mont = [c * base.p.R_mod % Q for c in flat]
    k = 2 if g2 else 1
    mont = [c + Q if i < lazy * k else c for i, c in enumerate(mont)]
    return torch.as_tensor(base.encode_words(mont, mont=False)) \
        .reshape(len(vals), -1)


def _jac(ff, hf, pts, g2, rng, lazy=0):
    """Host points -> Jacobian words with random Z (infinity (1, 1, 0))."""
    X, Y, Z = [], [], []
    one, zero = (hf.one, hf.zero)
    for P in pts:
        if P is host.INF:
            X.append(one)
            Y.append(one)
            Z.append(zero)
            continue
        z = (rng.randrange(1, Q), rng.randrange(Q)) if g2 else \
            rng.randrange(1, Q)
        z2 = hf.mul(z, z)
        X.append(hf.mul(P[0], z2))
        Y.append(hf.mul(P[1], hf.mul(z2, z)))
        Z.append(z)
    return (_elem_words(ff, X, g2, lazy), _elem_words(ff, Y, g2),
            _elem_words(ff, Z, g2))


def _decode(ff, w, g2):
    v = ff.decode_words(w.reshape(2, ff.nw) if g2 else w)
    return tuple(int(c) for c in v) if g2 else int(v)


def _to_host(ff, hf, P, g2):
    """Jacobian words -> host affine points."""
    out = []
    for i in range(P[0].shape[0]):
        X, Y, Z = (_decode(ff, a[i], g2) for a in P)
        if hf.is_zero(Z):
            out.append(host.INF)
            continue
        zi = hf.inv(Z)
        zi2 = hf.mul(zi, zi)
        out.append((hf.mul(X, zi2), hf.mul(Y, hf.mul(zi2, zi))))
    return out


@pytest.mark.parametrize("g2", [False, True])
def test_jac_plain_matches_host(g2):
    ff, hf, gen = _group(g2)
    rng = random.Random(31 + g2)
    n = 10
    P = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(n)]
    A = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(n)]
    inf2 = [False] * n
    P[0] = host.INF                       # infinity accumulator
    inf2[1] = True                        # masked operand
    A[2] = P[2]                           # R == A: the doubling branch
    A[3] = host.ec_neg(hf, P[3])          # R == -A: infinity
    P[4], inf2[4] = host.INF, True
    Pw = _jac(ff, hf, P, g2, rng, lazy=6)
    x2 = _elem_words(ff, [a[0] for a in A], g2, lazy=3)
    y2 = _elem_words(ff, [a[1] for a in A], g2)
    R = jac_add_mixed(ff, Pw, x2, y2, torch.tensor(inf2))
    assert _to_host(ff, hf, R, g2) == [
        p if m else host.ec_add(hf, p, a) for p, a, m in zip(P, A, inf2)]
    assert _to_host(ff, hf, jac_double(ff, Pw), g2) == \
        [host.ec_dbl(hf, p) for p in P]
    # one affine point broadcast to every row
    gx, gy = (_elem_words(ff, [c], g2) for c in gen)
    R = jac_add_mixed(ff, Pw, gx, gy, torch.tensor(inf2))
    assert _to_host(ff, hf, R, g2) == [
        p if m else host.ec_add(hf, p, gen) for p, m in zip(P, inf2)]


@pytest.mark.parametrize("g2", [False, True])
def test_fixed_base_ladder_matches_host(g2):
    """batch_scalar_mul at nbits = 16 and its affine conversion against
    the host; the ladder written with the reference's explicit
    select(bit, R + base, R) ends in the same words."""
    ff, hf, gen = _group(g2)
    fr = get_ff(CURVE.fr.name)
    rng = random.Random(41 + g2)
    ks = [0, 1, 2, 0xFFFF, 0x8000] + [rng.randrange(1 << 16)
                                      for _ in range(5)]
    sc = torch.as_tensor(fr.encode_words(ks, mont=False))
    base = tuple(_elem_words(ff, [c], g2) for c in gen)
    want = [host.ec_mul(hf, gen, k) for k in ks]
    ladder = batch_scalar_mul(ff, base, 16, sc)
    assert _to_host(ff, hf, ladder, g2) == want
    x, y, inf = jac_to_affine(ff, ladder)
    got = [host.INF if bool(inf[i]) else
           (_decode(ff, x[i], g2), _decode(ff, y[i], g2))
           for i in range(len(ks))]
    assert got == want
    assert all(bool((x[i] == 0).all() and (y[i] == 0).all())
               for i in range(len(ks)) if ks[i] == 0)
    R = jac_infinity_words(ff, len(ks), "cpu")
    none = torch.zeros(len(ks), dtype=torch.bool)
    for b in range(15, -1, -1):
        R = jac_double(ff, R)
        bit = (sc[:, 0] >> b) & 1
        added = jac_add_mixed(ff, R, *base, none)
        R = tuple(torch.where((bit == 1)[:, None], a, r)
                  for a, r in zip(added, R))
    assert all(torch.equal(u, v) for u, v in zip(R, ladder))


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setenv("GNARK_TPU_PALLAS", "1")
    config.use_pallas.cache_clear()
    yield
    config.use_pallas.cache_clear()


@pytest.mark.slow
def test_jac_plain_matches_reference_kernels(pallas_on):
    from gnark_tpu.ec.pallas_ec import jac_add_mixed_p, jac_double_p
    from gnark_tpu.ff import get_ff as ref_get_ff
    ff, hf, gen = _group(False)
    r = ref_get_ff(CURVE.fp.name)
    rng = random.Random(51)
    n = 8
    P = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(n)]
    A = [host.ec_mul(hf, gen, rng.randrange(1, 1000)) for _ in range(n)]
    inf2 = [False, True, False, False, False, True, False, False]
    P[0] = host.INF
    A[2] = P[2]
    A[3] = host.ec_neg(hf, P[3])
    Pw = _jac(ff, hf, P, False, rng)
    x2 = _elem_words(ff, [a[0] for a in A], False)
    y2 = _elem_words(ff, [a[1] for a in A], False)

    def ref(w):
        return jnp.asarray(ff.from_words(w).numpy().astype(np.uint32))

    def same(got, want):
        return all(np.array_equal(ff.from_words(g).numpy(),
                                  np.asarray(w).astype(np.int64))
                   for g, w in zip(got, want))

    mask = torch.tensor(inf2)
    assert same(jac_add_mixed(ff, Pw, x2, y2, mask),
                jac_add_mixed_p(r, tuple(ref(a) for a in Pw),
                                (ref(x2), ref(y2), jnp.asarray(inf2))))
    assert same(jac_double(ff, Pw), jac_double_p(r, tuple(ref(a)
                                                          for a in Pw)))
