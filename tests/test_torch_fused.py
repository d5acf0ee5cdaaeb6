"""K1's fused entry points on the CPU, where each runs its plain twin:
  * mont_mul_sub_mul, (a*b - c)*d, against the reference's
    ffr.mul(ffr.sub(ffr.mul(a, b), c), d) (computeH's pointwise step) on
    64 seeded elements, some of a, b, c in [p, 2p), d per element and
    broadcast;
  * affine_words (the Fermat chain) against the reference's
    gnark_tpu.ec.weierstrass.jac_to_affine on 16 G1 and 16 G2 Jacobian
    points with infinity and Z = 1;
  * with the kernel binding stubbed (meta tensors stand in for CUDA
    ones, no card needed): jac_to_affine goes to one launch of the
    affine kernel and never to mont_mul, and mont_mul_sub_mul is one
    launch.
The kernels themselves are held against these plain twins on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerance: exact equality
(canonical Montgomery words)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.ec.fp2 import get_ff2 as ref_get_ff2
from gnark_tpu.ec.weierstrass import jac_to_affine as ref_jac_to_affine
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu_torch import cuda
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff import mont_mul as mm
from gnark_tpu_torch.msm import fixed_base

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]


def _raw(vals):
    """Ints below 2^256 -> (n, 8) int32 words as they are."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.frombuffer(bytearray(buf), dtype=torch.int32) \
        .reshape(len(vals), 8).clone()


def _mont(f, vals, lazy=0):
    """Montgomery words of vals, the first `lazy` pushed into [p, 2p)."""
    q = f.p.modulus
    m = [v * f.p.R_mod % q for v in vals]
    return _raw([v + q if i < lazy else v for i, v in enumerate(m)])


@pytest.mark.parametrize("name", ["bn254_fr", "bn254_fp"])
def test_mont_mul_sub_mul_plain_matches_reference(name):
    f, r = get_ff(name), ref_get_ff(name)
    q = f.p.modulus
    rng = random.Random(1)
    vals = [[rng.randrange(q) for _ in range(61)] + [0, 1, q - 1]
            for _ in range(4)]
    a, b, c, d = (_mont(f, v, lazy=8 * (k < 3)) for k, v in enumerate(vals))
    ra, rb, rc, rd = (jnp.asarray(r.encode(v)) for v in vals)
    ref = jax.jit(lambda a, b, c, d: r.mul(r.sub(r.mul(a, b), c), d))
    for dd, rdd in ((d, rd), (d[:1], rd[:1])):
        got = mm.mont_mul_sub_mul(f, a, b, c, dd)
        assert np.array_equal(f.from_words(got).numpy(),
                              np.asarray(ref(ra, rb, rc, rdd)))


def _jacobian(hf, gen, rng, n, g2):
    """n host points (the first at infinity) as Jacobian ints with a
    random Z (Z = 1 on the second): lists X, Y, Z."""
    q = CURVE.fp.modulus
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    X, Y, Z = [one], [one], [zero]
    for i in range(1, n):
        P = host.ec_mul(hf, gen, rng.randrange(1, 1 << 20))
        z = one if i == 1 else ((rng.randrange(1, q), rng.randrange(q))
                                if g2 else rng.randrange(1, q))
        z2 = hf.mul(z, z)
        X.append(hf.mul(P[0], z2))
        Y.append(hf.mul(P[1], hf.mul(z2, z)))
        Z.append(z)
    return X, Y, Z


@pytest.mark.parametrize("g2", [False, True])
def test_affine_plain_matches_reference(g2):
    if g2:
        ff, rf = get_ff2(CURVE.fp.name, CURVE.fp2_nr), \
            ref_get_ff2(CURVE.fp.name, CURVE.fp2_nr)
    else:
        ff, rf = get_ff(CURVE.fp.name), ref_get_ff(CURVE.fp.name)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    n = 16
    cols = _jacobian(hf, CURVE.g2 if g2 else CURVE.g1, random.Random(2), n,
                     g2)
    P = tuple(torch.as_tensor(ff.encode_words(c)).reshape(n, -1)
              for c in cols)
    x, y, inf = fixed_base.jac_to_affine(ff, P)
    rx, ry, rinf = jax.jit(lambda P: ref_jac_to_affine(rf, P))(
        tuple(jnp.asarray(rf.encode(c)) for c in cols))
    shape = (n, 2, ff.nw) if g2 else (n, ff.nw)
    for got, want in ((x, rx), (y, ry)):
        assert np.array_equal(ff.from_words(got.reshape(shape)).numpy(),
                              np.asarray(want))
    assert inf.tolist() == np.asarray(rinf).tolist() == [True] + [False] * 15
    assert int(x[0].abs().sum() + y[0].abs().sum()) == 0


class _Kernel:
    """Stands in for a ctypes kernel entry point: records the calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    """cuda.dev_words / cuda.stream accept meta tensors; nothing runs."""
    monkeypatch.setattr(cuda, "dev_words", lambda t, what, shape=None: t)
    monkeypatch.setattr(cuda, "stream", lambda t: 0)


@pytest.mark.parametrize("g2", [False, True])
def test_jac_to_affine_on_the_card_is_one_fused_launch(g2, stub_card,
                                                        monkeypatch):
    ff = get_ff2(CURVE.fp.name, CURVE.fp2_nr) if g2 else \
        get_ff(CURVE.fp.name)
    kernel = _Kernel()
    monkeypatch.setattr(fixed_base, "_affine_fn", lambda field: kernel)

    def no_product(*args):
        raise AssertionError("a K1 product on the card's affine path")
    monkeypatch.setattr(mm, "mont_mul", no_product)
    monkeypatch.setattr(fixed_base, "mont_mul_plain", no_product)
    n, lw = 1000, 16 if g2 else 8
    P = tuple(torch.empty((n, lw), dtype=torch.int32, device="meta")
              for _ in range(3))
    before = fixed_base.affine_words.launches
    x, y, inf = fixed_base.jac_to_affine(ff, P)
    assert fixed_base.affine_words.launches - before == 1
    assert len(kernel.calls) == 1
    assert kernel.calls[0][5:7] == (n, int(g2))
    assert x.shape == y.shape == (n, lw) and inf.shape == (n,)


def test_mont_mul_sub_mul_on_the_card_is_one_launch(stub_card, monkeypatch):
    f = get_ff("bn254_fr")
    kernel = _Kernel()
    monkeypatch.setattr(mm, "_sub_fn", lambda field: kernel)
    n = 1 << 20
    a, b, c = (torch.empty((n, 8), dtype=torch.int32, device="meta")
               for _ in range(3))
    d = torch.empty((1, 8), dtype=torch.int32, device="meta")
    before = mm.mont_mul_sub_mul.launches
    out = mm.mont_mul_sub_mul(f, a, b, c, d)
    assert mm.mont_mul_sub_mul.launches - before == 1
    assert len(kernel.calls) == 1 and kernel.calls[0][5:7] == (n, 1)
    assert out.shape == (n, 8)
    with pytest.raises(ValueError):
        mm.mont_mul_sub_mul(f, a, b, c[:5], d)
