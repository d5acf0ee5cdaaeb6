"""The CUDA kernels K1-K7 against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither jax nor gnark_tpu, so it also runs where JAX
is not installed (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerance: bit-exact for K1-K3 and K5-K7 (canonical outputs are fixed
functions of the inputs); equal as group elements for K4 (the order of
additions differs, so the projective representatives do)."""

import random

import pytest
import torch

from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.jac_ec import (jac_add_mixed, jac_add_mixed_plain,
                                       jac_double, jac_double_plain)
from gnark_tpu_torch.ec.proj_ec import (_limbs, proj_add, proj_add_plain,
                                        proj_double, proj_double_plain)
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain
from gnark_tpu_torch.msm.bucket import (bucket_msm, bucket_msm_plain,
                                        curve_b3, curve_b3_g2,
                                        signed_digits)
from gnark_tpu_torch.msm.fixed_base import batch_scalar_mul_affine
from gnark_tpu_torch.msm.pippenger import scalar_limbs
from gnark_tpu_torch.ntt import Domain
from gnark_tpu_torch.ntt.fourstep import dif_stage_tw, row_fft, \
    row_fft_plain
from gnark_tpu_torch.ntt.radix2 import (butterfly, butterfly_plain,
                                        stage_twiddles)

CURVE = curves.CURVES["bn254"]
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


def _words(ff, n, seed, dev):
    q = ff.p.modulus
    rng = random.Random(seed)
    vals = [rng.randrange(q) for _ in range(n - 3)] + [0, 1, q - 1]
    return torch.as_tensor(ff.encode_words(vals), device=dev)


def _group(g2):
    if g2:
        return (get_ff2(CURVE.fp.name, CURVE.fp2_nr), CURVE.host_g2_field,
                curve_b3_g2(CURVE.fp.name), CURVE.g2)
    return (get_ff(CURVE.fp.name), CURVE.host_fp, curve_b3(CURVE.fp.name),
            CURVE.g1)


@pytest.mark.parametrize("name", ["bn254_fp", "bn254_fr"])
def test_mont_mul(dev, name):
    f = get_ff(name)
    a, b = _words(f, 4093, 1, dev), _words(f, 4093, 2, dev)
    for bb in (b, b[:1]):
        assert torch.equal(mont_mul(f, a, bb), mont_mul_plain(f, a, bb))


def test_row_fft_and_fourstep(dev, monkeypatch):
    monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", "11")
    f = get_ff("bn254_fr")
    for S in (2, 512, 1024):
        x = _words(f, 4 * S, S, dev).reshape(4, S, f.nw)
        tw = torch.as_tensor(dif_stage_tw(f, S, f.p.root_of_unity(S)),
                             device=dev)
        assert torch.equal(row_fft(f, x, tw), row_fft_plain(f, x, tw))
    n = 1 << 11
    x = _words(f, n, 3, "cpu")
    dg, dc = Domain(f, n, dev), Domain(f, n, "cpu")
    for coset in (False, True):
        assert torch.equal(dg.fft(x.to(dev), coset).cpu(), dc.fft(x, coset))
        assert torch.equal(dg.ifft(x.to(dev), coset).cpu(),
                           dc.ifft(x, coset))


@pytest.mark.parametrize("g2", [False, True])
def test_proj_ec(dev, g2):
    ff, _, b3, _ = _group(g2)
    n = 1000
    P = tuple(_words(ff.base if g2 else ff, 2 * n if g2 else n, s, dev)
              .reshape(n, -1) for s in range(6))
    got = proj_add(ff, b3, P[:3], P[3:])
    want = proj_add_plain(ff, b3, P[:3], P[3:])
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    got = proj_double(ff, b3, P[:3])
    want = proj_double_plain(ff, b3, P[:3])
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("g2", [False, True])
def test_bucket_msm(dev, g2):
    ff, hf, b3, gen = _group(g2)
    rng = random.Random(4)
    base = [gen]
    for _ in range(31):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 600
    pts = [base[rng.randrange(32)] for _ in range(n)]
    x = torch.as_tensor(ff.encode_words([p[0] for p in pts]),
                        device=dev).reshape(n, -1)
    y = torch.as_tensor(ff.encode_words([p[1] for p in pts]),
                        device=dev).reshape(n, -1)
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[3:6] = True
    ks = [rng.randrange(CURVE.fr.modulus) for _ in range(n)]
    ks[7:9] = [0, 0]
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False),
                         device=dev)
    digits = signed_digits(scalar_limbs(sc), CURVE.fr.bits, 8)
    got = bucket_msm(ff, b3, x, y, inf, digits)
    want = bucket_msm_plain(ff, b3, x, y, inf, digits)
    X1, Y1, Z1 = (_limbs(ff, a) for a in got)
    X2, Y2, Z2 = (_limbs(ff, a) for a in want)
    assert torch.equal(ff.is_zero(Z1), ff.is_zero(Z2))
    assert torch.equal(ff.mul(X1, Z2), ff.mul(X2, Z1))
    assert torch.equal(ff.mul(Y1, Z2), ff.mul(Y2, Z1))


def test_butterfly_and_radix2(dev):
    f = get_ff("bn254_fr")
    n = 1 << 11
    for tw in stage_twiddles(f, n, f.p.root_of_unity(n)):
        tw = torch.as_tensor(tw, device=dev)
        y = _words(f, n, tw.shape[0], dev)
        assert torch.equal(butterfly(f, y.clone(), tw),
                           butterfly_plain(f, y.clone(), tw))
    x = _words(f, n, 5, "cpu")
    dg, dc = Domain(f, n, dev), Domain(f, n, "cpu")
    for coset in (False, True):
        assert torch.equal(dg.fft(x.to(dev), coset).cpu(), dc.fft(x, coset))
        assert torch.equal(dg.ifft(x.to(dev), coset).cpu(),
                           dc.ifft(x, coset))


@pytest.mark.parametrize("g2", [False, True])
def test_jac_ec(dev, g2):
    ff, _, _, _ = _group(g2)
    n = 1000
    P = tuple(_words(ff.base if g2 else ff, 2 * n if g2 else n, s, dev)
              .reshape(n, -1) for s in range(5))
    mask = torch.arange(n, device=dev) % 3 == 0
    for x2, y2 in ((P[3], P[4]), (P[3][:1], P[4][:1])):
        got = jac_add_mixed(ff, P[:3], x2, y2, mask)
        want = jac_add_mixed_plain(ff, P[:3], x2, y2, mask)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    got, want = jac_double(ff, P[:3]), jac_double_plain(ff, P[:3])
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("g2", [False, True])
def test_fixed_base_ladder(dev, g2):
    ff, _, _, gen = _group(g2)
    rng = random.Random(6)
    ks = [0, 1] + [rng.randrange(1 << 20) for _ in range(62)]
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False))
    base = tuple(torch.as_tensor(ff.encode_words([c])).reshape(1, -1)
                 for c in gen)
    got = batch_scalar_mul_affine(ff, tuple(a.to(dev) for a in base), 20,
                                  sc.to(dev))
    want = batch_scalar_mul_affine(ff, base, 20, sc)
    assert all(torch.equal(u.cpu(), v) for u, v in zip(got, want))
