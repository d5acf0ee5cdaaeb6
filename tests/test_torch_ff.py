"""gnark_tpu_torch.ff against the reference gnark_tpu.ff: plain limb
arithmetic bit-exact in Montgomery form, limb <-> word conversion, and
the plain version of kernel K1 (mont_mul) against the reference's
in-kernel Montgomery product TFF.mul. Tolerance: exact equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu.fields import FIELDS as REF_FIELDS
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.ff.pallas_mont import TFF
from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff.mont_mul import mont_mul, mont_mul_plain

torch.set_num_threads(2)

BN254 = ["bn254_fp", "bn254_fr"]


def _vals(q, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(q) for _ in range(n)] + [0, 1, q - 1]


@pytest.mark.parametrize("name", BN254)
def test_ff_matches_reference(name):
    f, r = get_ff(name), ref_get_ff(name)
    q = f.p.modulus
    a, b = _vals(q, 61, 1), _vals(q, 61, 2)[::-1]
    assert np.array_equal(f.encode(a), r.encode(a))
    assert np.array_equal(f.encode(a, mont=False), r.encode(a, mont=False))
    A, B = torch.as_tensor(f.encode(a)), torch.as_tensor(f.encode(b))
    rA, rB = jnp.asarray(r.encode(a)), jnp.asarray(r.encode(b))
    for op in ("add", "sub", "mul"):
        got = getattr(f, op)(A, B).numpy()
        assert np.array_equal(got, np.asarray(getattr(r, op)(rA, rB))), op
    for op in ("neg", "square", "to_mont", "from_mont"):
        got = getattr(f, op)(A).numpy()
        assert np.array_equal(got, np.asarray(getattr(r, op)(rA))), op
    assert [int(v) for v in f.decode(A)] == a
    inv = f.inv(A[:4])
    assert [int(v) for v in f.decode(inv)] == [pow(v, -1, q) if v else 0
                                               for v in a[:4]]


@pytest.mark.parametrize("name", ["tinyfield", "babybear"])
def test_small_field_encode_mul(name):
    f, r = get_ff(name), ref_get_ff(name)
    q = f.p.modulus
    a, b = _vals(q, 20, 3), _vals(q, 20, 4)
    assert np.array_equal(f.encode(a), r.encode(a))
    got = f.mul(torch.as_tensor(f.encode(a)), torch.as_tensor(f.encode(b)))
    want = r.mul(jnp.asarray(r.encode(a)), jnp.asarray(r.encode(b)))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", BN254)
def test_limb_word_round_trip(name):
    f, r = get_ff(name), ref_get_ff(name)
    q = f.p.modulus
    a = _vals(q, 30, 5)
    limbs = torch.as_tensor(f.encode(a))
    words = f.to_words(limbs)
    assert words.dtype == torch.int32 and words.shape == (33, 8)
    assert np.array_equal(words.numpy(), f.encode_words(a))
    assert torch.equal(f.from_words(words), limbs)
    assert [int(v) for v in f.decode_words(words)] == a
    # the solver's u64 limbs viewed as u32 words are the kernels' format
    u64 = np.array([[(v >> (64 * i)) & (2**64 - 1) for i in range(4)]
                    for v in a], dtype=np.uint64)
    u32 = f.u64_view(u64)
    got = f.limbs_from_u32(torch.from_numpy(u32.view(np.int32)))
    want = r.limbs_from_u32(jnp.asarray(u32))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", BN254)
def test_mont_mul_plain_matches_tff(name):
    """Plain K1 == the reference kernel arithmetic TFF.mul on (L, T)."""
    f = get_ff(name)
    tff = TFF(REF_FIELDS[name])
    q = f.p.modulus
    a, b = _vals(q, 45, 6), _vals(q, 45, 7)
    wa = torch.as_tensor(f.encode_words(a))
    wb = torch.as_tensor(f.encode_words(b))
    ra, rb = jnp.asarray(f.encode(a).T), jnp.asarray(f.encode(b).T)
    want = np.asarray(tff.mul(ra, rb)).T
    got = mont_mul_plain(f, wa, wb)
    assert np.array_equal(f.from_words(got).numpy(), want)
    # CPU tensors go to the plain version; a one-element b broadcasts
    assert torch.equal(mont_mul(f, wa, wb), got)
    want1 = np.asarray(tff.mul(ra, jnp.broadcast_to(rb[:, :1], ra.shape))).T
    got1 = mont_mul(f, wa, wb[:1])
    assert np.array_equal(f.from_words(got1).numpy(), want1)


def test_kernel_constants_use_32bit_redc():
    for name in BN254:
        c = cuda.field_consts(name)
        p = get_ff(name).p.modulus
        assert int(c[24]) * p % (1 << 32) == (1 << 32) - 1
        assert sum(int(c[i]) << (32 * i) for i in range(8)) == p
        assert sum(int(c[8 + i]) << (32 * i) for i in range(8)) == 2 * p
    with pytest.raises(ValueError):
        cuda.field_consts("koalabear")


def test_kernel_constants_end_with_r_cubed():
    """csrc/mont.cuh's FieldC: 33 words, the last 8 R^3 mod p (by_inv's
    return from 1 / (z R) to Montgomery form), R = 2^256."""
    for name in BN254:
        c = cuda.field_consts(name)
        p = get_ff(name).p.modulus
        assert c.shape == (33,)
        r3 = sum(int(c[25 + i]) << (32 * i) for i in range(8))
        assert r3 == pow(2, 3 * 256, p)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error path of a machine without CUDA")
    with pytest.raises(RuntimeError):
        cuda.resolve_device(None)
    assert cuda.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", ["bn254_fp", "bn254_fr", "bls12_381_fp",
                                  "bls12_381_fr", "bls12_377_fp",
                                  "bls12_377_fr"])
def test_wide_redc_equals_limb_steps(name):
    """FF._mul_wide (the product on CUDA tensors: whole-width REDC in
    three matrix products) gives mul's words bit for bit (its limb-step
    REDC, the CPU path), on operands up to 2p - 1 (p, 0, 1 among them),
    broadcast and batched, in the lazy and the sound class."""
    f = get_ff(name)
    q = f.p.modulus
    rng = random.Random(31)
    vals = [0, 1, q - 1, q, 2 * q - 1] + [rng.randrange(2 * q)
                                          for _ in range(195)]
    a = torch.as_tensor([[(v >> (16 * i)) & 0xFFFF for i in range(f.n)]
                         for v in vals], dtype=torch.int64)
    b = a.flip(0)
    for x, y in ((a, b), (a, a), (a, b[:1]), (a.reshape(8, 25, f.n),
                                              b.reshape(8, 25, f.n))):
        assert torch.equal(f._mul_wide(*torch.broadcast_tensors(x, y)),
                           f.mul(x, y))
