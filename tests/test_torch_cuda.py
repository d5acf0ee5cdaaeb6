"""The CUDA kernels K1-K14 (K1 with its fused (a*b - c)*d and affine
entry points, K2 as whole four-step transforms, K5 as whole transforms,
K8 with its group fold, K13 over many columns, K14 the PLONK quotient's
numerator also against the sequence it replaced) and the fixed-base
ladder against their plain PyTorch versions, the scan-path MSM against
the bucket path, a chunked bucket MSM against the single-shot one, a
small PLONK proof made on the card against the same proof made on the
CPU, and its two quotient paths against each other on the card.
Every test here needs an NVIDIA GPU and skips without one.

This file imports neither jax nor gnark_tpu, so it also runs where JAX
is not installed (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerance: bit-exact for K1-K3, K5-K8, the ladder and K4's digit
kernel (canonical outputs are fixed functions of the inputs); equal as
group elements for K4, K9 and the two MSM paths (the order of additions
differs, so the representatives do)."""

import ctypes
import random

import numpy as np
import pytest
import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.backend import groth16, plonk_num
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.backend.groth16 import _to_affine_host
from gnark_tpu_torch.ec.jac_ec import (jac_add, jac_add_mixed,
                                       jac_add_mixed_plain, jac_add_plain,
                                       jac_double, jac_double_plain,
                                       jac_fold, jac_fold_plain)
from gnark_tpu_torch.ec.proj_ec import (_limbs, proj_add, proj_add_plain,
                                        proj_double, proj_double_plain)
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.ff import ops as ff_ops
from gnark_tpu_torch.ff.mont_mul import (mont_mul, mont_mul_plain,
                                         mont_mul_sub_mul,
                                         mont_mul_sub_mul_plain)
from gnark_tpu_torch.msm import bucket as bucket_mod
from gnark_tpu_torch.msm.bucket import (bucket_digits, bucket_msm,
                                        bucket_msm_plain, bucket_reduce,
                                        bucket_reduce_plain, group_b3,
                                        signed_digits)
from gnark_tpu_torch.msm.fixed_base import (affine_words, affine_words_plain,
                                            batch_scalar_mul,
                                            batch_scalar_mul_affine,
                                            batch_scalar_mul_plain)
from gnark_tpu_torch.msm.pippenger import msm_raw, scalar_limbs
from gnark_tpu_torch.ntt import Domain
from gnark_tpu_torch.ntt import fourstep
from gnark_tpu_torch.ntt.fourstep import (FourStep, fourstep_ntt,
                                          fourstep_ntt_plain, root_powers,
                                          row_fft, row_fft_plain)
from gnark_tpu_torch.ntt.radix2 import (butterfly, butterfly_plain,
                                        ntt_launches, radix2_ntt,
                                        radix2_ntt_plain, stage_twiddles)

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
                group_b3(CURVE, True), CURVE.g2)
    return (get_ff(CURVE.fp.name), CURVE.host_fp, group_b3(CURVE),
            CURVE.g1)


@pytest.mark.parametrize("name", ["bn254_fp", "bn254_fr"])
def test_mont_mul(dev, name):
    f = get_ff(name)
    a, b = _words(f, 4093, 1, dev), _words(f, 4093, 2, dev)
    for bb in (b, b[:1]):
        assert torch.equal(mont_mul(f, a, bb), mont_mul_plain(f, a, bb))


def _lazy_words(ff, n, seed, dev):
    """n elements in Montgomery form, every third one lifted to [p, 2p)
    (the raw words of x + p), a few zeros (0 and p) among them."""
    q = ff.p.modulus
    rng = random.Random(seed)
    vals = [rng.randrange(q) * ff.p.R_mod % q for _ in range(n)]
    for i in range(0, n, 97):
        vals[i] = 0
    raw = [v + q if i % 3 == 1 else v for i, v in enumerate(vals)]
    buf = b"".join(v.to_bytes(4 * ff.nw, "little") for v in raw)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.int32).reshape(
        n, ff.nw).copy()).to(dev)


@pytest.mark.parametrize("n", [1, 5, 2047, 2049, 1 << 16, 70001])
def test_ff_ops(dev, n):
    """K10-K13 against their plain versions on lazy inputs with zeros:
    one row, n not a power of two, K12 across many blocks (2048 rows a
    block), K13 past one block of its first pass."""
    f = get_ff("bn254_fr")
    a, b = _lazy_words(f, n, 1, dev), _lazy_words(f, n, 2, dev)
    for bb in (b, b[:1]):
        assert torch.equal(ff_ops.add(f, a, bb), ff_ops.add_plain(f, a, bb))
        assert torch.equal(ff_ops.sub(f, a, bb), ff_ops.sub_plain(f, a, bb))
    assert torch.equal(ff_ops.batch_inv(f, a), ff_ops.batch_inv_plain(f, a))
    assert torch.equal(ff_ops.scan_mul(f, a), ff_ops.scan_mul_plain(f, a))
    assert torch.equal(ff_ops.dot(f, a, b), ff_ops.dot_plain(f, a, b))
    assert torch.equal(ff_ops.dot(f, a), ff_ops.dot_plain(f, a))
    z = torch.zeros_like(a)
    assert torch.equal(ff_ops.batch_inv(f, z), z)


@pytest.mark.parametrize("n", [1, 5, 2049, 70001])
def test_bls12_381_scalar_field_kernels(dev, n):
    """K1 and K10-K13 built in the sound class for BLS12-381's scalar
    field (4r > R) against their plain versions, on lazy inputs whose
    first row is 2p - 1 in both operands (a lazy product of the two
    passes R)."""
    f = get_ff("bls12_381_fr")
    a, b = _lazy_words(f, n, 3, dev), _lazy_words(f, n, 4, dev)
    top = torch.as_tensor(np.frombuffer((2 * f.p.modulus - 1).to_bytes(
        4 * f.nw, "little"), dtype=np.int32).copy(), device=dev)
    a[0], b[0] = top, top
    for bb in (b, b[:1]):
        assert torch.equal(mont_mul(f, a, bb), mont_mul_plain(f, a, bb))
        assert torch.equal(ff_ops.add(f, a, bb), ff_ops.add_plain(f, a, bb))
        assert torch.equal(ff_ops.sub(f, a, bb), ff_ops.sub_plain(f, a, bb))
    assert torch.equal(mont_mul_sub_mul(f, a, b, b, a),
                       mont_mul_sub_mul_plain(f, a, b, b, a))
    assert torch.equal(ff_ops.batch_inv(f, a), ff_ops.batch_inv_plain(f, a))
    assert torch.equal(ff_ops.scan_mul(f, a), ff_ops.scan_mul_plain(f, a))
    assert torch.equal(ff_ops.dot(f, a, b), ff_ops.dot_plain(f, a, b))


@pytest.mark.parametrize("g2", [False, True])
def test_bls12_381_points(dev, g2):
    """The 12-word builds: the ladder at 255 bits on 0, 1, r - 1, r and
    r + 2 against the host, the affine kernel against its plain version,
    and the bucket MSM (digit kernel, K4, K9) against the host."""
    _curve_points(dev, "bls12_381", g2)


@pytest.mark.parametrize("g2", [False, True])
def test_bls12_377_points(dev, g2):
    """The 12-word builds with u^2 = -5 (nr5): as test_bls12_381_points,
    the ladder at 253 bits."""
    _curve_points(dev, "bls12_377", g2)


@pytest.mark.parametrize("g2", [False, True])
def test_bw6_761_points(dev, g2):
    """The 24-word builds (no Fp2; G2 over Fp on the G1 kernels with its
    own b3 = 12): the ladder at 377 bits on 12-word scalars 0, 1, r - 1,
    r and r + 2 against the host, the affine kernel against its plain
    version, and the bucket MSM against the host."""
    _curve_points(dev, "bw6_761", g2)


def _curve_points(dev, cv, g2):
    c = curves.CURVES[cv]
    ff, hf, b3, gen = _group_of(cv, g2)
    fr, r = get_ff(c.fr.name), c.fr.modulus
    ks = [0, 1, r - 1, r, r + 2] + [random.Random(g2).randrange(r)
                                    for _ in range(59)]
    sc = torch.as_tensor(np.frombuffer(b"".join(
        k.to_bytes(4 * fr.nw, "little") for k in ks), dtype=np.int32).copy(),
        device=dev).reshape(-1, fr.nw)
    base = tuple(torch.as_tensor(ff.encode_words([v]), device=dev)
                 for v in gen)
    P = batch_scalar_mul(ff, base, c.fr.bits, sc)
    x, y = affine_words(ff, P)
    assert all(torch.equal(u, v) for u, v in
               zip((x, y), affine_words_plain(ff, P)))
    shape = (-1, 2, ff.base.nw) if hasattr(ff, "base") else (-1, ff.nw)
    pts = _host_points_of(ff, hf, x, y, P[2], shape)
    assert pts == [host.ec_mul(hf, gen, k % r) for k in ks]
    rng = random.Random(7 + g2)
    ms = [rng.randrange(r) for _ in ks]
    ms[1], ms[2] = 0, r - 1
    inf = (P[2] == 0).all(-1)
    kind, R = msm_raw(ff, (x, y, inf), torch.as_tensor(
        fr.encode_words(ms, mont=False), device=dev), c.fr.bits, b3=b3)
    assert _to_affine_host(ff, hf, kind, R) == host.ec_msm(hf, pts, ms)


def _group_of(cv, g2):
    """(ff, host field, b3, generator) of curve cv's G1 or G2."""
    c = curves.CURVES[cv]
    if g2:
        return (groth16._g2_field(c), c.host_g2_field, group_b3(c, True),
                c.g2)
    return get_ff(c.fp.name), c.host_fp, group_b3(c), c.g1


@pytest.mark.parametrize("g2", [False, True])
def test_bls12_377_point_kernels(dev, g2):
    """The nr5 builds' K3, K6, K7, K8 and jac_fold against their plain
    versions, bit-exact, on curve points (infinity, P == Q, P == -Q, X in
    [p, 2p)) and on random words; K4 at c = 8 and 13 and K9 on its sums
    against their plain versions as group elements, and K9 against the
    host's MSM."""
    _point_kernels(dev, "bls12_377", g2)


@pytest.mark.parametrize("g2", [False, True])
def test_bw6_761_point_kernels(dev, g2):
    """As test_bls12_377_point_kernels on BW6-761's 24-word builds, G2
    over Fp through the G1 kernels with G2's b3."""
    _point_kernels(dev, "bw6_761", g2)


def _point_kernels(dev, cv, g2):
    c = curves.CURVES[cv]
    ff, hf, b3, gen = _group_of(cv, g2)
    rng = random.Random(21 + g2)
    base = [gen]
    for _ in range(15):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 300
    P = [base[rng.randrange(16)] for _ in range(n)]
    Q = [base[rng.randrange(16)] for _ in range(n)]
    Q[0], P[1], P[2], Q[2] = host.INF, host.INF, host.INF, host.INF
    Q[3], Q[4] = P[3], host.ec_neg(hf, P[4])
    Pw, Qw = _jac_words(ff, hf, P, rng, dev, 40), _jac_words(ff, hf, Q, rng,
                                                             dev, 20)
    got, want = jac_add(ff, Pw, Qw), jac_add_plain(ff, Pw, Qw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    for i in range(8):
        assert _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in got)) \
            == host.ec_add(hf, P[i], Q[i])
    f2 = hasattr(ff, "base")
    Qx, Qy = (torch.as_tensor(ff.encode_words(
        [((1, 0) if f2 else 1) if q is host.INF else q[k] for q in Q]),
        device=dev).reshape(n, -1) for k in (0, 1))
    mask = torch.as_tensor([q is host.INF for q in Q], device=dev)
    got = jac_add_mixed(ff, Pw, Qx, Qy, mask)
    assert all(torch.equal(u, v) for u, v in
               zip(got, jac_add_mixed_plain(ff, Pw, Qx, Qy, mask)))
    for i in range(8):
        assert _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in got)) \
            == host.ec_add(hf, P[i], Q[i])
    got = jac_double(ff, Pw)
    assert all(torch.equal(u, v) for u, v in zip(got, jac_double_plain(ff,
                                                                       Pw)))
    W, G, B = 2, 5, 30
    assert all(torch.equal(u, v) for u, v in
               zip(jac_fold(ff, Pw, G, B), jac_fold_plain(ff, Pw, G, B)))
    m = 500
    R6 = tuple(_words(ff.base if f2 else ff, 2 * m if f2 else m, s, dev)
               .reshape(m, -1) for s in range(6))
    for fn, pfn, args in ((jac_add, jac_add_plain, (R6[:3], R6[3:])),
                          (proj_add, proj_add_plain, (R6[:3], R6[3:])),
                          (proj_double, proj_double_plain, (R6[:3],))):
        pre = (b3,) if fn in (proj_add, proj_double) else ()
        assert all(torch.equal(u, v) for u, v in
                   zip(fn(ff, *pre, *args), pfn(ff, *pre, *args)))
    pts = [base[rng.randrange(16)] for _ in range(700)]
    x, y = (torch.as_tensor(ff.encode_words([p[i] for p in pts]),
                            device=dev).reshape(700, -1) for i in (0, 1))
    inf = torch.zeros(700, dtype=torch.bool, device=dev)
    inf[3:6] = True
    ks = [rng.randrange(c.fr.modulus) for _ in range(700)]
    ks[7:9] = [0, 0]
    ks[20:60] = [2] * 40
    sc = torch.as_tensor(get_ff(c.fr.name).encode_words(ks, mont=False),
                         device=dev)
    live = [(p, k) for i, (p, k) in enumerate(zip(pts, ks)) if not 3 <= i < 6]
    want = host.ec_msm(hf, [p for p, _ in live], [k for _, k in live])
    for cc in (8, 13):
        digits = bucket_digits(sc, c.fr.bits, cc, c.fp.name)
        assert torch.equal(digits, signed_digits(scalar_limbs(sc), c.fr.bits,
                                                 cc))
        got = bucket_msm(ff, b3, x, y, inf, digits, cc)
        assert _proj_equal(ff, got, bucket_msm_plain(ff, b3, x, y, inf,
                                                     digits, cc))
        Wd = digits.shape[0]
        Rr = bucket_reduce(ff, b3, got, Wd, cc)
        assert _proj_equal(ff, Rr, bucket_reduce_plain(ff, b3, got, Wd, cc))
        assert _to_affine_host(ff, hf, "proj", Rr) == want


def test_bls12_377_proofs_card_equal_cpu(dev):
    """The cubic over BLS12-377: the Groth16 setup and prove on the card
    equal the CPU's under the same seeds (keys and proof), and the PLONK
    proof on the card equals the CPU's on the same keys moved there; both
    verify."""
    import dataclasses

    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import groth16, kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import Cubic
    from gnark_tpu_torch.frontend import compile_circuit, witness
    from gnark_tpu_torch.frontend.scs import SCSBuilder

    cs = compile_circuit(Cubic(), fields.BLS12_377_FR)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proofs = {}
    for d in (dev, "cpu"):
        rng = random.Random(41)
        pk, vk = groth16.setup(cs, "bls12_377", rng=rng, device=d)
        proofs[d] = groth16.prove(cs, pk, pub, sec, rng=rng, device=d)
        assert groth16.verify(proofs[d], vk, pub)
    assert proofs[dev] == proofs["cpu"]

    cs = compile_circuit(Cubic(), fields.BLS12_377_FR,
                         builder_cls=SCSBuilder)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    srs = kzg.setup_srs("bls12_377", 64, rng=random.Random(43), device=dev)
    pk, vk = plonk.setup(cs, srs)
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(44), device=dev)
    want = plonk.prove(cs, pk.to("cpu"), pub, sec, rng=random.Random(44),
                       device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert plonk.verify(got, vk, pub)


def test_bw6_761_scalar_field_kernels(dev):
    """BW6-761's 12-word scalar field: K1's product and (a*b - c)*d on
    lazy inputs, K5 whole transforms from 2^1 to 2^13, K2 four-step
    transforms at 2^12 and 2^13 (rows of 2^7 and 2^6) and rows of 2^12
    (a global pass, then 2^11 segments: 2^12 does not fit a block at 12
    words), each against its plain version, bit-exact."""
    f = get_ff("bw6_761_fr")
    n = 5000
    a, b = _lazy_words(f, n, 3, dev), _lazy_words(f, n, 4, dev)
    for bb in (b, b[:1]):
        assert torch.equal(mont_mul(f, a, bb), mont_mul_plain(f, a, bb))
        assert torch.equal(mont_mul_sub_mul(f, a, b, a, bb),
                           mont_mul_sub_mul_plain(f, a, b, a, bb))
    for k in range(1, 14):
        m = 1 << k
        tw = torch.as_tensor(np.concatenate(stage_twiddles(
            f, m, f.p.root_of_unity(m))), device=dev)
        x = _lazy_words(f, m, k, dev)
        assert torch.equal(radix2_ntt(f, x, tw), radix2_ntt_plain(f, x, tw))
    for k in (12, 13):
        plan = FourStep(f, 1 << k, f.p.root_of_unity(1 << k), dev)
        x = _lazy_words(f, 1 << k, 20 + k, dev)
        assert torch.equal(fourstep_ntt(plan, x, x, x[:1]),
                           fourstep_ntt_plain(plan, x, x, x[:1]))
    S = 1 << 12
    assert fourstep.row_plan(S, f.nw) == ((1,), 11)
    pw = torch.as_tensor(root_powers(f, S, f.p.root_of_unity(S)),
                         device=dev)
    xr = _lazy_words(f, 4 * S, 31, dev).reshape(4, S, f.nw)
    assert torch.equal(row_fft(f, xr, pw), row_fft_plain(f, xr, pw))


def test_bw6_761_proof_card_equals_cpu(dev):
    """The cubic over BW6-761: the Groth16 setup and prove on the card
    equal the CPU's under the same seeds (keys and proof), and both
    verify; PLONK over BW6-761 on the card raises before any work."""
    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import Cubic
    from gnark_tpu_torch.frontend import compile_circuit, witness
    from gnark_tpu_torch.frontend.scs import SCSBuilder

    cs = compile_circuit(Cubic(), fields.BW6_761_FR)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proofs, keys = {}, {}
    for d in (dev, "cpu"):
        rng = random.Random(61)
        pk, vk = groth16.setup(cs, "bw6_761", rng=rng, device=d)
        keys[d] = [a.cpu() for k in ("g1_a", "g1_b", "g1_z", "g1_k", "g2_b")
                   for a in getattr(pk, k)]
        proofs[d] = groth16.prove(cs, pk, pub, sec, rng=rng, device=d)
        assert groth16.verify(proofs[d], vk, pub)
        assert not groth16.verify(proofs[d], vk, [36])
    assert all(torch.equal(u, v) for u, v in zip(keys[dev], keys["cpu"]))
    assert proofs[dev] == proofs["cpu"]
    cs = compile_circuit(Cubic(), fields.BW6_761_FR, builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bw6_761", 16, rng=random.Random(43), device=dev)
    with pytest.raises(ValueError, match="by_inv"):
        plonk.setup(cs, srs)


def _host_points_of(ff, hf, x, y, Z, shape):
    from gnark_tpu_torch.backend.groth16 import _host_points
    inf = (Z == 0).all(-1)
    return _host_points(ff, x.reshape(shape), y.reshape(shape), inf)


def _dev_rows(ff, n, seed, dev, zeros=()):
    """n random canonical rows made on the card (the top word cut below
    0x30000000, so < p), p added to every third one, the given rows zero
    (0 and p in turn)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = torch.randint(0, 1 << 32, (n, ff.nw), dtype=torch.int64,
                      device=dev, generator=g)
    w[:, -1] &= 0x2FFFFFFF
    lift = torch.arange(1, n, 3, device=dev)
    carry = torch.zeros_like(lift)
    for i in range(ff.nw):
        s = w[lift, i] + ((ff.p.modulus >> (32 * i)) & 0xFFFFFFFF) + carry
        w[lift, i], carry = s & 0xFFFFFFFF, s >> 32
    z = torch.as_tensor(list(zeros), dtype=torch.int64, device=dev)
    w[z] = 0
    w[z[::2]] = torch.tensor([(ff.p.modulus >> (32 * i)) & 0xFFFFFFFF
                              for i in range(ff.nw)], device=dev)
    return w.to(torch.int32)


def _scan_plain(ff, a, chunk=1 << 22):
    """scan_mul_plain in pieces of `chunk` rows, each times the prefix
    before it by the plain product (2^24 rows at once would need 32 GB a
    temporary of the plain product)."""
    out, carry = [], None
    for s in range(0, a.shape[0], chunk):
        y = ff_ops.scan_mul_plain(ff, a[s:s + chunk])
        if carry is not None:
            y = mont_mul_plain(ff, y, carry)
        carry = y[-1:]
        out.append(y)
    return torch.cat(out)


T_INV, T_SCAN = 2048, 8192     # ff_ops.INV_TILE (8 rows a thread), SCAN_TILE


@pytest.mark.parametrize("n, zeros", [
    (3 * T_INV + 5, range(T_INV, 2 * T_INV)),          # a tile of zeros
    (2 * T_INV + 3, range(2 * T_INV + 3)),             # all zeros
    (5000, [i for i in range(5000) if i != 3001]),     # one nonzero row
    (T_INV - 1, ()), (T_INV, (5,)), (T_INV + 1, (T_INV,)),
    (256 * T_INV, ()), (256 * T_INV + 1, (7,)),         # pass 2: 256 threads
    (1 << 21, range(0, 1 << 21, 4099))])               # the openings' 2N
def test_batch_inv_edges(dev, n, zeros):
    """K11 (three launches, one inversion a call) against its plain
    version: zero rows and tiles, either side of each pass's tile (below
    one wave of threads K11 takes 8 rows a thread, 2048 a tile; 2^21
    takes longer tiles)."""
    f = get_ff("bn254_fr")
    a = _dev_rows(f, n, n, dev, zeros)
    assert torch.equal(ff_ops.batch_inv(f, a), ff_ops.batch_inv_plain(f, a))


@pytest.mark.parametrize("n, zeros", [
    (5 * T_SCAN + 7, (3 * T_SCAN + 100,)),   # every later prefix is 0
    (1, ()), (T_SCAN - 1, ()), (T_SCAN, ()), (T_SCAN + 1, ()),
    (1 << 20, ()), ((1 << 22) + 1, ()),
    ((1 << 24) + 3, ())])                    # 2,049 tiles: many waves
def test_scan_mul_edges(dev, n, zeros):
    """K12 (one launch, decoupled look-back) against its plain version."""
    f = get_ff("bn254_fr")
    a = _dev_rows(f, n, n + 1, dev, zeros)
    got = ff_ops.scan_mul(f, a)
    assert torch.equal(got, _scan_plain(f, a))
    if zeros:
        assert not got[:zeros[0]].eq(0).all(dim=1).any()


@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("n", [1, 256, 257, (1 << 18) + 1])
def test_dot_many(dev, n, k):
    """K13 (one launch for up to eight columns) against its plain
    version: columns of unequal lengths (n, n - 1, ...), nine columns in
    two launches; dot, its one-column case, with and without b."""
    f = get_ff("bn254_fr")
    pows = _dev_rows(f, n, 3 * n, dev)
    cols = [_dev_rows(f, max(n - j, 1), 3 * n + 1 + j, dev)
            for j in range(k)]
    was = ff_ops.dot_many.launches
    assert torch.equal(ff_ops.dot_many(f, cols, pows),
                       ff_ops.dot_many_plain(f, cols, pows))
    assert ff_ops.dot_many.launches - was == -(-k // ff_ops.DOT_K)
    assert torch.equal(ff_ops.dot(f, cols[0], pows),
                       ff_ops.dot_plain(f, cols[0], pows))
    assert torch.equal(ff_ops.dot(f, pows), ff_ops.dot_plain(f, pows))


def _num_case(f, n, period, dev):
    """K14's inputs at n rows: lazy columns, points x = c w, a Z_H table
    of `period` entries, challenges (seeded)."""
    q = f.p.modulus
    rng = random.Random(n * 8 + period)
    cols = {k: _dev_rows(f, n, rng.randrange(1 << 30), dev)
            for k in plonk_num.NUM_COLS}
    zh = tuple(rng.randrange(1, q) for _ in range(period))
    pts = plonk_num.NumPoints(_dev_rows(f, n, rng.randrange(1 << 30), dev),
                              rng.randrange(1, q), zh,
                              tuple(pow(v, -1, q) for v in zh),
                              ("card test", n, period))
    s = {k: rng.randrange(q) for k in ("beta", "gamma", "alpha", "u")}
    s.update(alpha2=s["alpha"] ** 2 % q, u2=s["u"] ** 2 % q,
             Ninv=rng.randrange(1, q))
    return cols, pts, s


@pytest.mark.parametrize("period", [1, 4])
@pytest.mark.parametrize("n", [1, 255, 256, 257, (1 << 16) + 3])
def test_plonk_numerator(dev, n, period):
    """K14 against its plain version and against the K1 / K10 / K11
    sequence it replaced (numerator_plain with kernels=True), lazy
    inputs, one Z_H (the rho path) or a period-4 table (the coset)."""
    f = get_ff("bn254_fr")
    cols, pts, s = _num_case(f, n, period, dev)
    x = pts.x(f)
    zh, zhi = pts.table(f, pts.zh), pts.table(f, pts.zhi)
    was = plonk_num.plonk_numerator.launches
    got = plonk_num.plonk_numerator(f, cols, pts, s)
    assert plonk_num.plonk_numerator.launches - was == 1
    assert torch.equal(got, plonk_num.numerator_plain(f, cols, x, zh, zhi,
                                                      s))
    assert torch.equal(got, plonk_num.numerator_plain(f, cols, x, zh, zhi,
                                                      s, kernels=True))


@pytest.mark.parametrize("name", ["bn254_fp", "bn254_fr"])
def test_mont_mul_sub_mul(dev, name):
    f = get_ff(name)
    a, b, c, d = (_words(f, 4093, s, dev) for s in range(4))
    for dd in (d, d[:1]):
        assert torch.equal(mont_mul_sub_mul(f, a, b, c, dd),
                           mont_mul_sub_mul_plain(f, a, b, c, dd))


@pytest.mark.parametrize("g2", [False, True])
def test_affine_words(dev, g2):
    """K1's affine kernel against the plain Fermat chain on 509 Jacobian
    points (infinity, Z = 1, X in [p, 2p), random Z), bit-exact, and on
    them tiled 1024 times; the edge rows against the host."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(14)
    base = [gen]
    for _ in range(15):
        base.append(host.ec_add(hf, base[-1], gen))
    pts = [base[rng.randrange(16)] for _ in range(509)]
    pts[0] = host.INF
    X, Y, Z = _jac_words(ff, hf, pts, rng, dev, 40)
    X[1], Y[1] = (torch.as_tensor(ff.encode_words([pts[1][i]]), device=dev)
                  .reshape(-1) for i in (0, 1))
    Z[1] = torch.as_tensor(ff.encode_words([(1, 0) if g2 else 1]),
                           device=dev).reshape(-1)
    got = affine_words(ff, (X, Y, Z))
    assert all(torch.equal(u, v)
               for u, v in zip(got, affine_words_plain(ff, (X, Y, Z))))
    # tiled past the kernel's threads: each batch inversion spans points
    big = affine_words(ff, tuple(a.repeat(1024, 1) for a in (X, Y, Z)))
    assert all(torch.equal(u, v.repeat(1024, 1)) for u, v in zip(big, got))
    assert int(got[0][0].abs().sum() + got[1][0].abs().sum()) == 0
    shp = (-1, 2, 8) if g2 else (-1, 8)
    for i in range(1, 8):
        xs, ys = (ff.decode_words(a[i:i + 1].reshape(shp).cpu())
                  for a in got)
        pt = (tuple(int(c) for c in xs[0]), tuple(int(c) for c in ys[0])) \
            if g2 else (int(xs[0]), int(ys[0]))
        assert pt == pts[i]


def test_radix2_ntt(dev):
    """Whole K5 transforms at every n from 2^1 to 2^13 (a third of the
    inputs in [p, 2p)), forward and inverse, bit-exact against the plain
    transform, in at most two launches each."""
    f = get_ff("bn254_fr")
    q = f.p.modulus
    rng = random.Random(15)
    for k in range(1, 14):
        n = 1 << k
        vals = [rng.randrange(q) for _ in range(n)]
        vals = [v + q if i % 3 == 0 else v for i, v in enumerate(vals)]
        x = torch.frombuffer(bytearray(b"".join(
            v.to_bytes(32, "little") for v in vals)), dtype=torch.int32) \
            .reshape(n, 8).to(dev)
        w = f.p.root_of_unity(n)
        for ww in (w, pow(w, -1, q)):
            tw = torch.as_tensor(np.concatenate(stage_twiddles(f, n, ww)),
                                 device=dev)
            before = radix2_ntt.launches
            got = radix2_ntt(f, x, tw)
            assert radix2_ntt.launches - before == ntt_launches(n) <= 2
            assert torch.equal(got, radix2_ntt_plain(f, x, tw))


@pytest.mark.parametrize("g2", [False, True])
def test_chunked_msm_matches_single(dev, g2, monkeypatch):
    """K4's int32 offsets cap a chunk's (window, point) pairs at
    msm/bucket.MAX_PAIRS; with the cap forced down, a 600-point MSM
    runs in chunks (folded by K3) and equals the single-shot MSM."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(16)
    base = [gen]
    for _ in range(31):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 600
    pts = [base[rng.randrange(32)] for _ in range(n)]
    x, y = (torch.as_tensor(ff.encode_words([p[i] for p in pts]),
                            device=dev).reshape(n, -1) for i in (0, 1))
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[3:6] = True
    ks = [rng.randrange(CURVE.fr.modulus) for _ in range(n)]
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False),
                         device=dev)
    one = bucket_mod.msm_proj(ff, (x, y, inf), sc, CURVE.fr.bits,
                              b3=group_b3(CURVE, g2))
    monkeypatch.setattr(bucket_mod, "MAX_PAIRS", 6000)
    plan = bucket_mod.chunk_plan(n, CURVE.fr.bits, dev)
    assert len(plan) > 1
    before = bucket_msm.launches
    chunked = bucket_mod.msm_proj(ff, (x, y, inf), sc, CURVE.fr.bits,
                                  b3=group_b3(CURVE, g2))
    assert bucket_msm.launches - before == len(plan)
    assert _to_affine_host(ff, hf, "proj", chunked) == \
        _to_affine_host(ff, hf, "proj", one) != host.INF


def test_row_fft_and_fourstep(dev, monkeypatch):
    monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", "11")
    f = get_ff("bn254_fr")
    for S in (2, 512, 1024, 4096):
        x = _words(f, 4 * S, S, dev).reshape(4, S, f.nw)
        pw = torch.as_tensor(root_powers(f, S, f.p.root_of_unity(S)),
                             device=dev)
        assert torch.equal(row_fft(f, x, pw), row_fft_plain(f, x, pw))
    n = 1 << 11
    x = _words(f, n, 3, "cpu")
    dg, dc = Domain(f, n, dev), Domain(f, n, "cpu")
    for coset in (False, True):
        assert torch.equal(dg.fft(x.to(dev), coset).cpu(), dc.fft(x, coset))
        assert torch.equal(dg.ifft(x.to(dev), coset).cpu(),
                           dc.ifft(x, coset))


def _transforms(dom, x):
    """(name, kernel output, twin output) of fft / ifft, plain and coset,
    on Domain dom's four-step plans."""
    out = []
    for inv in (False, True):
        plan = dom._plan(inv)
        assert isinstance(plan, FourStep)
        for coset in (False, True):
            pre = dom._coset if coset and not inv else None
            post = None if not inv else (dom._coset_inv_ninv if coset
                                         else dom._ninv)
            got = (dom.ifft if inv else dom.fft)(x, coset=coset)
            out.append((f"{'i' if inv else ''}fft coset={coset}", got,
                        fourstep_ntt_plain(plan, x, pre, post)))
    return out


@pytest.mark.parametrize("k", [14, 15, 16])
def test_fourstep_two_launches(dev, k):
    """Domain.fft / ifft, plain and coset, at 2^14-2^16: two K2 launches
    each, no K1, bit-exact against the plain four-step sequence; a third
    of the inputs in [p, 2p)."""
    f = get_ff("bn254_fr")
    n = 1 << k
    q = f.p.modulus
    x = _words(f, n, k, dev)
    x[::3] = _raw_scalars([int(v) + q for v in f.decode_words(
        x[::3].cpu(), mont=False)], dev)
    dom = Domain(f, n, dev)
    k0, m0 = fourstep_ntt.launches, mont_mul.launches
    for name, got, want in _transforms(dom, x):
        assert torch.equal(got, want), name
    assert fourstep_ntt.launches - k0 == 8 and mont_mul.launches == m0


@pytest.mark.parametrize("k, cap", [(12, 3), (13, 4), (9, 2)])
def test_fourstep_global_passes(dev, k, cap, monkeypatch):
    """With the shared-memory cap lowered, rows longer than 2^cap run
    their first stages as global register passes: bit-exact against the
    twin, and one launch more a pass."""
    monkeypatch.setattr(fourstep, "SMEM_LOG", cap)
    monkeypatch.setenv("GNARK_TPU_NTT_FOURSTEP_LOG", "1")
    f = get_ff("bn254_fr")
    n = 1 << k
    dom = Domain(f, n, dev)
    plan = dom._plan(False)
    npass = sum(len(rp[0]) for rp in plan.rplan)
    assert npass > 0
    x = _words(f, n, k, dev)
    k0 = fourstep_ntt.launches
    for name, got, want in _transforms(dom, x):
        assert torch.equal(got, want), name
    assert fourstep_ntt.launches - k0 == 4 * (2 + npass)
    S = 1 << (cap + 2)
    xr = _words(f, 3 * S, 7, dev).reshape(3, S, f.nw)
    pw = torch.as_tensor(root_powers(f, S, f.p.root_of_unity(S)),
                         device=dev)
    assert torch.equal(row_fft(f, xr, pw), row_fft_plain(f, xr, pw))


def test_seg_smem_matches_kernel(dev):
    """fourstep.seg_smem_bytes, the host's copy of the segment block's
    shared-memory size that the row_plan fault tests read, against the
    kernel's own formula (gt_fs_smem) at every segment log."""
    for field in ("bn254_fr", "bw6_761_fr"):         # 8 and 12 words
        smem = cuda.lib("row_fft", field).gt_fs_smem
        smem.restype = ctypes.c_longlong
        nw = cuda.KERNEL_FIELDS[field].nw
        for G in range(1, fourstep.SMEM_LOG + 1):
            assert smem(G) == fourstep.seg_smem_bytes(G, nw), (field, G)


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


def _proj_equal(ff, A, B):
    X1, Y1, Z1 = (_limbs(ff, a) for a in A)
    X2, Y2, Z2 = (_limbs(ff, a) for a in B)
    return (torch.equal(ff.is_zero(Z1), ff.is_zero(Z2))
            and torch.equal(ff.mul(X1, Z2), ff.mul(X2, Z1))
            and torch.equal(ff.mul(Y1, Z2), ff.mul(Y2, Z1)))


def test_bucket_digits(dev):
    f = get_ff(CURVE.fr.name)
    rng = random.Random(6)
    ks = [rng.randrange(CURVE.fr.modulus) for _ in range(997)] + \
        [0, 1, CURVE.fr.modulus - 1]
    sc = torch.as_tensor(f.encode_words(ks, mont=False), device=dev)
    for c in range(2, 17):
        assert torch.equal(bucket_digits(sc, CURVE.fr.bits, c, CURVE.fp.name),
                           signed_digits(scalar_limbs(sc), CURVE.fr.bits, c))


@pytest.mark.parametrize("g2", [False, True])
@pytest.mark.parametrize("c", [5, 13, 16])
def test_bucket_msm_width_and_reduce(dev, g2, c):
    """K4 at width c against its plain version; K9 on its bucket sums
    against its plain version and the host's MSM."""
    ff, hf, b3, gen = _group(g2)
    rng = random.Random(c)
    base = [gen]
    for _ in range(31):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 700
    pts = [base[rng.randrange(32)] for _ in range(n)]
    x, y = (torch.as_tensor(ff.encode_words([p[i] for p in pts]),
                            device=dev).reshape(n, -1) for i in (0, 1))
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[3:6] = True
    ks = [rng.randrange(CURVE.fr.modulus) for _ in range(n)]
    ks[7:9] = [0, 0]
    ks[20:60] = [2] * 40                          # skew: one bucket
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False),
                         device=dev)
    digits = bucket_digits(sc, CURVE.fr.bits, c, CURVE.fp.name)
    got = bucket_msm(ff, b3, x, y, inf, digits, c)
    assert _proj_equal(ff, got, bucket_msm_plain(ff, b3, x, y, inf, digits,
                                                 c))
    W = digits.shape[0]
    R = bucket_reduce(ff, b3, got, W, c)
    assert _proj_equal(ff, R, bucket_reduce_plain(ff, b3, got, W, c))
    live = [(p, k) for i, (p, k) in enumerate(zip(pts, ks)) if not 3 <= i < 6]
    assert _to_affine_host(ff, hf, "proj", R) == host.ec_msm(
        hf, [p for p, _ in live], [k for _, k in live])


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


def _raw_scalars(vals, dev):
    """Ints below 2^256 -> (n, 8) int32 words as they are
    (encode_words(..., mont=False) reduces mod r: r would become 0)."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.frombuffer(bytearray(buf), dtype=torch.int32) \
        .reshape(len(vals), 8).to(dev)


@pytest.mark.parametrize("g2", [False, True])
def test_ladder_kernel(dev, g2):
    """The fused ladder kernel against its plain version (the per-bit
    plain K7 + K6) at 254 bits on 1,029 rows, bit-exact: 0, 1, r - 1, r
    (P == -A at the last add) and r + 2 (P == A, the doubling branch),
    then random scalars; the edge rows against the host."""
    ff, hf, _, gen = _group(g2)
    r = CURVE.fr.modulus
    rng = random.Random(12)
    ks = [0, 1, r - 1, r, r + 2] + [rng.randrange(r) for _ in range(1024)]
    sc = _raw_scalars(ks, dev)
    base = tuple(torch.as_tensor(ff.encode_words([c]), device=dev)
                 .reshape(1, -1) for c in gen)
    got = batch_scalar_mul(ff, base, CURVE.fr.bits, sc)
    want = batch_scalar_mul_plain(ff, base, CURVE.fr.bits, sc)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    for i, k in enumerate(ks[:5]):
        assert _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in got)) \
            == host.ec_mul(hf, gen, k % r)


@pytest.mark.parametrize("g2", [False, True])
def test_jac_madd_double_edges(dev, g2):
    """K6 and K7 (G2 on lane pairs) against their plain versions on 509
    points (a ragged last block): an accumulator at infinity, a masked
    operand, R == A (the doubling branch), R == -A, both at infinity, X
    in [p, 2p); per-row and broadcast operands; bit-exact, and the edge
    rows against the host."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(13)
    base = [gen]
    for _ in range(15):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 509
    P = [base[rng.randrange(16)] for _ in range(n)]
    A = [base[rng.randrange(16)] for _ in range(n)]
    inf2 = [rng.random() < 0.1 for _ in range(n)]
    P[0], inf2[0] = host.INF, False
    inf2[1] = True
    A[2], inf2[2] = P[2], False
    A[3], inf2[3] = host.ec_neg(hf, P[3]), False
    P[4], inf2[4] = host.INF, True
    Pw = _jac_words(ff, hf, P, rng, dev, 40)
    x2, y2 = (torch.as_tensor(ff.encode_words([a[i] for a in A]),
                              device=dev).reshape(n, -1) for i in (0, 1))
    gx, gy = (torch.as_tensor(ff.encode_words([c]), device=dev)
              .reshape(1, -1) for c in gen)
    mask = torch.tensor(inf2, device=dev)

    def host_row(R, i):
        return _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in R))

    for ax, ay, Ai in ((x2, y2, A), (gx, gy, [gen] * n)):
        got = jac_add_mixed(ff, Pw, ax, ay, mask)
        want = jac_add_mixed_plain(ff, Pw, ax, ay, mask)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        for i in range(8):
            assert host_row(got, i) == (P[i] if inf2[i] else
                                        host.ec_add(hf, P[i], Ai[i]))
    got = jac_double(ff, Pw)
    assert all(torch.equal(u, v) for u, v in zip(got,
                                                 jac_double_plain(ff, Pw)))
    for i in range(8):
        assert host_row(got, i) == host.ec_dbl(hf, P[i])


def _jac_words(ff, hf, pts, rng, dev, lazy=0):
    """Host affine points -> Jacobian words (x z^2, y z^3, z) with a
    random z, infinity (1, 1, 0); the first `lazy` rows get X + p."""
    g2 = hasattr(ff, "base")
    q = ff.p.modulus
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    cols = ([], [], [])
    for P in pts:
        if P is host.INF:
            for c, v in zip(cols, (one, one, zero)):
                c.append(v)
            continue
        z = (rng.randrange(1, q), rng.randrange(q)) if g2 else \
            rng.randrange(1, q)
        z2 = hf.mul(z, z)
        for c, v in zip(cols, (hf.mul(P[0], z2),
                               hf.mul(P[1], hf.mul(z2, z)), z)):
            c.append(v)
    out = [torch.as_tensor(ff.encode_words(c)).reshape(len(pts), -1)
           for c in cols]
    base = ff.base if g2 else ff
    nw = base.nw
    for i in range(lazy):          # encode_words would reduce X + p
        v = int(base.decode_words(out[0][i, :nw], mont=False)) + q
        out[0][i, :nw] = torch.frombuffer(bytearray(v.to_bytes(4 * nw,
                                                               "little")),
                                          dtype=torch.int32)
    return tuple(a.to(dev) for a in out)


@pytest.mark.parametrize("g2", [False, True])
def test_jac_add(dev, g2):
    """K8 (G2 on lane pairs) on P == Q (another Z), P == -Q, either or
    both at infinity, X in [p, 2p), random pairs; and on random words."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(8)
    base = [gen]
    for _ in range(15):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 512
    P = [base[rng.randrange(16)] for _ in range(n)]
    Q = [base[rng.randrange(16)] for _ in range(n)]
    Q[0] = host.INF
    P[1] = host.INF
    P[2] = Q[2] = host.INF
    Q[3] = P[3]
    Q[4] = host.ec_neg(hf, P[4])
    Pw, Qw = _jac_words(ff, hf, P, rng, dev, 40), _jac_words(ff, hf, Q, rng,
                                                             dev, 20)
    got, want = jac_add(ff, Pw, Qw), jac_add_plain(ff, Pw, Qw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    for i in range(8):
        assert _to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in got)) \
            == host.ec_add(hf, P[i], Q[i])
    m = 1000
    R = tuple(_words(ff.base if g2 else ff, 2 * m if g2 else m, s, dev)
              .reshape(m, -1) for s in range(6))
    got, want = jac_add(ff, R[:3], R[3:]), jac_add_plain(ff, R[:3], R[3:])
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("g2", [False, True])
def test_scan_msm_matches_bucket(dev, g2, monkeypatch):
    """A 2^12 MSM (infinity points, zero scalars, duplicates) on the scan
    path (K6, K8, K7) and on the bucket path (K4, K9): one group
    element."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(9)
    base = [gen]
    for _ in range(31):
        base.append(host.ec_add(hf, base[-1], gen))
    n = 1 << 12
    pts = [base[rng.randrange(32)] for _ in range(n)]
    x, y = (torch.as_tensor(ff.encode_words([p[i] for p in pts]),
                            device=dev).reshape(n, -1) for i in (0, 1))
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[3:6] = True
    ks = [rng.randrange(CURVE.fr.modulus) for _ in range(n)]
    ks[7:9] = [0, 0]
    ks[10] = ks[11]
    sc = torch.as_tensor(get_ff(CURVE.fr.name).encode_words(ks, mont=False),
                         device=dev)
    out = {}
    for impl in ("scan", "bucket"):
        monkeypatch.setenv("GNARK_TPU_MSM_IMPL", impl)
        kind, P = msm_raw(ff, (x, y, inf), sc, CURVE.fr.bits,
                          b3=group_b3(CURVE, g2))
        assert kind == ("jac" if impl == "scan" else "proj")
        out[impl] = _to_affine_host(ff, hf, kind, P)
    assert out["scan"] == out["bucket"] != host.INF


@pytest.mark.parametrize("g2", [False, True])
def test_jac_fold(dev, g2):
    """The group fold kernel against its plain twin, bit-exact, at W = 3,
    G = 8, B = 37 (a ragged last block): a column of equal points, one
    of P and -P, one all at infinity, X in [p, 2p); and the host's
    sums."""
    ff, hf, _, gen = _group(g2)
    rng = random.Random(17)
    base = [gen]
    for _ in range(15):
        base.append(host.ec_add(hf, base[-1], gen))
    W, G, B = 3, 8, 37
    pts = [base[rng.randrange(16)] for _ in range(W * G * B)]

    def row(w, g, b):
        return (w * G + g) * B + b

    for g in range(G):
        pts[row(0, g, 1)] = base[3]
        pts[row(2, g, 5)] = host.INF
    pts[row(1, 0, 2)], pts[row(1, 1, 2)] = base[7], host.ec_neg(hf, base[7])
    P = _jac_words(ff, hf, pts, rng, dev, 50)
    before = jac_fold.launches
    got = jac_fold(ff, P, G, B)
    assert jac_fold.launches - before == 1
    assert all(torch.equal(u, v)
               for u, v in zip(got, jac_fold_plain(ff, P, G, B)))
    for w, b in ((0, 1), (1, 2), (2, 5), (2, 36)):
        want = host.INF
        for g in range(G):
            want = host.ec_add(hf, want, pts[row(w, g, b)])
        i = w * B + b
        assert _to_affine_host(ff, hf, "jac",
                               tuple(a[i:i + 1] for a in got)) == want


def test_plonk_card_equals_cpu(dev):
    """The cubic PLONK (tests/test_torch_plonk.py's circuit) set up and
    proved on the card, and proved again on the CPU on the same keys
    moved there: the same proof bytes; verify accepts it."""
    import dataclasses

    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import kzg, plonk
    from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                          compile_circuit, witness)
    from gnark_tpu_torch.frontend.scs import SCSBuilder

    class Cubic(Circuit):
        x: Secret
        y: Public

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(api.add(x3, self.x, 5), self.y)

    cs = compile_circuit(Cubic(), fields.BN254_FR, builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bn254", 64, rng=random.Random(33), device=dev)
    pk, vk = plonk.setup(cs, srs)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(1), device=dev)
    want = plonk.prove(cs, pk.to("cpu"), pub, sec, rng=random.Random(1),
                       device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert plonk.verify(got, vk, pub)


def test_commitment_proofs_card(dev, monkeypatch):
    """A circuit with one BSB22 commitment (std/rangecheck over one
    value): its PLONK proof on the card equals the CPU's on the same
    keys (the Qcp columns and the pi2 commitment included), and its
    Groth16 proof on the scan path (K6, K7, K8) equals the bucket path's
    under the same rng (commitment and PoK included); both verify."""
    import dataclasses

    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import groth16, kzg, plonk
    from gnark_tpu_torch.backend.groth16_check import (
        RangeChecked, range_checked_assignment)
    from gnark_tpu_torch.frontend import compile_circuit, witness
    from gnark_tpu_torch.frontend.scs import SCSBuilder

    assign = range_checked_assignment(1, 5)
    cs = compile_circuit(RangeChecked(1), fields.BN254_FR,
                         builder_cls=SCSBuilder)
    assert len(cs.commitments) == 1
    pub, sec = witness(assign, cs)
    N = 1 << (cs.nb_public + cs.nb_constraints - 1).bit_length()
    srs = kzg.setup_srs("bn254", N + 8, rng=random.Random(0), device=dev)
    pk, vk = plonk.setup(cs, srs)
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(1), device=dev)
    with monkeypatch.context() as m:
        m.setenv("GNARK_TPU_MSM_C", "4")     # the plain epilogue's time
        want = plonk.prove(cs, pk.to("cpu"), pub, sec, rng=random.Random(1),
                           device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert plonk.verify(got, vk, pub)

    cs = compile_circuit(RangeChecked(1), fields.BN254_FR)
    assert len(cs.commitments) == 1
    pub, sec = witness(assign, cs)
    pk, vk = groth16.setup(cs, "bn254", rng=random.Random(2), device=dev)
    proofs = {}
    for impl in ("scan", "bucket"):
        monkeypatch.setenv("GNARK_TPU_MSM_IMPL", impl)
        proofs[impl] = groth16.prove(cs, pk, pub, sec, rng=random.Random(3),
                                     device=dev)
    assert proofs["scan"] == proofs["bucket"]
    assert groth16.verify(proofs["bucket"], vk, pub)


def test_rho_and_coset_quotients_equal(dev, monkeypatch):
    """The cubic PLONK proved on the card on the 4N coset (one K14
    launch) and, with RHO_MIN_LOG lowered, on the four N-point shifts
    (four): the same proof."""
    import dataclasses

    from gnark_tpu_torch import fields
    from gnark_tpu_torch.backend import kzg, plonk, plonk_device
    from gnark_tpu_torch.frontend import (Circuit, Public, Secret,
                                          compile_circuit, witness)
    from gnark_tpu_torch.frontend.scs import SCSBuilder

    class Cubic(Circuit):
        x: Secret
        y: Public

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(api.add(x3, self.x, 5), self.y)

    cs = compile_circuit(Cubic(), fields.BN254_FR, builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bn254", 64, rng=random.Random(33), device=dev)
    pk, vk = plonk.setup(cs, srs)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proofs = []
    for rho_log, launches in ((30, 1), (0, 4)):
        monkeypatch.setattr(plonk_device, "RHO_MIN_LOG", rho_log)
        was = plonk_num.plonk_numerator.launches
        proofs.append(plonk.prove(cs, pk, pub, sec, rng=random.Random(1),
                                  device=dev))
        assert plonk_num.plonk_numerator.launches - was == launches
    assert dataclasses.asdict(proofs[0]) == dataclasses.asdict(proofs[1])
    assert plonk.verify(proofs[1], vk, pub)

