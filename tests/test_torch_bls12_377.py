"""BLS12-377 in gnark_tpu_torch, against the reference and the host:
the kernels' field table and build variants (a 12-word Fp whose Fp2
takes u^2 = -5, GT_NR_ABS = 5 of csrc/mont.cuh; the scalar field on
BN254's 8-word lazy builds), the bindings each wrapper reaches, the
device Fp2 code of csrc/mont.cuh and csrc/fp2s.cuh compiled for the
host by g++ (one thread an Fp2, and a lane pair as two threads) on
operands up to 2p - 1 against the reference's FF2, the port's FF2 at
u^2 = -5 against the reference's, the bucket MSM and the 16-bit ladder
against the host oracle, the NTT against the reference's Domain, and a
CPU PLONK proof that the reference's verify accepts. Slow tier: the
PLONK proof equal to the reference's byte for byte.

Sizes stay small (at most 2^10 points or a 2^10 domain, ladders at 16
bits). Tolerance: exact equality (canonical Montgomery words, host
affine points, proof bytes); the device code's outputs are lazy, < 2p,
and equal the reference's after one conditional subtract of p."""

import ctypes
import dataclasses
import functools
import pathlib
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_tpu import fields as ref_fields
from gnark_tpu.backend import kzg as ref_kzg
from gnark_tpu.backend import plonk as ref_plonk
from gnark_tpu.ec import curves as ref_curves
from gnark_tpu.ec.fp2 import get_ff2 as ref_get_ff2
from gnark_tpu.ff import get_ff as ref_get_ff
from gnark_tpu.frontend import Circuit as RefCircuit
from gnark_tpu.frontend import Public as RefPublic
from gnark_tpu.frontend import Secret as RefSecret
from gnark_tpu.frontend import compile_circuit as ref_compile
from gnark_tpu.frontend import witness as ref_witness
from gnark_tpu.frontend.scs import SCSBuilder as RefSCSBuilder
from gnark_tpu.ntt import Domain as RefDomain
from gnark_tpu_torch import cuda, fields
from gnark_tpu_torch.backend import groth16, kzg, plonk, plonk_num
from gnark_tpu_torch.ec import curves, host, jac_ec, proj_ec
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ec.proj_ec import kernel_field, lib_field
from gnark_tpu_torch.ff import get_ff, mont_mul, ops
from gnark_tpu_torch.frontend import Circuit, Public, Secret
from gnark_tpu_torch.frontend import compile_circuit, witness
from gnark_tpu_torch.frontend.scs import SCSBuilder
from gnark_tpu_torch.msm import bucket, fixed_base, msm
from gnark_tpu_torch.ntt import Domain, fourstep, radix2

torch.set_num_threads(2)

CURVE = curves.CURVES["bls12_377"]
FP, FR = CURVE.fp.name, CURVE.fr.name
R = CURVE.fr.modulus
CSRC = pathlib.Path(cuda.__file__).resolve().parent / "csrc"


class Cubic(Circuit):
    x: Secret
    y: Public

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


class RefCubic(RefCircuit):
    x: RefSecret
    y: RefPublic

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(api.add(x3, self.x, 5), self.y)


# ---------------------------------------------------------------------------
# the field table, the constants, the builds and the bindings
# ---------------------------------------------------------------------------

def test_kernel_fields_and_builds_take_bls12_377():
    """BLS12-377's Fp is a 12-word lazy base field with u^2 = -5, its
    Fr an 8-word lazy scalar field; the builds are 35 libraries (27
    before BW6-761's eight), each with its own name and hash, and nr5
    only on BLS12-377's base field, whose Fr shares BN254's w8 builds;
    an empty list of builds starts no nvcc."""
    fp, fr = cuda.KERNEL_FIELDS[FP], cuda.KERNEL_FIELDS[FR]
    assert (fp.nw, fp.sound, fp.base, fp.nr) == (12, False, True, -5)
    assert (fr.nw, fr.sound, fr.base) == (8, False, False)
    assert (CURVE.fp2_nr + 5) % CURVE.fp.modulus == 0
    pairs = cuda.builds()
    assert len(pairs) == len(set(pairs)) == 35
    names = [cuda._target(s, v).name for s, v in pairs]
    assert len(set(names)) == 35
    assert len({n.rsplit("-", 1)[1] for n in names}) == 35     # hashes
    nr5 = [(s, v) for s, v in pairs if "nr5" in v.tag]
    assert nr5 == [(s, cuda.variant(FP)) for s in cuda.BASE_SOURCES]
    assert "-DGT_NR_ABS=5" in cuda.variant(FP).flags
    assert cuda.variant(FP).tag == "w12-nr5"
    assert cuda.variant(FR) == cuda.variant("bn254_fr")
    assert cuda.variant(FR).tag == "w8"
    assert cuda.builds([FP, FR])[:6] == nr5
    assert {v.nr_abs for f in cuda.KERNEL_FIELDS if f != FP
            for v in [cuda.variant(f)]} == {0, 1}
    assert [f for f in cuda.KERNEL_FIELDS
            if cuda.variant(f).nr_abs == 0] == ["bw6_761_fp"]
    # a curve whose libraries are all built by another's list starts none
    assert cuda.start_builds([])["jobs"] == {}


@pytest.mark.parametrize("name", [FP, FR])
def test_field_consts_layout(name):
    """FieldC at 4 nw + 1 words: p | 2p | R mod p | n0 | R^3 mod p, n0
    the 32-bit REDC constant (p n0 = -1 mod 2^32), R = 2^(32 nw)."""
    nw = cuda.KERNEL_FIELDS[name].nw
    c = cuda.field_consts(name)
    p = fields.FIELDS[name].modulus
    assert c.shape == (4 * nw + 1,) and c.dtype == np.uint32

    def val(i):
        return sum(int(c[i * nw + k]) << (32 * k) for k in range(nw))
    big = 1 << (32 * nw)
    assert (val(0), val(1), val(2)) == (p, 2 * p, big % p)
    assert 4 * p < big                                  # the lazy class
    assert int(c[3 * nw]) * p % (1 << 32) == (1 << 32) - 1
    r3 = sum(int(c[3 * nw + 1 + k]) << (32 * k) for k in range(nw))
    assert r3 == pow(big, 3, p)


def test_the_card_takes_bls12_377_and_refuses_bw6_761():
    """check_curve takes BLS12-377 on the card (both fields, u^2 = -5),
    for Groth16 and PLONK; BW6-761 for Groth16 only: PLONK over it is
    refused before any work (K11's inverse takes 8-word fields, its Fr
    has 12). The Fp2 kernels over BLS12-377's Fp take u^2 = -5 only;
    BW6-761's fields take their 24- and 12-word constants."""
    card = torch.device("cuda")
    for name in ("bn254", "bls12_381", "bls12_377"):
        cuda.check_curve(curves.CURVES[name], card, plonk=True)
    cuda.check_curve(curves.CURVES["bw6_761"], card)
    with pytest.raises(ValueError, match="by_inv"):
        cuda.check_curve(curves.CURVES["bw6_761"], card, plonk=True)
    cuda.check_curve(curves.CURVES["bw6_761"], torch.device("cpu"),
                     plonk=True)
    assert kernel_field(get_ff2(FP, -5)).shape == (49,)
    assert kernel_field(get_ff(FR)).shape == (33,)
    with pytest.raises(ValueError):
        kernel_field(get_ff2(FP, -1))
    assert [cuda.field_consts(f).shape for f in ("bw6_761_fp",
                                                 "bw6_761_fr")] == \
        [(97,), (49,)]
    with pytest.raises(ValueError):
        cuda.field_consts("grumpkin_fr")


class _Lib:
    """A stand-in for a loaded library: every entry point a no-op."""

    def __getattr__(self, name):
        def fn(*args):
            return 0
        return fn


BINDERS = [  # (module, binder, arguments before the field, base field)
    (mont_mul, "_fn", (), False), (mont_mul, "_sub_fn", (), False),
    (fixed_base, "_affine_fn", (), True), (fixed_base, "_ladder_fn", (), True),
    (proj_ec, "_add_fn", (), True), (proj_ec, "_dbl_fn", (), True),
    (jac_ec, "_madd_fn", (), True), (jac_ec, "_dbl_fn", (), True),
    (jac_ec, "_add_fn", (), True), (jac_ec, "_fold_fn", (), True),
    (bucket, "_k4", ("gt_bucket_acc",), True),
    (bucket, "_digits_fn", (), True), (bucket, "_k9", (), True),
    (fourstep, "_seg_fn", (), False), (fourstep, "_pass_fn", (), False),
    (radix2, "_seg_fn", (), False), (radix2, "_pass_fn", (), False),
    (ops, "_fn", ("gt_batch_inv",), False), (plonk_num, "_fn", (), False),
]


def test_every_binding_reaches_a_bls12_377_build(monkeypatch):
    """Each wrapper's binding, for the field its wrapper passes over
    BLS12-377 (lib_field of Fp or Fp2 for the point kernels, the scalar
    field's name for the others), loads the w12-nr5 library of its
    source, or BN254's w8 one."""
    seen = []

    def lib(name, v):
        seen.append((name, v.tag))
        return _Lib()
    monkeypatch.setattr(cuda, "_lib", lib)
    for mod, binder, args, base in BINDERS:
        fn = getattr(mod, binder).__wrapped__
        fields_ = [lib_field(get_ff(FP)), lib_field(get_ff2(FP, -5))] \
            if base else [get_ff(FR).p.name]
        for f in fields_:
            seen.clear()
            fn(*args, f)
            assert seen == [(seen[0][0], "w12-nr5" if base else "w8")], \
                (mod.__name__, binder)


# ---------------------------------------------------------------------------
# the device Fp2 code, built for the host by g++
# ---------------------------------------------------------------------------

STUB = r'''
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
inline uint4 __ldcg(const uint4* p) { return *p; }
struct dim3 { unsigned x, y, z; };
extern thread_local dim3 threadIdx;
unsigned __shfl_xor_sync(unsigned mask, unsigned v, int m);
int __all_sync(unsigned mask, int b);
'''

HARNESS = r'''
#include <barrier>
#include <thread>
#include "fp2s.cuh"
thread_local dim3 threadIdx;
static unsigned slot[2];
static std::barrier<>* bar;
unsigned __shfl_xor_sync(unsigned, unsigned v, int m) {
  const int l = threadIdx.x & 1;
  slot[l] = v;
  bar->arrive_and_wait();
  const unsigned r = slot[l ^ m];
  bar->arrive_and_wait();
  return r;
}
int __all_sync(unsigned, int b) {
  const int l = threadIdx.x & 1;
  slot[l] = b;
  bar->arrive_and_wait();
  const int r = slot[0] && slot[1];
  bar->arrive_and_wait();
  return r;
}
static Fp2 get(const uint32_t* g) { Fp2 r; ld(r, g); return r; }
// op 0: a c, 1: a^2, 2: a c + d e, 3: K1's G2 norm of a (in c0)
extern "C" void one_thread(int op, const uint32_t* a, const uint32_t* c,
                           const uint32_t* d, const uint32_t* e,
                           uint32_t* out, long long n, const uint32_t* k) {
  const FieldC F = field_from_host(k);
  for (long long i = 0; i < n; ++i) {
    const long long o = 2 * GT_NW * i;
    Fp2 r;
    if (op == 0) r = mul_lazy(get(a + o), get(c + o), F);
    if (op == 1) r = sqr_lazy(get(a + o), F);
    if (op == 2) r = sop2(get(a + o), get(c + o), get(d + o), get(e + o), F);
    if (op == 3) {
      const Fp2 z = get(a + o);
      r.c0 = add2p(sqr_lazy(z.c0, F), mul_nr_abs(sqr_lazy(z.c1, F), F), F);
      set_zero(r.c1);
    }
    st(out + o, r);
  }
}
// ops 0-2 on a lane pair (fp2s.cuh): two threads, one component each
extern "C" void lane_pair(int op, const uint32_t* a, const uint32_t* c,
                          const uint32_t* d, const uint32_t* e,
                          uint32_t* out, long long n, const uint32_t* k) {
  const FieldC F = field_from_host(k);
  std::barrier<> b2(2);
  bar = &b2;
  auto lane = [&](unsigned t) {
    threadIdx.x = t;
    for (long long i = 0; i < n; ++i) {
      const long long o = 2 * GT_NW * i;
      Fp2s x, y, z, w, r;
      ld(x, a + o); ld(y, c + o); ld(z, d + o); ld(w, e + o);
      if (op == 0) r = mul_lazy(x, y, F);
      if (op == 1) r = sqr_lazy(x, F);
      if (op == 2) r = sop2(x, y, z, w, F);
      st(out + o, r);
    }
  };
  std::thread t0(lane, 0u), t1(lane, 1u);
  t0.join();
  t1.join();
}
'''

HOST_CURVES = ("bn254", "bls12_381", "bls12_377")


@pytest.fixture(scope="module")
def host_fp2(tmp_path_factory):
    """curve -> the harness built by g++ with the curve's GT_NW and
    GT_NR_ABS (its cuda.variant flags)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("fp2_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    libs = {}

    def get(cv):
        if cv not in libs:
            v = cuda.variant(curves.CURVES[cv].fp.name)
            so = d / f"{cv}.so"
            subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                            "-pthread", *v.flags, "-I", str(d), "-I",
                            str(CSRC), "-o", str(so), str(d / "harness.cpp")],
                           check=True)
            lib = ctypes.CDLL(str(so))
            for fn in (lib.one_thread, lib.lane_pair):
                fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
                    [ctypes.c_longlong, ctypes.c_void_p]
            libs[cv] = lib
        return libs[cv]
    return get


def _lazy_fp2(q, n, seed):
    """n Fp2 values as Montgomery ints (canonical, then lazy < 2p): the
    first rows at 2p - 1 and p in each component, then random ones, half
    of their components lifted into [p, 2p)."""
    rng = random.Random(seed)
    edge = [(q - 1, q - 1), (q - 1, 0), (0, q - 1), (0, 0)]
    canon = edge + [(rng.randrange(q), rng.randrange(q))
                    for _ in range(n - len(edge))]
    lazy = [tuple(v + q if (i < 3 and v == q - 1) or (i == 3)
                  or (i > 3 and rng.random() < 0.5) else v for v in pair)
            for i, pair in enumerate(canon)]
    return canon, lazy


def _words_np(vals, nw):
    return np.frombuffer(b"".join(v.to_bytes(4 * nw, "little")
                                  for pair in vals for v in pair),
                         dtype=np.uint32).copy()


def _ints_np(w, nw):
    w = w.reshape(-1, 2, nw)
    return [tuple(sum(int(x[j, k]) << (32 * k) for k in range(nw))
                  for j in range(2)) for x in w]


def _ref_fp2_mul(c, a, b):
    """(a * b) over Fp2 = Fp[u]/(u^2 - nr) on host ints, Montgomery in
    and out (x R, y R -> x y R)."""
    q, nr = c.fp.modulus, c.fp2_nr
    rinv = pow(fields.FIELDS[c.fp.name].R, -1, q)
    a0, a1 = (v * rinv % q for v in a)
    b0, b1 = (v * rinv % q for v in b)
    r = ((a0 * b0 + nr * a1 * b1) % q, (a0 * b1 + a1 * b0) % q)
    big = fields.FIELDS[c.fp.name].R
    return tuple(v * big % q for v in r)


@pytest.mark.parametrize("form", ["one_thread", "lane_pair"])
@pytest.mark.parametrize("cv", HOST_CURVES)
def test_device_fp2_code_matches_reference(host_fp2, cv, form):
    """mul_lazy, sqr_lazy and sop2 of csrc/mont.cuh (one thread an Fp2)
    and csrc/fp2s.cuh (a lane pair), and K1's G2 norm z0^2 + |nr| z1^2,
    built with the curve's GT_NW and GT_NR_ABS, on lazy operands with
    components at 2p - 1 and p: every output component < 2p (the lazy
    class) and equal, mod p, to the schoolbook Fp2 on host ints (u^2 =
    -1 on BN254 and BLS12-381, -5 on BLS12-377), with which the
    reference's FF2 at u^2 = -5 agrees on the first rows."""
    c = curves.CURVES[cv]
    nw, q = cuda.KERNEL_FIELDS[c.fp.name].nw, c.fp.modulus
    big = fields.FIELDS[c.fp.name].R
    n = 24
    ins = [_lazy_fp2(q, n, 50 + k) for k in range(4)]
    (A, _), (C, _), (D, _), (E, _) = ins
    mul = functools.partial(_ref_fp2_mul, c)

    def add(x, y):
        return tuple((u + v) % q for u, v in zip(x, y))
    rinv = pow(big, -1, q)
    want = {0: [mul(a, b) for a, b in zip(A, C)],
            1: [mul(a, a) for a in A],
            2: [add(mul(a, b), mul(d, e)) for a, b, d, e in zip(A, C, D, E)],
            3: [((a[0] * a[0] - c.fp2_nr * a[1] * a[1]) * rinv % q, 0)
                for a in A]}
    if form == "one_thread" and cv == "bls12_377":
        r2 = ref_get_ff2(c.fp.name, c.fp2_nr)
        rA, rC = (jnp.asarray(r2.encode([[v * rinv % q for v in pair]
                                         for pair in X[:4]]))
                  for X in (A, C))
        assert np.array_equal(np.asarray(r2.mul(rA, rC)),
                              np.asarray(r2.encode([[v * rinv % q for v in
                                                     pair] for pair in
                                                    want[0][:4]])))
    bufs = [_words_np(lz, nw) for _, lz in ins]
    cons = cuda.field_consts(c.fp.name)
    fn = getattr(host_fp2(cv), form)
    for op in ((0, 1, 2, 3) if form == "one_thread" else (0, 1, 2)):
        out = np.zeros_like(bufs[0])
        fn(op, *(b.ctypes.data for b in bufs), out.ctypes.data, n,
           cons.ctypes.data)
        got = _ints_np(out, nw)
        assert all(v < 2 * q for pair in got for v in pair), (op, form)
        assert [tuple(v % q for v in pair) for pair in got] == want[op], \
            (cv, form, op)


def test_port_fp2_at_minus_5_matches_reference():
    """The port's FF2 at u^2 = -5 (the plain twins' arithmetic) against
    the reference's FF2: mul and square on values with components 0, 1
    and p - 1; inv against mul."""
    f2, r2 = get_ff2(FP, CURVE.fp2_nr), ref_get_ff2(FP, CURVE.fp2_nr)
    q = CURVE.fp.modulus
    rng = random.Random(60)
    vals = [(q - 1, q - 1), (0, q - 1), (1, 0), (0, 0)] + \
        [(rng.randrange(q), rng.randrange(q)) for _ in range(12)]
    other = vals[::-1]
    A, B = torch.as_tensor(f2.encode(vals)), torch.as_tensor(f2.encode(other))
    rA, rB = jnp.asarray(r2.encode(vals)), jnp.asarray(r2.encode(other))
    assert np.array_equal(f2.mul(A, B).numpy(), np.asarray(r2.mul(rA, rB)))
    assert np.array_equal(f2.square(A).numpy(), np.asarray(r2.square(rA)))
    one = f2.mul(A[4:], f2.inv(A[4:]))
    assert torch.equal(one, f2.ones((12,)))


# ---------------------------------------------------------------------------
# the MSM, the ladder and the NTT
# ---------------------------------------------------------------------------

def _points(g2, n, seed):
    """n points of G1 (or G2) with infinity, duplicates, and scalars
    with a zero, r - 1 and 1."""
    rng = random.Random(seed)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    pts = [host.ec_mul(hf, gen, rng.randrange(1, 1 << 16)) for _ in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    pts[1] = host.INF
    ks[2], ks[3], ks[6] = 0, R - 1, 1
    pts[4], ks[4] = pts[5], ks[5]
    return hf, pts, ks


def _encode_points(ff, pts, g2):
    zero = (0, 0) if g2 else 0
    x = ff.encode_words([zero if p is host.INF else p[0] for p in pts])
    y = ff.encode_words([zero if p is host.INF else p[1] for p in pts])
    return (torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor([p is host.INF for p in pts]))


@pytest.mark.parametrize("g2", [False, True])
def test_bucket_msm_against_host(g2, monkeypatch):
    """The bucket MSM's plain path (K4's and K9's twins, 253-bit scalars
    in 8 words, 12-word points, G2 at u^2 = -5) against host.ec_msm, at
    c = 4."""
    monkeypatch.setenv("GNARK_TPU_MSM_C", "4")
    ff = get_ff2(FP, CURVE.fp2_nr) if g2 else get_ff(FP)
    hf, pts, ks = _points(g2, 12, 70 + g2)
    P = _encode_points(ff, pts, g2)
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    J = msm(ff, P, sc, CURVE.fr.bits, device="cpu",
            b3=bucket.group_b3(CURVE, g2))
    got = groth16._to_affine_host(ff, hf, "jac", tuple(a[None] for a in J))
    assert got == host.ec_msm(hf, pts, ks)


@pytest.mark.parametrize("g2", [False, True])
def test_ladder_at_16_bits_against_host(g2):
    """The ladder's twin (the per-bit plain K7 + K6) at 16 bits, then the
    affine kernel's twin (the norm z0^2 + 5 z1^2 in G2), against host
    scalar multiplications."""
    ff = get_ff2(FP, CURVE.fp2_nr) if g2 else get_ff(FP)
    hf = CURVE.host_g2_field if g2 else CURVE.host_fp
    gen = CURVE.g2 if g2 else CURVE.g1
    ks = [0, 1, 2, (1 << 16) - 1, 12345, 40000]
    base = tuple(a.reshape(1, -1) for a in _encode_points(ff, [gen], g2)[:2])
    sc = torch.as_tensor(get_ff(FR).encode_words(ks, mont=False))
    x, y, inf = fixed_base.batch_scalar_mul_affine(ff, base, 16, sc)
    shape = (-1, 2, ff.nw) if g2 else (-1, ff.nw)
    got = groth16._host_points(ff, x.reshape(shape), y.reshape(shape), inf)
    assert got == [host.ec_mul(hf, gen, k) for k in ks]


def _words_of_ref(ff, limbs):
    return ff.to_words(torch.as_tensor(np.asarray(limbs).astype(np.int64)))


def test_ntt_matches_reference_domain():
    """Domain.fft / ifft, plain and coset, at 2^10 over BLS12-377's
    scalar field (47-adic) against the reference's Domain."""
    f, rf = get_ff(FR), ref_get_ff(FR)
    n = 1 << 10
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(n)]
    dom, ref = Domain(f, n, "cpu"), RefDomain(rf, n)
    x, rx = torch.as_tensor(f.encode_words(vals)), jnp.asarray(rf.encode(vals))
    for coset in (False, True):
        for fn, rfn in ((dom.fft, ref.fft), (dom.ifft, ref.ifft)):
            assert torch.equal(fn(x, coset=coset),
                               _words_of_ref(f, rfn(rx, coset=coset)))


# ---------------------------------------------------------------------------
# PLONK on the CPU, verified by the reference
# ---------------------------------------------------------------------------

def _host_ladder(ff, base_affine, nbits, scalars):
    """batch_scalar_mul's result from host multiplications of the G1
    generator (the SRS's only base): Jacobian words, Z = 1 or infinity."""
    ks = [int(k) for k in get_ff(FR).decode_words(scalars, mont=False)]
    pts = [host.ec_mul(CURVE.host_fp, CURVE.g1, k) for k in ks]
    X = [1 if p is host.INF else p[0] for p in pts]
    Y = [1 if p is host.INF else p[1] for p in pts]
    Z = [0 if p is host.INF else 1 for p in pts]
    return tuple(torch.as_tensor(ff.encode_words(v)).reshape(len(pts), -1)
                 for v in (X, Y, Z))


def _host_msm(ff, hf, points, scalars, nbits, b3):
    """_msm_affine_host's result from host.ec_msm (G1 commitments)."""
    x, y, inf = (a.cpu() for a in points)
    xs, ys = ff.decode_words(x), ff.decode_words(y)
    pts = [host.INF if bool(i) else (int(u), int(v))
           for u, v, i in zip(xs, ys, inf)]
    ks = [int(k) for k in get_ff(FR).decode_words(scalars.cpu(), mont=False)]
    return host.ec_msm(hf, pts, ks) if pts else host.INF


def _ref_vk(vk):
    return ref_plonk.PlonkVerifyingKey(
        curve=ref_curves.CURVES["bls12_377"],
        **{f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
           if f.name != "curve"})


def test_plonk_cpu_proof_accepted_by_reference_verify(monkeypatch):
    """The cubic's PLONK over BLS12-377 on the CPU (the SRS's ladder and
    the commitments' MSMs on the host, to keep the tier fast: the plain
    12-word MSM is held against the host above): the reference's verify
    accepts the port's proof and refuses it for a wrong public value."""
    monkeypatch.setattr(kzg, "batch_scalar_mul", _host_ladder)
    monkeypatch.setattr(kzg, "_msm_affine_host", _host_msm)
    cs = compile_circuit(Cubic(), fields.BLS12_377_FR,
                         builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bls12_377", 16, rng=random.Random(25),
                        device="cpu")
    pk, vk = plonk.setup(cs, srs)
    pub, sec = witness(Cubic(x=3, y=35), cs)
    proof = plonk.prove(cs, pk, pub, sec, rng=random.Random(26),
                        device="cpu")
    rproof = ref_plonk.PlonkProof(**{f.name: getattr(proof, f.name)
                                     for f in dataclasses.fields(proof)})
    assert ref_plonk.verify(rproof, _ref_vk(vk), pub)
    assert not ref_plonk.verify(rproof, _ref_vk(vk), [36])


# ---------------------------------------------------------------------------
# slow tier: the proof equal to the reference's byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_plonk_bls12_377_equals_reference():
    """PLONK over BLS12-377: the port's SRS, setup and prove on the CPU
    give the reference's vk and proof under the same seeds; both
    verifiers accept it and refuse a wrong public value."""
    rcs = ref_compile(RefCubic(), ref_fields.BLS12_377_FR,
                      builder_cls=RefSCSBuilder)
    rsrs = ref_kzg.setup_srs("bls12_377", 64, rng=random.Random(27))
    rpk, rvk = ref_plonk.setup(rcs, rsrs)
    pub, sec = ref_witness(RefCubic(x=3, y=35), rcs)
    want = ref_plonk.prove(rcs, rpk, pub, sec, rng=random.Random(28))
    cs = compile_circuit(Cubic(), fields.BLS12_377_FR,
                         builder_cls=SCSBuilder)
    srs = kzg.setup_srs("bls12_377", 64, rng=random.Random(27),
                        device="cpu")
    pk, vk = plonk.setup(cs, srs)
    got = plonk.prove(cs, pk, pub, sec, rng=random.Random(28), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert {f.name: getattr(vk, f.name) for f in dataclasses.fields(vk)
            if f.name != "curve"} == \
        {f.name: getattr(rvk, f.name) for f in dataclasses.fields(rvk)
         if f.name != "curve"}
    assert ref_plonk.verify(want, rvk, pub)
    assert plonk.verify(got, vk, pub) and not plonk.verify(got, vk, [36])
