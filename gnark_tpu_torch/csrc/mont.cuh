// Montgomery arithmetic over GT_NW x 32-bit words (set by the build: 8
// for the BN254 fields and the BLS12 scalar fields, 12 for the BLS12
// base fields and BW6-761's scalar field, 24 for BW6-761's base field),
// and its Fp2 lift, u^2 = -GT_NR_ABS (set by the build: 1 for BN254 and
// BLS12-381, 5 for BLS12-377; 0 for a base field with no Fp2, BW6-761's,
// whose G2 lies over Fp: the kernels' Fp2 instances are then compiled
// out and a launch asking for one is refused). GT_SW (set by the build)
// is the words of the point kernels' scalars: 8, 12 on BW6-761.
//
// Counterpart of gnark_tpu/ff/pallas_mont.py (TFF) and
// gnark_tpu/ff/pallas_fp2.py (TFF2). Not a kernel: device functions that
// the kernels of this directory compose.
//
// R = 2^(32 GT_NW), the same radix as 2 GT_NW 16-bit limbs, so
// Montgomery values are bit-identical with the reference's. The product
// is CIOS with 64-bit accumulators (one 32 x 32 -> 64 multiply-add per
// word pair). Two classes, chosen by the build (GT_SOUND):
//
// The lazy class (GT_SOUND 0) of the reference, for 4p < R:
//   mul_lazy      in < 2p, out < 2p  (no final subtract)
//   sqr_lazy      a * a, in < 2p, out < 2p: the same value as mul_lazy
//                 (Fp: each cross product once; fp2s.cuh: one product a
//                 lane)
//   sop2 / sop4   sum of 2 / 4 products, one / two conditional 2p subtracts
//   add2p, sub2p, neg2p, double2p   on [0, 2p)
//   canon         < 3p -> [0, p) with two conditional p subtracts
//   fermat_inv    z^(p-2), in < 2p, out < 2p
//   by_inv        1 / z by Bernstein-Yang divsteps, in < 2p (not 0 mod
//                 p), out < 2p: one thread's short-latency inverse (8
//                 words only)
//   is_zero_lazy  a < 2p is 0 mod p
// The sound class (GT_SOUND 1), for 4p >= R > 2p (BLS12-381's scalar
// field: 4r ~ 1.81 R, so a product of two operands < 2p reaches ~2.81 r,
// past R): the same functions, each taking values < 2p and returning
// them < p, so a kernel written for the lazy class stays right:
//   mul_lazy      the full CIOS result (< 2.81 p, its top word kept),
//                 two conditional p subtracts
//   sqr_lazy      mul_lazy(a, a) (the one-pass square drops a carry)
//   sop2 / sop4   the a (sop2) or all (sop4) operands brought below p
//                 first, then two conditional p subtracts
//   add2p, sub2p  a conditional 2p, then a p subtract (the sum's carry
//                 kept); neg2p two conditional p subtracts
// Field constants come in a FieldC passed by value as a kernel argument;
// n0 is -p^-1 mod 2^32 (not the reference's 16-bit constant); r3 is
// R^3 mod p (by_inv's return to Montgomery form).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef GT_NW
#define GT_NW 8        // words of a field element
#endif
#ifndef GT_SW
#define GT_SW 8        // words of a scalar (the point kernels' scalars)
#endif
#ifndef GT_SOUND
#define GT_SOUND 0     // 1: the sound class (4p >= R)
#endif
#ifndef GT_NOINLINE
#define GT_NOINLINE 0  // 1: the Fp products as called functions
#endif
#ifndef GT_NR_ABS
#define GT_NR_ABS 1    // Fp2 = Fp[u]/(u^2 + GT_NR_ABS); 0: no Fp2
#endif
static_assert(GT_NR_ABS >= 0 && GT_NR_ABS <= 8, "|u^2| is 0 to 8");
static_assert(GT_NW % 4 == 0, "an element is whole 16-byte vectors");

// A launch site's Fp2 branch, `if (fp2) GT_FP2_LAUNCH(kernel<Fp2..>
// <<<...>>>(...)); else ...`: the launch itself where the build has an
// Fp2, else a refusal (no Fp2 instance is compiled).
#if GT_NR_ABS
#define GT_FP2_LAUNCH(...) __VA_ARGS__
#else
#define GT_FP2_LAUNCH(...) return (int)cudaErrorInvalidValue
#endif

#if GT_NOINLINE
#define GT_PRODUCT __device__ __noinline__
#else
#define GT_PRODUCT __device__ __forceinline__
#endif

struct FieldC {
  uint32_t p[GT_NW];
  uint32_t p2[GT_NW];
  uint32_t one[GT_NW];
  uint32_t n0;
  uint32_t r3[GT_NW];
};

// Host: constants laid out as p | 2p | R mod p | n0 | R^3 mod p (4 GT_NW
// + 1 words; cuda.field_consts).
static inline FieldC field_from_host(const uint32_t* c) {
  FieldC f;
  for (int i = 0; i < GT_NW; ++i) {
    f.p[i] = c[i];
    f.p2[i] = c[GT_NW + i];
    f.one[i] = c[2 * GT_NW + i];
    f.r3[i] = c[3 * GT_NW + 1 + i];
  }
  f.n0 = c[3 * GT_NW];
  return f;
}

struct Fp {
  uint32_t w[GT_NW];
};

struct Fp2 {
  Fp c0, c1;
};

// Words of one element in a row of a point array, and the threads that
// hold one element (fp2s.cuh splits an Fp2 across two).
template <class E>
struct Row {
  static constexpr int W = sizeof(E) / 4;
  static constexpr int lanes = 1;
};

static inline Fp fp_from_host(const uint32_t* c) {
  Fp r;
  for (int i = 0; i < GT_NW; ++i) r.w[i] = c[i];
  return r;
}

static inline Fp2 fp2_from_host(const uint32_t* c) {
  Fp2 r;
  r.c0 = fp_from_host(c);
  r.c1 = fp_from_host(c + GT_NW);
  return r;
}

// ---------------------------------------------------------------------
// global / shared memory access (an element is 4 GT_NW contiguous bytes,
// GT_NW / 4 16-byte vectors)
// ---------------------------------------------------------------------

__device__ __forceinline__ void ld(Fp& r, const uint32_t* g) {
  const uint4* q = reinterpret_cast<const uint4*>(g);
#pragma unroll
  for (int k = 0; k < GT_NW / 4; ++k) {
    const uint4 u = q[k];
    r.w[4 * k] = u.x; r.w[4 * k + 1] = u.y;
    r.w[4 * k + 2] = u.z; r.w[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void st(uint32_t* g, const Fp& a) {
  uint4* q = reinterpret_cast<uint4*>(g);
#pragma unroll
  for (int k = 0; k < GT_NW / 4; ++k)
    q[k] = make_uint4(a.w[4 * k], a.w[4 * k + 1], a.w[4 * k + 2],
                      a.w[4 * k + 3]);
}

// from L2, past L1 (rows that other blocks wrote)
__device__ __forceinline__ void ld_cg(Fp& r, const uint32_t* g) {
  const uint4* q = reinterpret_cast<const uint4*>(g);
#pragma unroll
  for (int k = 0; k < GT_NW / 4; ++k) {
    const uint4 u = __ldcg(q + k);
    r.w[4 * k] = u.x; r.w[4 * k + 1] = u.y;
    r.w[4 * k + 2] = u.z; r.w[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void ld(Fp2& r, const uint32_t* g) {
  ld(r.c0, g);
  ld(r.c1, g + GT_NW);
}

__device__ __forceinline__ void st(uint32_t* g, const Fp2& a) {
  st(g, a.c0);
  st(g + GT_NW, a.c1);
}

// ---------------------------------------------------------------------
// word helpers
// ---------------------------------------------------------------------

// r = a - c; returns the borrow (1 if a < c)
__device__ __forceinline__ uint32_t sub_words(uint32_t* r, const uint32_t* a,
                                              const uint32_t* c) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) {
    uint64_t d = (uint64_t)a[i] - c[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// r = a + c; returns the carry
__device__ __forceinline__ uint32_t add_words(uint32_t* r, const uint32_t* a,
                                              const uint32_t* c) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) {
    uint64_t s = (uint64_t)a[i] + c[i] + carry;
    r[i] = (uint32_t)s;
    carry = s >> 32;
  }
  return (uint32_t)carry;
}

// (top:a) >= c ? (top:a) - c : (top:a), over NW words plus a top word
__device__ __forceinline__ void cond_sub(uint32_t* a, uint32_t& top,
                                         const uint32_t* c) {
  uint32_t d[GT_NW];
  uint32_t borrow = sub_words(d, a, c);
  bool take = top >= borrow;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) a[i] = take ? d[i] : a[i];
  top = take ? top - borrow : top;
}

// ---------------------------------------------------------------------
// CIOS: sum_k a_k * b_k * R^-1, result in (top:out)
// ---------------------------------------------------------------------

// t[0 .. NW+1] += a * bi
__device__ __forceinline__ void mac_row(uint32_t* t, const uint32_t* a,
                                        uint32_t bi) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < GT_NW; ++j) {
    uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  uint64_t s = (uint64_t)t[GT_NW] + c;
  t[GT_NW] = (uint32_t)s;
  t[GT_NW + 1] += (uint32_t)(s >> 32);
}

// t += m * p with m = t[0] * n0 (so t[0] becomes 0), then t >>= 32
__device__ __forceinline__ void reduce_row(uint32_t* t, const FieldC& F) {
  uint32_t m = t[0] * F.n0;
  uint64_t s = (uint64_t)m * F.p[0] + t[0];
  uint64_t c = s >> 32;
#pragma unroll
  for (int j = 1; j < GT_NW; ++j) {
    s = (uint64_t)m * F.p[j] + t[j] + c;
    t[j - 1] = (uint32_t)s;
    c = s >> 32;
  }
  s = (uint64_t)t[GT_NW] + c;
  t[GT_NW - 1] = (uint32_t)s;
  s = (uint64_t)t[GT_NW + 1] + (s >> 32);
  t[GT_NW] = (uint32_t)s;
  t[GT_NW + 1] = (uint32_t)(s >> 32);
}

template <int K>
__device__ __forceinline__ void cios(uint32_t* out, uint32_t& top,
                                     const Fp* a, const Fp* b,
                                     const FieldC& F) {
  uint32_t t[GT_NW + 2];
#pragma unroll
  for (int i = 0; i < GT_NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) mac_row(t, a[k].w, b[k].w[i]);
    reduce_row(t, F);
  }
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) out[i] = t[i];
  top = t[GT_NW];
}

// ---------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------

// a < 2p -> a < p (the sound class's operand reduction)
__device__ __forceinline__ Fp red1(const Fp& a, const FieldC& F) {
  Fp r = a;
  uint32_t top = 0;
  cond_sub(r.w, top, F.p);
  return r;
}

// (top:w) < 3p -> [0, p)
__device__ __forceinline__ void sub_p_twice(uint32_t* w, uint32_t& top,
                                            const FieldC& F) {
  cond_sub(w, top, F.p);
  cond_sub(w, top, F.p);
}

GT_PRODUCT Fp mul_lazy(const Fp& a, const Fp& b,
                                       const FieldC& F) {
  Fp r;
  uint32_t top;
  cios<1>(r.w, top, &a, &b, F);
#if GT_SOUND
  sub_p_twice(r.w, top, F);     // < (4p^2 + R p) / R < 3p, as 2p < R
#endif
  return r;
}

// a * a * R^-1 by separated operand scanning: the 28 products a_i a_j,
// i < j, once, doubled, plus the 8 squares, then 8 reduction rows; 100
// word products and 8 for the m words, against mul_lazy's 128 and 8.
// The same value as mul_lazy(a, a): m = -a^2 p^-1 mod R is unique.
// a < 2p and 4p < R, so a^2 and a^2 + m p fit 2 GT_NW words (no carry
// out); the sound class takes the product.
GT_PRODUCT Fp sqr_lazy(const Fp& a, const FieldC& F) {
#if GT_SOUND
  return mul_lazy(a, a, F);
#else
  uint32_t t[2 * GT_NW];
#pragma unroll
  for (int i = 0; i < 2 * GT_NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < GT_NW - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < GT_NW; ++j) {
      uint64_t s = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + GT_NW] = (uint32_t)c;
  }
#pragma unroll
  for (int i = 2 * GT_NW - 1; i > 0; --i)
    t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) {
    uint64_t d = (uint64_t)a.w[i] * a.w[i];
    uint64_t s = (d & 0xFFFFFFFFu) + t[2 * i] + c;
    t[2 * i] = (uint32_t)s;
    s = (d >> 32) + t[2 * i + 1] + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  uint32_t extra = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) {
    uint32_t m = t[i] * F.n0;
    uint64_t cc = 0;
#pragma unroll
    for (int j = 0; j < GT_NW; ++j) {
      uint64_t s = (uint64_t)m * F.p[j] + t[i + j] + cc;
      t[i + j] = (uint32_t)s;
      cc = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + GT_NW] + cc + extra;
    t[i + GT_NW] = (uint32_t)s;
    extra = (uint32_t)(s >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = t[GT_NW + i];
  return r;
#endif
}

// z^(p-2) by square-and-multiply over the exponent's bits, most
// significant first (the reference's FF.inv; 0 -> 0); in < 2p, out < 2p.
// The exponent comes from F.p, so the branch is the same in every thread.
// For BN254 (either field): 253 squarings (sqr_lazy) and 109 products;
// for BLS12-381's base field 380 and 228.
__device__ __forceinline__ Fp fermat_inv(const Fp& z, const FieldC& F) {
  uint32_t e[GT_NW];
  uint32_t two[GT_NW] = {2};
  sub_words(e, F.p, two);
  Fp r = z;
  bool started = false;
#pragma unroll
  for (int w = GT_NW - 1; w >= 0; --w) {
    const uint32_t ew = e[w];
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      const bool bit = (ew >> b) & 1;
      if (started) {
        r = sqr_lazy(r, F);
        if (bit) r = mul_lazy(r, z, F);
      } else {
        started = bit;
      }
    }
  }
  return r;
}

GT_PRODUCT Fp sop2(const Fp& a1, const Fp& b1, const Fp& a2,
                                   const Fp& b2, const FieldC& F) {
#if GT_SOUND
  Fp a[2] = {red1(a1, F), red1(a2, F)};      // (2 p 2p + R p) / R < 3p
#else
  Fp a[2] = {a1, a2};
#endif
  Fp b[2] = {b1, b2};
  Fp r;
  uint32_t top;
  cios<2>(r.w, top, a, b, F);
#if GT_SOUND
  sub_p_twice(r.w, top, F);
#else
  cond_sub(r.w, top, F.p2);
#endif
  return r;
}

GT_PRODUCT Fp sop4(const Fp& a1, const Fp& b1, const Fp& a2,
                                   const Fp& b2, const Fp& a3, const Fp& b3,
                                   const Fp& a4, const Fp& b4,
                                   const FieldC& F) {
#if GT_SOUND
  // every operand < p: (4 p^2 + R p) / R < 3p
  Fp a[4] = {red1(a1, F), red1(a2, F), red1(a3, F), red1(a4, F)};
  Fp b[4] = {red1(b1, F), red1(b2, F), red1(b3, F), red1(b4, F)};
#else
  Fp a[4] = {a1, a2, a3, a4};
  Fp b[4] = {b1, b2, b3, b4};
#endif
  Fp r;
  uint32_t top;
  cios<4>(r.w, top, a, b, F);
#if GT_SOUND
  sub_p_twice(r.w, top, F);
#else
  cond_sub(r.w, top, F.p2);
  cond_sub(r.w, top, F.p2);
#endif
  return r;
}

__device__ __forceinline__ Fp add2p(const Fp& a, const Fp& b,
                                    const FieldC& F) {
  Fp r;
  uint32_t top = add_words(r.w, a.w, b.w);
  cond_sub(r.w, top, F.p2);
#if GT_SOUND
  cond_sub(r.w, top, F.p);
#endif
  return r;
}

__device__ __forceinline__ Fp sub2p(const Fp& a, const Fp& b,
                                    const FieldC& F) {
  Fp r;
  uint32_t top = add_words(r.w, a.w, F.p2);      // a + 2p < 4p (top kept)
  top -= sub_words(r.w, r.w, b.w);               // >= 0 since b < 2p
  cond_sub(r.w, top, F.p2);
#if GT_SOUND
  cond_sub(r.w, top, F.p);
#endif
  return r;
}

__device__ __forceinline__ Fp neg2p(const Fp& a, const FieldC& F) {
  Fp r;
  sub_words(r.w, F.p2, a.w);
#if GT_SOUND
  uint32_t top = 0;
  sub_p_twice(r.w, top, F);
#endif
  return r;
}

__device__ __forceinline__ Fp double2p(const Fp& a, const FieldC& F) {
  return add2p(a, a, F);
}

__device__ __forceinline__ Fp canon(const Fp& a, const FieldC& F) {
  Fp r = a;
  uint32_t top = 0;
  cond_sub(r.w, top, F.p);
  cond_sub(r.w, top, F.p);
  return r;
}

// a < 2p is 0 mod p (0 or p itself)
__device__ __forceinline__ bool is_zero_lazy(const Fp& a, const FieldC& F) {
  Fp c = canon(a, F);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) acc |= c.w[i];
  return acc == 0;
}

__device__ __forceinline__ void set_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = 0;
}

__device__ __forceinline__ void set_one(Fp& r, const FieldC& F) {
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = F.one[i];
}

#if GT_NW == 8
// ---------------------------------------------------------------------
// 1 / z by Bernstein and Yang's safegcd ("Fast constant-time gcd
// computation and modular inversion", 2019) in the form of
// libsecp256k1's modinv32: signed 30-bit limbs (9 for 254 bits), 30
// divsteps a batch on 32-bit words, each batch's 2x2 matrix then applied
// to (f, g) exactly and to (d, e) mod p with 30 bits divided out
// (d z = f, e z = g mod p throughout). 20 batches (600 divsteps) suffice
// for moduli below 2^256 (the bound is 590, from delta = 1/2); the loop
// ends early once g = 0, after which the batches leave d unchanged mod p
// (random BN254 inputs take 17-18 batches: at most 18 in 200,000 a
// field). Short dependent integer steps, against fermat_inv's 362
// dependent products.
// ---------------------------------------------------------------------

#define GT_S30 9
#define GT_M30 0x3FFFFFFF

struct S30 {
  int32_t v[GT_S30];
};

// GT_NW words (< 2^256) -> 9 limbs of 30 bits
__device__ __forceinline__ S30 s30_of(const uint32_t* w) {
  S30 r;
#pragma unroll
  for (int i = 0; i < GT_S30; ++i) {
    const int bit = 30 * i, k = bit >> 5, s = bit & 31;
    uint64_t x = w[k];
    if (k + 1 < GT_NW) x |= (uint64_t)w[k + 1] << 32;
    r.v[i] = (int32_t)((x >> s) & GT_M30);
  }
  return r;
}

// 9 limbs in [0, 2^30) -> GT_NW words
__device__ __forceinline__ Fp words_of(const S30& a) {
  Fp r;
#pragma unroll
  for (int k = 0; k < GT_NW; ++k) {
    const int bit = 32 * k, i = bit / 30, s = bit % 30;
    uint64_t x = (uint64_t)(uint32_t)a.v[i] >> s;
    if (i + 1 < GT_S30) x |= (uint64_t)(uint32_t)a.v[i + 1] << (30 - s);
    r.w[k] = (uint32_t)x;
  }
  return r;
}

// 30 divsteps on the low words of f (odd) and g from zeta = -(delta +
// 1/2); (u v; q r) such that 2^30 (f', g') = (u f + v g, q f + r g).
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f,
                                               uint32_t g, int32_t* t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll 6
  for (int i = 0; i < 30; ++i) {
    uint32_t m1 = (uint32_t)(zeta >> 31);          // zeta < 0
    const uint32_t m2 = 0u - (g & 1);              // g odd
    const uint32_t x = (f ^ m1) - m1, y = (u ^ m1) - m1, z = (v ^ m1) - m1;
    g += x & m2;
    q += y & m2;
    r += z & m2;
    m1 &= m2;
    zeta = (int32_t)((uint32_t)zeta ^ m1) - 1;
    f += g & m1;
    u += q & m1;
    v += r & m1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30, exact
__device__ __forceinline__ void update_fg_30(S30& f, S30& g,
                                             const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < GT_S30; ++i) {
    cf += (int64_t)u * f.v[i] + (int64_t)v * g.v[i];
    cg += (int64_t)q * f.v[i] + (int64_t)r * g.v[i];
    f.v[i - 1] = (int32_t)cf & GT_M30;
    g.v[i - 1] = (int32_t)cg & GT_M30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[GT_S30 - 1] = (int32_t)cf;
  g.v[GT_S30 - 1] = (int32_t)cg;
}

// (d, e) <- (u d + v e, q d + r e) / 2^30 mod p: the multiples md, me of
// p that clear the low 30 bits are added first (pinv = p^-1 mod 2^32);
// d, e stay in (-2p, p).
__device__ __forceinline__ void update_de_30(S30& d, S30& e, const int32_t* t,
                                             const S30& P, uint32_t pinv) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[GT_S30 - 1] >> 31, se = e.v[GT_S30 - 1] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((pinv * (uint32_t)cd + (uint32_t)md) & GT_M30);
  me -= (int32_t)((pinv * (uint32_t)ce + (uint32_t)me) & GT_M30);
  cd += (int64_t)P.v[0] * md;
  ce += (int64_t)P.v[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < GT_S30; ++i) {
    cd += (int64_t)u * d.v[i] + (int64_t)v * e.v[i] + (int64_t)P.v[i] * md;
    ce += (int64_t)q * d.v[i] + (int64_t)r * e.v[i] + (int64_t)P.v[i] * me;
    d.v[i - 1] = (int32_t)cd & GT_M30;
    e.v[i - 1] = (int32_t)ce & GT_M30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[GT_S30 - 1] = (int32_t)cd;
  e.v[GT_S30 - 1] = (int32_t)ce;
}

// d in (-2p, p) -> (sign < 0 ? -d : d) mod p in [0, p), limbs in [0, 2^30)
__device__ __forceinline__ void normalize_30(S30& d, int32_t sign,
                                             const S30& P) {
  int32_t add = d.v[GT_S30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < GT_S30; ++i) d.v[i] += P.v[i] & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < GT_S30; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < GT_S30 - 1; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= GT_M30;
  }
  add = d.v[GT_S30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < GT_S30; ++i) d.v[i] += P.v[i] & add;
#pragma unroll
  for (int i = 0; i < GT_S30 - 1; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= GT_M30;
  }
}

// z R (Montgomery, < 2p, not 0 mod p) -> z^-1 R (< 2p): the integer
// inverse of canon(z R) is z^-1 R^-1; one product by R^3 gives z^-1 R.
__device__ __forceinline__ Fp by_inv(const Fp& z, const FieldC& F) {
  const Fp x = canon(z, F);
  const S30 P = s30_of(F.p);
  const uint32_t pinv = 0u - F.n0;
  S30 d, e, f = P, g = s30_of(x.w);
#pragma unroll
  for (int i = 0; i < GT_S30; ++i) d.v[i] = e.v[i] = 0;
  e.v[0] = 1;
  int32_t zeta = -1;
#pragma unroll 1
  for (int it = 0; it < 20; ++it) {
    int32_t t[4];
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30(d, e, t, P, pinv);
    update_fg_30(f, g, t);
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < GT_S30; ++i) nz |= g.v[i];
    if (nz == 0) break;
  }
  normalize_30(d, f.v[GT_S30 - 1], P);
  Fp r3;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r3.w[i] = F.r3[i];
  return mul_lazy(words_of(d), r3, F);
}
#else
// by_inv is sized for moduli below 2^256: a wider build refuses a call
template <int N = GT_NW>
__device__ Fp by_inv(const Fp& z, const FieldC& F) {
  static_assert(N == 8, "by_inv takes 8-word fields only");
  return z;
}
#endif

// ---------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 + GT_NR_ABS), per component in the class of Fp (TFF2,
// nr = -GT_NR_ABS)
// ---------------------------------------------------------------------

// GT_NR_ABS a by an add chain (gnark_tpu/ff/pallas_fp2.py _mul_nr_abs):
// in < 2p, out < 2p, each step an add2p; a itself at GT_NR_ABS = 1
__device__ __forceinline__ Fp mul_nr_abs(const Fp& a, const FieldC& F) {
  Fp r = a, cur = a;
  bool have = GT_NR_ABS & 1;
#pragma unroll
  for (int k = GT_NR_ABS >> 1; k; k >>= 1) {
    cur = double2p(cur, F);
    if (k & 1) {
      r = have ? add2p(r, cur, F) : cur;
      have = true;
    }
  }
  return r;
}

// c0 = t0 - |nr| t1, c1 = (a0 + a1)(c0 + c1) - t0 - t1 (Karatsuba)
__device__ __forceinline__ Fp2 mul_lazy(const Fp2& a, const Fp2& c,
                                        const FieldC& F) {
  Fp t0 = mul_lazy(a.c0, c.c0, F);
  Fp t1 = mul_lazy(a.c1, c.c1, F);
  Fp2 r;
  r.c0 = sub2p(t0, mul_nr_abs(t1, F), F);
  Fp m = mul_lazy(add2p(a.c0, a.c1, F), add2p(c.c0, c.c1, F), F);
  r.c1 = sub2p(sub2p(m, t0, F), t1, F);
  return r;
}

// one thread an Fp2 (K1's G2 affine kernel): as the product
__device__ __forceinline__ Fp2 sqr_lazy(const Fp2& a, const FieldC& F) {
  return mul_lazy(a, a, F);
}

// a*c + d*e: r0 = a0c0 - |nr| a1c1 + d0e0 - |nr| d1e1 (the negative
// terms as neg2p operands, each < 2p), r1 = a0c1 + a1c0 + d0e1 + d1e0
__device__ __forceinline__ Fp2 sop2(const Fp2& a, const Fp2& c, const Fp2& d,
                                    const Fp2& e, const FieldC& F) {
  Fp na1 = neg2p(mul_nr_abs(a.c1, F), F);
  Fp nd1 = neg2p(mul_nr_abs(d.c1, F), F);
  Fp2 r;
  r.c0 = sop4(a.c0, c.c0, na1, c.c1, d.c0, e.c0, nd1, e.c1, F);
  r.c1 = sop4(a.c0, c.c1, a.c1, c.c0, d.c0, e.c1, d.c1, e.c0, F);
  return r;
}

__device__ __forceinline__ Fp2 add2p(const Fp2& a, const Fp2& b,
                                     const FieldC& F) {
  Fp2 r;
  r.c0 = add2p(a.c0, b.c0, F);
  r.c1 = add2p(a.c1, b.c1, F);
  return r;
}

__device__ __forceinline__ Fp2 sub2p(const Fp2& a, const Fp2& b,
                                     const FieldC& F) {
  Fp2 r;
  r.c0 = sub2p(a.c0, b.c0, F);
  r.c1 = sub2p(a.c1, b.c1, F);
  return r;
}

__device__ __forceinline__ Fp2 neg2p(const Fp2& a, const FieldC& F) {
  Fp2 r;
  r.c0 = neg2p(a.c0, F);
  r.c1 = neg2p(a.c1, F);
  return r;
}

__device__ __forceinline__ Fp2 double2p(const Fp2& a, const FieldC& F) {
  return add2p(a, a, F);
}

__device__ __forceinline__ Fp2 canon(const Fp2& a, const FieldC& F) {
  Fp2 r;
  r.c0 = canon(a.c0, F);
  r.c1 = canon(a.c1, F);
  return r;
}

__device__ __forceinline__ void set_zero(Fp2& r) {
  set_zero(r.c0);
  set_zero(r.c1);
}

__device__ __forceinline__ void set_one(Fp2& r, const FieldC& F) {
  set_one(r.c0, F);
  set_zero(r.c1);
}
