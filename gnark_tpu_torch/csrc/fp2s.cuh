// Fp2 split across a pair of threads: the even lane of the pair holds c0,
// the odd lane c1 of the same Fp2 value, in the lazy class of mont.cuh.
// A product takes the partner's component by a shuffle inside the pair
// (mask: the two lanes, which run the same path), so each thread keeps
// half the state of an Fp2 formula: the G2 formulas then need about the
// registers of G1 (no spills) and twice the threads. Each thread computes
// one component of every product as a sum of two Montgomery products
// (u^2 = -|nr|, |nr| = GT_NR_ABS of mont.cuh: c0 = a0 c0' - |nr| a1 c1',
// c1 = a0 c1' + a1 c0'), the pair four, as the schoolbook product; the
// even lane's negative operand is neg2p(|nr| a1), its add chain
// (mul_nr_abs) keeping it below 2p; the selects between the lanes'
// operands are branch-free.
//
// The proj.cuh formulas take this type as they take Fp and Fp2.
#pragma once

#include "mont.cuh"

struct Fp2s {
  Fp v;
};

template <>
struct Row<Fp2s> {
  static constexpr int W = 2 * GT_NW;   // a row holds c0 | c1
  static constexpr int lanes = 2;
};

__device__ __forceinline__ int lane_half() { return threadIdx.x & 1; }

// the two lanes of this thread's pair
__device__ __forceinline__ unsigned pair_mask() {
  return 3u << (threadIdx.x & 30);
}

// b on both lanes of the pair (both lanes must call it)
__device__ __forceinline__ bool pair_all(bool b) {
  return __all_sync(pair_mask(), b);
}

__device__ __forceinline__ Fp partner(const Fp& a) {
  const unsigned mask = pair_mask();
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = __shfl_xor_sync(mask, a.w[i], 1);
  return r;
}

__device__ __forceinline__ Fp pick(bool odd, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = odd ? a.w[i] : b.w[i];
  return r;
}

// this lane's component of a * c
__device__ __forceinline__ Fp2s mul_lazy(const Fp2s& a, const Fp2s& c,
                                         const FieldC& F) {
  const bool odd = lane_half();
  Fp ao = partner(a.v), co = partner(c.v);
  Fp2s r;
  r.v = sop2(pick(odd, ao, a.v), c.v,
            pick(odd, a.v, neg2p(mul_nr_abs(ao, F), F)), co, F);
  return r;
}

// this lane's component of a^2. At |nr| = 1: c0 = (a0 + a1)(a0 - a1),
// c1 = 2 a0 a1, one product a lane where a * a takes a sum of two. That
// identity holds for u^2 = -1 only; otherwise c0 = a0^2 - |nr| a1^2
// and c1 = a0 a1 + a1 a0, one sum of two products a lane (the product's
// form with c = a, one shuffle).
__device__ __forceinline__ Fp2s sqr_lazy(const Fp2s& a, const FieldC& F) {
  const bool odd = lane_half();
  Fp o = partner(a.v);
  Fp2s r;
#if GT_NR_ABS == 1
  r.v = mul_lazy(pick(odd, double2p(o, F), add2p(a.v, o, F)),
                 pick(odd, a.v, sub2p(a.v, o, F)), F);
#else
  r.v = sop2(pick(odd, o, a.v), a.v,
             pick(odd, a.v, neg2p(mul_nr_abs(o, F), F)), o, F);
#endif
  return r;
}

// this lane's component of a * c + d * e
__device__ __forceinline__ Fp2s sop2(const Fp2s& a, const Fp2s& c,
                                     const Fp2s& d, const Fp2s& e,
                                     const FieldC& F) {
  const bool odd = lane_half();
  Fp ao = partner(a.v), co = partner(c.v);
  Fp dd = partner(d.v), eo = partner(e.v);
  Fp2s r;
  r.v = sop4(pick(odd, ao, a.v), c.v,
             pick(odd, a.v, neg2p(mul_nr_abs(ao, F), F)), co,
             pick(odd, dd, d.v), e.v,
             pick(odd, d.v, neg2p(mul_nr_abs(dd, F), F)), eo, F);
  return r;
}

__device__ __forceinline__ Fp2s add2p(const Fp2s& a, const Fp2s& b,
                                      const FieldC& F) {
  Fp2s r;
  r.v = add2p(a.v, b.v, F);
  return r;
}

__device__ __forceinline__ Fp2s sub2p(const Fp2s& a, const Fp2s& b,
                                      const FieldC& F) {
  Fp2s r;
  r.v = sub2p(a.v, b.v, F);
  return r;
}

__device__ __forceinline__ Fp2s neg2p(const Fp2s& a, const FieldC& F) {
  Fp2s r;
  r.v = neg2p(a.v, F);
  return r;
}

__device__ __forceinline__ Fp2s double2p(const Fp2s& a, const FieldC& F) {
  return add2p(a, a, F);
}

__device__ __forceinline__ Fp2s canon(const Fp2s& a, const FieldC& F) {
  Fp2s r;
  r.v = canon(a.v, F);
  return r;
}

__device__ __forceinline__ void set_zero(Fp2s& r) { set_zero(r.v); }

__device__ __forceinline__ void set_one(Fp2s& r, const FieldC& F) {
  set_one(r.v, F);
  if (lane_half()) set_zero(r.v);
}

// this lane's component of the row at g (c0 | c1)
__device__ __forceinline__ void ld(Fp2s& r, const uint32_t* g) {
  ld(r.v, g + lane_half() * GT_NW);
}

__device__ __forceinline__ void st(uint32_t* g, const Fp2s& a) {
  st(g + lane_half() * GT_NW, a.v);
}

__device__ __forceinline__ Fp2s split(const Fp2& a) {
  Fp2s r;
  r.v = lane_half() ? a.c1 : a.c0;
  return r;
}

// a kernel's constant (b3) as the element type it computes in
__device__ __forceinline__ void as_elem(Fp& r, const Fp& h) { r = h; }
__device__ __forceinline__ void as_elem(Fp2s& r, const Fp2& h) {
  r = split(h);
}

// this lane's component, past L1 (rows that other blocks wrote)
__device__ __forceinline__ void ld_cg(Fp2s& r, const uint32_t* g) {
  ld_cg(r.v, g + lane_half() * GT_NW);
}
