// Jacobian formulas for a = 0 curves, (X : Y : Z) ~ (X/Z^2, Y/Z^3),
// infinity Z == 0, generic over the coordinate field (Fp for G1, Fp2 for
// the G2 twist).
//
// Counterparts of gnark_tpu/ec/pallas_ec.py _jac_double_t (EFD
// dbl-2009-l) and _jac_add_mixed_t (EFD madd-2007-bl plus the selects
// that make it complete), operation for operation, in the lazy [0, 2p)
// class: inputs < 2p, outputs < 2p; callers canonicalize at the kernel
// boundary. The predicates (Z1 == 0, H == 0, r == 0) canonicalize first,
// so a lazy representative of 0 (p itself) counts as 0.
#pragma once

#include "mont.cuh"

template <class E>
struct Jac {
  E X, Y, Z;
};

__device__ __forceinline__ bool is_zero_lazy(const Fp& a, const FieldC& F) {
  Fp c = canon(a, F);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) acc |= c.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool is_zero_lazy(const Fp2& a, const FieldC& F) {
  return is_zero_lazy(a.c0, F) && is_zero_lazy(a.c1, F);
}

template <class E>
__device__ __forceinline__ void jac_infinity(Jac<E>& r, const FieldC& F) {
  set_one(r.X, F);
  set_one(r.Y, F);
  set_zero(r.Z);
}

// dbl-2009-l (a = 0): 2M + 5S. Infinity stays infinity (Z3 = 2 Y Z = 0).
template <class E>
__device__ __forceinline__ Jac<E> jac_dbl(const Jac<E>& P, const FieldC& F) {
  E A = mul_lazy(P.X, P.X, F);
  E B = mul_lazy(P.Y, P.Y, F);
  E C = mul_lazy(B, B, F);
  E t = add2p(P.X, B, F);
  t = mul_lazy(t, t, F);
  E D = double2p(sub2p(sub2p(t, A, F), C, F), F);
  E E3 = add2p(double2p(A, F), A, F);               // 3A
  E F2 = mul_lazy(E3, E3, F);
  Jac<E> R;
  R.X = sub2p(F2, double2p(D, F), F);
  E C8 = double2p(double2p(double2p(C, F), F), F);  // 8C
  R.Y = sub2p(mul_lazy(E3, sub2p(D, R.X, F), F), C8, F);
  R.Z = double2p(mul_lazy(P.Y, P.Z, F), F);
  return R;
}

// The doubling inside the mixed add runs on a few lanes at most; a call
// keeps the (large, for Fp2) formula out of the add's basic block.
template <class E>
__device__ __noinline__ Jac<E> jac_dbl_call(const Jac<E>& P, const FieldC& F) {
  return jac_dbl(P, F);
}

// madd-2007-bl (a = 0): 7M + 4S, plus the selects of the complete add:
// P == A doubles, P == -A gives infinity, P at infinity gives A (or
// infinity if inf2), inf2 gives P.
template <class E>
__device__ __forceinline__ Jac<E> jac_madd(const Jac<E>& P, const E& x2,
                                           const E& y2, bool inf2,
                                           const FieldC& F) {
  E Z1Z1 = mul_lazy(P.Z, P.Z, F);
  E U2 = mul_lazy(x2, Z1Z1, F);
  E S2 = mul_lazy(mul_lazy(y2, P.Z, F), Z1Z1, F);
  E H = sub2p(U2, P.X, F);
  E HH = mul_lazy(H, H, F);
  E I = double2p(double2p(HH, F), F);                // 4HH
  E J = mul_lazy(H, I, F);
  E r = double2p(sub2p(S2, P.Y, F), F);
  E V = mul_lazy(P.X, I, F);
  Jac<E> R;
  R.X = sub2p(sub2p(mul_lazy(r, r, F), J, F), double2p(V, F), F);
  R.Y = sub2p(mul_lazy(r, sub2p(V, R.X, F), F),
              double2p(mul_lazy(P.Y, J, F), F), F);
  E zh = add2p(P.Z, H, F);
  R.Z = sub2p(sub2p(mul_lazy(zh, zh, F), Z1Z1, F), HH, F);

  const bool inf1 = is_zero_lazy(P.Z, F);
  if (!inf1 && !inf2 && is_zero_lazy(H, F)) {
    if (is_zero_lazy(r, F))
      R = jac_dbl_call(P, F);
    else
      jac_infinity(R, F);
  }
  if (inf1) {
    if (inf2) {
      jac_infinity(R, F);
    } else {
      R.X = x2;
      R.Y = y2;
      set_one(R.Z, F);
    }
  }
  if (inf2) R = P;
  return R;
}

template <class E>
__device__ __forceinline__ void ld_jac(Jac<E>& r, const uint32_t* x,
                                       const uint32_t* y, const uint32_t* z,
                                       long long i) {
  constexpr int W = sizeof(E) / 4;
  ld(r.X, x + i * W);
  ld(r.Y, y + i * W);
  ld(r.Z, z + i * W);
}

template <class E>
__device__ __forceinline__ void st_jac_canon(uint32_t* x, uint32_t* y,
                                             uint32_t* z, long long i,
                                             const Jac<E>& r,
                                             const FieldC& F) {
  constexpr int W = sizeof(E) / 4;
  st(x + i * W, canon(r.X, F));
  st(y + i * W, canon(r.Y, F));
  st(z + i * W, canon(r.Z, F));
}
