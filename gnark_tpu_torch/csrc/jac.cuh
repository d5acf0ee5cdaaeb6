// Jacobian formulas for a = 0 curves, (X : Y : Z) ~ (X/Z^2, Y/Z^3),
// infinity Z == 0, generic over the coordinate field (Fp for G1; for the
// G2 twist Fp2s of fp2s.cuh on a lane pair).
//
// Counterparts of gnark_tpu/ec/pallas_ec.py _jac_double_t (EFD
// dbl-2009-l), _jac_add_mixed_t (EFD madd-2007-bl plus the selects
// that make it complete) and _jac_add_t (EFD add-2007-bl plus the
// selects), operation for operation, in the lazy [0, 2p)
// class: inputs < 2p, outputs < 2p; callers canonicalize at the kernel
// boundary. The predicates (Z1 == 0, H == 0, r == 0) canonicalize first,
// so a lazy representative of 0 (p itself) counts as 0. With Fp2s every
// predicate holds for the whole pair, so both lanes take the same
// branches: the shuffles of a product need both.
#pragma once

#include "fp2s.cuh"

template <class E>
struct Jac {
  E X, Y, Z;
};

// both components zero: each lane's flag, ANDed across the pair
__device__ __forceinline__ bool is_zero_lazy(const Fp2s& a, const FieldC& F) {
  return pair_all(is_zero_lazy(a.v, F));
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
  E A = sqr_lazy(P.X, F);
  E B = sqr_lazy(P.Y, F);
  E C = sqr_lazy(B, F);
  E t = add2p(P.X, B, F);
  t = sqr_lazy(t, F);
  E D = double2p(sub2p(sub2p(t, A, F), C, F), F);
  E E3 = add2p(double2p(A, F), A, F);               // 3A
  E F2 = sqr_lazy(E3, F);
  Jac<E> R;
  R.X = sub2p(F2, double2p(D, F), F);
  E C8 = double2p(double2p(double2p(C, F), F), F);  // 8C
  R.Y = sub2p(mul_lazy(E3, sub2p(D, R.X, F), F), C8, F);
  R.Z = double2p(mul_lazy(P.Y, P.Z, F), F);
  return R;
}

// The doubling inside the mixed add runs on a few lanes at most; a call
// keeps the formula out of the add's basic block. With
// Fp2s both lanes of a pair call it or neither does.
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
  E Z1Z1 = sqr_lazy(P.Z, F);
  E U2 = mul_lazy(x2, Z1Z1, F);
  E S2 = mul_lazy(mul_lazy(y2, P.Z, F), Z1Z1, F);
  E H = sub2p(U2, P.X, F);
  E HH = sqr_lazy(H, F);
  E I = double2p(double2p(HH, F), F);                // 4HH
  E J = mul_lazy(H, I, F);
  E r = double2p(sub2p(S2, P.Y, F), F);
  E V = mul_lazy(P.X, I, F);
  Jac<E> R;
  R.X = sub2p(sub2p(sqr_lazy(r, F), J, F), double2p(V, F), F);
  R.Y = sub2p(mul_lazy(r, sub2p(V, R.X, F), F),
              double2p(mul_lazy(P.Y, J, F), F), F);
  E zh = add2p(P.Z, H, F);
  R.Z = sub2p(sub2p(sqr_lazy(zh, F), Z1Z1, F), HH, F);

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

// add-2007-bl (a = 0): 11M + 5S, plus the selects of the complete add
// (_jac_add_t): Q at infinity gives P, P at infinity gives Q, P == Q
// doubles, P == -Q gives infinity. The infinity cases return before the
// formula, so Q is not kept live to the end for a select (the G2 lane
// pair's registers); both lanes of a pair take the same return. The
// formula stays one straight run, the H == 0 cases after it.
template <class E>
__device__ __forceinline__ Jac<E> jac_add(const Jac<E>& P, const Jac<E>& Q,
                                          const FieldC& F) {
  if (is_zero_lazy(Q.Z, F)) return P;
  if (is_zero_lazy(P.Z, F)) return Q;
  E Z1Z1 = sqr_lazy(P.Z, F);
  E Z2Z2 = sqr_lazy(Q.Z, F);
  E U1 = mul_lazy(P.X, Z2Z2, F);
  E U2 = mul_lazy(Q.X, Z1Z1, F);
  E S1 = mul_lazy(mul_lazy(P.Y, Q.Z, F), Z2Z2, F);
  E S2 = mul_lazy(mul_lazy(Q.Y, P.Z, F), Z1Z1, F);
  E H = sub2p(U2, U1, F);
  E r = double2p(sub2p(S2, S1, F), F);
  E H2 = double2p(H, F);
  E I = sqr_lazy(H2, F);
  E J = mul_lazy(H, I, F);
  E V = mul_lazy(U1, I, F);
  Jac<E> R;
  R.X = sub2p(sub2p(sqr_lazy(r, F), J, F), double2p(V, F), F);
  R.Y = sub2p(mul_lazy(r, sub2p(V, R.X, F), F),
              double2p(mul_lazy(S1, J, F), F), F);
  E zz = add2p(P.Z, Q.Z, F);
  R.Z = mul_lazy(sub2p(sub2p(sqr_lazy(zz, F), Z1Z1, F), Z2Z2, F), H, F);
  if (is_zero_lazy(H, F)) {
    if (is_zero_lazy(r, F))
      R = jac_dbl_call(P, F);
    else
      jac_infinity(R, F);
  }
  return R;
}

template <class E>
__device__ __forceinline__ void ld_jac(Jac<E>& r, const uint32_t* x,
                                       const uint32_t* y, const uint32_t* z,
                                       long long i) {
  constexpr int W = Row<E>::W;
  ld(r.X, x + i * W);
  ld(r.Y, y + i * W);
  ld(r.Z, z + i * W);
}

template <class E>
__device__ __forceinline__ void st_jac_canon(uint32_t* x, uint32_t* y,
                                             uint32_t* z, long long i,
                                             const Jac<E>& r,
                                             const FieldC& F) {
  constexpr int W = Row<E>::W;
  st(x + i * W, canon(r.X, F));
  st(y + i * W, canon(r.Y, F));
  st(z + i * W, canon(r.Z, F));
}
