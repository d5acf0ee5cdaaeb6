// Renes-Costello-Batina complete formulas for a = 0 curves in
// homogeneous projective (X : Y : Z), identity (0 : 1 : 0), generic over
// the coordinate field (Fp for G1, Fp2 for the G2 twist).
//
// Counterparts of gnark_tpu/ec/pallas_ec.py _proj_add_t (Alg. 7),
// _proj_madd_t (Alg. 8) and _proj_dbl_t (Alg. 9), operation for
// operation, in the lazy [0, 2p) class: inputs < 2p, outputs < 2p;
// callers canonicalize at the kernel boundary. b3 = 3b in Montgomery form.
#pragma once

#include "mont.cuh"

template <class E>
struct Proj {
  E X, Y, Z;
};

template <class E>
__device__ __forceinline__ void proj_identity(Proj<E>& r, const FieldC& F) {
  set_zero(r.X);
  set_one(r.Y, F);
  set_zero(r.Z);
}

// RC15 Algorithm 7: P + Q
template <class E>
__device__ __forceinline__ Proj<E> proj_add(const Proj<E>& P,
                                            const Proj<E>& Q, const E& b3,
                                            const FieldC& F) {
  E t0 = mul_lazy(P.X, Q.X, F);
  E t1 = mul_lazy(P.Y, Q.Y, F);
  E t2 = mul_lazy(P.Z, Q.Z, F);
  E t3 = sub2p(mul_lazy(add2p(P.X, P.Y, F), add2p(Q.X, Q.Y, F), F),
               add2p(t0, t1, F), F);
  E t4 = sub2p(mul_lazy(add2p(P.Y, P.Z, F), add2p(Q.Y, Q.Z, F), F),
               add2p(t1, t2, F), F);
  E Y3 = sub2p(mul_lazy(add2p(P.X, P.Z, F), add2p(Q.X, Q.Z, F), F),
               add2p(t0, t2, F), F);
  E X3 = add2p(double2p(t0, F), t0, F);
  t2 = mul_lazy(t2, b3, F);
  E Z3 = add2p(t1, t2, F);
  t1 = sub2p(t1, t2, F);
  Y3 = mul_lazy(Y3, b3, F);
  Proj<E> R;
  R.X = sop2(t3, t1, t4, neg2p(Y3, F), F);
  R.Y = sop2(t1, Z3, Y3, X3, F);
  R.Z = sop2(Z3, t4, X3, t3, F);
  return R;
}

// RC15 Algorithm 8: P + (x2, y2), the affine point not the identity
template <class E>
__device__ __forceinline__ Proj<E> proj_madd(const Proj<E>& P, const E& x2,
                                             const E& y2, const E& b3,
                                             const FieldC& F) {
  E t0 = mul_lazy(P.X, x2, F);
  E t1 = mul_lazy(P.Y, y2, F);
  E t3 = sub2p(mul_lazy(add2p(x2, y2, F), add2p(P.X, P.Y, F), F),
               add2p(t0, t1, F), F);
  E t4 = add2p(mul_lazy(y2, P.Z, F), P.Y, F);
  E Y3 = add2p(mul_lazy(x2, P.Z, F), P.X, F);
  E X3 = add2p(double2p(t0, F), t0, F);
  E t2 = mul_lazy(P.Z, b3, F);
  E Z3 = add2p(t1, t2, F);
  t1 = sub2p(t1, t2, F);
  Y3 = mul_lazy(Y3, b3, F);
  Proj<E> R;
  R.X = sop2(t3, t1, t4, neg2p(Y3, F), F);
  R.Y = sop2(t1, Z3, Y3, X3, F);
  R.Z = sop2(Z3, t4, X3, t3, F);
  return R;
}

// RC15 Algorithm 9: 2P
template <class E>
__device__ __forceinline__ Proj<E> proj_dbl(const Proj<E>& P, const E& b3,
                                            const FieldC& F) {
  E t0 = mul_lazy(P.Y, P.Y, F);
  E Z3 = double2p(double2p(double2p(t0, F), F), F);
  E t1 = mul_lazy(P.Y, P.Z, F);
  E t2 = mul_lazy(mul_lazy(P.Z, P.Z, F), b3, F);
  E X3 = mul_lazy(t2, Z3, F);
  E Y3 = add2p(t0, t2, F);
  Z3 = mul_lazy(t1, Z3, F);
  t2 = add2p(double2p(t2, F), t2, F);
  t0 = sub2p(t0, t2, F);
  Y3 = add2p(X3, mul_lazy(t0, Y3, F), F);
  X3 = double2p(mul_lazy(t0, mul_lazy(P.X, P.Y, F), F), F);
  Proj<E> R;
  R.X = X3;
  R.Y = Y3;
  R.Z = Z3;
  return R;
}

template <class E>
__device__ __forceinline__ void ld_proj(Proj<E>& r, const uint32_t* x,
                                        const uint32_t* y, const uint32_t* z,
                                        long long i) {
  constexpr int W = Row<E>::W;
  ld(r.X, x + i * W);
  ld(r.Y, y + i * W);
  ld(r.Z, z + i * W);
}

template <class E>
__device__ __forceinline__ void st_proj(uint32_t* x, uint32_t* y,
                                        uint32_t* z, long long i,
                                        const Proj<E>& r) {
  constexpr int W = Row<E>::W;
  st(x + i * W, r.X);
  st(y + i * W, r.Y);
  st(z + i * W, r.Z);
}

template <class E>
__device__ __forceinline__ Proj<E> canon(const Proj<E>& P, const FieldC& F) {
  Proj<E> R;
  R.X = canon(P.X, F);
  R.Y = canon(P.Y, F);
  R.Z = canon(P.Z, F);
  return R;
}
