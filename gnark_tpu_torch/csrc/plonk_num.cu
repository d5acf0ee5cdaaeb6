// K14, the PLONK quotient's numerator in one pass over the rows
// (prove.go:1040-1106; the reference computes it as one XLA expression,
// gnark_tpu/backend/plonk_device.py:327 _numerator_t, around no Pallas
// kernel). Before this kernel the port ran it as 22 K1, 21 K10 and one
// K11 launch, each over the whole column (backend/plonk_num.py
// numerator_plain). For every row i, with x = c w[i]:
//
//   gate  = ql l + qr r + qm l r + qo o + qk
//   id    = (l + beta x + gamma)(r + beta u x + gamma)(o + beta u^2 x + gamma)
//   sigma = (l + beta s1 + gamma)(r + beta s2 + gamma)(o + beta s3 + gamma)
//   out   = (gate + alpha (sigma zs - id z)
//            + alpha^2 N^-1 zdiv (z - 1)) / Z_H(x)
//
// zdiv = Z_H(x) / (x - 1), so alpha^2 N^-1 zdiv = alpha^2 L1(x). zdiv and
// the table of 1 / Z_H(x) (row i takes entry i % period) depend on the
// points alone and are made once a domain and shift
// (backend/plonk_num.NumPoints); beta c, beta u c, beta u^2 c and alpha^2
// N^-1 are host products, so x itself is never formed.
//
// One thread a row, neighbouring threads on neighbouring rows: each
// column's element is one whole 32-byte sector. Every value stays lazy
// (< 2p) in registers and the row is canonicalized once at the store, so
// the output is bit-exact with the step-by-step composition. A row: 21
// products (the step-by-step one: 22 and an inversion) in 16 Montgomery
// reductions (sop4 for the gate's four, sop2 for the ordering's two and
// for alpha ord + alpha^2 L1 (z - 1)), 4,864 32-bit multiplies
// (mont.cuh: 264 a product, 392 a sop2, 648 a sop4);
// 15 reads and one write, 512 B. Bound on this card at 2^20 rows: the
// multiplies, ~0.31 ms at the multiply rate (the bytes ~0.16 ms).
#include "mont.cuh"

#define GT_NUM_T 256        // threads a block
#define GT_NUM_MAXP 8       // entries of the 1 / Z_H table at most

// the input columns, n rows of 8 words each, in this order
enum { NL, NR, NO, NZ, NZS, NQL, NQR, NQM, NQO, NQK, NS1, NS2, NS3, NW_,
       NZDIV, NCOLS };
struct NumCols {
  const uint32_t* c[NCOLS];
};

// per call, Montgomery form, in this order: gamma, beta, beta c,
// beta u c, beta u^2 c, alpha, alpha^2 N^-1, then the 1 / Z_H table
// (period entries)
enum { KG, KB, KBC, KBUC, KBU2C, KA, KA2N, NK };
struct NumK {
  Fp k[NK];
  Fp zhi[GT_NUM_MAXP];
};

// l + k v + gamma
__device__ __forceinline__ Fp lin_term(const Fp& l, const Fp& k, const Fp& v,
                                       const Fp& gamma, const FieldC& F) {
  return add2p(add2p(l, mul_lazy(k, v, F), F), gamma, F);
}

__global__ void __launch_bounds__(GT_NUM_T)
    numerator_kernel(NumCols C, uint32_t* __restrict__ out, long long n,
                     int period, NumK K, FieldC F) {
  const long long i = blockIdx.x * (long long)GT_NUM_T + threadIdx.x;
  if (i >= n) return;
  const long long e = i * GT_NW;
  Fp l, r, o, a, b, c, d, t;
  ld(l, C.c[NL] + e);
  ld(r, C.c[NR] + e);
  ld(o, C.c[NO] + e);
  // gate
  ld(a, C.c[NQL] + e);
  ld(b, C.c[NQR] + e);
  ld(c, C.c[NQM] + e);
  ld(d, C.c[NQO] + e);
  Fp gate = sop4(a, l, b, r, c, mul_lazy(l, r, F), d, o, F);
  ld(t, C.c[NQK] + e);
  gate = add2p(gate, t, F);
  // sigma and identity products
  ld(t, C.c[NS1] + e);
  a = lin_term(l, K.k[KB], t, K.k[KG], F);
  ld(t, C.c[NS2] + e);
  a = mul_lazy(a, lin_term(r, K.k[KB], t, K.k[KG], F), F);
  ld(t, C.c[NS3] + e);
  a = mul_lazy(a, lin_term(o, K.k[KB], t, K.k[KG], F), F);
  ld(t, C.c[NW_] + e);
  b = lin_term(l, K.k[KBC], t, K.k[KG], F);
  b = mul_lazy(b, lin_term(r, K.k[KBUC], t, K.k[KG], F), F);
  b = mul_lazy(b, lin_term(o, K.k[KBU2C], t, K.k[KG], F), F);
  // ordering = sigma zs - id z; L1 (z - 1) up to N^-1
  ld(c, C.c[NZ] + e);
  ld(t, C.c[NZS] + e);
  a = sop2(a, t, neg2p(b, F), c, F);
  ld(t, C.c[NZDIV] + e);
  Fp one;
  set_one(one, F);
  b = mul_lazy(t, sub2p(c, one, F), F);
  a = add2p(gate, sop2(K.k[KA], a, K.k[KA2N], b, F), F);
  // / Z_H(x): entry i % period of the table, by selects (a dynamic index
  // would copy the parameter array to local memory)
  const int k = period == 1 ? 0 : (int)(i % period);
  t = K.zhi[0];
#pragma unroll
  for (int j = 1; j < GT_NUM_MAXP; ++j)
    if (j == k) t = K.zhi[j];
  st(out + e, canon(mul_lazy(a, t, F), F));
}

// cols: NCOLS device pointers in NumCols order; consts: (NK + period)
// x 8 words in NumK's order; 1 <= period <= GT_NUM_MAXP. One launch.
extern "C" int gt_plonk_numerator(const void* const* cols, void* out,
                                  const void* consts, long long n,
                                  int period, const void* fconsts,
                                  void* stream) {
  if (n <= 0) return 0;
  const long long nb = (n + GT_NUM_T - 1) / GT_NUM_T;
  if (period < 1 || period > GT_NUM_MAXP || nb > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  NumCols C;
  for (int j = 0; j < NCOLS; ++j) C.c[j] = (const uint32_t*)cols[j];
  const uint32_t* k = (const uint32_t*)consts;
  NumK K;
  for (int j = 0; j < NK; ++j) K.k[j] = fp_from_host(k + j * GT_NW);
  for (int j = 0; j < GT_NUM_MAXP; ++j)     // unused entries: entry 0
    K.zhi[j] = fp_from_host(k + (NK + (j < period ? j : 0)) * GT_NW);
  FieldC F = field_from_host((const uint32_t*)fconsts);
  numerator_kernel<<<(unsigned)nb, GT_NUM_T, 0, (cudaStream_t)stream>>>(
      C, (uint32_t*)out, n, period, K, F);
  return (int)cudaGetLastError();
}
