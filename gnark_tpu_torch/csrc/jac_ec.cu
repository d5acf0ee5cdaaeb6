// K6 jac_add_mixed, K7 jac_double and K8 jac_add: batched complete
// Jacobian + affine add (with an infinity mask on the affine operand),
// Jacobian double and complete Jacobian + Jacobian add, a = 0, over Fp
// (G1) and Fp2 (G2, u^2 = -|nr|); inputs < 2p, outputs canonical.
//
// Replaces gnark_tpu/ec/pallas_ec.py jac_add_mixed_p, jac_double_p and
// jac_add_p (formulas _jac_add_mixed_t, _jac_double_t and _jac_add_t,
// jac.cuh), which the reference defines for G1 only. In the scan-path
// MSM (msm/pippenger.py) K6 is the bucket update of each step, K8 the
// group fold, the bucket suffix sums and the Horner adds, K7 the Horner
// doublings. Setup's fixed-base ladder runs the same two formulas fused
// in ladder.cu; the per-bit K7 + K6 sequence is what it is checked
// against.
//
// K8 is 16 products (11M + 5S) against 288 B (G1) of traffic per point,
// so it is bound by operations as K6 is; one thread per point (a lane
// pair in G2), the doubling branch taken only by the lanes that need it.
// jac_fold is K8's formula over the scan path's group fold: one thread
// (lane pair) a bucket column adds the column's G points left to right,
// the accumulator lazy in registers, canonicalized once; one launch
// where a halving tree took log2 G launches and a copy of every bucket
// after each.
//
// Bound on this card: operations. A G1 mixed add is 11 Montgomery
// products (4 of them squarings) and a double 7 (5 squarings), x3 base
// products for a G2 product and x2 for a G2 squaring, against 192 B
// (double) to 193 B (add with a broadcast base) of traffic per point:
// ~2900 32-bit multiplies per 193 B for the add. Design: one thread per
// point, the whole formula in registers; the affine operand is read with
// stride 0 when it is one point (it stays in L1), the mask as one byte a
// point. The doubling branch of the complete add is taken only by the
// lanes that need it, through a call, not evaluated on every lane as the
// TPU kernel's selects do. In G2, K6 and K7 give a point to a lane pair
// (Fp2s, fp2s.cuh: c0 on the even lane, c1 on the odd), at twice the
// threads, so each thread holds G1-sized state; the mask and the
// affine operand are read per point. K8 and jac_fold run G2 the same way
// (the one-thread Fp2 reached 255 registers and spilled).
// A 12-word build (off the main path: the scan path, K3) takes the Fp
// products as called functions (GT_NOINLINE): inlined, its nvcc build
// took ~290 s, the longest of all.
#if GT_NW > 8 && !defined(GT_NOINLINE)
#define GT_NOINLINE 1
#endif
#include "jac.cuh"

// E: Fp (G1), or Fp2s (G2, Row<E>::lanes threads a point)
template <class E>
__global__ void jac_madd_kernel(const uint32_t* x1, const uint32_t* y1,
                                const uint32_t* z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint8_t* __restrict__ inf2,
                                long long stride2, uint32_t* ox,
                                uint32_t* oy, uint32_t* oz, long long n,
                                FieldC F) {
  constexpr int W = Row<E>::W;
  long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (i >= n) return;
  Jac<E> P;
  ld_jac(P, x1, y1, z1, i);
  E ax, ay;
  ld(ax, x2 + i * stride2 * W);
  ld(ay, y2 + i * stride2 * W);
  st_jac_canon(ox, oy, oz, i, jac_madd(P, ax, ay, inf2[i] != 0, F), F);
}

template <class E>
__global__ void jac_dbl_kernel(const uint32_t* x1, const uint32_t* y1,
                               const uint32_t* z1, uint32_t* ox, uint32_t* oy,
                               uint32_t* oz, long long n, FieldC F) {
  long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (i >= n) return;
  Jac<E> P;
  ld_jac(P, x1, y1, z1, i);
  st_jac_canon(ox, oy, oz, i, jac_dbl(P, F), F);
}

static const int T = 128;

template <class E>
__global__ void __launch_bounds__(T)
    jac_add_kernel(const uint32_t* x1, const uint32_t* y1,
                   const uint32_t* z1, const uint32_t* x2,
                   const uint32_t* y2, const uint32_t* z2, uint32_t* ox,
                   uint32_t* oy, uint32_t* oz, long long n, FieldC F) {
  long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (i >= n) return;
  Jac<E> P, Q;
  ld_jac(P, x1, y1, z1, i);
  ld_jac(Q, x2, y2, z2, i);
  st_jac_canon(ox, oy, oz, i, jac_add(P, Q, F), F);
}

// column o = w B + b of rows (w G + g) B + b, g = 0 .. G - 1: their sum,
// added left to right
template <class E>
__global__ void __launch_bounds__(T)
    jac_fold_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                    uint32_t* ox, uint32_t* oy, uint32_t* oz, long long ncol,
                    int G, long long B, FieldC F) {
  long long o = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (o >= ncol) return;
  const long long w = o / B;
  const long long r0 = w * G * B + (o - w * B);
  Jac<E> acc;
  ld_jac(acc, x, y, z, r0);
  for (int g = 1; g < G; ++g) {
    Jac<E> Q;
    ld_jac(Q, x, y, z, r0 + g * B);
    acc = jac_add(acc, Q, F);
  }
  st_jac_canon(ox, oy, oz, o, acc, F);
}

// blocks of T threads for n points of `lanes` threads each
static unsigned blocks(long long n, int lanes) {
  return (unsigned)((lanes * n + T - 1) / T);
}

// bcast != 0: x2, y2 hold one point for every row (stride 0).
extern "C" int gt_jac_add_mixed(const void* x1, const void* y1,
                                const void* z1, const void* x2,
                                const void* y2, const void* inf2, void* ox,
                                void* oy, void* oz, long long n, int bcast,
                                int fp2, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  long long stride2 = bcast ? 0 : 1;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(jac_madd_kernel<Fp2s><<<blocks(n, 2), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (const uint8_t*)inf2,
        stride2, (p)ox, (p)oy, (p)oz, n, F));
  else
    jac_madd_kernel<Fp><<<blocks(n, 1), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (const uint8_t*)inf2,
        stride2, (p)ox, (p)oy, (p)oz, n, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_jac_double(const void* x1, const void* y1, const void* z1,
                             void* ox, void* oy, void* oz, long long n,
                             int fp2, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(jac_dbl_kernel<Fp2s><<<blocks(n, 2), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (p)ox, (p)oy, (p)oz, n, F));
  else
    jac_dbl_kernel<Fp><<<blocks(n, 1), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (p)ox, (p)oy, (p)oz, n, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_jac_add(const void* x1, const void* y1, const void* z1,
                          const void* x2, const void* y2, const void* z2,
                          void* ox, void* oy, void* oz, long long n, int fp2,
                          const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(jac_add_kernel<Fp2s><<<blocks(n, 2), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (cp)z2, (p)ox, (p)oy, (p)oz,
        n, F));
  else
    jac_add_kernel<Fp><<<blocks(n, 1), T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (cp)z2, (p)ox, (p)oy, (p)oz,
        n, F);
  return (int)cudaGetLastError();
}

// x, y, z: W G B rows, group-major ((w G + g) B + b); out: W B rows
extern "C" int gt_jac_fold(const void* x, const void* y, const void* z,
                           void* ox, void* oy, void* oz, long long ncol,
                           int G, long long B, int fp2, const void* consts,
                           void* stream) {
  if (ncol <= 0) return 0;
  if (G < 1 || B < 1 || ncol % B) return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(jac_fold_kernel<Fp2s><<<blocks(ncol, 2), T, 0, s>>>(
        (cp)x, (cp)y, (cp)z, (p)ox, (p)oy, (p)oz, ncol, G, B, F));
  else
    jac_fold_kernel<Fp><<<blocks(ncol, 1), T, 0, s>>>(
        (cp)x, (cp)y, (cp)z, (p)ox, (p)oy, (p)oz, ncol, G, B, F);
  return (int)cudaGetLastError();
}
