// K6 jac_add_mixed and K7 jac_double: batched complete Jacobian + affine
// add (with an infinity mask on the affine operand) and Jacobian double,
// a = 0, over Fp (G1) and Fp2 (G2, u^2 = -1); inputs < 2p, outputs
// canonical.
//
// Replaces gnark_tpu/ec/pallas_ec.py jac_add_mixed_p and jac_double_p
// (formulas _jac_add_mixed_t and _jac_double_t, jac.cuh), which the
// reference defines for G1 only. Here they carry the fixed-base ladder of
// Groth16 Setup (gnark_tpu/msm/fixed_base.py batch_scalar_mul): per bit,
// one double of every accumulator and one mixed add of the one base
// point, where inf2 = ~bit turns the add into the identity on R.
//
// Bound on this card: operations. A G1 mixed add is 11 Montgomery
// products and a double 7 (x3 base products for G2), against 192 B
// (double) to 193 B (add with a broadcast base) of traffic per point:
// ~2900 32-bit multiplies per 193 B for the add. Design: one thread per
// point, the whole formula in registers; the affine operand is read with
// stride 0 when it is one point (it stays in L1), the mask as one byte a
// point. The doubling branch of the complete add is taken only by the
// lanes that need it, through a call, not evaluated on every lane as the
// TPU kernel's selects do. The Fp2 instantiation is expected to reach
// 255 registers and spill (see the ptxas report of the build).
#include "jac.cuh"

template <class E>
__global__ void jac_madd_kernel(const uint32_t* x1, const uint32_t* y1,
                                const uint32_t* z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                const uint8_t* __restrict__ inf2,
                                long long stride2, uint32_t* ox,
                                uint32_t* oy, uint32_t* oz, long long n,
                                FieldC F) {
  constexpr int W = sizeof(E) / 4;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
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
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> P;
  ld_jac(P, x1, y1, z1, i);
  st_jac_canon(ox, oy, oz, i, jac_dbl(P, F), F);
}

static const int T = 128;

// bcast != 0: x2, y2 hold one point for every row (stride 0).
extern "C" int gt_jac_add_mixed(const void* x1, const void* y1,
                                const void* z1, const void* x2,
                                const void* y2, const void* inf2, void* ox,
                                void* oy, void* oz, long long n, int bcast,
                                int fp2, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  unsigned blocks = (unsigned)((n + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  long long stride2 = bcast ? 0 : 1;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    jac_madd_kernel<Fp2><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (const uint8_t*)inf2,
        stride2, (p)ox, (p)oy, (p)oz, n, F);
  else
    jac_madd_kernel<Fp><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (const uint8_t*)inf2,
        stride2, (p)ox, (p)oy, (p)oz, n, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_jac_double(const void* x1, const void* y1, const void* z1,
                             void* ox, void* oy, void* oz, long long n,
                             int fp2, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  unsigned blocks = (unsigned)((n + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    jac_dbl_kernel<Fp2><<<blocks, T, 0, s>>>((cp)x1, (cp)y1, (cp)z1, (p)ox,
                                             (p)oy, (p)oz, n, F);
  else
    jac_dbl_kernel<Fp><<<blocks, T, 0, s>>>((cp)x1, (cp)y1, (cp)z1, (p)ox,
                                            (p)oy, (p)oz, n, F);
  return (int)cudaGetLastError();
}
