// K3 proj_ec: batched complete projective add (RC15 Alg. 7) and double
// (RC15 Alg. 9) for a = 0 curves, over Fp (G1) and Fp2 (G2), inputs
// < 2p, outputs canonical.
//
// Replaces gnark_tpu/ec/pallas_ec.py proj_add_p and proj_double_p, the
// MSM epilogue's group operations (bucket suffix sums and the Horner
// ladder over windows).
//
// Bound on this card: operations at the suffix-sum width (4096 points,
// ~18 Montgomery products each for G1, ~60 base products for G2), and
// launch latency at the Horner width of one point, which is most of the
// ~300 launches of an MSM epilogue. Design: one thread per point, the
// whole formula in registers; the Fp2 instantiation spills (see the
// ptxas report of the build). Batching the Horner ladder into one
// launch is later work.
// A 12-word build (K3: off every path) takes the Fp products as called
// functions (GT_NOINLINE), a shorter build.
#if GT_NW > 8 && !defined(GT_NOINLINE)
#define GT_NOINLINE 1
#endif
#include "proj.cuh"

template <class E>
__global__ void proj_add_kernel(const uint32_t* x1, const uint32_t* y1,
                                const uint32_t* z1, const uint32_t* x2,
                                const uint32_t* y2, const uint32_t* z2,
                                uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                long long n, E b3, FieldC F) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<E> P, Q;
  ld_proj(P, x1, y1, z1, i);
  ld_proj(Q, x2, y2, z2, i);
  st_proj(ox, oy, oz, i, canon(proj_add(P, Q, b3, F), F));
}

template <class E>
__global__ void proj_dbl_kernel(const uint32_t* x1, const uint32_t* y1,
                                const uint32_t* z1, uint32_t* ox,
                                uint32_t* oy, uint32_t* oz, long long n,
                                E b3, FieldC F) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<E> P;
  ld_proj(P, x1, y1, z1, i);
  st_proj(ox, oy, oz, i, canon(proj_dbl(P, b3, F), F));
}

static const int T = 128;

extern "C" int gt_proj_add(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* ox, void* oy, void* oz, long long n,
                           int fp2, const void* consts, const void* b3,
                           void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  unsigned blocks = (unsigned)((n + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(proj_add_kernel<Fp2><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (cp)z2, (p)ox, (p)oy, (p)oz,
        n, fp2_from_host((const uint32_t*)b3), F));
  else
    proj_add_kernel<Fp><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (cp)x2, (cp)y2, (cp)z2, (p)ox, (p)oy, (p)oz,
        n, fp_from_host((const uint32_t*)b3), F);
  return (int)cudaGetLastError();
}

extern "C" int gt_proj_double(const void* x1, const void* y1, const void* z1,
                              void* ox, void* oy, void* oz, long long n,
                              int fp2, const void* consts, const void* b3,
                              void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  unsigned blocks = (unsigned)((n + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  if (fp2)
    GT_FP2_LAUNCH(proj_dbl_kernel<Fp2><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (p)ox, (p)oy, (p)oz, n,
        fp2_from_host((const uint32_t*)b3), F));
  else
    proj_dbl_kernel<Fp><<<blocks, T, 0, s>>>(
        (cp)x1, (cp)y1, (cp)z1, (p)ox, (p)oy, (p)oz, n,
        fp_from_host((const uint32_t*)b3), F);
  return (int)cudaGetLastError();
}
