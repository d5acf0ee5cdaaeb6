// K5 butterfly: one radix-2 DIT stage of an n-point NTT, in place on the
// (n, 8) word vector y (already in bit-reversed order for the first
// stage). With half = 2^lh, butterfly b pairs i0 = (b / half) * 2 half +
// j and i1 = i0 + half, j = b mod half:
//   (y[i0], y[i1]) <- (e + o tw[j], e - o tw[j]),  e = y[i0], o = y[i1],
// inputs < 2p, outputs canonical.
//
// Replaces gnark_tpu/ff/pallas_ops.py butterfly_p, the stage of the
// radix-2 plan the reference takes below the four-step threshold
// (gnark_tpu/ntt/domain.py _ntt_kernel).
//
// Bound on this card: bytes at large n (one Montgomery product, 264
// 32-bit multiplies, per 96-112 B moved), and at the plan's sizes (n <
// 2^14, at most 8192 butterflies) the launch itself: a stage moves under
// a megabyte. Design: one thread per butterfly; each element is two
// 16-byte loads; the twiddle table (half, 8) is read by j, so the
// threads of a block share it through L1. Not the TPU's (T, L) tiling:
// the even and odd halves are not split into separate arrays.
#include "mont.cuh"

__global__ void butterfly_kernel(uint32_t* y, const uint32_t* __restrict__ tw,
                                 long long nb, int lh, FieldC F) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const long long j = b & ((1LL << lh) - 1);
  const long long i0 = ((b >> lh) << (lh + 1)) + j;
  const long long i1 = i0 + (1LL << lh);
  Fp e, o, w;
  ld(e, y + i0 * GT_NW);
  ld(o, y + i1 * GT_NW);
  ld(w, tw + j * GT_NW);
  Fp t = mul_lazy(o, w, F);
  st(y + i0 * GT_NW, canon(add2p(e, t, F), F));
  st(y + i1 * GT_NW, canon(sub2p(e, t, F), F));
}

// y: n = 2 * nb elements, updated in place; tw: 2^lh stage twiddles.
extern "C" int gt_butterfly(void* y, const void* tw, long long nb, int lh,
                            const void* consts, void* stream) {
  if (nb <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  const int T = 256;
  butterfly_kernel<<<(unsigned)((nb + T - 1) / T), T, 0,
                     (cudaStream_t)stream>>>((uint32_t*)y,
                                             (const uint32_t*)tw, nb, lh, F);
  return (int)cudaGetLastError();
}
