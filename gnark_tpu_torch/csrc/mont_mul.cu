// K1 mont_mul: out[i] = a[i] * b[i or 0] * R^-1 mod p, canonical.
//
// Replaces gnark_tpu/ff/pallas_ops.py mul_p (elementwise Montgomery
// product with a broadcast operand: coset and n^-1 scaling) and
// gnark_tpu/ntt/fourstep.py _mid_mul (the four-step mid twiddle).
//
// Bound on this card: bytes. At 2^20 elements it reads 64 MB and writes
// 32 MB, about 29 us at 3.35 TB/s, while the ~264 32-bit multiplies of
// one product over 2^20 elements take about half that at the int32
// multiply rate. Design: one thread per element, each element loaded as
// two 16-byte vectors (32 contiguous bytes), so a warp reads one
// contiguous kilobyte; the broadcast operand is one element every thread
// reads (it stays in L1).
#include "mont.cuh"

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n,
                                int bcast, FieldC F) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y;
  ld(x, a + i * GT_NW);
  ld(y, b + (bcast ? 0 : i) * GT_NW);
  st(out + i * GT_NW, canon(mul_lazy(x, y, F), F));
}

extern "C" int gt_mont_mul(const void* a, const void* b, void* out,
                           long long n, int bcast, const void* consts,
                           void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  const int T = 256;
  long long blocks = (n + T - 1) / T;
  mont_mul_kernel<<<(unsigned)blocks, T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, bcast, F);
  return (int)cudaGetLastError();
}
