// K2 row_fft: every radix-2 DIF stage of `rows` independent S-point rows,
// natural order in, bit-reversed order out, canonical.
//
// Replaces gnark_tpu/ntt/fourstep.py _row_fft (kernel _row_fft_kernel),
// the two passes of the four-step NTT.
//
// Bound on this card: operations. A row of S points costs (S/2) log2 S
// Montgomery products, which at S = 1024 over 1024 rows is about 1.4e9
// 32-bit multiplies (~83 us at the int32 multiply rate), against 64 MB of
// traffic (~19 us). Design: one block per row; the row (32 B a point,
// 32 KB at S = 1024) lives in shared memory through all stages, with a
// barrier between stages, so device memory sees one read and one write
// per point. Each thread runs butterflies; the per-stage twiddles
// (k, S, 8) are read from global memory, where they stay in L2 across
// the row blocks. Arithmetic stays in the lazy [0, 2p) class and is
// canonicalized once on the way out.
#include "mont.cuh"

__device__ __forceinline__ void lds(Fp& r, const uint32_t* s) {
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = s[i];
}

__device__ __forceinline__ void sts(uint32_t* s, const Fp& a) {
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) s[i] = a.w[i];
}

__global__ void row_fft_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ tw, int S,
                               int logS, FieldC F) {
  extern __shared__ uint32_t sh[];
  const long long base = (long long)blockIdx.x * S * GT_NW;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    Fp v;
    ld(v, x + base + (long long)i * GT_NW);
    sts(sh + i * GT_NW, v);
  }
  __syncthreads();
  for (int s = 0; s < logS; ++s) {
    const int lh = logS - s - 1;           // log2(half)
    const int half = 1 << lh;
    const uint32_t* tws = tw + (long long)s * S * GT_NW;
    for (int b = threadIdx.x; b < (S >> 1); b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> lh) << (lh + 1)) + j;
      const int i1 = i0 + half;
      Fp u, v, w;
      lds(u, sh + i0 * GT_NW);
      lds(v, sh + i1 * GT_NW);
      ld(w, tws + (long long)i1 * GT_NW);
      sts(sh + i0 * GT_NW, add2p(u, v, F));
      sts(sh + i1 * GT_NW, mul_lazy(sub2p(u, v, F), w, F));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    Fp v;
    lds(v, sh + i * GT_NW);
    st(out + base + (long long)i * GT_NW, canon(v, F));
  }
}

extern "C" int gt_row_fft(const void* x, void* out, const void* tw, int rows,
                          int S, int logS, const void* consts, void* stream) {
  if (rows <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  size_t smem = (size_t)S * GT_NW * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = S / 2 < 1 ? 1 : (S / 2 > 512 ? 512 : S / 2);
  row_fft_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, S, logS, F);
  return (int)cudaGetLastError();
}
