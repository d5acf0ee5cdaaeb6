// K5: a whole radix-2 DIT NTT of n = 2^k points (GT_NW-word elements: 8,
// or 12 for BW6-761's scalar field) in at most two launches for n <=
// 2^13:
//   gt_ntt_seg   one block a segment of S = min(n, 1024) points: reads
//                its points through the bit-reverse permutation (the
//                gather folded into the load), runs stages 1..min(k, 10)
//                in shared memory, writes the segment;
//   gt_ntt_pass  stages s0 + 1 .. s0 + r (r <= 3) in registers, in place:
//                one thread the 2^r points i = base + m 2^s0 that those
//                stages pair (a radix-2^r step). After gt_ntt_seg, k - 10
//                stages are left: none up to 2^10, at most 3 up to 2^13
//                (larger n, past the four-step threshold, take one pass
//                for each 3 stages). One pass with r = 1 is one stage.
// Stage s (half = 2^(s-1)) maps (y[i0], y[i1]), i1 = i0 + half, j = i0
// mod half, to (e + o tw_s[j], e - o tw_s[j]); inputs < 2p, outputs
// canonical. Twiddles: the per-stage tables laid end to end, stage s at
// row 2^(s-1) - tw0 (tw0 = 1: every stage from the first).
//
// Replaces gnark_tpu/ff/pallas_ops.py butterfly_p as
// gnark_tpu/ntt/domain.py _ntt_kernel runs it, one pallas_call a stage
// after an XLA gather (the radix-2 plan below the four-step threshold).
//
// Bound on this card: at 2^13 a transform moves ~0.5 MB (0.15 us) and
// does 4096 x 13 Montgomery products (~0.8 us at the card's multiply
// rate); what it cost before was launches: 13 of ~25-50 us, plus the
// gather's. Design: two launches. A 2^13 vector (256 KB) is larger than
// a block's shared memory, so 1,024-point segments (32 KB each, eight
// blocks at 2^13) run the first ten stages on chip, and the last three
// stages are one radix-8 step in registers. Shared memory is word-major
// (word w of point i at sh[w * S + i]), so a warp's 32 points are 32
// banks.
#include "mont.cuh"

#define SEG_LOG 10
#define SEG (1 << SEG_LOG)

__global__ void __launch_bounds__(SEG / 2)
    ntt_seg_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ tw, int k, int S, int stages,
                   FieldC F) {
  __shared__ uint32_t sh[GT_NW * SEG];   // 48 KB at 12 words: the static
                                          // limit, exactly
  const int t = threadIdx.x;
  const unsigned base = blockIdx.x * (unsigned)S;
  for (int i = t; i < S; i += blockDim.x) {
    const unsigned src = __brev(base + i) >> (32 - k);
    Fp v;
    ld(v, x + (long long)src * GT_NW);
#pragma unroll
    for (int w = 0; w < GT_NW; ++w) sh[w * S + i] = v.w[w];
  }
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int half = 1 << s;
    const int j = t & (half - 1);
    const int i0 = ((t >> s) << (s + 1)) + j, i1 = i0 + half;
    Fp e, o, w;
#pragma unroll
    for (int q = 0; q < GT_NW; ++q) {
      e.w[q] = sh[q * S + i0];
      o.w[q] = sh[q * S + i1];
    }
    ld(w, tw + (long long)(half - 1 + j) * GT_NW);
    const Fp m = mul_lazy(o, w, F);
    const Fp a = add2p(e, m, F), b = sub2p(e, m, F);
#pragma unroll
    for (int q = 0; q < GT_NW; ++q) {
      sh[q * S + i0] = a.w[q];
      sh[q * S + i1] = b.w[q];
    }
    __syncthreads();
  }
  for (int i = t; i < S; i += blockDim.x) {
    Fp v;
#pragma unroll
    for (int w = 0; w < GT_NW; ++w) v.w[w] = sh[w * S + i];
    st(y + ((long long)base + i) * GT_NW, canon(v, F));
  }
}

template <int R>
__global__ void ntt_pass_kernel(uint32_t* y, const uint32_t* __restrict__ tw,
                                long long nt, int s0, long long tw0,
                                FieldC F) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= nt) return;
  const long long lo = t & ((1LL << s0) - 1);
  const long long base = ((t >> s0) << (s0 + R)) + lo;
  Fp e[1 << R];
#pragma unroll
  for (int m = 0; m < (1 << R); ++m)
    ld(e[m], y + (base + ((long long)m << s0)) * GT_NW);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long half = 1LL << (s0 + q);
    const uint32_t* tws = tw + (half - tw0) * GT_NW;
#pragma unroll
    for (int m = 0; m < (1 << R); ++m) {
      if (m & (1 << q)) continue;
      const int m1 = m | (1 << q);
      const long long j = lo + ((long long)(m & ((1 << q) - 1)) << s0);
      Fp w;
      ld(w, tws + j * GT_NW);
      const Fp p = mul_lazy(e[m1], w, F);
      e[m1] = sub2p(e[m], p, F);
      e[m] = add2p(e[m], p, F);
    }
  }
#pragma unroll
  for (int m = 0; m < (1 << R); ++m)
    st(y + (base + ((long long)m << s0)) * GT_NW, canon(e[m], F));
}

// x, y: n = 2^k points (x is not written); stages = min(k, 10); the
// twiddle table starts at stage 1
extern "C" int gt_ntt_seg(const void* x, void* y, const void* tw, int k,
                          const void* consts, void* stream) {
  if (k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  const int stages = k < SEG_LOG ? k : SEG_LOG;
  const int S = 1 << stages;
  ntt_seg_kernel<<<(unsigned)(1LL << (k - stages)), S / 2, 0,
                   (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)y,
                                           (const uint32_t*)tw, k, S, stages,
                                           F);
  return (int)cudaGetLastError();
}

// stages s0 + 1 .. s0 + r of y (n points) in place; stage s's twiddles at
// row 2^(s-1) - tw0 of tw
extern "C" int gt_ntt_pass(void* y, const void* tw, long long n, int s0,
                           int r, long long tw0, const void* consts,
                           void* stream) {
  if (r < 1 || r > 3 || n < (2LL << (s0 + r - 1)))
    return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  const long long nt = n >> r;
  const int T = 128;
  const unsigned blocks = (unsigned)((nt + T - 1) / T);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* py = (uint32_t*)y;
  const uint32_t* ptw = (const uint32_t*)tw;
  if (r == 1)
    ntt_pass_kernel<1><<<blocks, T, 0, s>>>(py, ptw, nt, s0, tw0, F);
  else if (r == 2)
    ntt_pass_kernel<2><<<blocks, T, 0, s>>>(py, ptw, nt, s0, tw0, F);
  else
    ntt_pass_kernel<3><<<blocks, T, 0, s>>>(py, ptw, nt, s0, tw0, F);
  return (int)cudaGetLastError();
}
