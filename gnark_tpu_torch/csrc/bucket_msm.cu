// K4 bucket_msm: signed-digit Pippenger bucket accumulation. For every
// window w and bucket j, the sum of the points whose digit d in window w
// has |d| = j + 1, with y negated for d < 0; zero digits and infinity
// points are left out. Output: (W * 128) canonical projective buckets.
//
// Replaces gnark_tpu/msm/bucket_kernel.py _msm_device's pallas_call
// (kernel _accumulate_kernel), for G1 (Fp) and G2 (Fp2).
//
// The TPU kernel gathers and writes back every bucket with one-hot masks
// because the TPU has no per-lane scatter. That is not copied. Here the
// wrapper groups the (point, digit) pairs by (window, bucket) key with a
// sort and cuts each bucket's list into fixed segments of at most SEG
// pairs. Pass 1 runs one thread per segment: it accumulates its pairs
// with the complete mixed add (RC15 Alg. 8) into a projective point held
// in registers and writes the partial sum. Pass 2 runs one thread per
// bucket and folds that bucket's partials with the complete add (RC15
// Alg. 7). Fixed segments keep a skewed bucket (many points on one
// digit) from serializing one thread; duplicate points in one bucket are
// handled by the complete formulas.
//
// Bound on this card: operations, ~17 Montgomery products per mixed add
// (about 3 x that for G2) over ~32 adds per point; the random point
// gathers (64 B / 128 B a pair) are a few percent of that in bytes.
#include "proj.cuh"

// The formulas are called, not inlined, inside the data-dependent loops:
// a fully inlined Fp2 formula in a loop body is a very large basic block.
template <class E>
__device__ __noinline__ Proj<E> madd_step(const Proj<E>& acc, const E& x,
                                          const E& y, const E& b3,
                                          const FieldC& F) {
  return proj_madd(acc, x, y, b3, F);
}

template <class E>
__device__ __noinline__ Proj<E> add_step(const Proj<E>& acc,
                                         const Proj<E>& part, const E& b3,
                                         const FieldC& F) {
  return proj_add(acc, part, b3, F);
}

template <class E>
__global__ void bucket_acc_kernel(const uint32_t* __restrict__ px,
                                  const uint32_t* __restrict__ py,
                                  const int32_t* __restrict__ entries,
                                  const int32_t* __restrict__ seg_start,
                                  const int32_t* __restrict__ seg_len,
                                  long long nseg, uint32_t* sx, uint32_t* sy,
                                  uint32_t* sz, E b3, FieldC F) {
  constexpr int W = sizeof(E) / 4;
  long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const int start = seg_start[s];
  const int len = seg_len[s];
  Proj<E> acc;
  {
    int e = entries[start];
    long long idx = e >> 1;
    ld(acc.X, px + idx * W);
    ld(acc.Y, py + idx * W);
    if (e & 1) acc.Y = neg2p(acc.Y, F);
    set_one(acc.Z, F);
  }
  for (int t = 1; t < len; ++t) {
    int e = entries[start + t];
    long long idx = e >> 1;
    E x, y;
    ld(x, px + idx * W);
    ld(y, py + idx * W);
    if (e & 1) y = neg2p(y, F);
    acc = madd_step(acc, x, y, b3, F);
  }
  st_proj(sx, sy, sz, s, acc);
}

template <class E>
__global__ void bucket_fold_kernel(const uint32_t* __restrict__ sx,
                                   const uint32_t* __restrict__ sy,
                                   const uint32_t* __restrict__ sz,
                                   const int32_t* __restrict__ seg_off,
                                   long long nb, uint32_t* ox, uint32_t* oy,
                                   uint32_t* oz, E b3, FieldC F) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  Proj<E> acc;
  proj_identity(acc, F);
  for (int s = seg_off[b]; s < seg_off[b + 1]; ++s) {
    Proj<E> part;
    ld_proj(part, sx, sy, sz, s);
    acc = add_step(acc, part, b3, F);
  }
  st_proj(ox, oy, oz, b, canon(acc, F));
}

template <class E>
static int launch(const void* px, const void* py, const void* entries,
                  const void* seg_start, const void* seg_len, long long nseg,
                  void* sx, void* sy, void* sz, const void* seg_off,
                  long long nb, void* ox, void* oy, void* oz, E b3, FieldC F,
                  cudaStream_t s) {
  const int T = 128;
  typedef const uint32_t* cp;
  typedef const int32_t* ci;
  typedef uint32_t* p;
  if (nseg > 0)
    bucket_acc_kernel<E><<<(unsigned)((nseg + T - 1) / T), T, 0, s>>>(
        (cp)px, (cp)py, (ci)entries, (ci)seg_start, (ci)seg_len, nseg,
        (p)sx, (p)sy, (p)sz, b3, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bucket_fold_kernel<E><<<(unsigned)((nb + T - 1) / T), T, 0, s>>>(
      (cp)sx, (cp)sy, (cp)sz, (ci)seg_off, nb, (p)ox, (p)oy, (p)oz, b3, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_bucket_msm(const void* px, const void* py,
                             const void* entries, const void* seg_start,
                             const void* seg_len, void* sx, void* sy,
                             void* sz, const void* seg_off, void* ox,
                             void* oy, void* oz, long long nseg, long long nb,
                             int fp2, const void* consts, const void* b3,
                             void* stream) {
  if (nb <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp2)
    return launch<Fp2>(px, py, entries, seg_start, seg_len, nseg, sx, sy, sz,
                       seg_off, nb, ox, oy, oz,
                       fp2_from_host((const uint32_t*)b3), F, s);
  return launch<Fp>(px, py, entries, seg_start, seg_len, nseg, sx, sy, sz,
                    seg_off, nb, ox, oy, oz,
                    fp_from_host((const uint32_t*)b3), F, s);
}
