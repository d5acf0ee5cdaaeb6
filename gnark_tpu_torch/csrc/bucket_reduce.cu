// K9 bucket_reduce: the epilogue of the bucket MSM in one launch. From
// the W * B projective bucket sums of K4 (B = 2^(c-1), entry w*B + j the
// sum of window w's points with |digit| = j + 1) it computes the MSM's
// point sum_w 2^(c w) T_w, T_w = sum_j (j + 1) P_{w,j}; output canonical.
//
// Replaces, on the bucket path, the epilogue of
// gnark_tpu/msm/bucket_kernel.py _msm_device (:372-404): two suffix sums
// over the buckets of each window and a Horner loop over the windows,
// each step a call of ec/pallas_ec.py proj_add_p / proj_double_p (K3
// here, ~314 batch-1 or narrow launches an MSM).
//
// Bound on this card: the work is ~2 adds a bucket plus the lifts below,
// a few million products at most, so the bound by operations is under a
// millisecond; what bounds the kernel is latency: the Horner chain is
// c (W - 1) dependent doublings and W adds on one thread (~250 at any c).
// Design:
//  * a thread runs L consecutive buckets of one window from the top with
//    a running sum S and a weighted sum V (2 complete adds a bucket), so
//    V = sum (j - lo + 1) P_j; it lifts its chunk into place as
//    V + lo * S, lo the number of buckets below the chunk (a
//    double-and-add over the bits of lo);
//  * a block's T threads sum their results by a tree in shared memory;
//    a window has nblk blocks (L * T * nblk = B, set by the caller);
//  * the last block to finish (an atomic counter) adds each window's
//    block sums and runs Horner over the windows on one thread.
// The complete RC15 formulas (Alg. 7 and 9, proj.cuh) take empty
// buckets (the identity), equal points and infinities without branches.
// The formulas are calls: a chunk loop is short, and the Fp2 formulas
// inlined into loops are what nvcc has failed on.
#include "fp2s.cuh"
#include "proj.cuh"

#define GT_RT 128   // chunks a block at most (G2: two threads a chunk)

template <class E>
__device__ __noinline__ Proj<E> add_call(const Proj<E>& P, const Proj<E>& Q,
                                         const E& b3, const FieldC& F) {
  return proj_add(P, Q, b3, F);
}

template <class E>
__device__ __noinline__ Proj<E> dbl_call(const Proj<E>& P, const E& b3,
                                         const FieldC& F) {
  return proj_dbl(P, b3, F);
}

// the block sums that other blocks wrote, past L1
template <class E>
__device__ __forceinline__ void ld_proj_cg(Proj<E>& r, const uint32_t* x,
                                           const uint32_t* y,
                                           const uint32_t* z, long long i) {
  constexpr int W = Row<E>::W;
  ld_cg(r.X, x + i * W);
  ld_cg(r.Y, y + i * W);
  ld_cg(r.Z, z + i * W);
}

// E: Fp (G1), or Fp2s (G2: the two threads of a pair hold c0 and c1 of
// one chunk's values, so T chunks take 2 T threads)
template <class E, class H>
__global__ void __launch_bounds__(2 * GT_RT) bucket_reduce_kernel(
    const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
    const uint32_t* __restrict__ bz, uint32_t* px, uint32_t* py,
    uint32_t* pz, unsigned int* counter, uint32_t* ox, uint32_t* oy,
    uint32_t* oz, int W, int c, int L, int nblk, H b3h, FieldC F) {
  constexpr int K = Row<E>::lanes;
  // a slot a thread: 36,864 B at 24 words (G1) and at 12 (G2 pairs),
  // within the 48 KB of static shared memory
  __shared__ Proj<E> sh[K * GT_RT];
  __shared__ int last;
  E b3;
  as_elem(b3, b3h);
  const int B = 1 << (c - 1);
  const int w = blockIdx.x / nblk;
  const int t = threadIdx.x / K;            // this thread's chunk
  const int T = blockDim.x / K;
  const int lo = ((blockIdx.x % nblk) * T + t) * L;
  const long long base = (long long)w * B;

  // the chunk [lo, lo + L) from the top: S = sum P_j, V = sum (j-lo+1) P_j
  Proj<E> S, V;
  ld_proj(S, bx, by, bz, base + lo + L - 1);
  V = S;
  for (int j = lo + L - 2; j >= lo; --j) {
    Proj<E> P;
    ld_proj(P, bx, by, bz, base + j);
    S = add_call(S, P, b3, F);
    V = add_call(V, S, b3, F);
  }
  // V += lo * S, double-and-add from the top bit of lo
  if (lo) {
    Proj<E> R = S;
    for (int bit = 30 - __clz(lo); bit >= 0; --bit) {
      R = dbl_call(R, b3, F);
      if ((lo >> bit) & 1) R = add_call(R, S, b3, F);
    }
    V = add_call(V, R, b3, F);
  }

  // the block's sum: a tree in shared memory (slot threadIdx.x holds
  // this thread's part of chunk t)
  const int me = threadIdx.x;
  sh[me] = V;
  for (int h = T >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (t < h) sh[me] = add_call(sh[me], sh[me + h * K], b3, F);
  }
  if (t == 0) {
    st_proj(px, py, pz, blockIdx.x, sh[me]);
    __threadfence();
  }
  __syncthreads();
  if (me == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: T_v = the sum of window v's block sums, into slot
  // v * nblk; then Horner over the windows on thread 0
  __threadfence();
  for (int v = t; v < W; v += T) {
    Proj<E> acc;
    ld_proj_cg(acc, px, py, pz, (long long)v * nblk);
    for (int k = 1; k < nblk; ++k) {
      Proj<E> q;
      ld_proj_cg(q, px, py, pz, (long long)v * nblk + k);
      acc = add_call(acc, q, b3, F);
    }
    st_proj(px, py, pz, (long long)v * nblk, acc);
  }
  __syncthreads();
  if (t != 0) return;
  Proj<E> R;
  ld_proj_cg(R, px, py, pz, (long long)(W - 1) * nblk);
  for (int v = W - 2; v >= 0; --v) {
    for (int d = 0; d < c; ++d) R = dbl_call(R, b3, F);
    Proj<E> Tv;
    ld_proj_cg(Tv, px, py, pz, (long long)v * nblk);
    R = add_call(R, Tv, b3, F);
  }
  st_proj(ox, oy, oz, 0, canon(R, F));
}

// buckets: bx, by, bz (W * 2^(c-1) rows); part: W * nblk rows of scratch;
// counter: one zeroed word; out: one row each
extern "C" int gt_bucket_reduce(const void* bx, const void* by,
                                const void* bz, void* px, void* py, void* pz,
                                void* counter, void* ox, void* oy, void* oz,
                                int W, int c, int L, int T, int nblk, int fp2,
                                const void* consts, const void* b3,
                                void* stream) {
  if (W <= 0 || c < 2 || c > 16 || T < 1 || T > GT_RT || (T & (T - 1)) ||
      L < 1 || nblk < 1 || (long long)L * T * nblk != (1LL << (c - 1)))
    return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* q;
  unsigned grid = (unsigned)(W * nblk);
  if (fp2)
    GT_FP2_LAUNCH(bucket_reduce_kernel<Fp2s, Fp2><<<grid, 2 * T, 0, s>>>(
        (cp)bx, (cp)by, (cp)bz, (q)px, (q)py, (q)pz, (unsigned int*)counter,
        (q)ox, (q)oy, (q)oz, W, c, L, nblk,
        fp2_from_host((const uint32_t*)b3), F));
  else
    bucket_reduce_kernel<Fp, Fp><<<grid, T, 0, s>>>(
        (cp)bx, (cp)by, (cp)bz, (q)px, (q)py, (q)pz, (unsigned int*)counter,
        (q)ox, (q)oy, (q)oz, W, c, L, nblk,
        fp_from_host((const uint32_t*)b3), F);
  return (int)cudaGetLastError();
}
