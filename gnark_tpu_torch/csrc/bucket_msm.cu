// K4 bucket_msm: signed-digit Pippenger bucket accumulation at a window
// width c (2..16) given by the caller. For every window w and bucket j
// (B = 2^(c-1) a window), the sum of the points whose digit d in window w
// has |d| = j + 1, with y negated for d < 0; zero digits and infinity
// points are left out. Output: (W * B) canonical projective buckets. The
// source also holds the digit recoding (scalars -> signed digits).
//
// Replaces gnark_tpu/msm/bucket_kernel.py _msm_device's pallas_call
// (kernel _accumulate_kernel), for G1 (Fp) and G2 (Fp2); the digit
// kernel replaces its signed_digits (XLA there).
//
// Bound on this card: operations, one complete mixed add (RC15 Alg. 8:
// 7 Montgomery products and 3 sums of two, x3 base products for G2) per
// (point, window) pair; the random gathers of the points (64 B / 128 B a
// pair) are a few percent of that in bytes, and the many resident warps
// hide their latency. The earlier design lost about as much time around
// that work as in it: a sort of all W*n pairs in torch, a fold of ~256
// partials a bucket by one thread each on 4,096 threads, and G2
// formulas at 255 registers with spills. This design:
//  * a digit kernel recodes the scalars (one thread a scalar, all W
//    windows), and the pairs are grouped by a counting sort of its own:
//    a count kernel (atomics), a prefix sum (torch cumsum over the W*B
//    counts) and a scatter kernel; all sized from W*n, no host sync;
//  * pass 1: one segment of at most SEG pairs of one bucket (found by
//    binary search in the segment offsets) a thread, the sum in
//    registers, the formula inlined; G2 runs on two threads a segment,
//    c0 and c1 (fp2s.cuh), at about G1's registers and no spills;
//  * pass 2: the partials of a bucket are folded FOLD at a time, level by
//    level (one launch of one kernel each, log_FOLD of the largest
//    bucket's segments); at the last level one thread (pair) per bucket
//    adds the last few and canonicalizes. A skewed bucket (many points on
//    one digit) only adds levels;
//  * the width c is the caller's: a wider window cuts the pairs (W = 20
//    at c = 13 against 32 at c = 8) and moves work into the bucket
//    reduction (K9, csrc/bucket_reduce.cu).
// The order of the pairs inside a bucket is that of the atomics, so the
// projective representative of a bucket sum may differ from run to run;
// the group element does not.
//
// A 12-word build takes the Fp products as called functions
// (GT_NOINLINE): nvcc 12.9's front end (cicc) crashes on this source's
// formulas inlined at that width.
#if GT_NW > 8 && !defined(GT_NOINLINE)
#define GT_NOINLINE 1
#endif
#include "fp2s.cuh"
#include "proj.cuh"

template <class E>
__device__ __noinline__ Proj<E> add_call(const Proj<E>& acc,
                                         const Proj<E>& part, const E& b3,
                                         const FieldC& F) {
  return proj_add(acc, part, b3, F);
}

// signed c-bit digits of n plain scalars (GT_SW words each) into (W, n):
// window t plus the carry; t >= 2^(c-1) gives t - 2^c and carry 1.
__global__ void digits_kernel(const uint32_t* __restrict__ sc, long long n,
                              int c, int W0, int W, int32_t* digits) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[GT_SW + 1];
#pragma unroll
  for (int k = 0; k < GT_SW; ++k) s[k] = sc[i * GT_SW + k];
  s[GT_SW] = 0;
  const int half = 1 << (c - 1);
  const uint32_t mask = (1u << c) - 1;
  int carry = 0;
  for (int w = 0; w < W; ++w) {
    int t = carry;
    if (w < W0) {
      const int bit = w * c, lo = bit >> 5, sh = bit & 31;
      uint32_t v = s[lo] >> sh;
      if (sh + c > 32) v |= s[lo + 1] << (32 - sh);
      t += (int)(v & mask);
    }
    carry = t >= half;
    digits[w * n + i] = t - (carry << c);
  }
}

// counts[w*B + |d| - 1] += 1 for every pair with d != 0 on a finite point
__global__ void count_kernel(const int32_t* __restrict__ digits,
                             const uint8_t* __restrict__ inf, long long n,
                             int W, int B, int32_t* counts) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n || inf[i]) return;
  for (int w = 0; w < W; ++w) {
    int d = digits[w * n + i];
    if (d != 0) atomicAdd(&counts[w * B + abs(d) - 1], 1);
  }
}

// each such pair takes the next slot of its bucket: 2 i + [d < 0]
__global__ void scatter_kernel(const int32_t* __restrict__ digits,
                               const uint8_t* __restrict__ inf, long long n,
                               int W, int B, int32_t* cursor,
                               int32_t* entries) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n || inf[i]) return;
  for (int w = 0; w < W; ++w) {
    int d = digits[w * n + i];
    if (d != 0) {
      int slot = atomicAdd(&cursor[w * B + abs(d) - 1], 1);
      entries[slot] = 2 * (int)i + (d < 0);
    }
  }
}

// the bucket b with off[b] <= s < off[b + 1] (off non-decreasing,
// off[0] = 0 <= s < off[nb])
__device__ __forceinline__ int find_bucket(const int32_t* off, int nb,
                                           long long s) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// pass 1: segment s sums its pairs; partial s, lazy (Row<E>::lanes
// threads a segment)
template <class E, class H>
__global__ void bucket_acc_kernel(const uint32_t* __restrict__ px,
                                  const uint32_t* __restrict__ py,
                                  const int32_t* __restrict__ entries,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ off, int nb,
                                  int seg, uint32_t* sx, uint32_t* sy,
                                  uint32_t* sz, H b3h, FieldC F) {
  constexpr int W = Row<E>::W;
  long long s = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (s >= off[nb]) return;
  E b3;
  as_elem(b3, b3h);
  const int b = find_bucket(off, nb, s);
  const int r = (int)(s - off[b]) * seg;
  const int start = starts[b] + r;
  const int len = min(seg, counts[b] - r);
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
    acc = proj_madd(acc, x, y, b3, F);
  }
  st_proj(sx, sy, sz, s, acc);
}

// pass 2, one level: out segment s adds at most seg consecutive partials
// of its bucket (in_off: the bucket's partials, out_off: its segments).
// The last level has one segment a bucket (out_off[b] = b), so an empty
// bucket gives the identity, and writes the sums canonical.
template <class E, class H, bool Last>
__global__ void bucket_segfold_kernel(const uint32_t* __restrict__ ix,
                                      const uint32_t* __restrict__ iy,
                                      const uint32_t* __restrict__ iz,
                                      const int32_t* __restrict__ in_off,
                                      const int32_t* __restrict__ out_off,
                                      int nb, int seg, uint32_t* ox,
                                      uint32_t* oy, uint32_t* oz, H b3h,
                                      FieldC F) {
  long long s = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (s >= out_off[nb]) return;
  E b3;
  as_elem(b3, b3h);
  const int b = find_bucket(out_off, nb, s);
  const int start = in_off[b] + (int)(s - out_off[b]) * seg;
  const int end = min(start + seg, in_off[b + 1]);
  Proj<E> acc;
  if (start < end)
    ld_proj(acc, ix, iy, iz, start);
  else
    proj_identity(acc, F);
  for (int t = start + 1; t < end; ++t) {
    Proj<E> part;
    ld_proj(part, ix, iy, iz, t);
    acc = add_call(acc, part, b3, F);
  }
  st_proj(ox, oy, oz, s, Last ? canon(acc, F) : acc);
}

static const int T = 128;

static unsigned blocks(long long n) { return (unsigned)((n + T - 1) / T); }

typedef const uint32_t* cp;
typedef const int32_t* ci;
typedef uint32_t* p;

extern "C" int gt_bucket_digits(const void* sc, void* digits, long long n,
                                int c, int W0, int W, void* stream) {
  if (n <= 0) return 0;
  if (c < 2 || c > 16) return (int)cudaErrorInvalidValue;
  digits_kernel<<<blocks(n), T, 0, (cudaStream_t)stream>>>(
      (cp)sc, n, c, W0, W, (int32_t*)digits);
  return (int)cudaGetLastError();
}

extern "C" int gt_bucket_count(const void* digits, const void* inf,
                               void* counts, long long n, int W, int B,
                               void* stream) {
  if (n <= 0) return 0;
  count_kernel<<<blocks(n), T, 0, (cudaStream_t)stream>>>(
      (ci)digits, (const uint8_t*)inf, n, W, B, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int gt_bucket_scatter(const void* digits, const void* inf,
                                 void* cursor, void* entries, long long n,
                                 int W, int B, void* stream) {
  if (n <= 0) return 0;
  scatter_kernel<<<blocks(n), T, 0, (cudaStream_t)stream>>>(
      (ci)digits, (const uint8_t*)inf, n, W, B, (int32_t*)cursor,
      (int32_t*)entries);
  return (int)cudaGetLastError();
}

// nseg_max bounds the number of segments (the grid); threads past the
// real count (off[nb]) return at once
extern "C" int gt_bucket_acc(const void* px, const void* py,
                             const void* entries, const void* starts,
                             const void* counts, const void* off, void* sx,
                             void* sy, void* sz, int nb, int seg,
                             long long nseg_max, int fp2, const void* consts,
                             const void* b3, void* stream) {
  if (nb <= 0 || nseg_max <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp2)
    GT_FP2_LAUNCH(bucket_acc_kernel<Fp2s, Fp2>
                  <<<blocks(2 * nseg_max), T, 0, s>>>(
        (cp)px, (cp)py, (ci)entries, (ci)starts, (ci)counts, (ci)off, nb,
        seg, (p)sx, (p)sy, (p)sz, fp2_from_host((const uint32_t*)b3), F));
  else
    bucket_acc_kernel<Fp, Fp><<<blocks(nseg_max), T, 0, s>>>(
        (cp)px, (cp)py, (ci)entries, (ci)starts, (ci)counts, (ci)off, nb,
        seg, (p)sx, (p)sy, (p)sz, fp_from_host((const uint32_t*)b3), F);
  return (int)cudaGetLastError();
}

template <bool Last>
static int segfold(const void* ix, const void* iy, const void* iz,
                   const void* in_off, const void* out_off, void* ox,
                   void* oy, void* oz, int nb, int seg, long long bound,
                   int fp2, const void* consts, const void* b3,
                   cudaStream_t s) {
  FieldC F = field_from_host((const uint32_t*)consts);
  if (fp2)
    GT_FP2_LAUNCH(bucket_segfold_kernel<Fp2s, Fp2, Last>
                  <<<blocks(2 * bound), T, 0, s>>>(
        (cp)ix, (cp)iy, (cp)iz, (ci)in_off, (ci)out_off, nb, seg, (p)ox,
        (p)oy, (p)oz, fp2_from_host((const uint32_t*)b3), F));
  else
    bucket_segfold_kernel<Fp, Fp, Last><<<blocks(bound), T, 0, s>>>(
        (cp)ix, (cp)iy, (cp)iz, (ci)in_off, (ci)out_off, nb, seg, (p)ox,
        (p)oy, (p)oz, fp_from_host((const uint32_t*)b3), F);
  return (int)cudaGetLastError();
}

// one level of pass 2; last: the final level (one segment a bucket,
// canonical sums)
extern "C" int gt_bucket_segfold(const void* ix, const void* iy,
                                 const void* iz, const void* in_off,
                                 const void* out_off, void* ox, void* oy,
                                 void* oz, int nb, int seg, long long bound,
                                 int fp2, int last, const void* consts,
                                 const void* b3, void* stream) {
  if (nb <= 0 || bound <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return last ? segfold<true>(ix, iy, iz, in_off, out_off, ox, oy, oz, nb,
                              seg, bound, fp2, consts, b3, s)
              : segfold<false>(ix, iy, iz, in_off, out_off, ox, oy, oz, nb,
                               seg, bound, fp2, consts, b3, s);
}
