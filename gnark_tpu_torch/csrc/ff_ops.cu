// K10-K13, the field operations of the PLONK prover over word vectors
// (n rows of 8 words, Montgomery form), canonical outputs:
//
//   gt_ff_addsub   K10  out = a +- b[i or 0]
//   gt_batch_inv   K11  out = 1 / a (0 -> 0), Montgomery's trick
//   gt_scan_mul    K12  out[i] = a[0] * ... * a[i], the inclusive prefix
//                       product
//   gt_dot         K13  out = sum_i a[i] * b[i] (or sum_i a[i]), one element
//
// None replaces a TPU kernel: the reference runs each as XLA ops around
// its Pallas ones (gnark_tpu/ff/mont.py FF.add / FF.sub / FF.batch_inv,
// jax.lax.associative_scan(ff.mul) in gnark_tpu/backend/plonk_device.py
// :63, :193, :265, and its ff_sum :66 over ff.mul for the evaluations).
// Inputs may be lazy (< 2p) everywhere.
//
// Bound on this card:
//  * K10 by bytes: 96 B an element (two reads, a write), ~30 us at 2^20;
//  * K11 by operations: three products an element (the prefix, then the
//    inverse and the running inverse) plus one Fermat inverse a block;
//    what bounds it here is that inverse's latency (253 squarings and
//    109 products in a row on one thread), so the launch is one wave:
//    each block takes n / (blocks of one wave) elements and inverts once;
//  * K12 by operations: one product an element for the local prefix, one
//    for the block's prefix, one for the fix-up of earlier blocks;
//  * K13 by operations at one product an element, and by bytes (64 B an
//    element); the sum is a tree in shared memory, then one block over
//    the blocks' sums.
// Every element is one 32-byte sector, so any row order reads whole
// sectors; K10 and K13 put neighbouring threads on neighbouring rows.
#include "mont.cuh"

#define GT_FB 256          // threads a block, K11 to K13
#define GT_SCAN_E 8        // elements a thread in K12 (a block: 2048)
#define GT_DOT_MAXB 1024   // blocks of K13's first pass at most

__global__ void addsub_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, long long n,
                              int bcast, int sub, FieldC F) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y;
  ld(x, a + i * GT_NW);
  ld(y, b + (bcast ? 0 : i) * GT_NW);
  st(out + i * GT_NW, canon(sub ? sub2p(x, y, F) : add2p(x, y, F), F));
}

// In-block inclusive scan of s[0 .. GT_FB) by products, forward (s[t] =
// s[0] ... s[t]) or backward (s[t] = s[t] ... s[GT_FB - 1]); Hillis and
// Steele, log2(GT_FB) steps.
__device__ __forceinline__ void block_scan(Fp* s, bool backward,
                                           const FieldC& F) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int off = 1; off < GT_FB; off <<= 1) {
    const int o = backward ? t + off : t - off;
    const bool has = backward ? o < GT_FB : o >= 0;
    Fp v = s[t], w;
    if (has) w = s[o];
    __syncthreads();
    if (has) s[t] = mul_lazy(w, v, F);
    __syncthreads();
  }
}

// Block b takes rows [b E GT_FB, (b + 1) E GT_FB), thread t the rows
// b E GT_FB + k GT_FB + t, k < E (neighbouring threads, neighbouring
// rows). Forward: out[row] = the thread's product of its nonzero rows so
// far. The thread totals' inverses come from one Fermat inverse of the
// block's product and the in-block prefix and suffix products; backward,
// 1 / a = inv * (the thread's prefix before the row), inv *= a.
__global__ void __launch_bounds__(GT_FB)
    batch_inv_kernel(const uint32_t* __restrict__ a,
                     uint32_t* __restrict__ out, long long n, int E,
                     FieldC F) {
  __shared__ Fp pre[GT_FB], suf[GT_FB];
  __shared__ Fp inv_all;
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * E * GT_FB + t;
  Fp acc, x;
  set_one(acc, F);
  int kn = 0;                       // rows of this thread
  for (int k = 0; k < E; ++k) {
    const long long i = base + (long long)k * GT_FB;
    if (i >= n) break;
    ld(x, a + i * GT_NW);
    if (!is_zero_lazy(x, F)) acc = mul_lazy(acc, x, F);
    st(out + i * GT_NW, acc);
    kn = k + 1;
  }
  pre[t] = acc;
  suf[t] = acc;
  __syncthreads();
  block_scan(pre, false, F);
  block_scan(suf, true, F);
  if (t == 0) inv_all = fermat_inv(pre[GT_FB - 1], F);
  __syncthreads();
  Fp inv = inv_all;
  if (t > 0) inv = mul_lazy(inv, pre[t - 1], F);
  if (t < GT_FB - 1) inv = mul_lazy(inv, suf[t + 1], F);
  for (int k = kn - 1; k >= 0; --k) {
    const long long i = base + (long long)k * GT_FB;
    ld(x, a + i * GT_NW);
    Fp r;
    if (is_zero_lazy(x, F)) {
      set_zero(r);
    } else {
      Fp prev;
      if (k > 0)
        ld(prev, out + (i - GT_FB) * GT_NW);
      else
        set_one(prev, F);
      r = canon(mul_lazy(inv, prev, F), F);
      inv = mul_lazy(inv, x, F);
    }
    st(out + i * GT_NW, r);
  }
}

// Block b takes rows [b C, (b + 1) C), C = GT_SCAN_E GT_FB, thread t the
// GT_SCAN_E rows from b C + t GT_SCAN_E: its running product, then the
// product of the block's earlier threads (an in-block scan) in front.
// tot[b] = the block's product (lazy); out canonical.
__global__ void __launch_bounds__(GT_FB)
    scan_block_kernel(const uint32_t* __restrict__ a,
                      uint32_t* __restrict__ out, uint32_t* __restrict__ tot,
                      long long n, FieldC F) {
  __shared__ Fp s[GT_FB];
  const int t = threadIdx.x;
  const long long base =
      (long long)blockIdx.x * GT_SCAN_E * GT_FB + (long long)t * GT_SCAN_E;
  Fp acc, x;
  set_one(acc, F);
  int kn = 0;
  for (int k = 0; k < GT_SCAN_E; ++k) {
    const long long i = base + k;
    if (i >= n) break;
    ld(x, a + i * GT_NW);
    acc = k ? mul_lazy(acc, x, F) : x;
    st(out + i * GT_NW, acc);
    kn = k + 1;
  }
  s[t] = acc;
  __syncthreads();
  block_scan(s, false, F);
  Fp before;
  if (t > 0) before = s[t - 1];
  for (int k = 0; k < kn; ++k) {
    const long long i = base + k;
    ld(x, out + i * GT_NW);
    if (t > 0) x = mul_lazy(before, x, F);
    st(out + i * GT_NW, canon(x, F));
  }
  if (t == GT_FB - 1) st(tot + (long long)blockIdx.x * GT_NW, s[t]);
}

// rows of block b >= 1 times the scanned product of blocks 0 .. b - 1
__global__ void scan_fix_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ pre,
                                long long n, FieldC F) {
  const long long C = (long long)GT_SCAN_E * GT_FB;
  const long long i = C + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y;
  ld(x, out + i * GT_NW);
  ld(y, pre + (i / C - 1) * GT_NW);
  st(out + i * GT_NW, canon(mul_lazy(x, y, F), F));
}

// Each thread sums a[i] b[i] (or a[i]) over i = its index + k * (all
// threads), lazily; the block adds its threads' sums by a tree and
// thread 0 writes the block's sum, canonical.
__global__ void __launch_bounds__(GT_FB)
    dot_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n, int has_b,
               FieldC F) {
  __shared__ Fp s[GT_FB];
  const int t = threadIdx.x;
  const long long stride = (long long)gridDim.x * GT_FB;
  Fp acc, x, y;
  set_zero(acc);
  for (long long i = blockIdx.x * (long long)GT_FB + t; i < n; i += stride) {
    ld(x, a + i * GT_NW);
    if (has_b) {
      ld(y, b + i * GT_NW);
      x = mul_lazy(x, y, F);
    }
    acc = add2p(acc, x, F);
  }
  s[t] = acc;
  __syncthreads();
#pragma unroll 1
  for (int h = GT_FB / 2; h > 0; h >>= 1) {
    if (t < h) s[t] = add2p(s[t], s[t + h], F);
    __syncthreads();
  }
  if (t == 0) st(out + (long long)blockIdx.x * GT_NW, canon(s[0], F));
}

static unsigned blocks_of(long long n, int T) {
  return (unsigned)((n + T - 1) / T);
}

extern "C" int gt_ff_addsub(const void* a, const void* b, void* out,
                            long long n, int bcast, int sub,
                            const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  addsub_kernel<<<blocks_of(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, bcast, sub,
      F);
  return (int)cudaGetLastError();
}

// One wave of blocks (as many as the card holds at once), at least one
// row a thread.
extern "C" int gt_batch_inv(const void* a, void* out, long long n,
                            const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batch_inv_kernel,
                                                GT_FB, 0);
  long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long E = (n + wave * GT_FB - 1) / (wave * GT_FB);
  if (E < 1) E = 1;
  batch_inv_kernel<<<blocks_of(n, (int)(E * GT_FB)), GT_FB, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, (int)E, F);
  return (int)cudaGetLastError();
}

// scratch, at each level: the blocks' products, then (past one block)
// their scan and the next level's scratch (ff/ops.py scan_scratch_rows)
static int scan_rec(const uint32_t* a, uint32_t* out, uint32_t* scratch,
                    long long n, FieldC F, cudaStream_t s) {
  const long long C = (long long)GT_SCAN_E * GT_FB;
  const long long m = (n + C - 1) / C;
  uint32_t* tot = scratch;
  uint32_t* pre = scratch + m * GT_NW;
  scan_block_kernel<<<(unsigned)m, GT_FB, 0, s>>>(a, out, tot, n, F);
  int rc = (int)cudaGetLastError();
  if (rc || m == 1) return rc;
  rc = scan_rec(tot, pre, pre + m * GT_NW, m, F, s);
  if (rc) return rc;
  scan_fix_kernel<<<blocks_of(n - C, 256), 256, 0, s>>>(out, pre, n, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_scan_mul(const void* a, void* out, void* scratch,
                           long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  return scan_rec((const uint32_t*)a, (uint32_t*)out, (uint32_t*)scratch, n,
                  F, (cudaStream_t)stream);
}

// scratch: GT_DOT_MAXB rows for the first pass's block sums
extern "C" int gt_dot(const void* a, const void* b, void* out,
                      void* scratch, long long n, const void* consts,
                      void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  long long nb = blocks_of(n, GT_FB);
  if (nb > GT_DOT_MAXB) nb = GT_DOT_MAXB;
  const int has_b = b != nullptr;
  if (nb == 1) {
    dot_kernel<<<1, GT_FB, 0, s>>>((const uint32_t*)a, (const uint32_t*)b,
                                   (uint32_t*)out, n, has_b, F);
    return (int)cudaGetLastError();
  }
  dot_kernel<<<(unsigned)nb, GT_FB, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)scratch, n, has_b, F);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dot_kernel<<<1, GT_FB, 0, s>>>((const uint32_t*)scratch, nullptr,
                                 (uint32_t*)out, nb, 0, F);
  return (int)cudaGetLastError();
}
