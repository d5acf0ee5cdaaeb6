// K10-K13, the field operations of the PLONK prover over word vectors
// (n rows of GT_NW (8) words, Montgomery form; another tile's values are
// read with mont.cuh's ld_cg, from L2), canonical outputs:
//
//   gt_ff_addsub   K10  out = a +- b[i or 0]
//   gt_batch_inv   K11  out = 1 / a (0 -> 0), Montgomery's trick
//   gt_scan_mul    K12  out[i] = a[0] * ... * a[i], the inclusive prefix
//                       product
//   gt_dot_many    K13  out[j] = sum_i c_j[i] * pw[i] (or sum_i c_j[i]) for
//                       up to GT_DOT_K columns c_j, one element each
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
//    inverse and the running inverse), one inversion a call. Three
//    launches: pass 1 (tiles of E GT_FB rows, E the least power of two
//    from GT_INV_E that fits the tiles in one wave) writes each thread's
//    prefixes of its nonzero rows and the tile's product; pass 2, one
//    block, inverts the m tiles' products by the same trick around one
//    by_inv (Bernstein-Yang, csrc/mont.cuh) of their total, on one
//    non-inlined product (its code runs once a call, cold); pass 3 gives
//    each thread the inverse of its product (in-warp prefix and suffix
//    scans by shuffles, the same over the warps) and walks its rows
//    backward. Rows go to threads strided (neighbouring threads,
//    neighbouring rows), so every load is coalesced. What bounds it
//    here: the products' throughput (about 4.2 an element with the
//    in-block scans and reduction), and pass 2's latency;
//  * K12 by bytes: 64 B an element (a read, a write), ~20 us at 2^20; its
//    two products an element take ~33 us at the card's product rate. One
//    launch, a single-pass scan with decoupled look-back (Merrill and
//    Garland, "Single-pass Parallel Prefix Scan with Decoupled
//    Look-back", NVIDIA 2016): tiles of GT_SCAN_E GT_SCAN_T rows taken in
//    order by an atomic ticket; each thread's GT_SCAN_E consecutive rows
//    are read twice (up: their product; down: the running product),
//    which measured faster than staging a tile through shared memory
//    (that held fewer blocks a multiprocessor and took more products a
//    row); the tile's product and, once the earlier tiles' are known,
//    its inclusive prefix are published beside a flag;
//  * K13 by operations at one product an element a column, and by bytes
//    (32 B an element a column, and pw's 32 B a row once for all k
//    columns). One launch (in place of two: a shared-memory tree, then one
//    block over the blocks' sums): one wave of blocks, two rows a thread
//    an iteration, warp shuffles for the block's sums, and the last block
//    to finish (an atomic ticket) adds the blocks' sums.
// Every element is one 32-byte sector, so any row order reads whole
// sectors; K10, K11 and K13 put neighbouring threads on neighbouring
// rows, K12 each thread on consecutive rows (lanes 512 B apart, every
// sector read whole).
#include "mont.cuh"

#define GT_FB 256                    // threads a block, K10, K11, K13
#define GT_WARPS (GT_FB / 32)
#define GT_WARPS_LOG 3
#define GT_INV_E 8                   // K11's least rows a thread
#define GT_SCAN_T 512                // threads a block, K12
#define GT_SCAN_E 16                 // rows a thread in K12
#define GT_SCAN_C (GT_SCAN_E * GT_SCAN_T)  // rows a tile of K12 (8192)
static_assert((1 << GT_WARPS_LOG) == GT_WARPS, "GT_WARPS_LOG");
#define GT_DOT_MAXB 1024             // blocks of a K13 launch at most
#define GT_DOT_K 8                   // columns of a K13 launch at most
#define GT_FULL 0xFFFFFFFFu

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

// ---------------------------------------------------------------------
// products across the lanes of a warp (every lane of the warp calls)
// ---------------------------------------------------------------------

__device__ __forceinline__ Fp shfl_up(const Fp& a, int d) {
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = __shfl_up_sync(GT_FULL, a.w[i], d);
  return r;
}

__device__ __forceinline__ Fp shfl_down(const Fp& a, int d) {
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i)
    r.w[i] = __shfl_down_sync(GT_FULL, a.w[i], d);
  return r;
}

__device__ __forceinline__ Fp shfl_xor(const Fp& a, int d) {
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i)
    r.w[i] = __shfl_xor_sync(GT_FULL, a.w[i], d);
  return r;
}

__device__ __forceinline__ Fp shfl_idx(const Fp& a, int lane) {
  Fp r;
#pragma unroll
  for (int i = 0; i < GT_NW; ++i) r.w[i] = __shfl_sync(GT_FULL, a.w[i], lane);
  return r;
}

// Inclusive product scan over lanes [0, width), width a power of two:
// lane l gets lanes 0 .. l (forward) or l .. width - 1 (backward).
__device__ __forceinline__ Fp warp_scan(Fp v, bool backward, int width,
                                        const FieldC& F) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int off = 1; off < width; off <<= 1) {
    const Fp w = backward ? shfl_down(v, off) : shfl_up(v, off);
    if (backward ? lane + off < width : lane >= off) v = mul_lazy(v, w, F);
  }
  return v;
}

// The product of the lanes of each aligned group of `width` lanes, in
// every lane of the group.
__device__ __forceinline__ Fp warp_prod(Fp v, int width, const FieldC& F) {
#pragma unroll 1
  for (int off = 1; off < width; off <<= 1)
    v = mul_lazy(v, shfl_xor(v, off), F);
  return v;
}

// ---------------------------------------------------------------------
// K11
// ---------------------------------------------------------------------

// Rows of the thread whose first row is `first`, E rows GT_FB apart,
// below n.
__device__ __forceinline__ int rows_of(long long first, long long n, int E) {
  if (first >= n) return 0;
  const long long k = (n - 1 - first) / GT_FB + 1;
  return k < E ? (int)k : E;
}

// Pass 1: tile b = rows [b C, (b + 1) C), C = E GT_FB, thread t its rows
// b C + k GT_FB + t: pre[row] = the thread's product of its nonzero rows
// so far (lazy); tot[b] = the tile's product (never 0 mod p).
__global__ void __launch_bounds__(GT_FB)
    inv_up_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ pre,
                  uint32_t* __restrict__ tot, long long n, int E, FieldC F) {
  __shared__ Fp wt[GT_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * E * GT_FB + threadIdx.x;
  const int kn = rows_of(first, n, E);
  Fp acc, x;
  set_one(acc, F);
  for (int k = 0; k < kn; ++k) {
    const long long i = first + (long long)k * GT_FB;
    ld(x, a + i * GT_NW);
    if (!is_zero_lazy(x, F)) acc = mul_lazy(acc, x, F);
    st(pre + i * GT_NW, acc);
  }
  acc = warp_prod(acc, 32, F);
  if (lane == 0) wt[w] = acc;
  __syncthreads();
  if (w == 0) {
    acc = warp_prod(wt[lane & (GT_WARPS - 1)], GT_WARPS, F);
    if (lane == 0) st(tot + (long long)blockIdx.x * GT_NW, acc);
  }
}

// One copy of the product's code for the one-block pass: its code runs
// once a call, cold, so the fetches of many inlined copies would cost
// more than the calls.
__device__ __noinline__ Fp mul_once(Fp a, Fp b, const FieldC& F) {
  return mul_lazy(a, b, F);
}

// Pass 2, one block: tot[b] <- 1 / tot[b] for the m tiles (never 0 mod
// p) around one by_inv; latency-bound, so the block's product is a tree
// of xor shuffles whose partners each level keeps: going down, 1 / (a
// node) = 1 / (its parent) * (its partner), five levels in a warp and
// GT_WARPS_LOG over the warps. pre: m rows of scratch (the prefixes).
__global__ void __launch_bounds__(GT_FB)
    inv_mid_kernel(uint32_t* __restrict__ tot, uint32_t* __restrict__ pre,
                   long long m, FieldC F) {
  __shared__ Fp wt[GT_WARPS];
  __shared__ Fp inv_s;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int E = (int)((m + GT_FB - 1) / GT_FB);
  const int kn = rows_of(t, m, E);
  Fp acc, x;
  set_one(acc, F);
#pragma unroll 1
  for (int k = 0; k < kn; ++k) {
    const long long i = t + (long long)k * GT_FB;
    ld(x, tot + i * GT_NW);
    acc = mul_once(acc, x, F);
    st(pre + i * GT_NW, acc);
  }
  Fp s[5], u[GT_WARPS_LOG];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    s[l] = shfl_xor(acc, 1 << l);
    acc = mul_once(acc, s[l], F);
  }
  if (lane == 0) wt[w] = acc;
  __syncthreads();
  acc = wt[lane & (GT_WARPS - 1)];
#pragma unroll
  for (int l = 0; l < GT_WARPS_LOG; ++l) {
    u[l] = shfl_xor(acc, 1 << l);
    acc = mul_once(acc, u[l], F);
  }
  if (t == 0) inv_s = by_inv(acc, F);
  __syncthreads();
  Fp inv = inv_s;
#pragma unroll
  for (int l = GT_WARPS_LOG - 1; l >= 0; --l) inv = mul_once(inv, u[l], F);
  inv = shfl_idx(inv, w);                    // 1 / (this warp's product)
#pragma unroll
  for (int l = 4; l >= 0; --l) inv = mul_once(inv, s[l], F);
#pragma unroll 1
  for (int k = kn - 1; k >= 0; --k) {
    const long long i = t + (long long)k * GT_FB;
    Fp prev;
    if (k > 0)
      ld(prev, pre + (i - GT_FB) * GT_NW);
    else
      set_one(prev, F);
    ld(x, tot + i * GT_NW);
    st(tot + i * GT_NW, mul_once(inv, prev, F));
    inv = mul_once(inv, x, F);
  }
}

// Pass 3: tile b from its inverse tinv[b]; out holds pass 1's prefixes
// and takes 1 / a[row] (0 for a zero row), canonical. The thread's
// product is its last prefix; its inverse is 1 / (the tile's product)
// times every other thread's product (in the warp: exclusive prefix and
// suffix scans; across the warps the same in warp 0). Then, backward
// over the thread's rows, 1 / a = inv * (the prefix before the row), inv
// *= a; each row's prefix is read before the row is written.
__global__ void __launch_bounds__(GT_FB)
    inv_down_kernel(const uint32_t* __restrict__ a, uint32_t* out,
                    const uint32_t* __restrict__ tinv, long long n, int E,
                    FieldC F) {
  __shared__ Fp wt[GT_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * E * GT_FB + threadIdx.x;
  const int kn = rows_of(first, n, E);
  Fp tot, x;
  if (kn > 0)
    ld(tot, out + (first + (long long)(kn - 1) * GT_FB) * GT_NW);
  else
    set_one(tot, F);
  const Fp fw = warp_scan(tot, false, 32, F);
  const Fp bw = warp_scan(tot, true, 32, F);
  const Fp before = shfl_up(fw, 1), after = shfl_down(bw, 1);
  if (lane == 31) wt[w] = fw;
  __syncthreads();
  if (w == 0) {
    if (lane < GT_WARPS)
      x = wt[lane];
    else
      set_one(x, F);
    const Fp xf = warp_scan(x, false, GT_WARPS, F);
    const Fp xb = warp_scan(x, true, GT_WARPS, F);
    const Fp xp = shfl_up(xf, 1), xs = shfl_down(xb, 1);
    Fp inv;
    ld(inv, tinv + (long long)blockIdx.x * GT_NW);
    if (lane > 0) inv = mul_lazy(inv, xp, F);
    if (lane < GT_WARPS - 1) inv = mul_lazy(inv, xs, F);
    if (lane < GT_WARPS) wt[lane] = inv;      // 1 / (warp lane's product)
  }
  __syncthreads();
  Fp inv = wt[w];
  if (lane > 0) inv = mul_lazy(inv, before, F);
  if (lane < 31) inv = mul_lazy(inv, after, F);
  for (int k = kn - 1; k >= 0; --k) {
    const long long i = first + (long long)k * GT_FB;
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

// ---------------------------------------------------------------------
// K12
// ---------------------------------------------------------------------

#define GT_AGG 1   // a tile's flag: its product is published
#define GT_INC 2   // ... its inclusive prefix is published

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// after a flag read relaxed: the reads that follow see what was written
// before the flag's release (a plain spin, then one fence)
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void publish(uint32_t* val, int* flag,
                                        long long tile, const Fp& v,
                                        int state) {
  st(val + tile * GT_NW, v);
  st_release(flag + tile, state);
}

// Warp 0 of the tile: publishes the tile's product A (agg, flag
// GT_AGG), returns the product of every earlier tile (one for tile 0)
// and publishes that times A (inc, flag GT_INC). Lane l waits on the
// tile l + 1 before this one. If one of those 32 has its prefix
// published, the product runs up to the nearest such tile (its inc)
// over the products of the tiles after it. Otherwise the 32 products'
// product W is taken and lane 0 waits for the prefix of the tile just
// before them, which that tile publishes by the same rule: a chain of
// one product a link, 33 tiles a link (products commute, so the order
// within a window does not matter). A tile's ticket is taken when its
// block starts, so every earlier tile's block is running or done: no
// deadlock; tile 0 publishes its prefix at once.
__device__ __forceinline__ Fp lookback(long long tile, const Fp& A,
                                       int* flag, uint32_t* agg,
                                       uint32_t* inc, const FieldC& F) {
  const int lane = threadIdx.x & 31;
  Fp run;
  set_one(run, F);
  if (tile == 0) {
    if (lane == 0) publish(inc, flag, 0, A, GT_INC);
    return run;
  }
  if (lane == 0) publish(agg, flag, tile, A, GT_AGG);
  const long long i = tile - 1 - lane;
  int f = GT_INC;
  if (i >= 0)
    while ((f = ld_relaxed(flag + i)) == 0) {
    }
  fence_acquire();
  const unsigned pm = __ballot_sync(GT_FULL, f == GT_INC);
  if (i >= 0 && (pm == 0 || lane <= __ffs(pm) - 1))
    ld_cg(run, (f == GT_INC ? inc : agg) + i * GT_NW);
  run = warp_prod(run, 32, F);
  if (pm) {
    if (lane == 0) publish(inc, flag, tile, mul_lazy(run, A, F), GT_INC);
    return run;
  }
  const Fp wa = mul_lazy(run, A, F);
  Fp p;
  set_one(p, F);
  if (lane == 0) {
    const long long j = tile - 33;
    while (ld_relaxed(flag + j) != GT_INC) {
    }
    fence_acquire();
    ld_cg(p, inc + j * GT_NW);
    publish(inc, flag, tile, mul_lazy(p, wa, F), GT_INC);
  }
  return mul_lazy(run, shfl_idx(p, 0), F);
}

// One launch: the block takes tile `ticket` (rows [tile C, (tile + 1) C),
// C = GT_SCAN_C), thread t the GT_SCAN_E consecutive rows from t
// GT_SCAN_E. Up: the thread's product of its rows; a shuffle scan of the
// warp's, a scan of the warps' in warp 0, the look-back for the earlier
// tiles'. Down: the rows read again (from L2: the tile was just read),
// the thread's running product from (the earlier tiles', warps' and
// lanes' product) written row by row. About two products a row, no
// shared memory for the rows, so more blocks a multiprocessor. state:
// [0] the ticket, [1 + b] tile b's flag, zeroed by the caller; agg, inc:
// a value a tile. out canonical.
__global__ void __launch_bounds__(GT_SCAN_T)
    scan_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                int* state, uint32_t* agg, uint32_t* inc, long long n,
                FieldC F) {
  __shared__ Fp wt[GT_SCAN_T / 32];
  __shared__ long long tile_s;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) tile_s = atomicAdd(state, 1);
  __syncthreads();
  const long long tile = tile_s;
  const long long first = tile * GT_SCAN_C + (long long)t * GT_SCAN_E;
  const int kn = first >= n ? 0
                 : n - first < GT_SCAN_E ? (int)(n - first) : GT_SCAN_E;
  Fp x, acc;
  set_one(acc, F);
#pragma unroll 1
  for (int k = 0; k < kn; ++k) {
    ld(x, a + (first + k) * GT_NW);
    acc = k ? mul_lazy(acc, x, F) : x;
  }
  const Fp li = warp_scan(acc, false, 32, F);
  const Fp before = shfl_up(li, 1);
  if (lane == 31) wt[w] = li;
  __syncthreads();
  if (w == 0) {
    if (lane < GT_SCAN_T / 32)
      x = wt[lane];
    else
      set_one(x, F);
    const Fp wi = warp_scan(x, false, GT_SCAN_T / 32, F);
    Fp X = lookback(tile, shfl_idx(wi, GT_SCAN_T / 32 - 1), state + 1, agg,
                    inc, F);
    const Fp wb = shfl_up(wi, 1);
    if (lane > 0) X = mul_lazy(X, wb, F);
    if (lane < GT_SCAN_T / 32) wt[lane] = X;  // all before warp lane
  }
  __syncthreads();
  Fp pre = wt[w];
  if (lane > 0) pre = mul_lazy(pre, before, F);
#pragma unroll 1
  for (int k = 0; k < kn; ++k) {
    ld(x, a + (first + k) * GT_NW);
    pre = mul_lazy(pre, x, F);
    st(out + (first + k) * GT_NW, canon(pre, F));
  }
}

// ---------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------

// columns of one K13 launch, each at most as long as the vector it is
// multiplied by, zero past its end
struct DotCols {
  const uint32_t* c[GT_DOT_K];
  long long len[GT_DOT_K];
};

// The sums acc[0 .. k) of every thread of the block -> tot[0 .. k) in
// shared memory: five xor-shuffle levels in each warp, then thread j < k
// adds column j's sums of the warps. Every thread of the block calls.
__device__ __forceinline__ void block_sums(Fp* acc, int k, Fp* tot,
                                           const FieldC& F) {
  __shared__ Fp ws[GT_WARPS][GT_DOT_K];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < GT_DOT_K; ++j) {
    if (j < k) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1)
        acc[j] = add2p(acc[j], shfl_xor(acc[j], d), F);
      if (lane == 0) ws[w][j] = acc[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < k) {
    Fp s = ws[0][threadIdx.x];
#pragma unroll
    for (int v = 1; v < GT_WARPS; ++v) s = add2p(s, ws[v][threadIdx.x], F);
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// One launch: out[j] = sum_i c_j[i] pw[i] (pw null: sum_i c_j[i]) for
// the k <= GT_DOT_K columns, rows below n = their longest. Thread t of
// block b takes rows b GT_FB + t + m S, S all the threads, two rows an
// iteration (their loads issued together; with pw one sop2 a column,
// both products in one reduction), one lazy sum a column in registers.
// Each block publishes its k sums in part; the last block to finish
// (an atomic ticket in *ticket, zero at the launch) adds every block's,
// writes out, canonical, and sets the ticket back to zero for the next
// launch on the stream.
__global__ void __launch_bounds__(GT_FB)
    dot_kernel(DotCols C, const uint32_t* __restrict__ pw,
               uint32_t* __restrict__ out, uint32_t* part,
               unsigned* ticket, long long n, int k, FieldC F) {
  __shared__ Fp tot[GT_DOT_K];
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long S = (long long)gridDim.x * GT_FB;
  Fp acc[GT_DOT_K];
#pragma unroll
  for (int j = 0; j < GT_DOT_K; ++j) set_zero(acc[j]);
  for (long long i = blockIdx.x * (long long)GT_FB + t; i < n; i += 2 * S) {
    const long long i2 = i + S;
    Fp p, p2, x, x2;
    if (pw) {
      ld(p, pw + i * GT_NW);
      if (i2 < n)
        ld(p2, pw + i2 * GT_NW);
      else
        set_zero(p2);
    }
#pragma unroll
    for (int j = 0; j < GT_DOT_K; ++j) {
      if (j < k) {
        if (i < C.len[j])
          ld(x, C.c[j] + i * GT_NW);
        else
          set_zero(x);
        if (i2 < C.len[j])
          ld(x2, C.c[j] + i2 * GT_NW);
        else
          set_zero(x2);
        acc[j] = add2p(acc[j], pw ? sop2(x, p, x2, p2, F) : add2p(x, x2, F),
                       F);
      }
    }
  }
  block_sums(acc, k, tot, F);
  if (t < k) st(part + ((long long)blockIdx.x * GT_DOT_K + t) * GT_NW, tot[t]);
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < GT_DOT_K; ++j) set_zero(acc[j]);
  for (long long b = t; b < gridDim.x; b += GT_FB) {
#pragma unroll
    for (int j = 0; j < GT_DOT_K; ++j) {
      if (j < k) {
        Fp x;
        ld_cg(x, part + (b * GT_DOT_K + j) * GT_NW);
        acc[j] = add2p(acc[j], x, F);
      }
    }
  }
  block_sums(acc, k, tot, F);
  if (t < k) st(out + (long long)t * GT_NW, canon(tot[t], F));
  if (t == 0) *ticket = 0;      // every block has taken its ticket
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

// Rows a thread in K11's passes 1 and 3: the least power of two from
// GT_INV_E that fits all tiles in one wave of pass 3's blocks (fewer,
// longer threads spend fewer products on their in-block inverses).
static int inv_rows(long long n) {
  static long long waves[64];          // threads of one wave, by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!waves[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_down_kernel,
                                                  GT_FB, 0);
    waves[dev] = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) *
                 GT_FB;
  }
  const long long wave = waves[dev];
  int E = GT_INV_E;
  while ((long long)E * wave < n && E < (1 << 20)) E <<= 1;
  return E;
}

// scratch: 2m rows, m the tiles at GT_INV_E rows a thread at most
// (ff/ops.py inv_tiles): the tiles' products, then their inverses; pass
// 2's prefixes. Three launches.
extern "C" int gt_batch_inv(const void* a, void* out, void* scratch,
                            long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  const int E = inv_rows(n);
  const long long m = (n + (long long)E * GT_FB - 1) / ((long long)E * GT_FB);
  if (m > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  uint32_t* tot = (uint32_t*)scratch;
  inv_up_kernel<<<(unsigned)m, GT_FB, 0, s>>>((const uint32_t*)a,
                                              (uint32_t*)out, tot, n, E, F);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  inv_mid_kernel<<<1, GT_FB, 0, s>>>(tot, tot + m * GT_NW, m, F);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  inv_down_kernel<<<(unsigned)m, GT_FB, 0, s>>>(
      (const uint32_t*)a, (uint32_t*)out, tot, n, E, F);
  return (int)cudaGetLastError();
}

// scratch, zero: the ticket and the m tiles' flags (1 + m ints, padded
// to a multiple of GT_NW), then 2m rows (the tiles' products, their
// inclusive prefixes); m = the tiles (ff/ops.py scan_tiles). One launch.
extern "C" int gt_scan_mul(const void* a, void* out, void* scratch,
                           long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  const long long m = (n + GT_SCAN_C - 1) / GT_SCAN_C;
  if (m > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int* state = (int*)scratch;
  uint32_t* v = (uint32_t*)scratch + (1 + m + GT_NW - 1) / GT_NW * GT_NW;
  scan_kernel<<<(unsigned)m, GT_SCAN_T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, state, v, v + m * GT_NW, n, F);
  return (int)cudaGetLastError();
}

// Blocks of one K13 launch: one wave of the card, at most GT_DOT_MAXB,
// at least two rows a thread.
static long long dot_blocks(long long n) {
  static long long wave[64];           // blocks of one wave, by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!wave[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dot_kernel, GT_FB,
                                                  0);
    wave[dev] = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  long long nb = (n + 2 * GT_FB - 1) / (2 * GT_FB);
  if (nb > wave[dev]) nb = wave[dev];
  return nb < GT_DOT_MAXB ? nb : GT_DOT_MAXB;
}

// cols, lens: k <= GT_DOT_K host arrays (device pointers, rows); pw: n
// rows or null; n >= every len; out: k rows; scratch: a row whose first
// word, the ticket, is zero (and is zero again after the launch), then
// GT_DOT_MAXB GT_DOT_K rows for the blocks' sums: one scratch a stream
// (ff/ops.py dot_scratch). One launch.
extern "C" int gt_dot_many(const void* const* cols, const long long* lens,
                           const void* pw, void* out, void* scratch, int k,
                           long long n, const void* consts, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (k > GT_DOT_K) return (int)cudaErrorInvalidValue;
  DotCols C;
  for (int j = 0; j < GT_DOT_K; ++j) {
    C.c[j] = (const uint32_t*)cols[j < k ? j : 0];
    C.len[j] = j < k ? lens[j] : 0;
  }
  FieldC F = field_from_host((const uint32_t*)consts);
  dot_kernel<<<(unsigned)dot_blocks(n), GT_FB, 0, (cudaStream_t)stream>>>(
      C, (const uint32_t*)pw, (uint32_t*)out, (uint32_t*)scratch + GT_NW,
      (unsigned*)scratch, n, k, F);
  return (int)cudaGetLastError();
}
