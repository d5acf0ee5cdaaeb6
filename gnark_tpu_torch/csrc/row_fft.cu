// K2: the two passes of a four-step NTT, each one launch, with the
// transposes, the mid twiddle product and the coset / n^-1 scalings
// folded into their loads and stores.
//
// Replaces gnark_tpu/ntt/fourstep.py _row_fft (kernel _row_fft_kernel,
// the DIF stages of rows) and _mid_mul (the mid twiddle product, a K1
// launch in the port before), and the torch transposes, gathers and K1
// scalings that ran around them.
//
// A "row" is 2^L points: point e of row `row` is read at in + (row in_rs
// + e in_es) points, so a pass reads the columns of x in place. All L
// radix-2 DIF stages run on it (natural order in, bit-reversed out):
// stage s pairs points i and i + 2^(L-s-1) of each block of 2^(L-s) and
// maps (u, v) to (u + v, (u - v) w^(j 2^s)), j = i mod 2^(L-s-1), w the
// row's root. Output position p goes to out + (orow(row) out_rs +
// oel(p) out_es), where orow / oel bit-reverse when asked; an optional
// `pre` vector multiplies each input by pre[its input address], an
// optional `post` vector each output by post[its output address] (or
// post[0] if post_bcast). Four-step's pass 1 is rows = columns of x, pre
// = the coset powers, post = the mid twiddle (stored in pass 1's output
// layout); pass 2 writes each point to its natural-order place, post =
// n^-1 or the n^-1 g^-i of a coset iFFT.
//
//   fs_seg_kernel   one block a segment of 2^G <= 2^12 points of a row
//                   (the whole row unless the row is longer): one radix-2
//                   stage a step, in registers; the first step loads from
//                   global memory, the last stores to it, the ones between
//                   go through shared memory. Radix-4 and radix-8 steps
//                   were measured on the H100 and dropped: radix 4 ran no
//                   faster at 80 registers, radix 8 took 255 registers,
//                   spilled and ran 2.4x slower. Shared memory is
//                   word-major with one pad word every 8 points (word w
//                   of point i at sh[w * (2^G + 2^G / 8) + i + i / 8]: at
//                   most 2-way bank conflicts for every stage's pattern),
//                   and the segment root's 2^(G-1) powers sit beside it,
//                   word-major, with the low five bits of each index
//                   XOR-folded with the rest (no conflict for any stage's
//                   stride; the host stores the table so).
//   fs_pass_kernel  the first L - G stages of rows longer than 2^G, in
//                   registers over global memory (one thread the 2^r
//                   points of a radix-2^r step, r <= 3), written to a
//                   row-contiguous buffer; after them each 2^G segment
//                   of a row is an independent 2^G-point DIF with root
//                   w^(2^(L-G)).
//
// Bound on this card: operations. A 2^20 transform is two passes of
// 2^19 x 10 Montgomery products, plus 2^20 each for the mid twiddle and
// a scaling (~0.2 ms at the int32 multiply rate), against 4 x 32 MB of
// point traffic plus the tables (~0.05 ms). Point-sized accesses are one
// 32-byte sector each, so the strided column reads and the scattered
// stores waste no DRAM sectors. Arithmetic stays in the lazy [0, 2p)
// class and is canonicalized once on the way out.
#include "mont.cuh"

#define FS_TMAX 256            // threads a block of fs_seg_kernel

struct FsArgs {
  const uint32_t* in;
  const uint32_t* pre;         // null, or indexed by input address
  uint32_t* out;
  const uint32_t* post;        // null, or indexed by output address
  const uint32_t* tw;          // row (segment) root powers
  long long in_rs, in_es, out_rs, out_es;
  int orow_bits, oel_bits;     // > 0: bit-reverse row / position
  int post_bcast;
  int L;                       // log2 of the row length
  int G;                       // segment log (fs_seg_kernel)
};

__device__ __forceinline__ long long brev_bits(long long v, int bits) {
  return bits ? (long long)(__brevll((unsigned long long)v) >> (64 - bits))
              : v;
}

// index of twiddle e in a word plane of the shared table
__device__ __forceinline__ int tw_pos(int e) {
  return (e & ~31) | ((e ^ (e >> 5) ^ (e >> 10) ^ (e >> 15)) & 31);
}

__device__ __forceinline__ int sh_pos(int i) { return i + (i >> 3); }

__device__ __forceinline__ Fp ld_in(const FsArgs& a, long long row,
                                    long long e, const FieldC& F) {
  const long long off = row * a.in_rs + e * a.in_es;
  Fp v;
  ld(v, a.in + off * GT_NW);
  if (a.pre) {
    Fp s;
    ld(s, a.pre + off * GT_NW);
    v = mul_lazy(v, s, F);
  }
  return v;
}

__device__ __forceinline__ void st_out(const FsArgs& a, long long row,
                                       long long p, Fp v, const FieldC& F) {
  const long long off = brev_bits(row, a.orow_bits) * a.out_rs +
                        brev_bits(p, a.oel_bits) * a.out_es;
  if (a.post) {
    Fp s;
    ld(s, a.post + (a.post_bcast ? 0 : off) * GT_NW);
    v = mul_lazy(v, s, F);
  }
  st(a.out + off * GT_NW, canon(v, F));
}

// stages s .. s + r - 1 (of a DIF over blocks of m = 2^(lg - s)) on the
// 2^r points e[t] = x[i0 + t M], M = m >> r, i0 = blk m + j; twiddle of
// exponent x from tw(x)
template <int r, class TW>
__device__ __forceinline__ void dif_steps(Fp* e, int j, int M, int s,
                                          const TW& tw, const FieldC& F) {
#pragma unroll
  for (int q = 0; q < r; ++q) {
    const int h = 1 << (r - 1 - q);
#pragma unroll
    for (int t = 0; t < (1 << r); ++t) {
      if (t & h) continue;
      const long long jj = j + (long long)(t & (h - 1)) * M;
      const Fp w = tw(jj << (s + q));
      const Fp u = e[t], v = e[t | h];
      e[t] = add2p(u, v, F);
      e[t | h] = mul_lazy(sub2p(u, v, F), w, F);
    }
  }
}

struct ShTw {
  const uint32_t* sh;
  int half;
  __device__ __forceinline__ Fp operator()(long long x) const {
    const int p = tw_pos((int)x);
    Fp w;
#pragma unroll
    for (int q = 0; q < GT_NW; ++q) w.w[q] = sh[q * half + p];
    return w;
  }
};

struct GlTw {
  const uint32_t* g;
  __device__ __forceinline__ Fp operator()(long long x) const {
    Fp w;
    ld(w, g + x * GT_NW);
    return w;
  }
};

// stage s of a 2^G segment: from global memory (first) or shared
// memory, to shared or global (last)
__device__ __forceinline__ void seg_step(const FsArgs& a, uint32_t* sd,
                                         int pad, const ShTw& tw, int s,
                                         bool first, bool last,
                                         long long row, long long base,
                                         const FieldC& F) {
  const int lM = a.G - s - 1, M = 1 << lM;
  for (int u = threadIdx.x; u < (1 << (a.G - 1)); u += blockDim.x) {
    const int j = u & (M - 1);
    const int i0 = (u >> lM) * 2 * M + j;
    Fp e[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + t * M;
      if (first) {
        e[t] = ld_in(a, row, base + i, F);
      } else {
#pragma unroll
        for (int q = 0; q < GT_NW; ++q) e[t].w[q] = sd[q * pad + sh_pos(i)];
      }
    }
    dif_steps<1>(e, j, M, s, tw, F);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + t * M;
      if (last) {
        st_out(a, row, base + i, e[t], F);
      } else {
#pragma unroll
        for (int q = 0; q < GT_NW; ++q) sd[q * pad + sh_pos(i)] = e[t].w[q];
      }
    }
  }
}

// block b: row b >> segs_log, segment b & (2^segs_log - 1), 2^G points;
// at most 85 registers a thread, three blocks an SM (8 words); at 12
// words 128 and two (a 2^10 segment's 79,872 B of shared memory: two
// blocks an SM; the longest, 2^11, 159,744 B, takes one)
__global__ void __launch_bounds__(FS_TMAX, GT_NW == 8 ? 3 : 2)
    fs_seg_kernel(FsArgs a, FieldC F) {
  extern __shared__ uint32_t sm[];
  const int G = a.G, n = 1 << G, half = n >> 1;
  const int pad = n + (n >> 3);
  uint32_t* sd = sm;
  uint32_t* st_tw = sm + (G > 1 ? GT_NW * pad : 0);
  const int segs_log = a.L - G;
  const long long row = (long long)blockIdx.x >> segs_log;
  const long long base = (long long)(blockIdx.x & ((1u << segs_log) - 1))
                         << G;
  for (int i = threadIdx.x; i < GT_NW * half; i += blockDim.x)
    st_tw[i] = a.tw[i];
  __syncthreads();
  const ShTw tw{st_tw, half};
  for (int s = 0; s < G; ++s) {
    if (s) __syncthreads();
    seg_step(a, sd, pad, tw, s, s == 0, s == G - 1, row, base, F);
  }
}

// stages s0 .. s0 + r - 1 of every row, in registers; thread t: row
// t >> (L - r), step u = t mod 2^(L - r)
template <int r>
__global__ void fs_pass_kernel(FsArgs a, int s0, long long nt, FieldC F) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= nt) return;
  const int lM = a.L - s0 - r;
  const long long M = 1LL << lM, m = M << r;
  const long long row = t >> (a.L - r);
  const long long u = t & ((1LL << (a.L - r)) - 1);
  const long long j = u & (M - 1);
  const long long i0 = (u >> lM) * m + j;
  Fp e[1 << r];
#pragma unroll
  for (int q = 0; q < (1 << r); ++q) e[q] = ld_in(a, row, i0 + q * M, F);
  dif_steps<r>(e, (int)j, (int)M, s0, GlTw{a.tw}, F);
#pragma unroll
  for (int q = 0; q < (1 << r); ++q) {
    const long long off = row * a.out_rs + (i0 + q * M) * a.out_es;
    st(a.out + off * GT_NW, canon(e[q], F));
  }
}

static FsArgs fs_args(const void* in, const void* pre, void* out,
                      const void* post, const void* tw, long long in_rs,
                      long long in_es, long long out_rs, long long out_es,
                      int L) {
  FsArgs a;
  a.in = (const uint32_t*)in;
  a.pre = (const uint32_t*)pre;
  a.out = (uint32_t*)out;
  a.post = (const uint32_t*)post;
  a.tw = (const uint32_t*)tw;
  a.in_rs = in_rs;
  a.in_es = in_es;
  a.out_rs = out_rs;
  a.out_es = out_es;
  a.orow_bits = a.oel_bits = a.post_bcast = 0;
  a.L = L;
  a.G = L;
  return a;
}

// Shared memory of fs_seg_kernel at segment log G (bytes): the points
// (when there is more than one stage) and the twiddles.
static size_t fs_smem(int G) {
  const size_t n = (size_t)1 << G;
  return ((G > 1 ? GT_NW * (n + n / 8) : 0) + GT_NW * n / 2) * 4;
}

// fs_smem for the host, which checks its own copy of the formula
// (fourstep.seg_smem_bytes) against it
extern "C" long long gt_fs_smem(int G) { return (long long)fs_smem(G); }

// The last G stages of `rows` rows of 2^L points (all of them if G = L),
// in segments of 2^G (1 <= G <= 12, and fs_smem(G) within a block's
// shared memory: G <= 11 at 12 words, fourstep.seg_log); tw: the
// 2^(G-1) powers of the
// segment root, word-major and index-folded as tw_pos reads them.
extern "C" int gt_fs_seg(const void* in, const void* pre, void* out,
                         const void* post, const void* tw, long long in_rs,
                         long long in_es, long long out_rs, long long out_es,
                         long long rows, int L, int G, int orow_bits,
                         int oel_bits, int post_bcast, const void* consts,
                         void* stream) {
  if (rows <= 0) return 0;
  if (G < 1 || G > 12 || L < G || L > 30) return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  FsArgs a = fs_args(in, pre, out, post, tw, in_rs, in_es, out_rs, out_es,
                     L);
  a.G = G;
  a.orow_bits = orow_bits;
  a.oel_bits = oel_bits;
  a.post_bcast = post_bcast;
  const size_t smem = fs_smem(G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fs_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int steps = 1 << (G - 1);
  const int threads = steps < FS_TMAX ? steps : FS_TMAX;
  const long long blocks = rows << (L - G);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fs_seg_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      a, F);
  return (int)cudaGetLastError();
}

// DIF stages s0 .. s0 + r - 1 (r <= 3) of `rows` rows of 2^L points;
// tw: the 2^(L-1) powers of the row root, natural order. out may be in
// (the same layout), the pass reads all its points before it writes.
extern "C" int gt_fs_pass(const void* in, const void* pre, void* out,
                          const void* tw, long long in_rs, long long in_es,
                          long long out_rs, long long out_es,
                          long long rows, int L, int s0, int r,
                          const void* consts, void* stream) {
  if (rows <= 0) return 0;
  if (r < 1 || r > 3 || s0 < 0 || s0 + r > L || L > 30)
    return (int)cudaErrorInvalidValue;
  FieldC F = field_from_host((const uint32_t*)consts);
  FsArgs a = fs_args(in, pre, out, nullptr, tw, in_rs, in_es, out_rs, out_es,
                     L);
  const long long nt = rows << (L - r);
  const int T = 128;
  const long long blocks = (nt + T - 1) / T;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (r == 1)
    fs_pass_kernel<1><<<(unsigned)blocks, T, 0, s>>>(a, s0, nt, F);
  else if (r == 2)
    fs_pass_kernel<2><<<(unsigned)blocks, T, 0, s>>>(a, s0, nt, F);
  else
    fs_pass_kernel<3><<<(unsigned)blocks, T, 0, s>>>(a, s0, nt, F);
  return (int)cudaGetLastError();
}
