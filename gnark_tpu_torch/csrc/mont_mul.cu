// K1, the port's elementwise field kernels, canonical outputs: one
// thread an element (the affine conversion: one thread a strided run of
// points).
//
//   gt_mont_mul          out = a * b[i or 0] * R^-1
//   gt_mont_mul_sub_mul  out = (a * b - c) * d[i or 0]   (Montgomery)
//   gt_jac_to_affine     Jacobian (X, Y, Z) -> affine (X / Z^2, Y / Z^3),
//                        infinity (Z = 0) -> (0, 0); G1 over Fp, or G2
//                        over Fp2 = Fp[u]/(u^2 + |nr|), one launch a
//                        group
//
// Replaces gnark_tpu/ff/pallas_ops.py mul_p (elementwise Montgomery
// product with a broadcast operand: coset and n^-1 scaling) and
// gnark_tpu/ntt/fourstep.py _mid_mul (the four-step mid twiddle); the
// fused entry points also take in what the reference leaves to XLA
// around mul_p: computeH's ffr.sub (gnark_tpu/backend/groth16.py:437)
// and the batched Fermat inversion of jac_to_affine
// (gnark_tpu/ec/weierstrass.py:164, f.inv).
//
// Bound on this card: mont_mul and mont_mul_sub_mul by bytes (at 2^20
// elements 96 / 128 MB moved, ~29 / 38 us at 3.35 TB/s, against ~264 /
// 528 32-bit multiplies an element at about half that time). Each
// element is two 16-byte loads (32 contiguous bytes), so a warp reads one
// contiguous kilobyte; a broadcast operand is one element every thread
// reads (it stays in L1). Before the fusion, (a * b - c) * d was two
// launches with a plain int64-limb subtract between them.
//
// jac_to_affine: the reference inverts every Z by Fermat (z^(p-2): 253
// squarings and 109 products, mont.cuh fermat_inv), which Setup ran as
// 732 launches of gt_mont_mul over the batch, plus plain torch for G2's
// norm, conjugate and Fp2 products. One Fermat chain a point in one
// thread is latency-bound (each product waits on the last) and was no
// faster than those launches at 4.2M G1 points. So the kernel does the
// least work instead: Montgomery's batch inversion, one thread for each
// of the ~n / T points it takes (T: one wave of threads on the card), one
// Fermat chain a thread, ~7 products and a squaring a point; bound by
// operations, ~0.5 ms at the setup's 4.2M G1 points, about as long as
// the bytes (160 B a point G1, 320 B G2) take.
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

// inputs < 2p: a * b < 2p, minus c (sub2p) < 2p, times d < 2p
__global__ void mont_mul_sub_mul_kernel(const uint32_t* __restrict__ a,
                                        const uint32_t* __restrict__ b,
                                        const uint32_t* __restrict__ c,
                                        const uint32_t* __restrict__ d,
                                        uint32_t* __restrict__ out,
                                        long long n, int bcast, FieldC F) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y;
  ld(x, a + i * GT_NW);
  ld(y, b + i * GT_NW);
  Fp t = mul_lazy(x, y, F);
  ld(y, c + i * GT_NW);
  t = sub2p(t, y, F);
  ld(y, d + (bcast ? 0 : i) * GT_NW);
  st(out + i * GT_NW, canon(mul_lazy(t, y, F), F));
}

// Jacobian -> affine for the points i = t, t + T, t + 2T, ... < n of
// thread t (adjacent threads on adjacent points), by Montgomery's batch
// inversion of their denominators d_i (G1: Z; G2 (u^2 = -|nr|): the norm
// z0^2 + |nr| z1^2, since 1 / (z0 + z1 u) = (z0 - z1 u) / (z0^2 + |nr|
// z1^2)):
//   forward:  acc = prod of the nonzero d_i so far, written to x[i]
//             (G2: d_i beside it, in x[i]'s second half);
//   one fermat_inv of acc;
//   backward: 1 / d_i = inv * (the prefix before i), inv *= d_i; then
//             x = X zi^2, y = Y zi^3 overwrite x[i], y[i].
// d_i = 0 mod p (infinity) stays out of the products and gives x = y = 0.
template <bool G2>
__global__ void __launch_bounds__(128)
    affine_kernel(const uint32_t* __restrict__ X,
                  const uint32_t* __restrict__ Y,
                  const uint32_t* __restrict__ Z, uint32_t* __restrict__ x,
                  uint32_t* __restrict__ y, long long n, long long T,
                  FieldC F) {
  constexpr int W = G2 ? 2 * GT_NW : GT_NW;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= T || t >= n) return;
  Fp acc, d;
  set_one(acc, F);
  for (long long i = t; i < n; i += T) {
    if (G2) {
      Fp2 z;
      ld(z, Z + i * W);
      d = add2p(sqr_lazy(z.c0, F), mul_nr_abs(sqr_lazy(z.c1, F), F), F);
      st(x + i * W + GT_NW, d);
    } else {
      ld(d, Z + i * W);
    }
    if (!is_zero_lazy(d, F)) acc = mul_lazy(acc, d, F);
    st(x + i * W, acc);
  }
  Fp inv = fermat_inv(acc, F);
  for (long long i = t + (n - 1 - t) / T * T; i >= t; i -= T) {
    ld(d, G2 ? x + i * W + GT_NW : Z + i * W);
    Fp di;
    if (is_zero_lazy(d, F)) {
      set_zero(di);
    } else {
      Fp prev;
      if (i >= t + T)
        ld(prev, x + (i - T) * W);
      else
        set_one(prev, F);
      di = mul_lazy(inv, prev, F);
      inv = mul_lazy(inv, d, F);
    }
    if (G2) {
      Fp2 a, zi;
      ld(a, Z + i * W);
      zi.c0 = mul_lazy(a.c0, di, F);
      zi.c1 = neg2p(mul_lazy(a.c1, di, F), F);
      const Fp2 zi2 = sqr_lazy(zi, F);
      ld(a, X + i * W);
      st(x + i * W, canon(mul_lazy(a, zi2, F), F));
      ld(a, Y + i * W);
      st(y + i * W, canon(mul_lazy(a, mul_lazy(zi2, zi, F), F), F));
    } else {
      const Fp zi2 = sqr_lazy(di, F);
      Fp a;
      ld(a, X + i * W);
      st(x + i * W, canon(mul_lazy(a, zi2, F), F));
      ld(a, Y + i * W);
      st(y + i * W, canon(mul_lazy(a, mul_lazy(zi2, di, F), F), F));
    }
  }
}

// T: as many threads as the card holds at once (one wave), at most n;
// each thread's share, ~n / T points, shares one inversion
template <bool G2>
static int launch_affine(const void* X, const void* Y, const void* Z,
                         void* x, void* y, long long n, FieldC F,
                         cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, affine_kernel<G2>,
                                                128, 0);
  long long T = (long long)sms * (per_sm > 0 ? per_sm : 1) * 128;
  if (T > n) T = n;
  affine_kernel<G2><<<(unsigned)((T + 127) / 128), 128, 0, s>>>(
      (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
      (uint32_t*)x, (uint32_t*)y, n, T, F);
  return (int)cudaGetLastError();
}

static unsigned blocks(long long n, int T) {
  return (unsigned)((n + T - 1) / T);
}

extern "C" int gt_mont_mul(const void* a, const void* b, void* out,
                           long long n, int bcast, const void* consts,
                           void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  mont_mul_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, bcast, F);
  return (int)cudaGetLastError();
}

extern "C" int gt_mont_mul_sub_mul(const void* a, const void* b,
                                   const void* c, const void* d, void* out,
                                   long long n, int bcast,
                                   const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  mont_mul_sub_mul_kernel<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)d, (uint32_t*)out, n, bcast, F);
  return (int)cudaGetLastError();
}

// X, Y, Z, x, y: n rows of GT_NW (fp2 = 0) or 2 GT_NW (fp2 = 1) words
extern "C" int gt_jac_to_affine(const void* X, const void* Y, const void* Z,
                                void* x, void* y, long long n, int fp2,
                                const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp2)
    GT_FP2_LAUNCH(return launch_affine<true>(X, Y, Z, x, y, n, F, s));
  return launch_affine<false>(X, Y, Z, x, y, n, F, s);
}
