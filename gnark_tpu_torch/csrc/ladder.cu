// Fixed-base ladder: R_i = [s_i] B for one affine base point B and n
// scalars s_i, Jacobian, over Fp (G1) and Fp2 (G2, u^2 = -|nr|); output
// canonical. Setup's device work: every key column is a batch of such
// products (gnark-crypto BatchScalarMultiplicationG1/G2).
//
// No TPU kernel of its own: the reference computes the ladder as an XLA
// fori_loop over plain group ops (gnark_tpu/msm/fixed_base.py
// batch_scalar_mul:27-52). This kernel fuses the port's per-bit sequence
// of K7 jac_double over every accumulator and K6 jac_add_mixed of the
// base with inf2 = !bit (jac_ec.cu, the formulas of
// gnark_tpu/ec/pallas_ec.py jac_double_p and jac_add_mixed_p), MSB
// first, in the same order, so its canonical words equal those of that
// sequence bit for bit (the lazy class changes representatives, never
// values, and the predicates canonicalize).
//
// Bound on this card: operations. A bit is a doubling (2M + 5S) and a
// mixed add (7M + 4S) against a scalar of 32 B read once and a point of
// 96 B (G1) or 192 B (G2) written once. Run as 254 launches each of K7
// and K6 the accumulator went out to HBM and back twice a bit; here it
// stays in registers, in the lazy [0, 2p) class, for all the bits and is
// canonicalized once at the end. Design: one thread a scalar in G1, one
// lane pair (Fp2s, fp2s.cuh) in G2; the scalar's words are loaded one at
// a time as the bits reach them; the base comes by value as a kernel
// argument; squarings take sqr_lazy (G1: each cross product once; G2:
// one product a lane). Both groups are held to 168 registers a thread,
// so three blocks share an SM (G2 at the cost of a few spills).
// A 12-word build takes the Fp products as called functions
// (GT_NOINLINE), as jac_ec.cu's 12-word K6 and K7 do: inlined, its body
// ran slower than the per-bit K7 + K6 launches it fuses; called, it is
// faster than them, at 2 blocks an SM (3 or 4, with more spills, are
// slower).
#if GT_NW > 8 && !defined(GT_NOINLINE)
#define GT_NOINLINE 1
#endif
#include "jac.cuh"

static const int T = 128;
// 8 words: G2 unbounded: 255 registers, 2 blocks; 12 words: 2 blocks
static const int MIN_BLOCKS = GT_NW == 8 ? 3 : 2;

// E: Fp (G1), or Fp2s (G2, Row<E>::lanes threads a scalar); H the host
// type of the base's coordinates
template <class E, class H>
__global__ void __launch_bounds__(T, MIN_BLOCKS)
    ladder_kernel(const uint32_t* __restrict__ sc, int nbits, H bxh, H byh,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                  FieldC F) {
  long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) /
                Row<E>::lanes;
  if (i >= n) return;
  E bx, by;
  as_elem(bx, bxh);
  as_elem(by, byh);
  Jac<E> R;
  jac_infinity(R, F);
  for (int k = (nbits - 1) >> 5; k >= 0; --k) {
    const uint32_t w = sc[i * GT_SW + k];
    for (int j = min(31, nbits - 1 - 32 * k); j >= 0; --j) {
      R = jac_dbl(R, F);
      R = jac_madd(R, bx, by, ((w >> j) & 1) == 0, F);
    }
  }
  st_jac_canon(ox, oy, oz, i, R, F);
}

// sc: n scalars of GT_SW words, plain integers; bx, by: the base's
// affine coordinates on the host (GT_NW words, 2 GT_NW for Fp2),
// Montgomery, < 2p; 0 <= nbits <= 32 GT_SW.
extern "C" int gt_ladder(const void* sc, const void* bx, const void* by,
                         void* ox, void* oy, void* oz, long long n,
                         int nbits, int fp2, const void* consts,
                         void* stream) {
  if (nbits < 0 || nbits > 32 * GT_SW) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  FieldC F = field_from_host((const uint32_t*)consts);
  cudaStream_t s = (cudaStream_t)stream;
  typedef const uint32_t* cp;
  typedef uint32_t* p;
  const int lanes = fp2 ? 2 : 1;
  unsigned blocks = (unsigned)((lanes * n + T - 1) / T);
  if (fp2)
    GT_FP2_LAUNCH(ladder_kernel<Fp2s, Fp2><<<blocks, T, 0, s>>>(
        (cp)sc, nbits, fp2_from_host((cp)bx), fp2_from_host((cp)by), (p)ox,
        (p)oy, (p)oz, n, F));
  else
    ladder_kernel<Fp, Fp><<<blocks, T, 0, s>>>(
        (cp)sc, nbits, fp_from_host((cp)bx), fp_from_host((cp)by), (p)ox,
        (p)oy, (p)oz, n, F);
  return (int)cudaGetLastError();
}
