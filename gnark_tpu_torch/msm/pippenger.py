"""Multi-scalar multiplication: digit helpers and the public `msm`.

Counterpart of gnark_tpu.msm.pippenger. The reference keeps a portable
scan-path Pippenger beside its bucket kernel; the port has only the
bucket path (msm/bucket.py, kernels K4 and K3), for G1 over Fp and G2
over Fp2 of curves with a = 0. The scan path is not ported.
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.fields import LIMB_BITS


def window_digits(scalars: torch.Tensor, nbits: int, c: int):
    """(n, K) int64 16-bit scalar limbs -> (n, W) int32 c-bit digits."""
    n, K = scalars.shape
    W = -(-nbits // c)
    padded = torch.cat([scalars, scalars.new_zeros(n, 1)], dim=1)
    mask = (1 << c) - 1
    cols = []
    for w in range(W):
        lo, sh = divmod(w * c, LIMB_BITS)
        v = padded[:, lo] >> sh
        if sh + c > LIMB_BITS:
            v = v | (padded[:, lo + 1] << (LIMB_BITS - sh))
        cols.append(v & mask)
    return torch.stack(cols, dim=1).to(torch.int32)


def scalar_limbs(words: torch.Tensor) -> torch.Tensor:
    """(n, nw) int32 words of plain scalars -> (n, 2*nw) int64 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        words.shape[0], -1)


def _suffix_sums(f, P, m: int, axis: int, add_fn):
    """Inclusive suffix sums over `axis` (length m, a power of two) with
    group adds: index i of the result holds sum_{j >= i} P_j.

    A work-efficient (Brent-Kung) scan on the reversed axis: log2(m)
    up-sweep and log2(m) - 1 down-sweep steps, about 2m adds in all
    instead of m log2(m); each step is one add_fn call over every
    (window, position) pair it touches. add_fn(f, S, T) takes flat
    (N, Lw) batches."""
    if m & (m - 1):
        raise ValueError("suffix sums need a power-of-two length")
    S = [torch.flip(a, dims=(axis,)) for a in P]
    dev = S[0].device

    def step(dst, off):
        idx = torch.as_tensor(dst, device=dev)
        A = [a.index_select(axis, idx - off) for a in S]
        B = [a.index_select(axis, idx) for a in S]
        shp = A[0].shape
        R = add_fn(f, tuple(a.reshape(-1, shp[-1]) for a in A),
                   tuple(b.reshape(-1, shp[-1]) for b in B))
        for a, r in zip(S, R):
            a.index_copy_(axis, idx, r.reshape(shp))

    k = m.bit_length() - 1
    for d in range(k):                               # up-sweep
        step(list(range((2 << d) - 1, m, 2 << d)), 1 << d)
    for d in range(k - 2, -1, -1):                   # down-sweep
        step(list(range(3 * (1 << d) - 1, m, 2 << d)), 1 << d)
    return tuple(torch.flip(a, dims=(axis,)) for a in S)


def msm(f, points, scalars, nbits: int, device=None):
    """MSM: sum_i scalars[i] * points[i].

    points:  (x, y, inf): x, y (n, nw) words (G1) or (n, 2, nw) (G2),
             Montgomery form; inf (n,) bool
    scalars: (n, nw) int32 words of PLAIN (non-Montgomery) scalars
    nbits:   scalar bit width (fr.bits)
    device:  where it runs (None: the card); the inputs are moved there
    Returns a Jacobian point of word tensors (batch shape ())."""
    from gnark_tpu_torch.cuda import resolve_device
    from gnark_tpu_torch.msm.bucket import msm_bucket_chunked
    dev = resolve_device(device)
    points = tuple(a.to(dev) for a in points)
    return msm_bucket_chunked(f, points, scalars.to(dev), nbits)
