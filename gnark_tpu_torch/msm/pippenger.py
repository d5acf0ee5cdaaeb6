"""Multi-scalar multiplication: digit helpers, the scan-path Pippenger
and the public `msm`, which routes between it and the bucket path.

Counterpart of gnark_tpu.msm.pippenger. Two paths:
  * bucket (msm/bucket.py, kernels K4 and K3): G1 over Fp and G2 over Fp2
    of curves with a = 0;
  * scan (here, kernels K6, K8 and K7, for G1 and G2): scalars are cut
    into W windows of c bits; the points are split into G groups, and
    n/G sequential steps each add one point of every (window, group)
    pair into its bucket: a gather, one mixed add K6 of width W*G, a
    scatter (the W*G bucket indices of a step are distinct by
    construction). The groups fold in one launch (jac_fold: K8's formula,
    each bucket's G partial sums added left to right), each window's
    sum_j j*B_j is two suffix sums with K8, and the windows combine by
    Horner with c doublings (K7) and one add (K8) each.
GNARK_TPU_MSM_IMPL (read at each call, as the reference reads it):
"bucket", "scan", or "auto" (default), which takes the bucket path on the
card and on the CPU. The bucket path's complete formulas need the group's
3 b, which every caller passes (b3; msm/bucket.group_b3): it is taken by
group, not by field, since two groups can share a field (BW6-761's G1 and
G2 lie over one Fp with b = -1 and b2 = 4); b3 = None (no a = 0 curve)
takes the scan path.
"""

from __future__ import annotations

import os

import torch

from gnark_tpu_torch.ec import jac_ec
from gnark_tpu_torch.ec.weierstrass import jac_inf
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


def _pick_params(n: int, nbits: int):
    """(c, G) for n points (a power of two): c balances the scan work
    n*W against the W*2^c buckets; G is capped at n/2^c so the group
    fold stays below the useful adds (the reference's heuristic)."""
    if n <= 256:
        c = 4
    elif n <= 1 << 12:
        c = 8
    elif n <= 1 << 16:
        c = 11
    elif n <= 1 << 20:
        c = 13
    else:
        c = 15
    G = max(1, min(4096, n >> c))
    return c, G


def _inf_words(f, m: int, device):
    """m Jacobian infinities (1, 1, 0) as one (3, m, Lw) word tensor."""
    P = tuple(f.to_words(a).reshape(1, -1) for a in jac_inf(f, (1,), device))
    return torch.stack([a.expand(m, -1) for a in P]).contiguous()


def _msm_scan(f, points, scalars, nbits: int, c: int, G: int, n_class: int):
    """The scan path on flat (n, Lw) affine words; returns a Jacobian
    point of (1, Lw) canonical words."""
    x, y, inf = points
    n, Lw = x.shape
    dev = x.device
    pad = n_class - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad, Lw)])
        y = torch.cat([y, y.new_zeros(pad, Lw)])
        inf = torch.cat([inf, inf.new_ones(pad)])
        scalars = torch.cat([scalars, scalars.new_zeros(pad,
                                                        scalars.shape[1])])
    digits = window_digits(scalar_limbs(scalars), nbits, c)   # (n, W)
    W = digits.shape[1]
    B = 1 << c
    steps = n_class // G

    # bucket index of each (step, window, group): (w*G + g)*B + digit
    d = digits.reshape(G, steps, W).permute(1, 2, 0).to(torch.int64)
    wg = torch.arange(W * G, device=dev, dtype=torch.int64).reshape(W, G)
    idx = (d + wg * B).reshape(steps, W * G)

    def tiled(a):
        """(n, ...) -> (steps, W*G, ...): the G points of a step (point
        g*steps + s for group g), repeated for each window."""
        g = a.reshape((G, steps) + a.shape[1:]).transpose(0, 1)
        return g.unsqueeze(1).expand((steps, W) + g.shape[1:]).reshape(
            (steps, W * G) + a.shape[1:])

    xt, yt, it = tiled(x), tiled(y), tiled(inf)
    bk = _inf_words(f, W * G * B, dev)              # (3, W*G*B, Lw)
    for s in range(steps):
        ix = idx[s]
        cur = bk.index_select(1, ix)
        new = jac_ec.jac_add_mixed(f, tuple(cur), xt[s], yt[s], it[s])
        bk.index_copy_(1, ix, torch.stack(new))
    del xt, yt, it

    # fold the groups: (3, W*G*B) -> (3, W, B), one jac_fold launch
    P = torch.stack(jac_ec.jac_fold(f, tuple(bk), G, B)) if G > 1 else bk
    P = P.reshape(3, W, B, Lw)
    del bk

    # per window sum_j j*B_j: suffix sums of buckets 1..B-1, padded to B
    # with an infinity at the end, then their sum (suffix sums again)
    tail = torch.cat([P[:, :, 1:], _inf_words(f, W, dev)[:, :, None]], 2)
    suf = _suffix_sums(f, tuple(tail), B, 1, jac_ec.jac_add)
    tot = _suffix_sums(f, suf, B, 1, jac_ec.jac_add)
    tot = tuple(a[:, 0] for a in tot)                # (W, Lw)

    # Horner over the windows, from the top: R = 2^c R + T_w
    R = tuple(_inf_words(f, 1, dev))
    for i in range(W):
        for _ in range(c):
            R = jac_ec.jac_double(f, R)
        R = jac_ec.jac_add(f, R, tuple(a[W - 1 - i][None] for a in tot))
    return R


def msm_raw(f, points, scalars, nbits: int, c: int | None = None,
            groups: int | None = None, *, b3):
    """The routed MSM on the points' device, in the path's own
    coordinates: ("proj", P) from the bucket path (projective) or
    ("jac", P) from the scan path (Jacobian), P of (1, Lw) words.
    b3: 3 b of the points' group (bucket.group_b3), None for a group
    without an a = 0 curve (the scan path). c, groups: the scan path's
    window width and group count (default: _pick_params)."""
    impl = os.environ.get("GNARK_TPU_MSM_IMPL", "auto")
    if impl not in ("auto", "bucket", "scan"):
        raise ValueError(f"GNARK_TPU_MSM_IMPL={impl!r}: want auto, bucket "
                         f"or scan")
    if impl != "scan" and b3 is not None:
        from gnark_tpu_torch.msm.bucket import msm_proj
        return "proj", msm_proj(f, points, scalars, nbits, b3=b3)
    x, y, inf = points
    n = x.shape[0]
    n_class = 64
    while n_class < n:
        n_class *= 2
    c_auto, g_auto = _pick_params(n_class, nbits)
    c, G = c or c_auto, min(groups or g_auto, n_class)
    return "jac", _msm_scan(f, (x.reshape(n, -1), y.reshape(n, -1),
                                inf.reshape(n)), scalars, nbits, c, G,
                            n_class)


def msm(f, points, scalars, nbits: int, device=None, c: int | None = None,
        groups: int | None = None, *, b3):
    """MSM: sum_i scalars[i] * points[i], routed by GNARK_TPU_MSM_IMPL.

    points:  (x, y, inf): x, y (n, nw) words (over Fp) or (n, 2, nw)
             (over Fp2),
             Montgomery form; inf (n,) bool
    scalars: (n, nw) int32 words of PLAIN (non-Montgomery) scalars
    nbits:   scalar bit width (fr.bits)
    b3:      3 b of the points' group (bucket.group_b3: G1's b or G2's
             b2), or None for the scan path
    device:  where it runs (None: the card); the inputs are moved there
    Returns a Jacobian point of word tensors (batch shape ())."""
    from gnark_tpu_torch.cuda import resolve_device
    from gnark_tpu_torch.msm.bucket import _elem_shape, _to_jacobian
    dev = resolve_device(device)
    points = tuple(a.to(dev) for a in points)
    kind, P = msm_raw(f, points, scalars.to(dev), nbits, c, groups,
                      b3=b3)
    if kind == "proj":
        return _to_jacobian(f, P)
    return tuple(a.reshape(_elem_shape(f)) for a in P)
