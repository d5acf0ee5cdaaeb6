"""K10-K13: the field operations of the PLONK prover over word tensors.

(n, nw) int32 words in Montgomery form, inputs < 2p, canonical outputs:

  add, sub   K10 ff_addsub: a +- b, b the same shape or one element
  batch_inv  K11: 1 / a elementwise, 0 -> 0 (Montgomery's trick)
  scan_mul   K12: the inclusive prefix product a[0] * ... * a[i]
  dot        K13: sum_i a[i] * b[i], or sum_i a[i] without b; (1, nw)
  dot_many   K13: sum_i c_j[i] * pows[i] for k columns c_j; (k, nw)

None of them replaces a TPU kernel: the reference runs them as XLA ops
(gnark_tpu/ff/mont.py FF.add / FF.sub / FF.batch_inv:330,
jax.lax.associative_scan(ff.mul) and ff_sum in
gnark_tpu/backend/plonk_device.py:58-77). Kernels: csrc/ff_ops.cu. On a
CPU tensor each runs its plain version (`*_plain`, over the int64 limbs
of ff.mont.FF); on a CUDA tensor its kernel, or an error. Each wrapper
counts its calls in `.launches` (each docstring says the kernels a call
starts).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gnark_tpu_torch import cuda
from gnark_tpu_torch.ff.mont import FF

INV_TILE = 8 * 256        # K11's least rows a tile (GT_INV_E * GT_FB)
SCAN_TILE = 16 * 512      # rows a tile of K12 (GT_SCAN_C)
DOT_MAXB = 1024           # K13's blocks a launch at most (GT_DOT_MAXB)
DOT_K = 8                 # K13's columns a launch at most (GT_DOT_K)


def _limbs(ff: FF, w):
    return ff.canon(ff.from_words(w))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def add_plain(ff: FF, a, b):
    return ff.to_words(ff.add(_limbs(ff, a), _limbs(ff, b)))


def sub_plain(ff: FF, a, b):
    return ff.to_words(ff.sub(_limbs(ff, a), _limbs(ff, b)))


def batch_inv_plain(ff: FF, a):
    return ff.to_words(ff.batch_inv(_limbs(ff, a)))


def scan_mul_plain(ff: FF, a):
    return ff.to_words(ff.scan_mul(_limbs(ff, a)))


def dot_plain(ff: FF, a, b=None):
    """The reference's ff_sum over ff.mul: products, then a tree of
    sums over the rows zero-padded to a power of two."""
    x = _limbs(ff, a)
    if b is not None:
        x = ff.mul(x, _limbs(ff, b))
    m = 1 << max(x.shape[0] - 1, 0).bit_length()
    if m != x.shape[0]:
        x = torch.cat([x, ff.zeros((m - x.shape[0],), x.device)])
    while m > 1:
        m //= 2
        x = ff.add(x[:m], x[m:2 * m])
    return ff.to_words(x[:1])


def dot_many_plain(ff: FF, cols, pows):
    """dot_plain of each column by the first len(column) rows of pows."""
    return torch.cat([dot_plain(ff, c, pows[:c.shape[0]]) for c in cols])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(ff: FF, what: str, a, b=None, bcast=False):
    if a.dim() != 2 or a.shape[1] != ff.nw:
        raise ValueError(f"{what}: a must be (n, {ff.nw}) words, got "
                         f"{tuple(a.shape)}")
    if b is not None:
        ok = (1, a.shape[0]) if bcast else (a.shape[0],)
        if b.dim() != 2 or b.shape[1] != ff.nw or b.shape[0] not in ok:
            raise ValueError(f"{what}: b has shape {tuple(b.shape)}, a "
                             f"{tuple(a.shape)}")
        if b.device != a.device:
            raise ValueError(f"{what}: operands on different devices")


def _check_dot(ff: FF, what: str, cols, pows):
    """Columns and pows (m, nw) int32 words on one device, each column
    1 to m rows."""
    if not cols:
        raise ValueError(f"{what}: no columns")
    for t in list(cols) + [pows]:
        if t.dim() != 2 or t.shape[1] != ff.nw or t.shape[0] == 0:
            raise ValueError(f"{what}: expected (n >= 1, {ff.nw}) words, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: expected int32 words, got {t.dtype}")
        if t.device != cols[0].device:
            raise ValueError(f"{what}: operands on different devices")
    if max(c.shape[0] for c in cols) > pows.shape[0]:
        raise ValueError(f"{what}: a column is longer than pows "
                         f"({pows.shape[0]} rows)")


@functools.lru_cache(maxsize=None)
def _fn(name: str, field: str):
    sig = {"gt_ff_addsub": (3, [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]),
           "gt_batch_inv": (3, [ctypes.c_longlong, ctypes.c_void_p]),
           "gt_scan_mul": (3, [ctypes.c_longlong, ctypes.c_void_p]),
           "gt_dot_many": (5, [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p])}[name]
    return cuda.bind("ff_ops", field, name, *sig)


def ff_addsub(ff: FF, a, b, sub: bool):
    """K10: a - b if sub else a + b; b (n, nw) or one element (1, nw).
    One kernel on the card."""
    what = ("add", "sub")[sub]
    _check(ff, what, a, b, bcast=True)
    if a.device.type == "cpu":
        return (sub_plain if sub else add_plain)(ff, a, b)
    n = a.shape[0]
    a = cuda.dev_words(a, what)
    b = cuda.dev_words(b, what)
    out = torch.empty_like(a)
    fn = _fn("gt_ff_addsub", ff.p.name)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            int(b.shape[0] == 1 and n != 1), int(sub),
            cuda.field_consts(ff.p.name).ctypes.data,
            cuda.stream(a))
    cuda.check(rc, what)
    ff_addsub.launches += 1
    return out


ff_addsub.launches = 0


def add(ff: FF, a, b):
    return ff_addsub(ff, a, b, False)


def sub(ff: FF, a, b):
    return ff_addsub(ff, a, b, True)


def inv_tiles(n: int) -> int:
    """K11's tiles for n rows at most (its kernel takes longer tiles as n
    grows); its scratch is twice as many rows (the tiles' products and
    inverses, then the one-block pass's prefixes)."""
    return -(-n // INV_TILE)


def batch_inv(ff: FF, a):
    """1 / a for each row; zero rows give zero. On the card: prefixes a
    thread and each tile's product, one block that inverts the tiles'
    products around a single field inversion, then each tile's
    inverses; 3 kernels."""
    _check(ff, "batch_inv", a)
    if a.device.type == "cpu":
        return batch_inv_plain(ff, a)
    out = _batch_inv_card(ff, cuda.dev_words(a, "batch_inv"))
    batch_inv.launches += 1
    return out


batch_inv.launches = 0


def _batch_inv_card(ff: FF, a):
    n = a.shape[0]
    out = torch.empty_like(a)
    scratch = torch.empty((2 * max(inv_tiles(n), 1), ff.nw),
                          dtype=torch.int32, device=a.device)
    fn = _fn("gt_batch_inv", ff.p.name)
    rc = fn(a.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, cuda.field_consts(ff.p.name).ctypes.data,
            cuda.stream(a))
    cuda.check(rc, "batch_inv")
    return out


def scan_tiles(n: int) -> int:
    """Tiles of K12 for n rows."""
    return -(-n // SCAN_TILE)


def scan_scratch_words(n: int) -> int:
    """int32 words of K12's zeroed scratch for n rows: the ticket and a
    flag a tile (padded to whole rows), then two rows a tile (a tile's
    product, its inclusive prefix)."""
    m = max(scan_tiles(n), 1)
    return -(-(1 + m) // 8) * 8 + 2 * m * 8


def scan_mul(ff: FF, a):
    """Inclusive prefix products: out[i] = a[0] * ... * a[i]. On the
    card: one kernel, a single-pass scan of 8192-row tiles with
    decoupled look-back."""
    _check(ff, "scan_mul", a)
    if a.device.type == "cpu":
        return scan_mul_plain(ff, a)
    out = _scan_mul_card(ff, cuda.dev_words(a, "scan_mul"))
    scan_mul.launches += 1
    return out


scan_mul.launches = 0


def _scan_mul_card(ff: FF, a):
    n = a.shape[0]
    out = torch.empty_like(a)
    scratch = torch.zeros(scan_scratch_words(n), dtype=torch.int32,
                          device=a.device)
    fn = _fn("gt_scan_mul", ff.p.name)
    rc = fn(a.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, cuda.field_consts(ff.p.name).ctypes.data,
            cuda.stream(a))
    cuda.check(rc, "scan_mul")
    return out


def dot(ff: FF, a, b=None):
    """sum_i a[i] * b[i] (b None: sum_i a[i]) as (1, nw) words, b as
    long as a. On the card: one kernel (dot_many's with one column)."""
    _check(ff, "dot", a, b)
    if a.shape[0] == 0:
        raise ValueError("dot: no rows")
    if a.device.type == "cpu":
        return dot_plain(ff, a, b)
    out = _dot_card(ff, [a], b)
    dot.launches += 1
    return out


dot.launches = 0


def dot_many(ff: FF, cols, pows):
    """For each column c_j: sum_i c_j[i] * pows[i] as (k, nw) canonical
    words; each column at most len(pows) rows and zero past its end. On
    the card: one kernel a DOT_K columns, each reading pows once."""
    _check_dot(ff, "dot_many", cols, pows)
    if pows.device.type == "cpu":
        return dot_many_plain(ff, cols, pows)
    outs = []
    for s in range(0, len(cols), DOT_K):
        outs.append(_dot_card(ff, cols[s:s + DOT_K], pows))
        dot_many.launches += 1
    return torch.cat(outs)


dot_many.launches = 0


_DOT_SCRATCH: dict = {}   # (device, stream) -> K13's scratch


def dot_scratch(device, stream: int) -> torch.Tensor:
    """K13's scratch for launches on one stream, made zero once: a row
    whose first word is the blocks' ticket (the last block sets it back
    to 0), then DOT_MAXB * DOT_K rows for the blocks' sums."""
    key = (str(device), stream)
    if key not in _DOT_SCRATCH:
        _DOT_SCRATCH[key] = torch.zeros((1 + DOT_MAXB * DOT_K, 8),
                                        dtype=torch.int32, device=device)
    return _DOT_SCRATCH[key]


def _dot_card(ff: FF, cols, pows):
    """One K13 launch over at most DOT_K columns (pows None: sums)."""
    cols = [cuda.dev_words(c, "dot") for c in cols]
    if pows is not None:
        pows = cuda.dev_words(pows, "dot")
    k = len(cols)
    out = torch.empty((k, ff.nw), dtype=torch.int32, device=cols[0].device)
    stream = cuda.stream(out)
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    lens = (ctypes.c_longlong * k)(*[c.shape[0] for c in cols])
    scratch = dot_scratch(out.device, stream)
    fn = _fn("gt_dot_many", ff.p.name)
    rc = fn(ctypes.addressof(ptrs), ctypes.addressof(lens),
            None if pows is None else pows.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), k, max(lens),
            cuda.field_consts(ff.p.name).ctypes.data, stream)
    cuda.check(rc, "dot")
    return out
