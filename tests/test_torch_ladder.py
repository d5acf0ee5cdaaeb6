"""The fixed-base ladder of Setup (msm/fixed_base.batch_scalar_mul) on
the CPU, where it runs its plain version, the per-bit K7 + K6 sequence,
in G1 and G2 (its short ladders against the host are in
tests/test_torch_jac.py):
  * the wrapper's argument checks, nbits = 0, and bits above nbits;
  * slow tier: the full 254-bit ladder on the scalars that take the
    complete add's branches (r: P == -A at the last bit; r + 2: P == A,
    the doubling branch) and on 0, 1, r - 1, against the host and
    against the reference's gnark_tpu.msm.fixed_base.batch_scalar_mul
    (~10 s a group for the plain ladder; the reference compiles its
    fori_loop).
The ladder kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
Tolerance: exact equality (canonical Montgomery words, affine host
ints)."""

import numpy as np
import pytest
import torch

from gnark_tpu_torch.backend.groth16 import _to_affine_host
from gnark_tpu_torch.ec import curves, host
from gnark_tpu_torch.ec.fp2 import get_ff2
from gnark_tpu_torch.ff import get_ff
from gnark_tpu_torch.msm.fixed_base import batch_scalar_mul, jac_to_affine

torch.set_num_threads(2)

CURVE = curves.CURVES["bn254"]
R_ORDER = CURVE.fr.modulus


def _group(g2):
    if g2:
        return get_ff2(CURVE.fp.name, CURVE.fp2_nr), CURVE.host_g2_field, \
            CURVE.g2
    return get_ff(CURVE.fp.name), CURVE.host_fp, CURVE.g1


def _base(ff, gen):
    return tuple(torch.as_tensor(ff.encode_words([c])).reshape(1, -1)
                 for c in gen)


def raw_scalars(vals, nw=8):
    """Ints below 2^(32 nw) -> (n, nw) int32 words as they are
    (encode_words(..., mont=False) reduces mod r: r would become 0)."""
    buf = b"".join(v.to_bytes(4 * nw, "little") for v in vals)
    return torch.frombuffer(bytearray(buf), dtype=torch.int32) \
        .reshape(len(vals), nw).clone()


def _host_points(ff, hf, P):
    return [_to_affine_host(ff, hf, "jac", tuple(a[i:i + 1] for a in P))
            for i in range(P[0].shape[0])]


BAD_ARGS = {
    "int64 scalars": ("int32", lambda ff, b, sc: (ff, b, 16,
                                                   sc.to(torch.int64))),
    "flat scalars": ("int32", lambda ff, b, sc: (ff, b, 16, sc.reshape(-1))),
    "negative nbits": ("nbits", lambda ff, b, sc: (ff, b, -1, sc)),
    "nbits above the words": ("nbits", lambda ff, b, sc: (ff, b, 257, sc)),
    "short base": ("base", lambda ff, b, sc: (ff, (b[0], b[1][:, :4]), 16,
                                              sc)),
    "base without y": ("base", lambda ff, b, sc: (ff, b[:1], 16, sc)),
    "base on another device": ("devices", lambda ff, b, sc: (
        ff, tuple(a.to("meta") for a in b), 16, sc)),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_ladder_argument_checks(case):
    ff, _, gen = _group(False)
    match, make = BAD_ARGS[case]
    with pytest.raises(ValueError, match=match):
        batch_scalar_mul(*make(ff, _base(ff, gen), raw_scalars([1, 2, 3])))


def test_ladder_no_bits_is_identity():
    ff, _, gen = _group(False)
    X, Y, Z = batch_scalar_mul(ff, _base(ff, gen), 0, raw_scalars([1, 2, 3]))
    one = torch.as_tensor(ff.encode_words([1])).reshape(1, -1)
    assert torch.equal(X, one.expand(3, -1)) and torch.equal(Y, X)
    assert not Z.any()


def test_ladder_ignores_bits_above_nbits():
    ff, _, gen = _group(False)
    base = _base(ff, gen)
    R = batch_scalar_mul(ff, base, 2, raw_scalars([1, 2, 3]))
    R_hi = batch_scalar_mul(ff, base, 2, raw_scalars([1 << 200 | k
                                                      for k in (1, 2, 3)]))
    assert all(torch.equal(u, v) for u, v in zip(R, R_hi))


EDGE = [0, 1, R_ORDER - 1, R_ORDER, R_ORDER + 2]


@pytest.mark.slow
@pytest.mark.parametrize("g2", [False, True])
def test_ladder_254_bits_edge_scalars(g2):
    """r: the accumulator reaches -G before the last add (P == -A gives
    infinity); r + 2: it reaches G (P == A, the doubling branch)."""
    ff, hf, gen = _group(g2)
    R = batch_scalar_mul(ff, _base(ff, gen), CURVE.fr.bits,
                         raw_scalars(EDGE))
    assert _host_points(ff, hf, R) == [host.ec_mul(hf, gen, k % R_ORDER)
                                       for k in EDGE]
    x, y, inf = jac_to_affine(ff, R)
    assert inf.tolist() == [True, False, False, True, False]


@pytest.mark.slow
@pytest.mark.parametrize("g2", [False, True])
def test_ladder_254_bits_matches_reference(g2):
    """The same scalars, as 16-bit limbs as they are, through the
    reference's batch_scalar_mul: the same group elements."""
    import jax.numpy as jnp
    from gnark_tpu.backend import groth16 as ref_groth16
    from gnark_tpu.ec import curves as ref_curves
    from gnark_tpu.ec.weierstrass import jac_to_affine as ref_to_affine
    from gnark_tpu.ff import get_ff as ref_get_ff
    from gnark_tpu.msm.fixed_base import batch_scalar_mul as ref_ladder
    ff, hf, gen = _group(g2)
    rc = ref_curves.CURVES["bn254"]
    if g2:
        rf = ref_groth16._g2_field(rc)
        rbase = ref_groth16._g2_base(rf, rc)
    else:
        rf = ref_get_ff(rc.fp.name)
        rbase = ref_groth16._g1_base(rf, rc)
    limbs = jnp.asarray(np.array([[(k >> (16 * i)) & 0xFFFF
                                   for i in range(16)] for k in EDGE],
                                 dtype=np.uint32))
    want = ref_groth16._decode_affine(rf, ref_to_affine(
        rf, ref_ladder(rf, rbase, CURVE.fr.bits, limbs)))
    R = batch_scalar_mul(ff, _base(ff, gen), CURVE.fr.bits,
                         raw_scalars(EDGE))
    assert _host_points(ff, hf, R) == want
