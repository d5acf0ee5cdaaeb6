"""Elliptic-curve layer: registry, host oracle, Fp2, point arithmetic.

  curves.py      — validated constants for the 5 gnark curves
  host.py        — pure-Python oracle (fields, affine ops, sqrt)
  fp2.py         — plain Fp2 over gnark_tpu_torch.ff.FF
  weierstrass.py — plain batched Jacobian ops
  proj_ec.py     — kernel K3, complete projective add / double
  jac_ec.py      — kernels K6 / K7, complete Jacobian mixed add / double
"""

from gnark_tpu_torch.ec.curves import CURVES, Curve
from gnark_tpu_torch.ec.fp2 import FF2, get_ff2

__all__ = ["CURVES", "Curve", "FF2", "get_ff2"]
