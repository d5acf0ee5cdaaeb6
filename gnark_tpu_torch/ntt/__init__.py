import functools

from gnark_tpu_torch.cuda import resolve_device
from gnark_tpu_torch.ntt.domain import Domain


@functools.lru_cache(maxsize=32)
def _domain_cached(field_name: str, n: int, device: str) -> Domain:
    from gnark_tpu_torch.ff import get_ff
    return Domain(get_ff(field_name), n, device)


def get_domain(ff, n: int, device=None) -> Domain:
    """Process-cached Domain: the twiddle and coset tables are seconds
    of host big-int work at 2^20."""
    return _domain_cached(ff.p.name, n, str(resolve_device(device)))


__all__ = ["Domain", "get_domain"]
