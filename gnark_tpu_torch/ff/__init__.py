"""Field arithmetic: plain limb ops (mont.FF) and the K1 kernel."""

from gnark_tpu_torch.ff.mont import FF, get_ff, on_words

__all__ = ["FF", "get_ff", "on_words"]
