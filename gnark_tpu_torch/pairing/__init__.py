from gnark_tpu_torch.pairing.tate import Pairing, get_pairing

__all__ = ["Pairing", "get_pairing"]
