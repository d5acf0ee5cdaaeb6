from gnark_tpu_torch.msm.pippenger import msm, window_digits

__all__ = ["msm", "window_digits"]
