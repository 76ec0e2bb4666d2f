from repro_torch.kernels.ssd.ops import ssd_forward

__all__ = ["ssd_forward"]
