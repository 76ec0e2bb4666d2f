from repro_torch.kernels.rglru.ops import rglru_scan

__all__ = ["rglru_scan"]
