from repro_torch.kernels.attach.ops import attach_arrivals

__all__ = ["attach_arrivals"]
