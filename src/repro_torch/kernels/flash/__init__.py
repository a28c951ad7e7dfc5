from repro_torch.kernels.flash.ops import flash_attention

__all__ = ["flash_attention"]
