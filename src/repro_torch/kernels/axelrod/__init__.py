from repro_torch.kernels.axelrod.ops import axelrod_wave

__all__ = ["axelrod_wave"]
