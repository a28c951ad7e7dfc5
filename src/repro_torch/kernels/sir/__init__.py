from repro_torch.kernels.sir.ops import sir_wave

__all__ = ["sir_wave"]
