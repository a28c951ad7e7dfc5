from repro_torch.kernels.levels.ops import wave_levels

__all__ = ["wave_levels"]
