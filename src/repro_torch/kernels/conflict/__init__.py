from repro_torch.kernels.conflict.ops import conflict_block, conflict_matrix

__all__ = ["conflict_matrix", "conflict_block"]
