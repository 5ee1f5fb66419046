from repro_torch.kernels.rmsnorm.ops import rmsnorm_fused

__all__ = ["rmsnorm_fused"]
