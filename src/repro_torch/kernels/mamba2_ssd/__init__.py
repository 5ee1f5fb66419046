from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd

__all__ = ["mamba2_ssd"]
