from repro_torch.kernels.moe_gmm.ops import moe_gmm

__all__ = ["moe_gmm"]
