"""Plain PyTorch version of the fused RMSNorm kernel."""

import torch


def rmsnorm_ref(x, scale, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
