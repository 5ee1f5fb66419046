"""Plain PyTorch version of the grouped (per-expert) matmul kernel."""

import torch


def moe_gmm_ref(x, w, n_valid=None):
    """x: (E,C,D); w: (E,D,F); n_valid: (E,) -> (E,C,F), invalid rows 0.

    fp32 product, rows c >= n_valid[e] zeroed, out in x's type.
    """
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if n_valid is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        y = torch.where(rows[None, :, None] < n_valid[:, None, None], y, 0.0)
    return y.to(x.dtype)
