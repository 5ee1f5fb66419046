"""Carry the JAX package's parameters across to the port.

The JAX parameter pytree arrives as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives).  Stacked leaves have a leading
layer axis; the converter splits it into the port's list of per-layer
dicts; the hybrid family's shared block has none.  bf16 arrays
(ml_dtypes) go through float32.  Matrices, tables, biases and the Mamba2
conv weights are cast once, here, to the activation type (the JAX package
casts them at every use, to the same numbers); RMSNorm scales and the
Mamba2 leaves that the JAX package uses in fp32 (``A_log``, ``dt_bias``,
``norm_scale``, and ``D``, which the SSD kernel takes in fp32) stay fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import check_ported

# RMSNorm scales and the Mamba2 decay rates, step biases, skip weights and
# gated-norm scales
_FP32_LEAVES = {"scale", "A_log", "dt_bias", "D", "norm_scale"}


def tree_from_numpy(node, device, dtype, name=None, layer=None):
    """Nested dicts of numpy arrays -> the same dicts of tensors.

    ``layer`` picks one entry of a leading layer axis.  Leaves named in
    ``_FP32_LEAVES`` stay fp32; the rest become ``dtype``.
    """
    if isinstance(node, dict):
        return {k: tree_from_numpy(v, device, dtype, k, layer)
                for k, v in node.items()}
    a = np.asarray(node, np.float32)
    if layer is not None:
        a = a[layer]
    return torch.tensor(a).to(
        device=device, dtype=torch.float32 if name in _FP32_LEAVES else dtype)


def params_from_numpy(tree, cfg, device=None, dtype=None):
    """The JAX parameter pytree (numpy leaves) -> the port's parameters.

    Args:
        tree: the JAX parameter pytree as numpy arrays.
        cfg: the port's ``ModelConfig`` (dense, non-MLA moe or hybrid
            family).
        device: where the tensors go (the card unless ``"cpu"``).
        dtype: type of matrices, tables and biases (default
            ``cfg.act_dtype``).
    """
    stack = "mamba" if check_ported(cfg) == "mamba" else "main"
    dev = resolve_device(device)
    dt = dtype or cfg.act_dtype
    out = {k: tree_from_numpy(v, dev, dt, k) for k, v in tree.items()
           if k != stack}
    out[stack] = [tree_from_numpy(tree[stack], dev, dt, layer=i)
                  for i in range(cfg.n_layers)]
    return out
