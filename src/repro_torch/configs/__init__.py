"""Architecture registry: ``--arch <id>`` resolution.

The text-only dense families, mixtral (MoE) and zamba2 (hybrid) are
ported; the rest of the JAX package's registry is queued in ROADMAP.md.
"""

from repro_torch.configs import (h2o_danube_3_4b, mixtral_8x22b, qwen2_1p5b,
                                 yi_6b, zamba2_1p2b)
from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig", "ARCHS", "get_config", "get_tiny"]

ARCHS = {
    "qwen2-1.5b": qwen2_1p5b,
    "yi-6b": yi_6b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "mixtral-8x22b": mixtral_8x22b,
    "zamba2-1.2b": zamba2_1p2b,
}


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch].get_config()


def get_tiny(arch: str) -> ModelConfig:
    return ARCHS[arch].tiny()
