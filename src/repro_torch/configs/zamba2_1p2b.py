"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attn blocks
[arXiv:2411.15242; hf].

The shared transformer block (GQA 32H + 8192 MLP) is applied with shared
weights after every 6 Mamba2 layers, six times in 38 layers; the last two
layers have no shared block after them.  1,170,473,856 parameters, 2.34 GB
in bf16, computed from the shapes.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_conv=4, ssm_headdim=64, ssm_expand=2,
        shared_attn_every=6,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-tiny", family="hybrid",
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        ssm_state=16, ssm_conv=4, ssm_headdim=16, ssm_expand=2,
        shared_attn_every=3,
    )
