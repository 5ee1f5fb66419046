"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

Each layer holds 8 experts of three 6144 x 16384 matrices: 2.42 B
parameters, 4.83 GB in bf16, computed from the shapes.  The whole model
(140.6 B parameters, 281 GB in bf16) does not fit one 80 GB card, so a
one-card run keeps fewer layers at full width.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, top_k=2, window=4096,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-tiny", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        n_experts=4, top_k=2, window=16,
    )
