"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

SWA window 4096 bounds the KV cache (ring cache).  head_dim = 3840/32 = 120,
which the decode-attention kernel takes as it is.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab_size=32000, window=4096,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-tiny", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8, window=16,
    )
