"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias, tied embeddings [arXiv:2407.10671; hf]."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True,
        rope_theta=1e6, tie_embeddings=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-tiny", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
        d_ff=128, vocab_size=256, vocab_pad_multiple=8,
        qkv_bias=True, tie_embeddings=True,
    )
