"""Qwen3-8B — dense, qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    d_ff=12288,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1e6),
    act="swiglu",
)
