"""Zamba2-7B — hybrid Mamba2 + shared attention blocks. [arXiv:2411.15242; unverified]

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Every 6th layer applies ONE shared attention+MLP block (Zamba's
parameter-sharing trick); the rest are Mamba2 blocks.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=112,
                              rope_theta=1e4),
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  chunk_size=128),
    attn_every=6,
    act="swiglu",
)
