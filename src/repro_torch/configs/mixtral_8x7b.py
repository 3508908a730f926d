"""Mixtral 8x7B — the paper's evaluation model. [arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff_expert=14336 vocab=32000, 8 experts
top-2, sliding-window attention (4096).
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, MoPConfig)

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=128,
        sliding_window=4096, rope_theta=1e6),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    mop=MoPConfig(enabled=True, bits=4, group_size=64, num_q_experts=0),
    act="swiglu",
)
