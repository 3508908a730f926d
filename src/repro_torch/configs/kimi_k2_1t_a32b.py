"""Kimi K2 — trillion-param MoE (paper-table config).
[arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff_expert=2048 vocab=163840, 384 experts
top-8. ~1.03T total / ~32B active params.
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig, MoEConfig,
                                      MoPConfig)

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=2048,
    vocab_size=163840,
    attention=AttentionConfig(
        num_heads=64, num_kv_heads=8, head_dim=112, rope_theta=5e6),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25),
    mop=MoPConfig(enabled=True, bits=4, group_size=64, num_q_experts=0),
    act="swiglu",
)
