"""Minitron-4B — pruned Nemotron. [arXiv:2407.14679; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    d_ff=9216,
    vocab_size=256000,
    attention=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128,
                              rope_theta=1e4),
    act="swiglu",
)
