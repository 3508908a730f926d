"""Granite-3.0-2B — dense GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    d_ff=8192,
    vocab_size=49155,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=64,
                              rope_theta=1e4),
    act="swiglu",
)
