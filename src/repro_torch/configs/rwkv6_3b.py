"""RWKV6 (Finch) 3B — attention-free, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=2560 d_ff=8960 vocab=65536, head size 64 (40 heads).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk_size=128),
    act="relu_sq",
)
