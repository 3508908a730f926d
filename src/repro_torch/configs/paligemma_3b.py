"""PaliGemma-3B — SigLIP + Gemma backbone. [arXiv:2407.07726; hf]

Text backbone: 18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384
vocab=257216. The SigLIP vision tower is a STUB per spec: input_specs()
provides 256 precomputed patch embeddings prepended to the text sequence.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257216,
    attention=AttentionConfig(num_heads=8, num_kv_heads=1, head_dim=256,
                              rope_theta=1e4),
    frontend="vision",
    frontend_len=256,
    act="gelu",
)
