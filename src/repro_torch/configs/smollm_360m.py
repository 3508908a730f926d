"""SmolLM-360M — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49152,
    attention=AttentionConfig(num_heads=15, num_kv_heads=5, head_dim=64,
                              rope_theta=1e4),
    act="swiglu",
)
