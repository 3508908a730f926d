"""SeamlessM4T-medium — enc-dec multimodal. [arXiv:2308.11596; hf]

12L (encoder) + 12L (decoder) d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206. The speech frontend (w2v-BERT conformer) is a STUB per spec:
input_specs() provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    num_encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                              rope_theta=1e4),
    frontend="audio",
    frontend_len=1024,
    act="gelu",
)
