"""llama-3.2-vision-90b — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, gated cross-attention image layers every 5 layers (stub vision
frontend: input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    d_ff=28672,
    vocab_size=128256,
    attn=AttnConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    cross_attn_every=5,
    vision_tokens=1600,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
