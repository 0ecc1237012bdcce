"""qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064,
QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab_size=152064,
    attn=AttnConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0, qkv_bias=True),
    mlp_activation="swiglu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
