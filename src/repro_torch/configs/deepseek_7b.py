"""deepseek-7b — 30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400,
llama architecture. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    d_ff=11008,
    vocab_size=102400,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=128,
                    rope_theta=10_000.0),
    mlp_activation="swiglu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
