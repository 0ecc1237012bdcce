"""deepseek-moe-16b — 28L d_model=2048 16H (MHA kv=16) expert d_ff=1408
vocab=102400, 2 shared + 64 routed top-6 fine-grained experts.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    d_ff=1408,
    vocab_size=102400,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                    rope_theta=10_000.0),
    moe=MoEConfig(num_experts=64, num_experts_per_tok=6,
                  num_shared_experts=2, expert_d_ff=1408,
                  capacity_factor=1.25),
    mlp_activation="swiglu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
