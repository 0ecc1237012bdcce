"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    attn=AttnConfig(num_heads=48, num_kv_heads=8, head_dim=128,
                    rope_theta=10_000.0),
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                  expert_d_ff=32768, capacity_factor=1.25),
    mlp_activation="gelu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
