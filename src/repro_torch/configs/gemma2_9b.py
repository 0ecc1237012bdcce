"""gemma2-9b — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local/global alternating attention, logit softcap. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                    rope_theta=10_000.0, sliding_window=4096,
                    local_global_pattern="LG", logit_softcap=50.0),
    mlp_activation="geglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    use_post_norm=True,
    final_logit_softcap=30.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=524288,
)
