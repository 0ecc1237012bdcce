"""gemma3-4b — 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262144,
    attn=AttnConfig(num_heads=8, num_kv_heads=4, head_dim=256,
                    rope_theta=1_000_000.0, sliding_window=1024,
                    local_global_pattern="LLLLLG", qk_norm=True),
    mlp_activation="geglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    use_post_norm=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=524288,
)
