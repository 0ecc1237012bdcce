"""t2i-transformer — the paper's text-to-image DiT (Emu-like config used in
Fig. 9: 24L d=2048; cross-attention text conditioning; 128×128 latent space,
patch 2 → 4096 tokens; LoRA recipe §3.2 with rank 64)."""
from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig

CONFIG = ModelConfig(
    name="t2i-transformer",
    family="dit",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=0,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                    use_rope=False, qk_norm=True),
    dit=DiTConfig(latent_shape=(1, 128, 128, 8), patch_size=(1, 2, 2),
                  flex_patch_sizes=((1, 4, 4),),
                  underlying_patch_size=(1, 4, 4),
                  conditioning="text", text_len=77, text_dim=2048,
                  learn_sigma=False, lora_rank=64),
    mlp_activation="gelu",
    norm_type="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=16384,
)
