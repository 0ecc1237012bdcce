"""video-dit — the paper's 4.9B text-to-video DiT (§4.3, MovieGen-style):
32×88×48 latent space, pre-trained patch (1,2,2) → 33792 tokens, flexified
to 'temporal' (2,2,2) and 'spatial' (1,4,4) weak modes; LoRA rank 64."""
from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig

CONFIG = ModelConfig(
    name="video-dit",
    family="dit",
    num_layers=32,
    d_model=3072,
    d_ff=12288,
    vocab_size=0,
    attn=AttnConfig(num_heads=24, num_kv_heads=24, head_dim=128,
                    use_rope=False, qk_norm=True),
    dit=DiTConfig(latent_shape=(32, 88, 48, 8), patch_size=(1, 2, 2),
                  flex_patch_sizes=((2, 2, 2), (1, 4, 4)),
                  underlying_patch_size=(2, 4, 4),
                  conditioning="text", text_len=256, text_dim=3072,
                  learn_sigma=False, lora_rank=64),
    mlp_activation="gelu",
    norm_type="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=65536,
)
