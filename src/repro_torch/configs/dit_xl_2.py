"""dit-xl-2 — the paper's class-conditioned ImageNet model (DiT-XL/2,
Peebles & Xie 2023): 28L d=1152 16H d_ff=4608, 256×256 images → 32×32×4
latents, patch size 2, flexified to patch size 4 (§4.1, shared-params
recipe)."""
from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig

CONFIG = ModelConfig(
    name="dit-xl-2",
    family="dit",
    num_layers=28,
    d_model=1152,
    d_ff=4608,
    vocab_size=0,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=72,
                    use_rope=False),
    dit=DiTConfig(latent_shape=(1, 32, 32, 4), patch_size=(1, 2, 2),
                  flex_patch_sizes=((1, 4, 4),),
                  underlying_patch_size=(1, 4, 4),
                  conditioning="class", num_classes=1000,
                  learn_sigma=True, lora_rank=0),
    mlp_activation="gelu",
    norm_type="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=1024,
)
