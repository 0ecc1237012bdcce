"""hymba-1.5b — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + mamba heads in every block, ssm_state=16.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attn=AttnConfig(num_heads=25, num_kv_heads=5, head_dim=64,
                    rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk_size=128),
    mlp_activation="swiglu",
    norm_type="rmsnorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=524288,
)
