"""mamba2-130m — 24L d_model=768 attention-free SSD (state-space duality),
ssm_state=128 vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    attn=None,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    norm_type="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=524288,
)
