"""whisper-small — enc-dec, 12L encoder + 12L decoder, d_model=768 12H
d_ff=3072 vocab=51865, conv frontend stubbed (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    audio_frames=1500,
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attn=AttnConfig(num_heads=12, num_kv_heads=12, head_dim=64,
                    use_rope=False),
    mlp_activation="gelu",
    norm_type="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    max_seq_len=32768,
)
