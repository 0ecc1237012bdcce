"""Config dataclasses of the PyTorch port.

The same plain frozen dataclasses as ``repro.configs.base``, field for
field, so a config means the same thing in both packages: the DiT
configurations, every language model (dense, MoE, hybrid, SSM, vision,
audio), the planner's input shapes and the training configuration.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    use_rope: bool = True
    logit_softcap: float = 0.0
    qkv_bias: bool = False
    sliding_window: int = 0
    local_global_pattern: str = "G"
    qk_norm: bool = False

    def window_for_layer(self, layer: int) -> int:
        """Static per-layer window (0 = full)."""
        pat = self.local_global_pattern
        kind = pat[layer % len(pat)]
        return self.sliding_window if kind == "L" else 0


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    num_heads: int = 0        # SSD heads; 0 → derived as d_inner // head_dim
    head_dim: int = 64
    expand: int = 2           # d_inner = expand * d_model
    chunk_size: int = 64      # SSD chunk length
    conv_width: int = 4       # depthwise conv width


@dataclass(frozen=True)
class DiTConfig:
    # Latent input: (frames, height, width, channels). frames=1 → image.
    latent_shape: Tuple[int, int, int, int] = (1, 32, 32, 4)
    # Pre-trained ("powerful") patch size (p_f, p_h, p_w).
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    # Additional ("weak") patch sizes the model is flexified to.
    flex_patch_sizes: Tuple[Tuple[int, int, int], ...] = ((1, 4, 4),)
    # Underlying patch size p' the flexible embed weights are stored at.
    underlying_patch_size: Tuple[int, int, int] = (1, 4, 4)
    # Conditioning: 'class' (adaLN label embedding), 'text' (cross-attn), 'none'
    conditioning: str = "class"
    num_classes: int = 1000
    text_len: int = 77
    text_dim: int = 0            # 0 → d_model
    learn_sigma: bool = True     # c_out = 2 * c_in
    # LoRA conversion recipe (Sec 3.2); 0 = shared-params recipe (Sec 3.1).
    lora_rank: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    dit: Optional[DiTConfig] = None
    mlp_activation: str = "swiglu"
    norm_type: str = "rmsnorm"
    tie_embeddings: bool = False
    final_logit_softcap: float = 0.0
    scale_embeddings: bool = False
    use_post_norm: bool = False
    cross_attn_every: int = 0
    vision_tokens: int = 0
    encoder_layers: int = 0
    audio_frames: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"
    unroll: bool = False
    kv_cache_dtype: str = "compute"
    sequence_parallel: bool = False
    max_seq_len: int = 8192

    @property
    def head_dim(self) -> int:
        assert self.attn is not None
        return self.attn.head_dim

    def num_params(self) -> int:
        """Analytic parameter count (approximate; embeddings included), the
        reference's formula term for term."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        total = 0
        if self.family != "dit":
            total += V * d                       # token embedding
            if not self.tie_embeddings:
                total += V * d                   # lm head
        att = 0
        if self.attn is not None:
            a = self.attn
            att = d * a.num_heads * a.head_dim + 2 * d * a.num_kv_heads * a.head_dim \
                + a.num_heads * a.head_dim * d
        mlp_mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        ffn = mlp_mult * d * f if f else 0
        moe = 0
        if self.moe is not None:
            m = self.moe
            e_ff = m.expert_d_ff or f
            moe = m.num_experts * mlp_mult * d * e_ff \
                + m.num_shared_experts * mlp_mult * d * e_ff + d * m.num_experts
            ffn = 0
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = s.num_heads or max(1, d_in // s.head_dim)
            # in-proj (z, x), B/C projections, dt head bias, out-proj (mamba2)
            ssm = d * 2 * d_in + d * 2 * s.state_dim + d * nheads + d_in * d
        per_layer = att + ffn + moe + ssm + 2 * d  # + norms
        total += L * per_layer
        return total

    def active_params(self) -> int:
        """Active parameters per token (for MoE rooflines), the
        reference's formula."""
        if self.moe is None:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        m = self.moe
        mlp_mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        e_ff = m.expert_d_ff or self.d_ff
        dense = self.num_params() - L * m.num_experts * mlp_mult * d * e_ff
        active = L * m.num_experts_per_tok * mlp_mult * d * e_ff
        return dense + active

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        attn = None
        if self.attn is not None:
            a = self.attn
            kv = max(1, min(2, a.num_kv_heads))
            attn = replace(
                a, num_heads=4, num_kv_heads=kv if 4 % kv == 0 else 1,
                head_dim=16,
                sliding_window=min(a.sliding_window, 32) if a.sliding_window else 0)
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=4,
                          num_experts_per_tok=min(2, self.moe.num_experts_per_tok),
                          num_shared_experts=min(1, self.moe.num_shared_experts),
                          expert_d_ff=32 if self.moe.expert_d_ff else 0)
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, state_dim=16, head_dim=16, chunk_size=16)
        dit = None
        if self.dit is not None:
            dit = replace(self.dit, latent_shape=(self.dit.latent_shape[0] if
                          self.dit.latent_shape[0] == 1 else 4, 16, 16, 4),
                          num_classes=10, text_len=8)
        kw: dict = dict(
            num_layers=2, d_model=64, d_ff=128 if self.d_ff else 0,
            vocab_size=256 if self.vocab_size else 0,
            attn=attn, moe=moe, ssm=ssm, dit=dit,
            encoder_layers=2 if self.encoder_layers else 0,
            audio_frames=16 if self.audio_frames else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            param_dtype="float32", compute_dtype="float32",
            max_seq_len=128, remat="none",
        )
        kw.update(overrides)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the planner's cells: the global batch, the
    sequence length and the step it feeds."""
    name: str
    seq_len: int
    global_batch: int
    kind: str    # 'train' | 'prefill' | 'decode'


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# Archs for which long_500k is planned (sub-quadratic or windowed mixing).
LONG_CONTEXT_OK = {"mamba2-130m", "hymba-1.5b", "gemma3-4b", "gemma2-9b"}


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    """A skip reason when the (arch, shape) cell is not planned."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK and not arch.startswith("dit"):
        return "pure full-attention arch: long_500k needs sub-quadratic mixing (DESIGN.md)"
    return None


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"            # cosine | linear | constant
    ema_rate: float = 0.9999
    microbatch: int = 0                 # 0 = no gradient accumulation
    zero_sharded_opt_state: bool = True
    grad_compression: str = "none"      # none | int8_ef
    opt_dtype: str = "float32"          # bf16 moments for 100B+ models
    seed: int = 0
