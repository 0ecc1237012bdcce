"""Architecture registry of the port: ``get_config(arch_id)`` → ModelConfig
(the DiT archs and every language model of the JAX package's registry:
dense, MoE, hybrid, SSM, vision and audio)."""
from typing import Dict, List

from repro_torch.configs.base import (LM_SHAPES, AttnConfig,  # noqa: F401
                                      DiTConfig, ModelConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, TrainConfig,
                                      cell_is_skipped, get_shape)
from repro_torch.configs.deepseek_7b import CONFIG as _ds7
from repro_torch.configs.deepseek_moe_16b import CONFIG as _dsmoe
from repro_torch.configs.dit_xl_2 import CONFIG as _dit
from repro_torch.configs.gemma2_9b import CONFIG as _g2
from repro_torch.configs.gemma3_4b import CONFIG as _g3
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.hymba_1_5b import CONFIG as _hy
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _lv
from repro_torch.configs.mamba2_130m import CONFIG as _m2
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen
from repro_torch.configs.t2i_transformer import CONFIG as _t2i
from repro_torch.configs.video_dit import CONFIG as _vdit
from repro_torch.configs.whisper_small import CONFIG as _wh

DIT_ARCHS: List[str] = ["dit-xl-2", "t2i-transformer", "video-dit"]
LM_ARCHS: List[str] = ["deepseek-7b", "qwen2.5-14b", "gemma2-9b", "gemma3-4b",
                       "hymba-1.5b", "mamba2-130m", "deepseek-moe-16b",
                       "grok-1-314b", "llama-3.2-vision-90b", "whisper-small"]

# The language models the planner's sweep covers, in the reference's order.
ASSIGNED_ARCHS: List[str] = [
    "grok-1-314b", "deepseek-moe-16b", "deepseek-7b", "gemma3-4b",
    "qwen2.5-14b", "gemma2-9b", "llama-3.2-vision-90b", "whisper-small",
    "hymba-1.5b", "mamba2-130m",
]

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [
    _dit, _t2i, _vdit, _ds7, _qwen, _g2, _g3, _hy, _m2, _dsmoe, _grok, _lv,
    _wh]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
