"""Architecture registry of the port: ``get_config(arch_id)`` → ModelConfig
(the DiT archs and mamba2-130m; the other language-model archs come with
their slice)."""
from typing import Dict, List

from repro_torch.configs.base import (AttnConfig, DiTConfig, ModelConfig,  # noqa: F401
                                      SSMConfig, TrainConfig)
from repro_torch.configs.dit_xl_2 import CONFIG as _dit
from repro_torch.configs.mamba2_130m import CONFIG as _m2
from repro_torch.configs.t2i_transformer import CONFIG as _t2i
from repro_torch.configs.video_dit import CONFIG as _vdit

DIT_ARCHS: List[str] = ["dit-xl-2", "t2i-transformer", "video-dit"]

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [_dit, _t2i, _vdit, _m2]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
