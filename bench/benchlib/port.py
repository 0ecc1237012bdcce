"""The harness's side of the port's public objects: the port's
``ModelConfig`` built from a configuration file, its noise schedule, and
the helpers every driver shares (the program's build counters, freeing
its state). Imported only where a run drives the program."""
from __future__ import annotations

import gc
from typing import Any, Dict

import torch

from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig
from repro_torch.diffusion.schedule import linear_schedule


def model_config(m: Dict[str, Any]) -> ModelConfig:
    """The configuration file's ``model`` section as the port's config."""
    kw = dict(m)
    kw["attn"] = AttnConfig(**m["attn"])
    dit = dict(m["dit"])
    for key in ("latent_shape", "patch_size", "underlying_patch_size"):
        dit[key] = tuple(dit[key])
    dit["flex_patch_sizes"] = tuple(tuple(p) for p in dit["flex_patch_sizes"])
    kw["dit"] = DiTConfig(**dit)
    return ModelConfig(**kw)


def schedule(diffusion: Dict[str, Any]):
    if diffusion["betas"] != "linear":
        raise ValueError(f"unknown noise schedule {diffusion['betas']!r}")
    return linear_schedule(diffusion["num_steps"], diffusion["beta_start"],
                           diffusion["beta_end"])


def built(pipe: Any) -> int:
    """Runners built plus CUDA graphs captured so far."""
    s = pipe.cache_stats()
    return int(s["compiled"]) + int(s.get("captured", 0))


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
