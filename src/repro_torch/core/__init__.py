"""FlexiDiT core of the port — the paper's contribution as plain functions
on tensors."""
from repro_torch.core.flexify import flexify, merge_lora, trainable_mask  # noqa: F401
from repro_torch.core.guidance import GuidanceConfig, make_eps_fn  # noqa: F401
from repro_torch.core.scheduler import (FlexiSchedule, dit_nfe_flops,  # noqa: F401
                                        relative_compute, schedule_flops)
