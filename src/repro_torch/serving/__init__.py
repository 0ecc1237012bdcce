"""Continuous-batching DiT serving engine of the port (``repro.serving``'s
counterpart).

Iteration-level scheduling over a FlexiPipeline: requests at different
denoise steps and compute budgets are packed token-wise into build-once
bucket layouts every engine step, with SLA-aware admission (FIFO /
earliest-deadline-first) and load-adaptive budget degradation.
"""
from repro_torch.cache.policy import CacheSpec  # noqa: F401
from repro_torch.cache.store import CacheStore  # noqa: F401
from repro_torch.serving.batcher import BucketMenu, count_chain  # noqa: F401
from repro_torch.serving.controller import (BudgetController,  # noqa: F401
                                            request_cost_flops)
from repro_torch.serving.metrics import (RequestRecord,  # noqa: F401
                                         ServingMetrics, StepRecord)
from repro_torch.serving.queue import Request, RequestQueue  # noqa: F401
from repro_torch.serving.scheduler import (ENGINE_POLICIES,  # noqa: F401
                                           InFlight, LevelPlan,
                                           ServedResult, ServingEngine)
