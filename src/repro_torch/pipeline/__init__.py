"""FlexiDiT inference API of the port: ``SamplingPlan`` declares what to
run (optionally sequence-parallel, with a ``ParallelSpec``),
``FlexiPipeline`` owns the weights on a device (and a mesh) and runs
plans, and ``PackLayout`` is the static shape of one packed serving step."""
from repro_torch.distributed.partition import ParallelSpec  # noqa: F401
from repro_torch.pipeline.packed import PackLayout  # noqa: F401
from repro_torch.pipeline.pipeline import FlexiPipeline, SampleResult  # noqa: F401
from repro_torch.pipeline.plan import (AdaptiveBudget, SamplingPlan,  # noqa: F401
                                       solve_t_weak)
