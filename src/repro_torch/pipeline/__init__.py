"""FlexiDiT inference API of the port: ``SamplingPlan`` declares what to
run, ``FlexiPipeline`` owns the weights on a device and runs plans."""
from repro_torch.pipeline.pipeline import FlexiPipeline, SampleResult  # noqa: F401
from repro_torch.pipeline.plan import (AdaptiveBudget, SamplingPlan,  # noqa: F401
                                       solve_t_weak)
