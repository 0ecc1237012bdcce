"""Cross-step activation cache of the port (``repro.cache``'s counterpart).

Adjacent denoise steps are highly redundant: the deep transformer
blocks' residual contribution is cached at *refresh* steps and replayed
(shallow blocks still recompute) at *skip* steps, on the plain pipeline
and on the packed serving engine. ``policy`` decides when to refresh,
``store`` carries per-request state across packed dispatches, ``apply``
builds the cached sampling loops, and ``ledger`` prices cache-hit steps.
"""
from repro_torch.cache.apply import (make_cached_eps_fn,  # noqa: F401
                                     sample_phased_cached)
from repro_torch.cache.ledger import (cache_savings,  # noqa: F401
                                      cached_nfe_flops, deep_block_flops,
                                      delta_bytes, schedule_cached_flops,
                                      store_bytes)
from repro_torch.cache.policy import (CACHE_POLICIES, CacheSpec,  # noqa: F401
                                      conditioning_drift, ladder_refresh_mask,
                                      refresh_intervals, refresh_mask)
from repro_torch.cache.store import (CacheStore,  # noqa: F401
                                     TransientAllocationError)
