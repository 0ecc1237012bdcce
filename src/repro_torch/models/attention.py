"""Attention backend selection, with the reference's names and rules
(``repro.models.attention``), so a plan means the same in both packages.

``"pallas"`` names the segment-aware flash kernel: in the port that is the
Hopper kernel of ``kernels.attention``. The language-model attention
layers come with their slice.
"""
from __future__ import annotations

ATTN_BACKENDS = ("auto", "pallas", "xla-blocked", "dense")

# Sequence length above which "auto" leaves the dense path.
BLOCKED_ATTN_THRESHOLD = 8192


def resolve_backend(backend: str, *, n_tokens: int, segmented: bool,
                    window_traced: bool = False) -> str:
    """Resolve an ``attn_backend`` name to a concrete implementation.

    ``auto`` picks the flash kernel whenever segment ids are in play or
    the sequence is long, the dense path otherwise; a per-call window
    schedule stays on the blocked path. ``xla`` is the legacy alias for
    the pre-backend auto (never the kernel)."""
    if backend in ("auto", "xla"):
        long = n_tokens > BLOCKED_ATTN_THRESHOLD
        if window_traced or backend == "xla":
            return "xla-blocked" if long else "dense"
        return "pallas" if (segmented or long) else "dense"
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attn_backend {backend!r}; known: "
                         f"{ATTN_BACKENDS}")
    if backend == "pallas" and window_traced:
        raise ValueError("the flash kernel takes a static window; window "
                         "schedules need the blocked backend")
    return backend
