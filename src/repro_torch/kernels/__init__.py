"""The port's hand-written Hopper kernels and their wrappers."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record through a kernel launch: the
    kernels have no backward, and their outputs no ``grad_fn``, so the
    gradient would stop there without a word (the JAX package's
    ``jax.grad`` of a ``pallas_call`` raises too). Run the launch under
    ``torch.no_grad()`` / ``torch.inference_mode()``, or train on a plain
    backend."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad() or train on a "
            f"differentiable backend (attention: 'dense' or 'xla')")
