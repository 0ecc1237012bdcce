"""Plain PyTorch versions of the patch embed / de-embed kernels: float32
products and bias, one rounding to the input's dtype."""
import torch


def patch_embed_ref(patches: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """patches: [N, K]; w: [K, d]; b: [d] → [N, d]."""
    out = torch.matmul(patches.float(), w.float()) + b.float()
    return out.to(patches.dtype)


def patch_deembed_ref(tokens: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """tokens: [N, d]; w: [d, K_out]; b: [K_out] → [N, K_out]."""
    out = torch.matmul(tokens.float(), w.float()) + b.float()
    return out.to(tokens.dtype)
