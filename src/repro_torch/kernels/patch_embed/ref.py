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


def patch_deembed_split_k(tokens: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, cluster: int,
                          k_slice: int) -> torch.Tensor:
    """The de-embed in the cluster kernel's order of sums: a float32
    partial product per K slice of ``k_slice``, the ``cluster`` partials
    added in rank order, then the bias, then one rounding."""
    x, wf = tokens.float(), w.float()
    out = torch.zeros((x.shape[0], wf.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r in range(cluster):
        sl = slice(r * k_slice, (r + 1) * k_slice)
        out = out + torch.matmul(x[:, sl], wf[sl])
    return (out + b.float()).to(tokens.dtype)
