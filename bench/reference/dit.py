"""The plain reference of the benchmark's DiTs: the forward pass, DDIM with
classifier-free guidance and the flow Euler sampler, in float32 PyTorch
with TF32 off, written from the model's equations. It imports nothing of
the program and takes nothing the program made: it reads the
benchmark's own weights and works out again everything derived from them
(the PI-resized patch embeddings of each mode, merged LoRA weights,
positional embeddings, the noise schedule).

The model (FlexiDiT, arXiv 2502.20126, on DiT, arXiv 2212.09748): a
patch embedding at the mode's patch size (mode 0: the underlying weights
PI-resized, ``W = pinv(B_up) w``; a new mode of the LoRA recipe: its own
embedding), fixed sin-cos positions at the patch centres, for a weak mode
a learned per-mode offset and LayerNorm, then ``L`` blocks of adaLN-Zero
modulated self-attention (+ text cross-attention) and a tanh-GELU MLP,
a modulated final LayerNorm and the de-embedding. The blocks' LoRA of a
weak mode is merged into the dense weights, as the program serves it.

``precision="fp8"`` is the benchmark's control: every linear layer's two
operands rounded to float8 e4m3 with one scale a tensor (its largest
magnitude at 448), the products summed in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

T_EMB_DIM = 256
E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Patches and the PI-resize projections


def _interp_1d(a: int, p: int) -> np.ndarray:
    """[p, a]: half-pixel linear interpolation from a samples to p."""
    m = np.zeros((p, a), np.float64)
    for o in range(p):
        src = min(max((o + 0.5) * a / p - 0.5, 0.0), a - 1.0)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, a - 1)
        w1 = src - i0
        m[o, i0] += 1.0 - w1
        m[o, i1] += w1
    return m


def q_embed(a: Sequence[int], p_prime: Sequence[int]) -> np.ndarray:
    """pinv of the upsampling matrix from patch ``a`` to ``p_prime``:
    [prod(a), prod(p_prime)]."""
    b = np.ones((1, 1))
    for ai, pi in zip(a, p_prime):
        b = np.kron(b, _interp_1d(int(ai), int(pi)))
    return np.linalg.pinv(b)


def patchify(x: torch.Tensor, p: Sequence[int]) -> torch.Tensor:
    """[B, F, H, W, C] -> [B, N, prod(p), C]"""
    B, Fr, H, W, C = x.shape
    pf, ph, pw = p
    x = x.reshape(B, Fr // pf, pf, H // ph, ph, W // pw, pw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, -1, pf * ph * pw, C)


def unpatchify(tok: torch.Tensor, latent: Sequence[int],
               p: Sequence[int]) -> torch.Tensor:
    """[B, N, prod(p), C] -> [B, F, H, W, C]"""
    Fr, H, W, _ = latent
    pf, ph, pw = p
    B, C = tok.shape[0], tok.shape[-1]
    x = tok.reshape(B, Fr // pf, H // ph, W // pw, pf, ph, pw, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, Fr, H, W, C)


def pos_embed(d: int, latent: Sequence[int], p: Sequence[int]) -> np.ndarray:
    """Sin-cos positions at the patch centres of the latent frame [N, d]:
    d split over (f, h, w), f taking the remainder, each axis [sin, cos]."""
    Fr, H, W, _ = latent
    axes = [(np.arange(n // q) + 0.5) * q for n, q in zip((Fr, H, W), p)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    d_axis = d // 3
    outs = []
    for ax in range(3):
        dd = d - 2 * d_axis if ax == 0 else d_axis
        half = dd // 2
        freqs = 1.0 / (10_000.0 ** (np.arange(half) / max(1, half)))
        args = grid[:, ax:ax + 1] * freqs[None]
        emb = np.concatenate([np.sin(args), np.cos(args)], axis=1)
        if emb.shape[1] < dd:
            emb = np.pad(emb, ((0, 0), (0, dd - emb.shape[1])))
        outs.append(emb)
    return np.concatenate(outs, axis=1)


def timestep_embedding(t: torch.Tensor, dim: int = T_EMB_DIM) -> torch.Tensor:
    """[B] -> [B, dim], [cos, sin] over geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (largest |x| at 448)."""
    s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


# ---------------------------------------------------------------------------
# The model


class DiT:
    """A DiT of the configuration's ``model`` section over the given
    weights (any float dtype; kept in float32 here)."""

    def __init__(self, m: Dict, weights: Dict, device: Any,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = m
        self.dit = m["dit"]
        self.device = torch.device(device)
        self.fp8 = precision == "fp8"
        self.d = m["d_model"]
        self.H = m["attn"]["num_heads"]
        self.L = m["num_layers"]
        self.c_in = self.dit["latent_shape"][-1]
        self.latent = tuple(self.dit["latent_shape"])
        self.patches = [tuple(self.dit["patch_size"])] + [
            tuple(p) for p in self.dit["flex_patch_sizes"]]
        f32 = lambda a: a.to(self.device, torch.float32)  # noqa: E731
        self.w = _tree_map(f32, weights)
        self._modes: Dict[int, Dict] = {}

    # -- what a mode derives from the weights ---------------------------

    def _mode(self, mode: int) -> Dict:
        if mode in self._modes:
            return self._modes[mode]
        w, dit = self.w, self.dit
        p = self.patches[mode]
        pp = tuple(dit["underlying_patch_size"])
        if mode > 0 and "embed_new" in w:
            new, de = w["embed_new"][f"m{mode}"], w["deembed_new"][f"m{mode}"]
            emb_w, emb_b = new["w"], new["b"]
            de_w, de_b = de["w"], de["b"]
        else:
            q = torch.as_tensor(q_embed(p, pp), dtype=torch.float32,
                                device=self.device)
            emb_w = torch.einsum("qp,pcd->qcd", q, w["embed"]["w_flex"])
            emb_b = w["embed"]["b"]
            de_w = torch.einsum("dcp,qp->dcq", w["deembed"]["w_flex"], q)
            de_b = torch.einsum("cp,qp->cq", w["deembed"]["b_flex"], q)
        blocks = dict(w["blocks"])
        if mode > 0 and "lora" in blocks:
            # merged LoRA: W + a b (2 / r), at float32
            lora = blocks.pop("lora")
            for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("mlp", ("w_in", "w_out"))):
                g = dict(blocks[grp])
                for n in names:
                    a = lora[grp][n]["a"][:, mode - 1]
                    b = lora[grp][n]["b"][:, mode - 1]
                    g[n] = g[n] + torch.einsum("ldr,lre->lde", a, b) * (
                        2.0 / a.shape[-1])
                blocks[grp] = g
        blocks.pop("lora", None)
        pos = torch.as_tensor(pos_embed(self.d, self.latent, p),
                              dtype=torch.float32, device=self.device)
        out = {"p": p, "emb_w": emb_w, "emb_b": emb_b, "de_w": de_w,
               "de_b": de_b, "blocks": blocks, "pos": pos}
        self._modes[mode] = out
        return out

    # -- pieces ---------------------------------------------------------

    def lin(self, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fp8:
            x, w = fp8(x), fp8(w)
        y = x @ w
        return y if b is None else y + b

    def attend(self, q, k, v, kv_mask=None) -> torch.Tensor:
        """Softmax attention [B, N, H, hd] over all keys (or the keys
        ``kv_mask`` [B, Nk] lets through)."""
        hd = q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask.bool()[:, None, None], -1e30)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)

    def block(self, blk: Dict, i: int, x, c, text, text_mask):
        B, N, d = x.shape
        H = self.H
        ada = self.lin(F.silu(c), blk["ada"]["w"][i], blk["ada"]["b"][i])
        sh1, sc1, g1, sh2, sc2, g2 = ada.chunk(6, dim=-1)
        h = layer_norm(x) * (1 + sc1[:, None]) + sh1[:, None]
        a = blk["attn"]
        q, k, v = (self.lin(h, a[n][i]).reshape(B, N, H, d // H)
                   for n in ("wq", "wk", "wv"))
        o = self.lin(self.attend(q, k, v).reshape(B, N, d), a["wo"][i])
        x = x + g1[:, None] * o
        if text is not None:
            xa = blk["xattn"]
            Tn = text.shape[1]
            h = layer_norm(x)
            q = self.lin(h, xa["wq"][i]).reshape(B, N, H, d // H)
            k = self.lin(text, xa["wk"][i]).reshape(B, Tn, H, d // H)
            v = self.lin(text, xa["wv"][i]).reshape(B, Tn, H, d // H)
            o = self.attend(q, k, v, text_mask).reshape(B, N, d)
            x = x + self.lin(o, xa["wo"][i])
        h = layer_norm(x) * (1 + sc2[:, None]) + sh2[:, None]
        mlp = blk["mlp"]
        h = F.gelu(self.lin(h, mlp["w_in"][i], mlp["b_in"][i]),
                   approximate="tanh")
        return x + g2[:, None] * self.lin(h, mlp["w_out"][i], mlp["b_out"][i])

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                mode: int, text_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x [B, F, H, W, C], t [B] (timestep values), cond: class labels
        [B] or text embeddings [B, T, dc] -> [B, F, H, W, c_out]."""
        w, md = self.w, self._mode(mode)
        patches = patchify(x.float(), md["p"])
        tok = torch.einsum("bnpc,pcd->bnd", *(
            (fp8(patches), fp8(md["emb_w"])) if self.fp8
            else (patches, md["emb_w"]))) + md["emb_b"]
        tok = tok + md["pos"][None]
        if mode > 0:
            tok = tok + w["ps_embed"][mode - 1]
            tok = (layer_norm(tok) * (1 + w["ps_ln"]["scale"][mode - 1])
                   + w["ps_ln"]["bias"][mode - 1])
        te = self.lin(timestep_embedding(t), w["t_embed"]["w1"],
                      w["t_embed"]["b1"])
        c = self.lin(F.silu(te), w["t_embed"]["w2"], w["t_embed"]["b2"])
        text = None
        if self.dit["conditioning"] == "class":
            c = c + w["class_embed"][cond.long()]
        else:
            text = self.lin(cond.float(), w["text_proj"])
        for i in range(self.L):
            tok = self.block(md["blocks"], i, tok, c, text, text_mask)
        ada = self.lin(F.silu(c), w["final"]["ada"]["w"], w["final"]["ada"]["b"])
        sh, sc = ada.chunk(2, dim=-1)
        tok = layer_norm(tok) * (1 + sc[:, None]) + sh[:, None]
        out = torch.einsum("bnd,dcq->bnqc", *(
            (fp8(tok), fp8(md["de_w"])) if self.fp8 else (tok, md["de_w"])))
        out = out + md["de_b"].T[None, None]
        return unpatchify(out, self.latent, md["p"])

    def eps(self, out: torch.Tensor) -> torch.Tensor:
        return out[..., :self.c_in] if self.dit["learn_sigma"] else out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Samplers


def linear_alphas_cumprod(num_steps: int, beta_start: float,
                          beta_end: float) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def respaced(num_steps: int, T: int) -> List[int]:
    """T timesteps spread evenly over [0, num_steps), descending."""
    ts = np.linspace(0, num_steps - 1, T).round().astype(np.int64)
    return [int(t) for t in ts[::-1]]


@torch.no_grad()
def ddim_cfg(model: DiT, x_T: torch.Tensor, labels: torch.Tensor,
             modes: Sequence[int], ts: Sequence[int], scale: float,
             acp: np.ndarray) -> torch.Tensor:
    """Deterministic DDIM (eta 0) under classifier-free guidance: at each
    step the conditional and the null-label prediction at that step's
    patch mode, ``e_u + s (e_c - e_u)``; the last step returns x0."""
    x = x_T.float()
    B = x.shape[0]
    null = torch.full_like(labels, model.dit["num_classes"])
    y2 = torch.cat([labels, null])
    for i, (t, mode) in enumerate(zip(ts, modes)):
        tp = ts[i + 1] if i + 1 < len(ts) else -1
        tt = torch.full((2 * B,), float(t), device=x.device)
        e = model.eps(model.forward(torch.cat([x, x]), tt, y2, mode))
        e_c, e_u = e[:B], e[B:]
        e = e_u + scale * (e_c - e_u)
        a_t = float(acp[t])
        a_p = float(acp[tp]) if tp >= 0 else 1.0
        x0 = (x - math.sqrt(1.0 - a_t) * e) / math.sqrt(a_t)
        x = math.sqrt(a_p) * x0 + math.sqrt(max(1.0 - a_p, 0.0)) * e
    return x


@torch.no_grad()
def flow_euler(model: DiT, x_T: torch.Tensor, text: torch.Tensor,
               phases: Sequence[Tuple[int, int]], T: int,
               text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rectified-flow Euler from tau 1 (noise) to 0 over ``T`` equal
    float32 intervals, each phase's steps at its mode; the model sees
    ``1000 tau``."""
    taus = np.linspace(1.0, 0.0, T + 1).astype(np.float32)
    x = x_T.float()
    i = 0
    for mode, n in phases:
        for j in range(i, i + n):
            a, b = taus[j], taus[j + 1]
            dt = float(np.float32(b - a))
            tau = torch.full((x.shape[0],), float(a), dtype=torch.float32,
                             device=x.device)
            v = model.eps(model.forward(x, tau * 1000.0, text, mode,
                                        text_mask))
            x = x + dt * v
        i += n
    return x
