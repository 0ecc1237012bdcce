"""The benchmark's weight maker: a DiT's parameters in the port's layout
(nested dicts, per-layer leaves stacked ``[L, ...]``, matrices ``[in,
out]``), drawn on the device from the seed in one call and scaled leaf by
leaf in place.

Every leaf is non-zero, the port's zero-initialised gates too (adaLN, the
de-embeddings, the cross-attention output, LoRA ``b``, the per-mode
embedding and norm), so a sample depends on every block and every
adapter. Scales: a matrix ``1 / sqrt(fan_in)`` of its own layer, a bias
0.02, the class table 0.5, the per-mode embedding and norm 0.1.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from benchlib import ledger

T_EMB_DIM = 256
BIAS_STD = 0.02
ALIGN = 64              # elements: 128 bytes at 16 bits


def _leaf(shape, std: float) -> Tuple[Tuple[int, ...], float]:
    return tuple(int(s) for s in shape), float(std)


def _mat(shape, fan_in: int) -> Tuple[Tuple[int, ...], float]:
    return _leaf(shape, 1.0 / math.sqrt(fan_in))


def layout(m: Dict) -> Dict[str, Any]:
    """The parameter tree as (shape, std) leaves."""
    d, f, L = m["d_model"], m["d_ff"], m["num_layers"]
    dit = m["dit"]
    c_in = dit["latent_shape"][-1]
    co = ledger.c_out(m)
    npp = math.prod(dit["underlying_patch_size"])
    flex = [tuple(p) for p in dit["flex_patch_sizes"]]
    n_new = len(flex)
    r = dit["lora_rank"]
    dc = dit["text_dim"] or d

    def stacked(shape, std):
        return _leaf((L,) + tuple(shape), std)

    block: Dict[str, Any] = {
        "ada": {"w": stacked((d, 6 * d), 1 / math.sqrt(d)),
                "b": stacked((6 * d,), BIAS_STD)},
        "attn": {k: stacked((d, d), 1 / math.sqrt(d))
                 for k in ("wq", "wk", "wv", "wo")},
        "mlp": {"w_in": stacked((d, f), 1 / math.sqrt(d)),
                "b_in": stacked((f,), BIAS_STD),
                "w_out": stacked((f, d), 1 / math.sqrt(f)),
                "b_out": stacked((d,), BIAS_STD)},
    }
    if dit["conditioning"] == "text":
        block["xattn"] = {"wq": stacked((d, d), 1 / math.sqrt(d)),
                          "wk": stacked((dc, d), 1 / math.sqrt(dc)),
                          "wv": stacked((dc, d), 1 / math.sqrt(dc)),
                          "wo": stacked((d, d), 1 / math.sqrt(d))}
    if r > 0 and n_new > 0:
        def pair(d_in, d_out):
            return {"a": stacked((n_new, d_in, r), 1 / math.sqrt(d_in)),
                    "b": stacked((n_new, r, d_out), 1 / math.sqrt(r))}
        block["lora"] = {
            "attn": {k: pair(d, d) for k in ("wq", "wk", "wv", "wo")},
            "mlp": {"w_in": pair(d, f), "w_out": pair(f, d)}}

    tree: Dict[str, Any] = {
        "embed": {"w_flex": _mat((npp, c_in, d), npp * c_in),
                  "b": _leaf((d,), BIAS_STD)},
        "deembed": {"w_flex": _mat((d, co, npp), d),
                    "b_flex": _leaf((co, npp), BIAS_STD)},
        "t_embed": {"w1": _mat((T_EMB_DIM, d), T_EMB_DIM),
                    "b1": _leaf((d,), BIAS_STD),
                    "w2": _mat((d, d), d),
                    "b2": _leaf((d,), BIAS_STD)},
        "final": {"ada": {"w": _mat((d, 2 * d), d),
                          "b": _leaf((2 * d,), BIAS_STD)}},
        "blocks": block,
    }
    if n_new > 0:
        tree["ps_embed"] = _leaf((n_new, d), 0.1)
        tree["ps_ln"] = {"scale": _leaf((n_new, d), 0.1),
                         "bias": _leaf((n_new, d), 0.1)}
    if r > 0 and n_new > 0:
        tree["embed_new"], tree["deembed_new"] = {}, {}
        for i, p in enumerate(flex, start=1):
            npix = math.prod(p)
            tree["embed_new"][f"m{i}"] = {
                "w": _mat((npix, c_in, d), npix * c_in),
                "b": _leaf((d,), BIAS_STD)}
            tree["deembed_new"][f"m{i}"] = {
                "w": _mat((d, co, npix), d),
                "b": _leaf((co, npix), BIAS_STD)}
    if dit["conditioning"] == "class":
        tree["class_embed"] = _leaf((dit["num_classes"] + 1, d), 0.5)
    else:
        tree["text_proj"] = _mat((dc, dc), dc)
    return tree


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def num_params(m: Dict) -> int:
    return sum(math.prod(shape) for _p, (shape, _s) in _leaves(layout(m)))


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0]) & (2 ** 63 - 1)


def make(m: Dict, seed: int, device: Any, dtype: torch.dtype) -> Dict:
    """The parameter tree, drawn in one call on ``device`` from ``seed``:
    every leaf a view of one buffer, scaled in place."""
    leaves = _leaves(layout(m))
    starts, total = [], 0
    for _p, (shape, _s) in leaves:
        starts.append(total)
        # each leaf starts on a 128-byte boundary, as an allocation would
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict[str, Any] = {}
    for (path, (shape, std)), off in zip(leaves, starts):
        leaf = flat[off:off + math.prod(shape)].view(shape).mul_(std)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
