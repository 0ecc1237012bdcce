"""Flexify a pre-trained DiT: §3.1 (shared parameters) and §3.2 (LoRA).

``flexify(params, cfg, new_patch_sizes, lora_rank)`` returns
``(flex_params, flex_cfg)``: embed / de-embed weights are lifted to the
underlying patch size ``p'`` with the PI-resize init (the pre-trained
forward is preserved at the pre-trained patch size), and new parameters
get function-preserving inits (zeros / PI-resize). Randomly initialized
new leaves (LoRA ``a``) are drawn from the given ``torch.Generator``.
Every leaf of ``flex_params`` is its own tensor (the leaves kept from
``params`` are copies): the train steps update a tree in place, so a
leaf shared with the pre-trained tree, or appearing twice, would be
written where the reference's values stay as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import resize
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import dtype_of, init_tree, tree_map

Params = Dict[str, Any]
Patch = Tuple[int, int, int]


def _max_patch(sizes: Sequence[Patch]) -> Patch:
    return tuple(max(p[i] for p in sizes) for i in range(3))  # type: ignore


def flexify(params: Params, cfg: ModelConfig,
            new_patch_sizes: Sequence[Patch],
            lora_rank: int = 0,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[Params, ModelConfig]:
    """Convert a (pre-trained) single-patch-size DiT into a FlexiDiT."""
    assert cfg.dit is not None
    if generator is None:
        generator = torch.Generator(device=params["embed"]["w_flex"].device)
        generator.manual_seed(0)
    p_pre = cfg.dit.patch_size
    old_pp = cfg.dit.underlying_patch_size
    # LoRA recipe: mode 0 must stay bit-exact, so the shared flex storage is
    # untouched; the shared recipe lifts storage to the largest patch size.
    new_pp = (old_pp if lora_rank > 0
              else _max_patch([old_pp, p_pre, *new_patch_sizes]))
    flex_cfg = dataclasses.replace(
        cfg, dit=dataclasses.replace(
            cfg.dit, flex_patch_sizes=tuple(new_patch_sizes),
            underlying_patch_size=new_pp, lora_rank=lora_rank))

    fresh = init_tree(dit_mod.dit_schema(flex_cfg), generator,
                      dtype_of(cfg.param_dtype))

    # Copy every leaf that exists in the old tree (blocks, conditioning, ...).
    def merge(new_tree: Any, old_tree: Any) -> Any:
        if isinstance(new_tree, dict):
            return {k: merge(v, old_tree[k]) if (isinstance(old_tree, dict)
                                                 and k in old_tree) else v
                    for k, v in new_tree.items()}
        return old_tree.clone() if old_tree is not None else new_tree

    flex = merge(fresh, params)

    if old_pp != new_pp:
        # collapse the old flex storage to the pre-trained size, then lift
        w_pre = resize.project_embed(params["embed"]["w_flex"], p_pre, old_pp)
        flex["embed"] = {"w_flex": resize.lift_embed(w_pre, p_pre, new_pp),
                         "b": params["embed"]["b"].clone()}
        wd_pre = resize.project_deembed(params["deembed"]["w_flex"], p_pre, old_pp)
        bd_pre = resize.project_deembed_bias(params["deembed"]["b_flex"], p_pre,
                                             old_pp)
        flex["deembed"] = {
            "w_flex": resize.lift_deembed(wd_pre, p_pre, new_pp),
            "b_flex": resize.lift_deembed_bias(bd_pre, p_pre, new_pp)}
    else:
        flex["embed"] = tree_map(torch.clone, params["embed"])
        flex["deembed"] = tree_map(torch.clone, params["deembed"])

    # LoRA recipe: per-new-mode embed layers, PI-resized from the
    # pre-trained weights: W(p_k) = B_up(p_pre→p_k)·w_pre.
    if lora_rank > 0:
        w_pre = resize.project_embed(params["embed"]["w_flex"], p_pre, old_pp)
        wd_pre = resize.project_deembed(params["deembed"]["w_flex"], p_pre,
                                        old_pp)
        bd_pre = resize.project_deembed_bias(params["deembed"]["b_flex"],
                                             p_pre, old_pp)
        for m, p_new in enumerate(new_patch_sizes, start=1):
            flex["embed_new"][f"m{m}"] = {
                "w": resize.lift_embed(w_pre, p_pre, p_new),
                "b": params["embed"]["b"].clone()}
            flex["deembed_new"][f"m{m}"] = {
                "w": resize.lift_deembed(wd_pre, p_pre, p_new),
                "b": resize.lift_deembed_bias(bd_pre, p_pre, p_new)}
    return flex, flex_cfg


TRAINABLE_LORA_KEYS = ("lora", "ps_embed", "ps_ln", "embed_new", "deembed_new")


def trainable_mask(flex_params: Params, recipe: str) -> Params:
    """Boolean tree: which leaves train under 'shared' (§3.1, everything)
    vs 'lora' (§3.2, only adapters + new layers; base frozen)."""
    if recipe == "shared":
        return tree_map(lambda _: True, flex_params)

    def mark(tree: Any, on: bool) -> Any:
        if isinstance(tree, dict):
            return {k: mark(v, on or k in TRAINABLE_LORA_KEYS)
                    for k, v in tree.items()}
        return on

    return mark(flex_params, False)


def merge_lora(flex_params: Params, cfg: ModelConfig, mode: int,
               lora_scale: float = 2.0) -> Params:
    """Merge mode-``mode`` LoRAs into dense weights (paper Fig. 5: inference
    without LoRAs — no FLOPs overhead, extra memory for the copy)."""
    assert mode > 0
    blocks = flex_params["blocks"]
    merged_blocks = {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in blocks.items()}

    def merge_one(w: torch.Tensor, pair: Params) -> torch.Tensor:
        # stacked over layers: w [L,din,dout]; a [L,n_new,din,r]; b [L,n_new,r,dout]
        a = pair["a"][:, mode - 1].float()
        b = pair["b"][:, mode - 1].float()
        r = a.shape[-1]
        delta = torch.einsum("ldr,lre->lde", a, b) * (lora_scale / r)
        return (w.float() + delta).to(w.dtype)

    lora = blocks.get("lora")
    if lora is not None:
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_in", "w_out"))):
            for n in names:
                if n in lora.get(grp, {}):
                    merged_blocks[grp][n] = merge_one(blocks[grp][n],
                                                      lora[grp][n])
        merged_blocks = {k: v for k, v in merged_blocks.items() if k != "lora"}
    out = dict(flex_params)
    out["blocks"] = merged_blocks
    return out
