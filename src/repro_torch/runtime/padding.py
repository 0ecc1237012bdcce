"""Padding helpers — the port of ``repro.runtime.padding``: round a count
up to a bucket boundary, pad a tensor along one axis, and pad a KV cache
so decode steps can write past the prefill length, into new tensors or
into a served batch's cache slot in place."""
from __future__ import annotations

from typing import Any

import torch


def round_up_to_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    return -(-n // multiple) * multiple


def pad_to(x: torch.Tensor, target: int, axis: int, value: float = 0.0
           ) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to length ``target`` (``x`` itself if
    equal)."""
    cur = x.shape[axis]
    if cur > target:
        raise ValueError(f"cannot pad axis {axis} of length {cur} down to "
                         f"{target}")
    if cur == target:
        return x
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


# cache leaf → its sequence axis, counted from the end
_SEQ_AXIS = {"k": -3, "v": -3, "k_scale": -2, "v_scale": -2}


def pad_kv_cache(cache: Any, seq_len: int, extra: int) -> Any:
    """Pad the KV-cache leaves (``k``, ``v`` [..., S, K, hd]; ``k_scale``,
    ``v_scale`` [..., S, K]) from ``seq_len`` by ``extra`` positions along
    the sequence axis so decode steps can write past the prefill length.
    The SSM state (``h``, ``conv``) passes through.

    The vision model's ``[G, k-1, B, S, K, hd]`` leaves pad on the same
    axis; its vision keys and values (``xk``, ``xv``) and whisper's
    encoder states (``enc``) pass through whole.

    Leaves are chosen by name. The reference chooses by shape (any leaf of
    4+ dims whose third-from-last size equals ``seq_len``), which also
    pads an SSM state whose head count equals the prompt length, and the
    vision keys and values when the image has as many tokens as the
    prompt, and breaks decode there (ROADMAP queue 3); on KV leaves the
    two agree."""
    out = {}
    for name, leaf in cache.items():
        axis = _SEQ_AXIS.get(name)
        if axis is not None and leaf.shape[axis] == seq_len:
            leaf = pad_to(leaf, seq_len + extra, axis=leaf.ndim + axis)
        out[name] = leaf
    return out


def write_kv_slot(slot: Any, cache: Any, seq_len: int) -> Any:
    """Write a prefill's ``cache`` into ``slot`` in place and return the
    slot: what :func:`pad_kv_cache` gives, without new tensors. ``slot``
    holds the same leaves (``models.lm.serve_slot``) with KV leaves longer
    along the sequence axis: each KV leaf takes the prefill's ``seq_len``
    positions first and zeros after them; every other leaf (the SSM
    state, the vision keys and values, whisper's encoder states) is
    copied whole."""
    if sorted(slot) != sorted(cache):
        raise ValueError(f"the slot holds {sorted(slot)}, the prefill's "
                         f"cache {sorted(cache)}")
    for name, leaf in cache.items():
        dst = slot[name]
        axis = _SEQ_AXIS.get(name)
        if axis is not None:
            axis += dst.ndim
            dst.narrow(axis, seq_len, dst.shape[axis] - seq_len).zero_()
            dst = dst.narrow(axis, 0, seq_len)
        if dst.shape != leaf.shape:
            raise ValueError(f"{name}: a prefill's {tuple(leaf.shape)} does "
                             f"not fit the slot's {tuple(dst.shape)}")
        dst.copy_(leaf)
    return slot
