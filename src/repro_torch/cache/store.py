"""Per-request activation-cache slots for the serving engine, the port of
``repro.cache.store``.

The :class:`CacheStore` holds every in-flight request's deep-block
residual delta, one pool tensor per patch mode on the engine's device,
addressed by *slot*. The packed step gathers the dispatched cohort's slots
into the layout's group order and scatters the updated deltas back, so
cache state survives bucket migrations (slots are keyed by mode, never by
layout).

Slot management is host-side and O(1): a free list per mode, LRU eviction
when a mode's pool is exhausted (the evicted request loses its cache and
refreshes; correctness never depends on a slot surviving), and an owner
tag so the engine can detect eviction.
"""
from __future__ import annotations

import itertools
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache import ledger
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import dtype_of


class TransientAllocationError(RuntimeError):
    """A slot allocation failed transiently; retry on a later dispatch.

    The engine treats the request as slotless for the current dispatch
    (deep blocks recomputed exactly, no cache writes) and re-allocates
    next time."""


def _crc(t: torch.Tensor) -> int:
    """CRC32 of a tensor's bytes (bf16 read through int16: numpy has no
    bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return zlib.crc32(t.contiguous().cpu().numpy().tobytes())


class CacheStore:
    """Slotted deep-block residual deltas, one pool per patch mode.

    Each mode's pool is a ``[n_slots, mult, N_mode, d]`` tensor (``mult``
    = 2 under CFG: conditional and unconditional branches share the
    request's staleness clock but carry distinct features), allocated up
    front on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, cfg: ModelConfig, modes: Sequence[int],
                 n_slots: int, *, guided: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 integrity: bool = False, device: Any = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.guided = guided
        self.n_slots = n_slots
        self.mult = 2 if guided else 1
        self.dtype = dtype or dtype_of(cfg.compute_dtype)
        self.device = resolve_device(device)
        self.modes = tuple(sorted(set(modes)))
        #: when True every scatter records a CRC32 per slot and
        #: :meth:`verify_slot` can detect out-of-band corruption. Costs a
        #: host read of each scattered row (a device sync), so it is opt-in.
        self.integrity = integrity
        self._deltas: Dict[int, torch.Tensor] = {}
        self._free: Dict[int, List[int]] = {}
        self._owner: Dict[int, Dict[int, int]] = {}    # mode → slot → owner
        self._stamp: Dict[int, Dict[int, int]] = {}    # mode → slot → LRU tick
        self._crc: Dict[int, Dict[int, int]] = {}      # mode → slot → crc32
        self._tick = itertools.count()
        self.evictions = 0
        self.corruptions = 0
        self.integrity_failures = 0
        self._fail_allocs = 0
        for m in self.modes:
            n_tok = dit_mod.tokens_for_mode(cfg, m)
            self._deltas[m] = torch.zeros(
                (n_slots, self.mult, n_tok, cfg.d_model), dtype=self.dtype,
                device=self.device)
            self._free[m] = list(range(n_slots - 1, -1, -1))
            self._owner[m] = {}
            self._stamp[m] = {}
            self._crc[m] = {}

    # ------------------------------------------------------------------
    # Slot lifecycle

    def alloc(self, mode: int, owner: int) -> int:
        """Claim a slot in ``mode``'s pool for ``owner`` (a request id).
        When the pool is exhausted the least-recently-touched active slot
        is evicted: its previous owner stops matching ``owner_of`` and
        must refresh on its next dispatch."""
        if self._fail_allocs > 0:
            self._fail_allocs -= 1
            raise TransientAllocationError(
                f"injected transient allocation failure (mode={mode}, "
                f"owner={owner})")
        if self._free[mode]:
            slot = self._free[mode].pop()
        else:
            slot = min(self._stamp[mode], key=self._stamp[mode].get)
            self.evictions += 1
        self._owner[mode][slot] = owner
        self._stamp[mode][slot] = next(self._tick)
        return slot

    def release(self, mode: int, slot: int) -> None:
        if slot in self._owner[mode]:
            del self._owner[mode][slot]
            del self._stamp[mode][slot]
            self._crc[mode].pop(slot, None)
            self._free[mode].append(slot)

    def owner_of(self, mode: int, slot: int) -> Optional[int]:
        return self._owner[mode].get(slot)

    def touch(self, mode: int, slot: int) -> None:
        if slot in self._stamp[mode]:
            self._stamp[mode][slot] = next(self._tick)

    # ------------------------------------------------------------------
    # Device state

    def _index(self, slots: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)

    def gather(self, mode: int, slots: Sequence[int]) -> torch.Tensor:
        """[len(slots), mult, N_mode, d] deltas for a dispatch, in the
        layout's request order (one device gather)."""
        return self._deltas[mode][self._index(slots)]

    def scatter(self, mode: int, slots: Sequence[int],
                values: torch.Tensor) -> None:
        """Write a dispatch's updated deltas back (one scatter)."""
        values = values.to(self.dtype)
        self._deltas[mode].index_copy_(0, self._index(slots), values)
        for s in slots:
            self.touch(mode, int(s))
        if self.integrity:
            for i, s in enumerate(slots):
                self._crc[mode][int(s)] = _crc(values[i])

    # ------------------------------------------------------------------
    # Integrity

    def verify_slot(self, mode: int, slot: int) -> bool:
        """True when the slot's resident bytes still match the checksum
        recorded at its last scatter (or no checksum exists yet: a fresh
        slot refreshes anyway). Requires ``integrity=True``."""
        want = self._crc[mode].get(int(slot))
        if want is None:
            return True
        if _crc(self._deltas[mode][int(slot)]) != want:
            self.integrity_failures += 1
            return False
        return True

    def corrupt_slot(self, mode: int, slot: int) -> None:
        """Overwrite a resident slot's delta with *finite* garbage, which
        only a checksum mismatch can tell (fault-injection seam)."""
        row = self._deltas[mode][int(slot)]
        self._deltas[mode][int(slot)] = row * -1.0 + 0.37
        self.corruptions += 1

    def fail_allocs(self, count: int) -> None:
        """Make the next ``count`` :meth:`alloc` calls raise
        :class:`TransientAllocationError` (fault-injection seam)."""
        self._fail_allocs += int(count)

    def active_slots(self) -> List[Tuple[int, int]]:
        """Every owned ``(mode, slot)`` pair, deterministic order."""
        return [(m, s) for m in self.modes for s in sorted(self._owner[m])]

    # ------------------------------------------------------------------
    # Accounting

    @property
    def n_active(self) -> int:
        return sum(len(o) for o in self._owner.values())

    def active_by_mode(self) -> Dict[int, int]:
        return {m: len(self._owner[m]) for m in self.modes}

    @property
    def bytes_resident(self) -> int:
        """Bytes of delta state belonging to live requests."""
        return ledger.store_bytes(self.cfg, self.active_by_mode(),
                                  self.guided)

    @property
    def bytes_total(self) -> int:
        """Bytes the pools occupy on the device (allocated up front)."""
        return ledger.store_bytes(self.cfg,
                                  {m: self.n_slots for m in self.modes},
                                  self.guided)
