"""Token-packing bucket menu, the port of ``repro.serving.batcher``.

The engine composes every step from a FIXED menu of
:class:`~repro_torch.pipeline.packed.PackLayout` buckets so each bucket
is built exactly once (geometric count chains keep the menu small — a
handful of shapes covers any demand). ``choose`` picks, for the current
per-mode demand, the bucket serving the most requests with the fewest
packed tokens; requests that don't fit simply wait one iteration
(iteration-level scheduling), and unused slots are padded with dummy
segments whose outputs are discarded (counted by the packing-efficiency
metric, never returned).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dit as dit_mod
from repro_torch.pipeline.packed import PackLayout


def count_chain(n_max: int) -> Tuple[int, ...]:
    """Geometric bucket sizes (ratio ~1.5) capped at (and including)
    ``n_max`` — demand is rounded up to the next chain value, so at most
    a third of a chosen bucket's slots are ever dummies, while the menu
    stays logarithmic in ``n_max``."""
    if n_max < 1:
        return ()
    out = []
    c = 1
    while c < n_max:
        out.append(c)
        c = max(c + 1, (c * 3) // 2)
    out.append(n_max)
    return tuple(out)


class BucketMenu:
    """All pack layouts the engine may run, derived from the plan menu's
    patch modes and a token budget per engine step."""

    def __init__(self, cfg: ModelConfig, modes: Sequence[int],
                 max_tokens_per_step: int, *, guided: bool = True,
                 row_capacity: int = 0):
        self.cfg = cfg
        self.guided = guided
        self.row_capacity = row_capacity or dit_mod.tokens_for_mode(cfg, 0)
        if max_tokens_per_step < self.row_capacity:
            raise ValueError(
                f"max_tokens_per_step={max_tokens_per_step} below one row "
                f"({self.row_capacity} tokens); nothing can be packed")
        self.max_tokens = max_tokens_per_step
        self.modes = tuple(sorted(set(modes)))
        mult = 2 if guided else 1
        self._seg_tokens = {m: dit_mod.tokens_for_mode(cfg, m)
                            for m in self.modes}
        chains: Dict[int, Tuple[int, ...]] = {}
        for m in self.modes:
            per_req = mult * self._seg_tokens[m]
            chains[m] = count_chain(max_tokens_per_step // per_req)
        self.chains = chains
        budget = max(self.max_tokens, self.row_capacity)
        self.layouts: List[PackLayout] = []
        for combo in itertools.product(
                *[(0,) + chains[m] for m in self.modes]):
            counts = {m: c for m, c in zip(self.modes, combo) if c > 0}
            if not counts:
                continue
            seg_tokens = sum(mult * c * self._seg_tokens[m]
                             for m, c in counts.items())
            if seg_tokens > budget:      # cheap bound before bin packing
                continue
            layout = PackLayout.for_counts(counts, guided=guided,
                                           row_capacity=self.row_capacity)
            if layout.cost(cfg).packed_tokens <= budget:
                self.layouts.append(layout)
        if not self.layouts:
            raise ValueError("empty bucket menu — max_tokens_per_step too "
                             "small for the plan menu's modes")
        # the ledger is pure arithmetic over static layouts: memoize it so
        # per-step bucket selection never recomputes bin packing
        self._ptokens = {l: l.cost(cfg).packed_tokens for l in self.layouts}

    def _packed_tokens(self, layout: PackLayout) -> int:
        """Tokens the hardware computes for one step at ``layout`` —
        row-count (segments never split rows) × capacity (memoized; the
        engine's exact-fit layouts land here on first sight)."""
        pt = self._ptokens.get(layout)
        if pt is None:
            pt = self._ptokens[layout] = layout.cost(self.cfg).packed_tokens
        return pt

    packed_tokens = _packed_tokens

    def greedy_fit(self, req_modes: Sequence[int]
                   ) -> Tuple[List[int], Dict[int, int]]:
        """Pack requests (given in priority order by patch mode) into the
        step's token budget with NO dummy slots: each accepted request
        contributes its CFG segment pair to rows of ``row_capacity``
        tokens, segments of a mode sharing partially-filled rows. Returns
        (accepted indices, per-mode counts) — the exact-fit layout the
        cold planner dispatches."""
        mult = 2 if self.guided else 1
        budget_rows = max(1, self.max_tokens // self.row_capacity)
        rows_used = 0
        free: Dict[int, int] = {}          # mode → open-row slots left
        counts: Dict[int, int] = {}
        accepted: List[int] = []
        for i, m in enumerate(req_modes):
            per_row = max(1, self.row_capacity // self._seg_tokens[m])
            need = mult
            take = min(free.get(m, 0), need)
            new_rows = -(-(need - take) // per_row)
            if rows_used + new_rows > budget_rows:
                continue                   # doesn't fit; try the next one
            free[m] = free.get(m, 0) - take + new_rows * per_row \
                - (need - take)
            rows_used += new_rows
            counts[m] = counts.get(m, 0) + 1
            accepted.append(i)
        return accepted, counts

    @property
    def max_requests(self) -> int:
        """Most requests any single bucket can step at once."""
        return max(l.n_requests for l in self.layouts)

    def choose(self, demand: Dict[int, int],
               among: Optional[Sequence[PackLayout]] = None
               ) -> Optional[PackLayout]:
        """Bucket maximizing requests served for ``demand`` ({mode:
        count}); ties broken by fewest packed tokens, then by the layout
        tuple for determinism. ``among`` restricts the search (the engine
        passes its warm set). None when demand is empty or nothing in
        ``among`` serves it."""
        demand = {m: n for m, n in demand.items() if n > 0}
        if not demand:
            return None
        for m in demand:
            if m not in self.chains:
                raise ValueError(f"mode {m} not in the bucket menu "
                                 f"(modes: {self.modes})")
        best, best_key = None, None
        for layout in (self.layouts if among is None else among):
            served = sum(min(layout.capacity_for(m), n)
                         for m, n in demand.items())
            if served == 0:
                continue
            key = (-served, self._packed_tokens(layout), layout.groups)
            if best_key is None or key < best_key:
                best, best_key = layout, key
        return best

    def served_by(self, layout: PackLayout, demand: Dict[int, int]) -> int:
        return sum(min(layout.capacity_for(m), n)
                   for m, n in demand.items())

    def describe(self) -> str:
        mult = 2 if self.guided else 1
        lines = [f"bucket menu: {len(self.layouts)} layouts, row capacity "
                 f"{self.row_capacity} tok, step budget {self.max_tokens} "
                 f"tok (CFG x{mult})"]
        for m in self.modes:
            lines.append(f"  mode {m}: {self._seg_tokens[m]} tok/segment, "
                         f"counts {self.chains[m]}")
        return "\n".join(lines)
