"""Write-ahead request journal for exactly-once replay (host-pure), the
port's copy of ``repro.resilience.journal``: the same records, written as
the same bytes, so a journal crosses packages both ways.

The fleet writes an ``admit`` record *before* the request enters the
router ledger, a ``dispatch`` record at every placement, and a terminal
``finish`` / ``expire`` record when the request leaves the system.  After
a router crash, :meth:`RequestJournal.unfinished` is exactly the set of
requests that were admitted but never reached a terminal state — each
appears once, in admission order, carrying everything needed to
re-derive its sampling seed (``request_seed(base_seed, rid)``), so a
fresh fleet can replay them exactly-once with re-admission error bounded
by the packing tolerance (≤1e-4, the bar of a mid-drain kill).

Records are plain dicts; with a ``path`` the journal also appends one
JSON line per record and flushes before returning (write-ahead on the
process level: a record is durable before the action it describes).
Host-pure — no torch, no numpy (``tests/test_torch_resilience.py``
checks the imports).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

RECORD_KINDS = ("admit", "dispatch", "finish", "expire", "escalate")


class RequestJournal:
    """In-memory request journal with an optional JSONL write-ahead log."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else None
        self._records: List[Dict] = []
        self._file = open(self.path, "a") if self.path is not None else None

    # ----------------------------------------------------------- recording
    def _append(self, rec: Dict) -> Dict:
        self._records.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec, sort_keys=True) + "\n")
            self._file.flush()
        return rec

    def admit(self, rid: int, *, cond: int, budget: float, deadline: float,
              time: float) -> Dict:
        """Record admission. MUST be written before the router ledger."""
        return self._append({"kind": "admit", "rid": int(rid),
                             "cond": int(cond), "budget": float(budget),
                             "deadline": float(deadline),
                             "time": float(time)})

    def dispatch(self, rid: int, *, replica: int, time: float) -> Dict:
        return self._append({"kind": "dispatch", "rid": int(rid),
                             "replica": int(replica), "time": float(time)})

    def finish(self, rid: int, *, replica: int, time: float) -> Dict:
        return self._append({"kind": "finish", "rid": int(rid),
                             "replica": int(replica), "time": float(time)})

    def expire(self, rid: int, *, time: float) -> Dict:
        return self._append({"kind": "expire", "rid": int(rid),
                             "time": float(time)})

    def escalate(self, rid: int, *, time: float, retries: int) -> Dict:
        return self._append({"kind": "escalate", "rid": int(rid),
                             "retries": int(retries), "time": float(time)})

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # -------------------------------------------------------------- replay
    @property
    def records(self) -> List[Dict]:
        return list(self._records)

    def unfinished(self) -> List[Dict]:
        """Admit records with no terminal record, in admission order.

        Each admitted rid appears at most once (exactly-once replay): a
        duplicate admit line for a rid already journaled is ignored.
        """
        done = {r["rid"] for r in self._records
                if r["kind"] in ("finish", "expire")}
        out, seen = [], set()
        for r in self._records:
            if r["kind"] == "admit" and r["rid"] not in done \
                    and r["rid"] not in seen:
                seen.add(r["rid"])
                out.append(dict(r))
        return out

    def summary(self) -> Dict[str, int]:
        kinds: Dict[str, int] = {}
        for r in self._records:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        kinds["unfinished"] = len(self.unfinished())
        return kinds

    # -------------------------------------------------------------- loading
    @classmethod
    def load(cls, path: str) -> "RequestJournal":
        """Read a JSONL journal back for replay (read-only: the returned
        journal does not append to the file)."""
        j = cls(None)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    j._records.append(json.loads(line))
        j.path = str(path)
        return j
