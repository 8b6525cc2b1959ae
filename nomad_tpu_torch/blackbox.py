"""Blackbox flight recorder: the control-plane journal.

Port of ``nomad_tpu/blackbox.py``, cut to the journal the scheduling
pipeline writes: a bounded ring of control-plane transitions (a
timestamp, a kind, a key and a small detail dict). The eval broker
journals admission sheds, the plan applier duplicate-mint trims, the
heartbeat wheel expiry batches, and the solver pool its member faults. The trigger engine, the incident
ledger and the timeline math stay with the reference's agent.

A stdlib-only leaf: the deque maxlen is the eviction bound, and
evictions are counted, never silent.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

DEFAULT_JOURNAL_CAPACITY = 4096
# the kind-count map is bounded too: a runaway caller minting kinds
# cannot grow it without limit
MAX_KINDS = 64

# Journal kinds the pipeline records under.
KIND_DUP_MINT = "dup_mint"        # plan-apply duplicate-mint trim
KIND_SHED = "shed"                # eval-broker admission shed
KIND_EXPIRY = "heartbeat_expiry"  # heartbeat wheel expiry batch
KIND_POOL_FAULT = "pool_fault"    # solver-pool member failed a dispatch

class FlightRecorder:
    """Bounded journal ring."""

    def __init__(self, capacity: int = DEFAULT_JOURNAL_CAPACITY) -> None:
        self._lock = threading.Lock()
        self.capacity = max(16, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._kind_counts: dict[str, int] = {}
        self.recorded = 0

    def record(self, kind: str, key: str = "", **detail) -> None:
        """Append one journal row: a dict build + deque append under the
        lock; the deque maxlen is the eviction bound."""
        row = {"ts": time.time(), "kind": kind, "key": key}
        if detail:
            row["detail"] = detail
        with self._lock:
            self._seq += 1
            row["seq"] = self._seq
            self.recorded += 1
            if kind in self._kind_counts:
                self._kind_counts[kind] += 1
            elif len(self._kind_counts) < MAX_KINDS:
                self._kind_counts[kind] = 1
            self._ring.append(row)

    def snapshot(
        self, limit: int = 0, kind: Optional[str] = None
    ) -> list[dict]:
        """Journal rows oldest-first, optionally of one kind; ``limit``
        keeps the newest n (0 = all buffered)."""
        with self._lock:
            rows = list(self._ring)
        if kind is not None:
            rows = [r for r in rows if r["kind"] == kind]
        if limit and len(rows) > limit:
            rows = rows[-limit:]
        return rows

    def kind_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._kind_counts)


# -- process-global recorder ----------------------------------------------

_global = FlightRecorder()


def recorder() -> FlightRecorder:
    return _global


def record(kind: str, key: str = "", **detail) -> None:
    """Module-level journal write — what the hook sites call (reads the
    global at call time so _install retargets them all)."""
    _global.record(kind, key, **detail)
