"""Event-driven alloc-watch fan-out: per-node wakeups, not a herd.

Reference: nomad's client alloc watch (``client/client.go:2003
watchAllocations``) is a blocking query; the server side wakes it
through memdb watch channels scoped to what actually changed. Our
seed-era port (``StateStore.wait_for_index``) wakes EVERY blocked
watcher on EVERY alloc-table write (``Condition.notify_all``), and each
woken watcher re-scans its node's alloc set — O(watchers) wakeups and
O(watchers × allocs) scan work per write. Ten clients never noticed;
10k make every plan apply a stampede.

:class:`AllocWatchHub` restores the reference's scoping with three
pieces, each bounded:

  * a **store subscriber** that runs under the store lock and does the
    minimum legal there: append the changed block's (index, node-ids)
    to a bounded inbox and set an event (no locks of ours, no store
    re-entry — the lock-order edge is store→inbox only);
  * a **fan-out thread** ("alloc-watch-fanout") that drains the inbox
    and advances a per-node change index, waking only the waiters of
    nodes that actually changed;
  * **per-node waiter lists** bounded at ``max_waiters_per_node`` —
    registering past the bound evicts the oldest waiter (it wakes and
    serves current state; ``nomad.fleet.watch_evicted`` counts) so a
    slow or leaky consumer can't grow an unbounded queue.

If the inbox itself overflows (replay floods, pathological write
storms), the hub degrades honestly: it remembers only the highest
flooded index, bumps EVERY tracked node to it, and counts
``nomad.fleet.fanout_overflow`` — a lost fine-grained route never loses
a wakeup, and a node the hub has never seen still converges through the
watcher's timeout-and-fetch fallback.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from .. import metrics

DEFAULT_INBOX_CAP = 4096
DEFAULT_MAX_WAITERS_PER_NODE = 4


class AllocWatchHub:
    def __init__(
        self,
        state,
        inbox_cap: int = DEFAULT_INBOX_CAP,
        max_waiters_per_node: int = DEFAULT_MAX_WAITERS_PER_NODE,
    ) -> None:
        from ..state.store import TABLE_ALLOCS

        self._alloc_table = TABLE_ALLOCS
        self._inbox_cap = inbox_cap
        self._max_waiters = max_waiters_per_node
        # inbox: filled under the STORE lock — keep the critical
        # section to an append + event set
        self._inbox_lock = threading.Lock()
        self._inbox: deque = deque()
        self._overflow_index = 0
        self._wake = threading.Event()
        # hub state: per-node change index + waiters. Store reads are
        # NEVER made under this lock (no hub→store lock-order edge).
        self._lock = threading.Lock()
        self._node_index: dict[str, int] = {}
        self._waiters: dict[str, list] = {}  # node_id -> [(min_index, Event)]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fanout_loop, name="alloc-watch-fanout", daemon=True
        )
        self._thread.start()
        state.subscribe(self._on_store_write)
        subscribe_restore = getattr(state, "subscribe_restore", None)
        if subscribe_restore is not None:
            subscribe_restore(self.prime)

    # -- store side (called under the store lock) ----------------------

    def _on_store_write(self, index: int, table: str, objs: list, etype: str) -> None:
        if table != self._alloc_table or not objs:
            return
        node_ids = {getattr(o, "node_id", "") for o in objs}
        node_ids.discard("")
        if not node_ids:
            return
        with self._inbox_lock:
            if len(self._inbox) >= self._inbox_cap:
                if index > self._overflow_index:
                    self._overflow_index = index
            else:
                self._inbox.append((index, node_ids))
        self._wake.set()

    def prime(self, index: int, node_ids: set) -> None:
        """Snapshot restore: the store was REPLACED, not written — no
        per-write routes fired, so re-seed every alloc-owning node at
        the restored index. Overwrites (never maxes) because an
        operator restore may rebase indexes DOWNWARD; and wakes every
        parked waiter so in-flight blocking queries resync their cursor
        against the new world instead of sleeping a full timeout."""
        with self._lock:
            self._node_index = {nid: index for nid in node_ids}
            waiters, self._waiters = self._waiters, {}
        for entries in waiters.values():
            for _min_index, ev in entries:
                ev.set()

    # -- fan-out thread ------------------------------------------------

    def _fanout_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(0.5)
            self._wake.clear()
            self._drain()

    def _drain(self) -> None:
        with self._inbox_lock:
            batch = list(self._inbox)
            self._inbox.clear()
            overflow = self._overflow_index
            self._overflow_index = 0
        if not batch and not overflow:
            return
        woken = 0
        with self._lock:
            for index, node_ids in batch:
                for node_id in node_ids:
                    if index > self._node_index.get(node_id, 0):
                        self._node_index[node_id] = index
                    woken += self._wake_waiters(node_id, index)
            if overflow:
                # fine-grained routes were lost: bump every tracked
                # node so no registered watcher sleeps through a write
                for node_id in list(self._node_index):
                    if overflow > self._node_index[node_id]:
                        self._node_index[node_id] = overflow
                    woken += self._wake_waiters(node_id, overflow)
        if overflow:
            metrics.incr("nomad.fleet.fanout_overflow")
        if woken:
            metrics.incr("nomad.fleet.watch_wakeups", woken)

    def _wake_waiters(self, node_id: str, index: int) -> int:
        """Signal waiters satisfied by `index`. Caller holds _lock."""
        waiters = self._waiters.get(node_id)
        if not waiters:
            return 0
        keep = []
        woken = 0
        for min_index, ev in waiters:
            if index >= min_index:
                ev.set()
                woken += 1
            else:
                keep.append((min_index, ev))
        if keep:
            self._waiters[node_id] = keep
        else:
            self._waiters.pop(node_id, None)
        return woken

    # -- watcher side --------------------------------------------------

    def index_of(self, node_id: str) -> int:
        """O(1) probe: the index of the node's last alloc change (0 if
        the hub has never routed one). The simulated fleet's
        cooperative watch poll rides this instead of holding a blocked
        thread per node."""
        with self._lock:
            return self._node_index.get(node_id, 0)

    def wait_for_node(
        self, node_id: str, min_index: int, timeout_s: Optional[float]
    ) -> bool:
        """Block until `node_id`'s alloc set has changed at or past
        `min_index`, or timeout. True = woken by a change (or already
        past), False = timed out (callers fall back to a fetch — the
        contract stays identical to the old wait_for_index poll, minus
        the herd wakeups)."""
        with self._lock:
            if self._node_index.get(node_id, 0) >= min_index:
                return True
            ev = threading.Event()
            waiters = self._waiters.setdefault(node_id, [])
            evicted = None
            if len(waiters) >= self._max_waiters:
                evicted = waiters.pop(0)
            waiters.append((min_index, ev))
        if evicted is not None:
            # wake the displaced waiter so it serves current state and
            # returns — a bounded queue, never a silent strand
            evicted[1].set()
            metrics.incr("nomad.fleet.watch_evicted")
        ok = ev.wait(timeout_s)
        if not ok:
            with self._lock:
                waiters = self._waiters.get(node_id)
                if waiters is not None:
                    self._waiters[node_id] = [
                        w for w in waiters if w[1] is not ev
                    ]
                    if not self._waiters[node_id]:
                        self._waiters.pop(node_id, None)
        return ok

    def stats(self) -> dict[str, float]:
        """Provider gauges (``nomad.fleet.*`` fan-out rows)."""
        with self._lock:
            subs = sum(len(w) for w in self._waiters.values())
            tracked = len(self._node_index)
        return {"watch_subscribers": subs, "nodes_tracked": tracked}

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
