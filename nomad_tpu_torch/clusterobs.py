"""Cluster-scope cost attribution: who is this server spending its
time on?

Port of ``nomad_tpu/clusterobs.py``, cut to what the RPC fabric writes:

  * :func:`source_of` derives the source one inbound request is
    attributed to: the node identity in the args when the request is
    about a node (``node:<id>``), else the dialing peer's label from the
    RPC envelope (``srv:<id>``, rpc/wire.py ``SRC_KEY``), else the
    object namespace (``ns:<name>``), else ``(unknown)``;
  * :class:`SourceLedger` is a bounded top-K ledger of per-(source,
    method) call counts and handler seconds, LRU-evicting cold sources
    into an explicit ``(other)`` bucket (coverage loss is counted, never
    silent). A process-global default (:func:`ledger`) serves every
    ``RPCServer`` that is not given its own;
  * the thread -> source registry (:func:`set_thread_source`) says which
    source each RPC handler thread is serving.

The reference's fleet-wide merge and host summary stay with its cluster
health endpoint. A stdlib-only leaf: it imports neither metrics nor
trace.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

DEFAULT_TOP_K = 128
OTHER_SOURCE = "(other)"
UNKNOWN_SOURCE = "(unknown)"

# -- source identity ------------------------------------------------------


def source_of(envelope_src: str, args) -> str:
    """The source identity one inbound request is attributed to.

    Node identity wins when the request is ABOUT a node (a heartbeat
    forwarded leaderward should still bill the node, not the forwarding
    server), then the dialing peer's envelope label, then the tenant
    namespace, then ``(unknown)``."""
    if isinstance(args, dict):
        node_id = args.get("node_id")
        if not node_id:
            node = args.get("node")
            node_id = getattr(node, "id", None)
        if node_id:
            return f"node:{node_id}"
    if envelope_src:
        return f"srv:{envelope_src}"
    if isinstance(args, dict):
        ns = args.get("namespace")
        if not ns:
            job = args.get("job")
            ns = getattr(job, "namespace", None)
        if ns:
            return f"ns:{ns}"
    return UNKNOWN_SOURCE


# -- the bounded per-source ledger ----------------------------------------


class SourceLedger:
    """Top-K (source -> per-method calls/seconds) with LRU overflow.

    A 5k-node fleet must not grow a 5k-entry dict per method on every
    server: the ledger keeps the `top_k` most-recently-active sources
    exact and folds evicted ones into ``(other)`` (totals stay
    conserved; `evicted` counts the identity loss). Per-source method
    maps are themselves bounded — the method set is closed in practice,
    the bound only guards pathological names."""

    MAX_METHODS_PER_SOURCE = 64

    def __init__(self, top_k: int = DEFAULT_TOP_K) -> None:
        self.top_k = max(2, int(top_k))
        self._lock = threading.Lock()
        # source -> {"calls": int, "seconds": float,
        #            "methods": {method: [calls, seconds]}}
        self._sources: "OrderedDict[str, dict]" = OrderedDict()
        self.evicted = 0
        self.total_calls = 0
        self.total_seconds = 0.0
        self.unattributed_calls = 0
        self.unattributed_seconds = 0.0

    def record(self, source: str, method: str, seconds: float) -> None:
        with self._lock:
            self.total_calls += 1
            self.total_seconds += seconds
            if source == UNKNOWN_SOURCE:
                self.unattributed_calls += 1
                self.unattributed_seconds += seconds
            ent = self._sources.get(source)
            if ent is None:
                # Make room: the ledger holds at most top_k EXACT
                # sources plus the explicit (other) bucket. The
                # LEAST-recently-active exact source folds into (other)
                # — totals conserved, identity loss counted.
                real = len(self._sources) - (
                    1 if OTHER_SOURCE in self._sources else 0
                )
                if real >= self.top_k and source != OTHER_SOURCE:
                    victim = next(
                        (s for s in self._sources if s != OTHER_SOURCE),
                        None,
                    )
                    if victim is not None:
                        v = self._sources.pop(victim)
                        self.evicted += 1
                        other = self._sources.get(OTHER_SOURCE)
                        if other is None:
                            other = self._sources[OTHER_SOURCE] = {
                                "calls": 0, "seconds": 0.0,
                                "methods": {},
                            }
                        other["calls"] += v["calls"]
                        other["seconds"] += v["seconds"]
                ent = self._sources[source] = {
                    "calls": 0, "seconds": 0.0, "methods": {},
                }
            else:
                self._sources.move_to_end(source)
            ent["calls"] += 1
            ent["seconds"] += seconds
            methods = ent["methods"]
            m = methods.get(method)
            if m is None:
                if len(methods) >= self.MAX_METHODS_PER_SOURCE:
                    method = OTHER_SOURCE
                    m = methods.get(method)
                if m is None:
                    m = methods[method] = [0, 0.0]
            m[0] += 1
            m[1] += seconds

    def snapshot(self, top: int = 10, methods_per_source: int = 3) -> dict:
        """Top sources by handler seconds + coverage stats — the
        ``/v1/operator/cluster/health`` per-member payload."""
        with self._lock:
            items = [
                (src, ent["calls"], ent["seconds"], dict(ent["methods"]))
                for src, ent in self._sources.items()
            ]
            out = {
                "tracked": len(self._sources),
                "top_k": self.top_k,
                "evicted": self.evicted,
                "total_calls": self.total_calls,
                "total_seconds": round(self.total_seconds, 6),
                "unattributed_calls": self.unattributed_calls,
                "unattributed_seconds": round(
                    self.unattributed_seconds, 6
                ),
            }
        items.sort(key=lambda it: -it[2])
        out["coverage"] = (
            round(
                1.0 - out["unattributed_seconds"]
                / max(out["total_seconds"], 1e-12),
                4,
            )
            if out["total_calls"]
            else 1.0
        )
        out["top"] = [
            {
                "source": src,
                "calls": calls,
                "seconds": round(secs, 6),
                "methods": {
                    name: {"calls": c, "seconds": round(s, 6)}
                    for name, (c, s) in sorted(
                        meths.items(), key=lambda kv: -kv[1][1]
                    )[: max(1, methods_per_source)]
                },
            }
            for src, calls, secs, meths in items[: max(1, top)]
        ]
        return out

# -- thread -> active-source registry ------------------------------------

# tid -> source, maintained by the RPC dispatch path around handler
# execution. GIL-atomic dict stores/deletes: a reader on another thread
# needs no lock.
_thread_sources: dict[int, str] = {}


def set_thread_source(source: str) -> None:
    _thread_sources[threading.get_ident()] = source


def clear_thread_source() -> None:
    _thread_sources.pop(threading.get_ident(), None)


def thread_sources() -> dict[int, str]:
    """Live view (reads are GIL-atomic)."""
    return _thread_sources


# -- process-global default ledger ---------------------------------------

_global = SourceLedger()


def ledger() -> SourceLedger:
    return _global
