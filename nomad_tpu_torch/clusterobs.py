"""Cluster-scope cost attribution: who is this server spending its

Port of ``nomad_tpu/clusterobs.py``.
time on?

Every observability layer before this one (traces, histograms,
solverobs, hostobs) answers "where does the second go" for ONE agent;
nothing attributed server-side cost to the client node, peer server, or
tenant namespace that CAUSED it — the capability ROADMAP item 4's
"bounded server-CPU-per-node" gate needs. This module is that layer:

  * :class:`SourceLedger` — a bounded top-K ledger of per-(source,
    method) call counts and handler seconds, LRU-evicting cold sources
    into an explicit ``(other)`` bucket (the hostobs pattern: coverage
    loss is COUNTED, never silent). One instance per server
    (``ClusterServer`` owns its own, so an in-process test cluster
    attributes per member); a process-global default serves bare
    ``RPCServer``\\ s.
  * source identity — :func:`source_of` derives the source for one
    inbound request: the node identity in the args when the request IS
    about a node (heartbeats, alloc updates — ``node:<id>``), else the
    dialing peer's label from the RPC envelope (server-to-server
    forwards and raft — ``srv:<id>``), else the object namespace
    (tenant-attributable writes — ``ns:<name>``), else ``(unknown)``.
    The dialer tags its envelope via :data:`~nomad_tpu_torch.rpc.wire.SRC_KEY`.
  * thread→source registry — the RPC dispatch path publishes "this
    thread is currently serving <source>" (GIL-atomic dict stores, the
    trace.thread_spans shape) so the hostobs sampling profiler can add
    a SOURCE dimension to its CPU attribution: ``handler CPU x source
    node`` becomes answerable from ``/v1/profile/status``.

Surfaced through ``Status.peer_telemetry`` / ``GET
/v1/operator/cluster/health`` (server/cluster.py), the
``nomad.rpc.source.*`` provider gauges (docs/metrics.md), and
``operator cluster health`` / ``operator top -cluster``.

Deliberately a stdlib-only leaf (registered in analysis/rules.py
LEAF_MODULES): metrics/trace are never imported here at all — the
ledger is pull-read by providers and the health RPC.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

DEFAULT_TOP_K = 128
OTHER_SOURCE = "(other)"
UNKNOWN_SOURCE = "(unknown)"

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Recording gate (GIL-atomic flag): the uninstrumented side of the
    throughput comparison gate; production leaves it on."""
    global _enabled
    _enabled = bool(on)


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
        if not _enabled:
            return
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

    def stats(self) -> dict:
        """Bounded-cardinality provider gauges (``nomad.rpc.source.*``
        rides the registry; per-source values stay in the ledger)."""
        with self._lock:
            return {
                "tracked": float(len(self._sources)),
                "evicted": float(self.evicted),
                "calls": float(self.total_calls),
                "seconds": round(self.total_seconds, 6),
                "unattributed_calls": float(self.unattributed_calls),
                "unattributed_seconds": round(
                    self.unattributed_seconds, 6
                ),
            }

    def reset(self) -> None:
        with self._lock:
            self._sources.clear()
            self.evicted = 0
            self.total_calls = 0
            self.total_seconds = 0.0
            self.unattributed_calls = 0
            self.unattributed_seconds = 0.0


def merge_top_sources(rows, top: int = 5) -> list[dict]:
    """Merge per-member ``snapshot()["top"]`` rows into one fleet-wide
    top-K: calls/seconds summed per source, heaviest seconds first.
    Shared by the cluster_health fleet block and run_soak's report so
    the two surfaces can never drift."""
    merged: dict[str, list] = {}
    for row in rows:
        agg = merged.setdefault(row["source"], [0, 0.0])
        agg[0] += row["calls"]
        agg[1] += row["seconds"]
    return [
        {"source": src, "calls": calls, "seconds": round(secs, 6)}
        for src, (calls, secs) in sorted(
            merged.items(), key=lambda kv: -kv[1][1]
        )[: max(1, int(top))]
    ]


# -- thread -> active-source registry (the hostobs source dimension) ------

# tid -> source, maintained by the RPC dispatch paths around handler
# execution. GIL-atomic dict stores/deletes, same discipline as
# trace.py's thread->span registry: the sampling profiler reads it
# from its own thread without locks.
_thread_sources: dict[int, str] = {}


def set_thread_source(source: str) -> None:
    _thread_sources[threading.get_ident()] = source


def clear_thread_source() -> None:
    _thread_sources.pop(threading.get_ident(), None)


def thread_sources() -> dict[int, str]:
    """Live view for the sampler (reads are GIL-atomic; the sampler
    copies nothing on the fast path)."""
    return _thread_sources


def prune_thread_sources(live_tids) -> None:
    """Drop dead threads' entries (hostobs flush calls this alongside
    trace.prune_thread_spans)."""
    for tid in [t for t in _thread_sources if t not in live_tids]:
        _thread_sources.pop(tid, None)


# -- lightweight host summary (peer_telemetry's CPU/RSS block) ------------


def host_summary() -> dict:
    """Process-level host cost: CPU seconds (all threads, monotonic),
    RSS, thread count. In production one agent is one process so these
    ARE the server's numbers; in-process test clusters share a process
    and the docs say so (docs/operations.md)."""
    rss = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    return {
        "cpu_seconds": round(time.process_time(), 3),
        "rss_bytes": rss,
        "threads": threading.active_count(),
    }


# -- process-global default ledger ---------------------------------------

_global = SourceLedger()


def ledger() -> SourceLedger:
    return _global


def _install(lg: SourceLedger) -> SourceLedger:
    """Swap the process-global default ledger (test isolation hook,
    mirroring hostobs._install). Servers that own their ledger are
    unaffected."""
    global _global
    old = _global
    _global = lg
    return old
