"""Agent profiling/debug surface.

Port of ``nomad_tpu/agent/debug.py``.

Reference: command/agent/pprof/ (/v1/agent/pprof/goroutine|profile|trace,
gated behind enable_debug/ACL agent:write) and command/operator_debug.go
(the `operator debug` bundle). Python analogs:

  * goroutine → a dump of every thread's stack (sys._current_frames)
  * profile   → a cProfile capture over `seconds` of wall time
  * heap      → object counts by type (gc) + RSS from /proc

The handlers return text/JSON rather than pprof protobufs — the point is
self-observability (VERDICT r2 §5.1: a system whose thesis is scheduler
throughput must be able to profile itself), not Go toolchain compat.
"""

from __future__ import annotations

import gc
import io
import os
import sys
import threading
import time
import traceback


def thread_dump() -> str:
    """Every live thread's stack, goroutine-dump style."""
    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    out = io.StringIO()
    for ident, frame in sorted(frames.items()):
        t = names.get(ident)
        name = t.name if t else "?"
        daemon = " daemon" if (t and t.daemon) else ""
        out.write(f"thread {ident} [{name}]{daemon}:\n")
        out.write("".join(traceback.format_stack(frame)))
        out.write("\n")
    return out.getvalue()


def cpu_profile(seconds: float = 2.0, top: int = 50,
                interval_s: float = 0.01) -> str:
    """Statistical profile of EVERY thread: sample sys._current_frames()
    on an interval for `seconds` and aggregate frame counts.

    cProfile's hook is per-thread-state (it would only see this handler
    sleeping), so a wall-clock sampler is the honest whole-process
    profiler — the same shape as the reference's pprof CPU profile.
    """
    if not (seconds == seconds):  # NaN guard before clamping
        seconds = 2.0
    seconds = max(0.1, min(seconds, 30.0))
    counts: dict[tuple, int] = {}
    samples = 0
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            f = frame
            while f is not None:
                key = (
                    f.f_code.co_filename,
                    f.f_lineno if f is frame else f.f_code.co_firstlineno,
                    f.f_code.co_name,
                    f is frame,  # leaf vs ancestor
                )
                counts[key] = counts.get(key, 0) + 1
                f = f.f_back
        samples += 1
        time.sleep(interval_s)
    leaf = [(k, c) for k, c in counts.items() if k[3]]
    cum = [(k, c) for k, c in counts.items() if not k[3]]
    out = io.StringIO()
    out.write(
        f"wall-clock sampling profile: {samples} samples over "
        f"{seconds:.1f}s ({interval_s*1000:.0f}ms interval), all threads\n\n"
    )
    out.write("self (leaf frames):\n")
    for (fn, line, name, _), c in sorted(leaf, key=lambda kv: -kv[1])[:top]:
        out.write(f"  {c:6d} ({100*c/max(samples,1):5.1f}%)  "
                  f"{name}  {fn}:{line}\n")
    out.write("\ncumulative (on-stack):\n")
    for (fn, line, name, _), c in sorted(cum, key=lambda kv: -kv[1])[:top]:
        out.write(f"  {c:6d}  {name}  {fn}:{line}\n")
    return out.getvalue()


def heap_summary(top: int = 40) -> dict:
    counts: dict[str, int] = {}
    for obj in gc.get_objects():
        name = type(obj).__name__
        counts[name] = counts.get(name, 0) + 1
    rss = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    top_types = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
    return {
        "rss_bytes": rss,
        "gc_objects": sum(counts.values()),
        "gc_counts": list(gc.get_count()),
        "top_types": [{"type": t, "count": c} for t, c in top_types],
        "threads": threading.active_count(),
    }


def debug_bundle(api) -> dict:
    """Collect the `operator debug` capture through the public API
    (reference command/operator_debug.go gathers the same surfaces)."""
    bundle: dict = {"captured_at": time.strftime("%Y-%m-%dT%H:%M:%S%z")}

    def grab(name, fn):
        try:
            bundle[name] = fn()
        except Exception as e:  # capture what we can, note what we can't
            bundle[name] = {"error": str(e)}

    grab("agent_self", lambda: api.agent.self())
    grab("members", lambda: api.agent.members())
    grab("metrics", lambda: api.agent.metrics())
    grab("regions", lambda: api.status.regions())
    grab("leader", lambda: api.status.leader())
    grab("peers", lambda: api.status.peers())
    grab("nodes", lambda: api.get("/v1/nodes"))
    grab("jobs", lambda: api.get("/v1/jobs"))
    grab("allocations", lambda: api.get("/v1/allocations"))
    grab("evaluations", lambda: api.get("/v1/evaluations"))
    grab("deployments", lambda: api.get("/v1/deployments"))
    grab("namespaces", lambda: api.namespaces.list())
    grab("threads", lambda: api.get("/v1/agent/pprof/goroutine"))
    grab("heap", lambda: api.get("/v1/agent/pprof/heap"))
    # solver observability: compile ledger / occupancy / transfers /
    # device memory — one archive now diagnoses a slow solve offline
    grab("solver", lambda: api.agent.solver_status())
    grab("traces", lambda: api.traces.list(limit=50))
    # host profiler: span-correlated CPU attribution + GC/lock/runtime
    # telemetry, and the collapsed stacks a flamegraph renders from —
    # "where does the host second go" answerable from the archive alone
    grab("profile", lambda: api.agent.profile_status())
    grab(
        "profile_stacks",
        lambda: {"collapsed": api.agent.profile_collapsed()},
    )
    # cluster-scope capture: every member's health/telemetry (raft
    # indices, depths, host CPU/RSS, per-source cost top-K) with
    # degraded members flagged — the `operator debug` analog of the
    # reference's autopilot-health grab
    grab("cluster_health", lambda: api.operator.cluster_health())
    # flight recorder: the incident index plus the journal tail — the
    # minutes-before-the-crash context (docs/incidents.md) travels in
    # the same archive as the point-in-time snapshots above
    grab("incidents", lambda: api.agent.incidents())
    grab("blackbox", lambda: api.agent.blackbox_status(journal=500))
    return bundle
