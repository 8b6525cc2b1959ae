"""Continuous host-profiling: span-correlated CPU attribution, runtime

Port of ``nomad_tpu/hostobs.py``.
telemetry (GC / RSS / fds / threads), and lock-wait accounting.

The solver's own telemetry (VERDICT r5, trace/solverobs) shows ~86% of a
c2m batch is host-side Python — but nothing attributed that second to
CODE: traces give stage wall time, the compile ledger covers the device,
and the only CPU profiler was the on-demand, enable_debug-gated capture
in agent/debug.py. This module is the always-on layer, in the spirit of
fleet continuous profilers (Google-Wide Profiling; Pyroscope/Parca):

  * sampling profiler — a background thread samples
    ``sys._current_frames()`` on an interval adaptive to load and
    attributes each busy sample to **(thread role x active trace span x
    leaf function)**, using the per-thread active-span registry
    maintained by trace.py (``trace.thread_spans()``). The
    pipelined worker's solve and commit threads profile as distinct
    roles. Ledgers are bounded (site/stack overflow aggregates into an
    explicit ``(other)`` bucket — coverage loss is COUNTED, never
    silent), and the idle fast path allocates nothing: a thread whose
    leaf frame is a known blocking wait is skipped before any tuple or
    string is built.
  * runtime telemetry — GC pause/collection accounting via
    ``gc.callbacks`` (pauses are buffered in the callback and flushed to
    the metrics registry by the sampler thread: the callback itself can
    fire while ANY lock — including the registry's — is held by the
    collecting thread, so it must never take one), gctune paused-GC
    section accounting (gctune.on_section_end), and RSS / fd-count /
    thread-count / gc-generation gauges sampled once per flush interval.
  * lock-wait attribution — :class:`TimedLock` wraps the hot locks
    (eval broker, plan queue, metrics registry): the uncontended path is
    a single non-blocking try-acquire (no timestamps, no allocation);
    only a CONTENDED acquire takes two clock reads and lands in the
    per-lock wait ledger + ``nomad.runtime.lock_wait_seconds.<lock>``.

Deliberately a stdlib-only leaf (like solverobs/faultplane): metrics and
trace are imported lazily inside functions so metrics.py itself can use
TimedLock without an import cycle.

Surfaces: ``GET /v1/profile/status`` (summary) and
``GET /v1/profile/collapsed`` (collapsed-stack flamegraph text) behind
``agent:read`` — always on, unlike the enable_debug-gated pprof capture;
``operator profile status|top|stacks``; a Host row in ``operator top``;
the ``operator debug`` bundle; and the bench's per-config
``host_attribution`` block. All ``nomad.host.*`` / ``nomad.runtime.*``
names are catalogued in docs/metrics.md (source-walk enforced). Design
notes and flamegraph reading: docs/profiling.md.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
import weakref
from typing import Optional

now_ns = time.monotonic_ns

# -- bounds --------------------------------------------------------------
# Sites are (role, span, function) triples — a closed set in practice
# (the codebase has a few hundred hot functions); the bound only matters
# under pathological frame churn (generated code), where overflow lands
# in "(other)" and sites_evicted counts the loss.
MAX_SITES = 2048
MAX_STACKS = 8192
MAX_DEPTH = 48
OTHER_SITE = "(other)"

# Leaf frames that mean "parked, not working": skipped before any
# allocation (the zero-allocation idle fast path). The basename match
# is anchored to the STDLIB directory (threading.__file__'s home) —
# a bare suffix match would classify this repo's own
# server/plan_queue.py as "queue.py" and silently drop one of the very
# hot paths this layer exists to attribute. The name set covers this
# repo's known blocking read loops, whose leaf is repo code parked in
# a C recv/accept.
_STDLIB_DIR = os.path.dirname(threading.__file__) + os.sep
_IDLE_STDLIB_BASENAMES = frozenset({
    "threading.py",
    "selectors.py",
    "queue.py",
    "socketserver.py",
    "socket.py",
    "ssl.py",
    "subprocess.py",
    "_base.py",  # concurrent/futures/_base.py (Future.result waits)
})
_IDLE_NAMES = frozenset({
    "recv_exact",
    "recv_frame",
    "_read_loop",
    "_accept_loop",
})

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Recording gate (GIL-atomic flag): the sampler thread keeps
    running but skips the frame walk entirely when off. The bench uses
    this to exclude cluster-build time from attribution windows and as
    the unprofiled side of the overhead gate; production leaves it on."""
    global _enabled
    _enabled = bool(on)


# -- lock-wait attribution ----------------------------------------------

_lock_registry: "weakref.WeakSet[TimedLock]" = weakref.WeakSet()


class TimedLock:
    """A Lock/RLock wrapper attributing contended-acquire wait time.

    Fast path: one non-blocking try-acquire — an uncontended lock costs
    a single extra C call, no clock reads, no allocation. Contended
    path: two monotonic_ns reads around the blocking acquire, instance
    counters (safe unsynchronized: the incrementing thread HOLDS the
    lock), and a ``nomad.runtime.lock_wait_seconds.<name>`` histogram
    observation unless ``histogram=False`` — the metrics registry's own
    lock MUST pass False (observing would re-acquire the very lock the
    caller now holds: self-deadlock).

    Condition-compatible: ``_release_save``/``_acquire_restore``/
    ``_is_owned`` delegate to the inner primitive where it provides them
    (RLock) and fall back to the stdlib default shapes otherwise, so
    ``threading.Condition(TimedLock(...))`` behaves exactly like
    Condition over the bare primitive. Pass the inner lock explicitly
    (``TimedLock("broker", threading.RLock())``) so the racecheck
    lock-order detector classes it by the REAL allocation site.
    """

    __slots__ = (
        "name", "_inner", "_histogram",
        "contended", "wait_ns", "max_wait_ns", "__weakref__",
    )

    def __init__(self, name: str, inner=None, histogram: bool = True) -> None:
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        self._histogram = histogram
        self.contended = 0
        self.wait_ns = 0
        self.max_wait_ns = 0
        _lock_registry.add(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        inner = self._inner
        if inner.acquire(False):
            return True
        if not blocking:
            return False
        t0 = now_ns()
        ok = inner.acquire(True, timeout)
        dt = now_ns() - t0
        if ok:
            # serialized by the lock itself: plain int ops are safe
            self.contended += 1
            self.wait_ns += dt
            if dt > self.max_wait_ns:
                self.max_wait_ns = dt
            if self._histogram and _enabled:
                from . import metrics

                metrics.incr(f"nomad.runtime.lock_contended.{self.name}")
                metrics.observe(
                    f"nomad.runtime.lock_wait_seconds.{self.name}", dt / 1e9
                )
        return ok

    def release(self) -> None:
        self._inner.release()

    def __enter__(self) -> "TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition plumbing (threading.Condition grabs these at __init__;
    # wait()'s release/reacquire cycles bypass the timing on purpose —
    # a Condition sleeper is parked, not contending).

    def _release_save(self):
        f = getattr(self._inner, "_release_save", None)
        if f is not None:
            return f()
        self._inner.release()

    def _acquire_restore(self, state) -> None:
        f = getattr(self._inner, "_acquire_restore", None)
        if f is not None:
            f(state)
            return
        self._inner.acquire()

    def _is_owned(self) -> bool:
        f = getattr(self._inner, "_is_owned", None)
        if f is not None:
            return f()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def stats(self) -> dict:
        return {
            "contended": self.contended,
            "wait_seconds_total": round(self.wait_ns / 1e9, 6),
            "max_wait_s": round(self.max_wait_ns / 1e9, 6),
        }


def lock_stats() -> dict[str, dict]:
    """Aggregate TimedLock stats by lock name across live instances
    (in-process test clusters run several brokers; operators run one)."""
    agg: dict[str, dict] = {}
    for lk in list(_lock_registry):
        cur = agg.setdefault(
            lk.name,
            {"contended": 0, "wait_seconds_total": 0.0, "max_wait_s": 0.0},
        )
        s = lk.stats()
        cur["contended"] += s["contended"]
        cur["wait_seconds_total"] = round(
            cur["wait_seconds_total"] + s["wait_seconds_total"], 6
        )
        cur["max_wait_s"] = max(cur["max_wait_s"], s["max_wait_s"])
    return agg


# -- thread-role classification ------------------------------------------

_ROLE_PREFIXES = (
    ("MainThread", "main"),
    ("tpu-batch-solve", "solve"),
    ("tpu-batch-commit", "commit"),
    ("worker", "worker"),
    ("plan-applier", "applier"),
    ("http-agent", "http"),
    ("rpc-", "rpc"),
    ("raft", "raft"),
    ("serf", "serf"),
    ("broker-delayed", "broker"),
    ("statsd-sink", "telemetry"),
    ("heartbeat", "heartbeat"),
)


def _role_of(name: str) -> str:
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    if "process_request_thread" in name:  # ThreadingHTTPServer workers
        return "http"
    if name.startswith("Thread-"):
        return "other"
    # bounded by the live thread-name set; strip trailing numbering so
    # "logmon-3" and "logmon-7" share a role
    return name.rstrip("0123456789-") or "other"


# -- the profiler --------------------------------------------------------


class HostProfiler:
    """One process-wide instance (module functions delegate); tests and
    the bench may install a fresh one via :func:`_install`.

    Writer discipline: the sampler thread is the only ledger writer (GC
    callbacks buffer into a bounded pending list the sampler flushes);
    readers (snapshot/collapsed, any thread) copy under ``_lock``. The
    lock is therefore uncontended at steady state — held by the sampler
    for the microseconds of one sample pass."""

    def __init__(
        self,
        interval_s: float = 0.010,
        idle_interval_s: float = 0.10,
        flush_interval_s: float = 10.0,
        max_sites: int = MAX_SITES,
        max_stacks: int = MAX_STACKS,
        max_depth: int = MAX_DEPTH,
    ) -> None:
        self.interval_s = max(0.001, float(interval_s))
        self.idle_interval_s = max(self.interval_s, float(idle_interval_s))
        self.flush_interval_s = max(0.05, float(flush_interval_s))
        # the sampler's EFFECTIVE period right now (backoff observable)
        self.cur_interval_s = self.interval_s
        self.max_sites = max(16, int(max_sites))
        self.max_stacks = max(16, int(max_stacks))
        self.max_depth = max(4, int(max_depth))
        self._lock = threading.Lock()
        # Serializes _flush: the sampler's periodic flush and a
        # snapshot() reader (HTTP thread) must not drain the GC-pending
        # buffers concurrently — the copy+clear is two bytecodes, and a
        # double drain double-counts every pause. Ordered BEFORE _lock
        # and the metrics registry lock everywhere.
        self._flush_lock = threading.Lock()
        # (role, span, site) -> [samples, busy_ns]
        self._sites: dict[tuple, list] = {}
        # collapsed "role;span;f0;f1;...;leaf" -> samples
        self._stacks: dict[str, int] = {}
        self._span_ns: dict[str, int] = {}
        # source -> busy ns: the clusterobs thread->source registry's
        # dimension ("handler CPU x source node") — bounded, overflow
        # folds into "(other)" like the site ledger
        self._source_ns: dict[str, int] = {}
        self.max_sources = 512
        self._role_stats: dict[str, list] = {}  # role -> [samples, ns]
        self.samples = 0
        self.idle_samples = 0
        self.busy_ns = 0
        self.sites_evicted = 0
        self.stacks_dropped = 0
        self._sampler_ns = 0  # time spent inside sample passes
        self._started_ns = 0
        # code object -> (qualified frame label, leaf-site label, idle?)
        self._code_cache: dict = {}
        self._roles: dict[int, str] = {}
        # GC accounting (callback-side buffers; sampler flushes)
        self._gc_t0 = 0
        self._gc_pending: list[tuple[int, int]] = []  # (gen, pause_ns)
        self.gc_dropped = 0
        self.gc_collections = [0, 0, 0]
        self.gc_collected = 0
        self.gc_pause_ns = 0
        self.gc_pause_max_ns = 0
        # gctune paused-GC sections (hook-side buffer; sampler flushes)
        self._section_pending: list[int] = []
        self.gc_sections = 0
        self.gc_section_ns = 0
        self._gc_collected_flushed = 0
        # lifecycle
        self._refs = 0
        self._ref_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._provider_handle = None
        self._prev_section_hook = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Refcounted: every Agent (and the bench) calls start/stop in
        pairs; one sampler thread serves the whole process."""
        with self._ref_lock:
            self._refs += 1
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._started_ns = now_ns()
            self._thread = threading.Thread(
                target=self._run, args=(self._stop,), daemon=True,
                name="host-profiler",
            )
            gc.callbacks.append(self._gc_cb)
            from . import gctune

            # save the previous owner: a PRIVATE instance (run_soak's
            # measurement apparatus) must hand the hook back to a
            # co-resident global profiler on stop, not null it out
            self._prev_section_hook = gctune.on_section_end
            gctune.on_section_end = self.note_gc_section
            if self._provider_handle is None:
                from . import metrics

                self._provider_handle = metrics.register_provider(
                    "nomad.host", self._provider
                )
            self._thread.start()

    def stop(self) -> None:
        with self._ref_lock:
            if self._refs > 0:
                self._refs -= 1
            if self._refs > 0 or self._thread is None:
                return
            self._stop.set()
            t = self._thread
            self._thread = None
        t.join(timeout=2)
        try:
            gc.callbacks.remove(self._gc_cb)
        except ValueError:
            pass
        from . import gctune

        if gctune.on_section_end == self.note_gc_section:
            gctune.on_section_end = self._prev_section_hook
        self._prev_section_hook = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def configure(
        self,
        interval_s: Optional[float] = None,
        flush_interval_s: Optional[float] = None,
        idle_interval_s: Optional[float] = None,
    ) -> None:
        """Operator knobs (telemetry { host_profile_interval }, SIGHUP
        reload): picked up by the sampler on its next wakeup.
        idle_interval_s clamps the idle backoff ceiling — the bench's
        attribution passes pin it to the busy interval so short bursts
        after long idle builds aren't sampled at the backed-off rate."""
        if interval_s is not None:
            self.interval_s = max(0.001, float(interval_s))
            self.idle_interval_s = max(self.interval_s, self.idle_interval_s)
        if idle_interval_s is not None:
            self.idle_interval_s = max(
                self.interval_s, float(idle_interval_s)
            )
        if flush_interval_s is not None:
            self.flush_interval_s = max(0.05, float(flush_interval_s))

    def reset_stats(self) -> None:
        """Forget attribution (bench per-config isolation; the sampler
        thread and lifecycle state are untouched)."""
        with self._flush_lock, self._lock:
            self._sites.clear()
            self._stacks.clear()
            self._span_ns.clear()
            self._source_ns.clear()
            self._role_stats.clear()
            self.samples = 0
            self.idle_samples = 0
            self.busy_ns = 0
            self.sites_evicted = 0
            self.stacks_dropped = 0
            self._sampler_ns = 0
            self._started_ns = now_ns()
            self.gc_collections = [0, 0, 0]
            self.gc_collected = 0
            self.gc_pause_ns = 0
            self.gc_pause_max_ns = 0
            self.gc_sections = 0
            self.gc_section_ns = 0
            self._gc_collected_flushed = 0
            del self._gc_pending[:]
            del self._section_pending[:]
        for lk in list(_lock_registry):
            lk.contended = 0
            lk.wait_ns = 0
            lk.max_wait_ns = 0

    # -- GC hooks (MUST NOT touch the metrics registry: the collector
    # can fire while the collecting thread holds any lock, including
    # the registry's — the sampler flushes these buffers instead) ------

    def _gc_cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = now_ns()
            return
        t0 = self._gc_t0
        if not t0:
            return
        self._gc_t0 = 0
        if not _enabled:
            return
        dt = now_ns() - t0
        gen = int(info.get("generation", 0))
        # GIL-atomic appends; bounded so a collection storm between
        # flushes can't grow the buffer without bound
        if len(self._gc_pending) < 1024:
            self._gc_pending.append((gen, dt))
        else:
            self.gc_dropped += 1
        self.gc_collected += int(info.get("collected", 0))

    def note_gc_section(self, dur_ns: int) -> None:
        """gctune.paused_gc outermost-exit hook: how long the collector
        was deliberately off for a batch (docs/profiling.md — a long
        paused section means the RE-ENABLE pays one big young-gen
        scan)."""
        if not _enabled:
            return
        if len(self._section_pending) < 1024:
            self._section_pending.append(int(dur_ns))

    # -- sampler ---------------------------------------------------------

    def _run(self, stop: threading.Event) -> None:
        last = now_ns()
        interval = self.interval_s
        idle_streak = 0
        next_flush = 0.0
        while not stop.wait(interval):
            self.cur_interval_s = interval
            t0 = now_ns()
            # wall time since the previous sample is what this sample's
            # busy threads are charged with (capped: a sampler starved
            # for seconds must not attribute the whole gap to whatever
            # runs at wakeup)
            dt = min(t0 - last, 2_000_000_000)
            last = t0
            if _enabled:
                busy = self._sample(dt)
                if busy:
                    idle_streak = 0
                    interval = self.interval_s
                else:
                    # adaptive idle backoff: a quiet agent converges to
                    # idle_interval_s, ~10x fewer wakeups
                    idle_streak += 1
                    if idle_streak >= 50:
                        interval = min(interval * 2, self.idle_interval_s)
            now = time.monotonic()
            if now >= next_flush:
                next_flush = now + self.flush_interval_s
                try:
                    self._flush()
                except Exception:  # flush must never kill the sampler
                    pass
            self._sampler_ns += now_ns() - t0

    def _sample(self, dt_ns: int) -> bool:
        """One pass over every live thread's current frame. Returns
        whether any thread was busy (drives the adaptive interval)."""
        from . import clusterobs as _clusterobs, trace as _trace

        me = threading.get_ident()
        spans = _trace.thread_spans()
        sources = _clusterobs.thread_sources()
        frames = sys._current_frames()
        busy_any = False
        code_cache = self._code_cache
        with self._lock:
            self.samples += 1
            for tid, frame in frames.items():
                if tid == me:
                    continue
                code = frame.f_code
                cached = code_cache.get(code)
                if cached is None:
                    cached = self._describe(code)
                    if len(code_cache) < 8192:
                        code_cache[code] = cached
                label, site, is_idle = cached
                if is_idle:
                    continue
                busy_any = True
                role = self._roles.get(tid)
                if role is None:
                    role = self._refresh_role(tid)
                span = spans.get(tid) or "-"
                key = (role, span, site)
                ent = self._sites.get(key)
                if ent is None:
                    if len(self._sites) >= self.max_sites:
                        key = (role, span, OTHER_SITE)
                        self.sites_evicted += 1
                        ent = self._sites.get(key)
                    if ent is None:
                        ent = self._sites[key] = [0, 0]
                ent[0] += 1
                ent[1] += dt_ns
                self.busy_ns += dt_ns
                self._span_ns[span] = self._span_ns.get(span, 0) + dt_ns
                # source dimension (clusterobs thread registry): only
                # threads currently serving an attributed request carry
                # one — handler CPU lands on its source node/namespace
                src = sources.get(tid)
                if src is not None:
                    if (
                        src not in self._source_ns
                        and len(self._source_ns) >= self.max_sources
                    ):
                        src = OTHER_SITE
                    self._source_ns[src] = (
                        self._source_ns.get(src, 0) + dt_ns
                    )
                rs = self._role_stats.get(role)
                if rs is None:
                    rs = self._role_stats[role] = [0, 0]
                rs[0] += 1
                rs[1] += dt_ns
                # collapsed stack (flamegraph surface): root-first
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < self.max_depth:
                    c = f.f_code
                    cc = code_cache.get(c)
                    if cc is None:
                        cc = self._describe(c)
                        if len(code_cache) < 8192:
                            code_cache[c] = cc
                    parts.append(cc[0])
                    f = f.f_back
                    depth += 1
                parts.append(f"{role};{span}")
                parts.reverse()
                stack_key = ";".join(parts)
                cnt = self._stacks.get(stack_key)
                if cnt is None:
                    if len(self._stacks) >= self.max_stacks:
                        self.stacks_dropped += 1
                        continue
                    self._stacks[stack_key] = 1
                else:
                    self._stacks[stack_key] = cnt + 1
            if not busy_any:
                self.idle_samples += 1
        return busy_any

    @staticmethod
    def _describe(code) -> tuple[str, str, bool]:
        """(frame label, leaf-site label, idle?) for one code object —
        computed once and cached; the per-sample path is dict hits."""
        fn = code.co_filename
        name = code.co_name
        if name == "_gc_cb" and fn.endswith("hostobs.py"):
            # gc.collect holds the GIL for the whole collection; the
            # sampler's only chance to run "inside" one is while the
            # Python gc callback executes, so the entire collection gap
            # lands on this frame — name it what it is
            return "(gc-collect)", "(gc-collect)", False
        base = os.path.basename(fn)
        mod = base[:-3] if base.endswith(".py") else base
        label = f"{mod}.{name}"
        site = f"{name} ({base}:{code.co_firstlineno})"
        idle = name in _IDLE_NAMES or (
            fn.startswith(_STDLIB_DIR) and base in _IDLE_STDLIB_BASENAMES
        )
        return label, site, idle

    def _refresh_role(self, tid: int) -> str:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, name in names.items():
            if ident not in self._roles:
                self._roles[ident] = _role_of(name)
        role = self._roles.get(tid)
        if role is None:
            role = self._roles[tid] = "other"
        return role

    # -- flush: buffered GC events + runtime gauges ----------------------

    def _flush(self) -> None:
        from . import metrics, trace as _trace

        with self._flush_lock:
            self._flush_locked(metrics, _trace)

    def _flush_locked(self, metrics, _trace) -> None:
        # drain the callback-side buffers (list slicing under the GIL;
        # the callback only appends)
        pending, self._gc_pending[:] = self._gc_pending[:], []
        sections, self._section_pending[:] = self._section_pending[:], []
        for gen, dt in pending:
            if 0 <= gen < 3:
                self.gc_collections[gen] += 1
            self.gc_pause_ns += dt
            if dt > self.gc_pause_max_ns:
                self.gc_pause_max_ns = dt
            metrics.incr("nomad.runtime.gc_collections")
            metrics.incr(f"nomad.runtime.gc_collections.gen{gen}")
            metrics.observe("nomad.runtime.gc_pause_seconds", dt / 1e9)
        if self.gc_dropped:
            metrics.incr("nomad.runtime.gc_pauses_dropped", self.gc_dropped)
            self.gc_dropped = 0
        collected_delta = self.gc_collected - self._gc_collected_flushed
        if collected_delta > 0:
            metrics.incr("nomad.runtime.gc_collected", collected_delta)
            self._gc_collected_flushed = self.gc_collected
        for dt in sections:
            self.gc_sections += 1
            self.gc_section_ns += dt
            metrics.incr("nomad.runtime.gc_paused_sections")
            metrics.observe(
                "nomad.runtime.gc_paused_section_seconds", dt / 1e9
            )
        # runtime gauges
        metrics.set_gauge(
            "nomad.runtime.threads", float(threading.active_count())
        )
        counts = gc.get_count()
        for gen in range(min(3, len(counts))):
            metrics.set_gauge(
                f"nomad.runtime.gc_pending.gen{gen}", float(counts[gen])
            )
        rss = _read_rss()
        if rss:
            metrics.set_gauge("nomad.runtime.rss_bytes", float(rss))
        fds = _count_fds()
        if fds is not None:
            metrics.set_gauge("nomad.runtime.fds", float(fds))
        # prune role cache + the trace-side span registry + the
        # clusterobs source registry for dead tids
        live = {t.ident for t in threading.enumerate()}
        for tid in [t for t in self._roles if t not in live]:
            self._roles.pop(tid, None)
        _trace.prune_thread_spans(live)
        from . import clusterobs as _clusterobs

        _clusterobs.prune_thread_sources(live)

    def _provider(self) -> dict:
        wall = max(1, now_ns() - self._started_ns)
        return {
            "samples": float(self.samples),
            "idle_samples": float(self.idle_samples),
            "busy_seconds": round(self.busy_ns / 1e9, 3),
            "duty_cycle": round(self._sampler_ns / wall, 6),
            "interval_ms": round(self.interval_s * 1e3, 3),
            "sites": float(len(self._sites)),
            "sites_evicted": float(self.sites_evicted),
            "stacks": float(len(self._stacks)),
            "stacks_dropped": float(self.stacks_dropped),
        }

    # -- read side -------------------------------------------------------

    def snapshot(self, top: int = 50) -> dict:
        """The /v1/profile/status payload."""
        try:
            self._flush()
        except Exception:
            pass
        with self._lock:
            sites = sorted(
                self._sites.items(), key=lambda kv: -kv[1][1]
            )[: max(1, top)]
            spans = {
                k: round(v / 1e9, 4)
                for k, v in sorted(
                    self._span_ns.items(), key=lambda kv: -kv[1]
                )
            }
            sources = {
                k: round(v / 1e9, 4)
                for k, v in sorted(
                    self._source_ns.items(), key=lambda kv: -kv[1]
                )[: max(1, top)]
            }
            roles = {
                r: {"samples": s[0], "busy_seconds": round(s[1] / 1e9, 4)}
                for r, s in sorted(self._role_stats.items())
            }
            wall_ns = max(1, now_ns() - self._started_ns)
            out = {
                "enabled": _enabled,
                "running": self.running(),
                "interval_ms": round(self.interval_s * 1e3, 3),
                "window_seconds": round(wall_ns / 1e9, 3),
                "samples": self.samples,
                "idle_samples": self.idle_samples,
                "busy_seconds": round(self.busy_ns / 1e9, 4),
                "overhead": {
                    "sampler_seconds": round(self._sampler_ns / 1e9, 4),
                    "duty_cycle": round(self._sampler_ns / wall_ns, 6),
                },
                "top_sites": [
                    {
                        "role": role,
                        "span": span,
                        "site": site,
                        "samples": ent[0],
                        "seconds": round(ent[1] / 1e9, 4),
                    }
                    for (role, span, site), ent in sites
                ],
                "spans": spans,
                # handler CPU x source (clusterobs dimension): seconds
                # of busy samples taken while the thread was serving an
                # attributed request for that source
                "sources": sources,
                "threads": roles,
                "sites": len(self._sites),
                "sites_evicted": self.sites_evicted,
                "stacks": len(self._stacks),
                "stacks_dropped": self.stacks_dropped,
                "gc": {
                    "collections": {
                        f"gen{i}": n
                        for i, n in enumerate(self.gc_collections)
                    },
                    "collected": self.gc_collected,
                    "pause_seconds_total": round(self.gc_pause_ns / 1e9, 6),
                    "pause_max_s": round(self.gc_pause_max_ns / 1e9, 6),
                    "paused_sections": self.gc_sections,
                    "paused_section_seconds": round(
                        self.gc_section_ns / 1e9, 6
                    ),
                },
                "locks": lock_stats(),
                "runtime": {
                    "rss_bytes": _read_rss(),
                    "threads": threading.active_count(),
                    "fds": _count_fds(),
                    "gc_pending": list(gc.get_count()),
                },
            }
        return out

    def collapsed(self, limit: int = 0) -> str:
        """Collapsed-stack text (``role;span;frame;...;leaf count`` per
        line, Brendan-Gregg format): feed to flamegraph.pl / speedscope
        / inferno verbatim. Sorted by sample count, heaviest first."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        if limit > 0:
            items = items[:limit]
        return "\n".join(f"{stack} {count}" for stack, count in items) + (
            "\n" if items else ""
        )


def _read_rss() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def _count_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


# -- process-global instance + module conveniences -----------------------

_global = HostProfiler()


def profiler() -> HostProfiler:
    return _global


def _install(prof: HostProfiler) -> HostProfiler:
    """Swap the process-global profiler (returns the previous one) —
    the test isolation hook, mirroring solverobs._install. The caller
    owns stopping the old instance's thread if it started one."""
    global _global, start, stop, running, configure, reset_stats
    global snapshot, collapsed, note_gc_section
    old = _global
    _global = prof
    start = prof.start
    stop = prof.stop
    running = prof.running
    configure = prof.configure
    reset_stats = prof.reset_stats
    snapshot = prof.snapshot
    collapsed = prof.collapsed
    note_gc_section = prof.note_gc_section
    return old


start = _global.start
stop = _global.stop
running = _global.running
configure = _global.configure
reset_stats = _global.reset_stats
snapshot = _global.snapshot
collapsed = _global.collapsed
note_gc_section = _global.note_gc_section
