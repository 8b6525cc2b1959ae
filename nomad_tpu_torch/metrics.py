"""In-process metrics registry + /v1/metrics surface.

Port of ``nomad_tpu/metrics.py``.

Reference: command/agent/command.go:979 setupTelemetry (go-metrics
InmemSink behind /v1/metrics) and the server gauges published from
nomad/server.go:444-450 (broker ready/unacked, plan-queue depth) plus the
per-eval invoke latencies emitted by the workers.

Design: one process-global registry with three primitives —

  * counters    (monotonic; incr)
  * gauges      (last value; set_gauge, or a registered PROVIDER callback
                 sampled at snapshot time, which is how subsystems that
                 already keep live stats — the eval broker, the plan
                 queue — are surfaced without double bookkeeping)
  * histograms  (observe: fixed-boundary exponential buckets + count/sum/
                 min/max/last, with an InmemSink-style ring of per-interval
                 snapshots so the surface can answer both "p99 since boot"
                 and "p99 right now" — the cumulative vs last-window split
                 that separates "slow now" from "slow once at startup")

Everything is threadsafe and cheap enough for hot paths: an observe is a
bucket index (bisect over ~50 precomputed bounds) plus bounded array
increments under the registry lock — no allocation on the steady path
(interval rotation allocates one fresh bucket array per interval).
Percentiles are computed at SNAPSHOT time from the bucket counts, never
on the write path.

Exported three ways: the JSON snapshot (/v1/metrics) carries
p50/p90/p95/p99 per name cumulative and for the last window;
?format=prometheus serves real histogram exposition (_bucket{le=...},
_sum, _count); the statsd/DogStatsD sinks forward raw observations as
|ms timings (captured in a bounded side buffer only while a sink is
attached — zero cost otherwise).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque
from math import inf
from typing import Callable, Optional

_START = time.time()

# Fixed exponential boundaries (seconds): 100us .. ~1678s at factor
# sqrt(2) — ~49 buckets plus +Inf. Exponential spacing keeps relative
# quantile-interpolation error bounded (<~20% per bucket) across seven
# decades of latency, the same shape Prometheus client libraries and
# go-metrics' bucketed sinks use. Fixed (not per-name) boundaries keep
# observe() a branch-free bisect and make buckets aggregatable across
# processes.
DEFAULT_BOUNDS: tuple[float, ...] = tuple(
    round(1e-4 * 2 ** (i / 2.0), 10) for i in range(49)
)
DEFAULT_INTERVAL_S = 10.0
DEFAULT_RING = 6  # with 10s intervals: the last minute
QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99))


def _bucket_quantile(
    bounds: tuple, counts, total: float, q: float, vmin: float, vmax: float
) -> float:
    """Quantile estimate from bucket counts: linear interpolation inside
    the covering bucket (Prometheus histogram_quantile semantics), with
    the open-ended buckets clamped to the observed min/max so a
    single-bucket distribution reports sane values."""
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else vmax
            v = lo + (hi - lo) * ((rank - cum) / c)
            return min(max(v, vmin), vmax)
        cum += c
    return vmax


class Histogram:
    """One metric's distribution: cumulative bucket counts + a bounded
    ring of per-interval snapshots (go-metrics InmemSink shape). All
    mutation happens under the owning Registry's lock; rotated interval
    entries are immutable by construction (rotation hands off the live
    array and allocates a fresh one), so snapshot readers may share
    them without copying."""

    __slots__ = (
        "bounds", "counts", "count", "sum", "min", "max", "last",
        "interval_s", "ring",
        "cur_counts", "cur_count", "cur_sum", "cur_min", "cur_max",
        "cur_start",
    )

    def __init__(
        self, bounds: tuple, interval_s: float, ring_len: int, now: float
    ) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = inf
        self.max = -inf
        self.last = 0.0
        self.interval_s = interval_s
        # (start, end, counts, count, sum, min, max) per completed
        # interval; deque(maxlen) IS the eviction bound
        self.ring: deque = deque(maxlen=max(1, int(ring_len)))
        self._fresh_interval(now)

    def _fresh_interval(self, now: float) -> None:
        self.cur_counts = [0] * (len(self.bounds) + 1)
        self.cur_count = 0
        self.cur_sum = 0.0
        self.cur_min = inf
        self.cur_max = -inf
        self.cur_start = now

    def maybe_rotate(self, now: float) -> None:
        if now - self.cur_start < self.interval_s:
            return
        if self.cur_count:
            # end is capped at the interval boundary, not `now`: every
            # observation in this entry predates the boundary (a later
            # one would have rotated first), and a read-time rotation
            # long after traffic stopped must not stamp the stale burst
            # as just-finished (window age_s would read 0)
            self.ring.append((
                self.cur_start, self.cur_start + self.interval_s,
                self.cur_counts, self.cur_count,
                self.cur_sum, self.cur_min, self.cur_max,
            ))
        # idle gaps collapse: the next interval starts now, not on a
        # fixed grid — empty intervals are never ring entries
        self._fresh_interval(now)

    def observe(self, value: float, now: float) -> None:
        self.maybe_rotate(now)
        i = bisect_right(self.bounds, value)
        self.counts[i] += 1
        self.cur_counts[i] += 1
        self.count += 1
        self.cur_count += 1
        self.sum += value
        self.cur_sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value < self.cur_min:
            self.cur_min = value
        if value > self.cur_max:
            self.cur_max = value
        self.last = value

    # -- read side (called on copies/under lock by Registry.snapshot) --

    def raw(self, now: float) -> dict:
        """Copy of the mutable state, taken under the registry lock so
        percentile math can run outside it. Ring entries are immutable
        and shared; only the live arrays are copied.

        Rotates first (the caller holds the registry lock): rotation
        otherwise only happens inside observe(), so a metric whose
        traffic STOPPED would keep presenting its last burst as the
        live interval forever — age_s 0, 'slow now' — which is exactly
        the slow-now/slow-once confusion the window exists to kill."""
        self.maybe_rotate(now)
        win = None
        if self.cur_count:
            win = (
                self.cur_start, now, list(self.cur_counts),
                self.cur_count, self.cur_sum, self.cur_min, self.cur_max,
            )
        else:
            for entry in reversed(self.ring):
                if entry[3]:
                    win = entry
                    break
        return {
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "last": self.last,
            "window": win,
        }


def _hist_stats(bounds: tuple, raw: dict, now: float) -> dict:
    """The JSON-snapshot entry for one histogram: back-compat
    count/sum/min/max/mean/last plus cumulative and last-window
    percentiles."""
    count = raw["count"]
    vmin = raw["min"] if count else 0.0
    vmax = raw["max"] if count else 0.0
    out = {
        "count": count,
        "sum": raw["sum"],
        "min": vmin,
        "max": vmax,
        "last": raw["last"],
        "mean": raw["sum"] / count if count else 0.0,
    }
    for key, q in QUANTILES:
        out[key] = _bucket_quantile(
            bounds, raw["counts"], count, q, vmin, vmax
        )
    win = raw["window"]
    if win is not None:
        ws, we, wcounts, wcount, wsum, wmin, wmax = win
        w = {
            "count": wcount,
            "mean": wsum / wcount if wcount else 0.0,
            "min": wmin if wcount else 0.0,
            "max": wmax if wcount else 0.0,
            "age_s": round(max(0.0, now - we), 3),
            "interval_s": round(we - ws, 3),
        }
        for key, q in QUANTILES:
            w[key] = _bucket_quantile(
                bounds, wcounts, wcount, q, wmin, wmax
            )
        out["window"] = w
    return out


class Registry:
    def __init__(
        self,
        bounds: tuple = DEFAULT_BOUNDS,
        interval_s: float = DEFAULT_INTERVAL_S,
        ring: int = DEFAULT_RING,
        histograms: bool = True,
    ) -> None:
        """histograms=False keeps the pre-histogram count/sum sample
        path — the bench comparator the 0.95x throughput gate measures
        the histogram path against (tests/test_metrics.py)."""
        # Lock-wait-attributed (hostobs.TimedLock): the registry lock is
        # the process's hottest shared lock — every observe/incr from
        # every subsystem serializes here. histogram=False is REQUIRED:
        # recording a wait via metrics.observe would re-acquire this
        # very lock (self-deadlock); the wait ledger rides the
        # /v1/profile/status locks table instead. Deferred import:
        # hostobs is a leaf that lazily imports metrics back.
        from .hostobs import TimedLock

        self._lock = TimedLock(
            "metrics_registry", threading.Lock(), histogram=False
        )
        self._bounds = tuple(bounds)
        self._interval_s = max(0.01, float(interval_s))
        self._ring_len = max(1, int(ring))
        self._histograms = bool(histograms)
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        self._samples: dict[str, dict[str, float]] = {}  # legacy mode
        # raw-observation side buffers for push sinks (statsd |ms
        # timings), PER CONSUMER handle — two sinks (statsd + datadog)
        # each get every observation instead of racing one shared
        # buffer's destructive drain. Empty = off (the default):
        # observe() pays one truthiness test. Bounded per name per
        # drain interval.
        self._timing_sinks: dict[object, dict[str, list[float]]] = {}
        self._timings_cap = 256
        self._timings_dropped = 0
        # name -> stack of (handle, fn): multiple instances (in-process
        # test clusters) may register the same name; the newest wins the
        # snapshot and unregistering by handle restores the previous one
        # instead of deleting a survivor's provider.
        self._providers: dict[str, list[tuple[object, Callable]]] = {}

    # -- write side ----------------------------------------------------

    def incr(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample (e.g. a latency in seconds)."""
        with self._lock:
            if self._timing_sinks:
                for bufs in self._timing_sinks.values():
                    buf = bufs.get(name)
                    if buf is None:
                        buf = bufs[name] = []
                    if len(buf) < self._timings_cap:
                        buf.append(value)
                    else:
                        self._timings_dropped += 1
            if not self._histograms:
                s = self._samples.get(name)
                if s is None:
                    self._samples[name] = {
                        "count": 1, "sum": value, "min": value,
                        "max": value, "last": value,
                    }
                else:
                    s["count"] += 1
                    s["sum"] += value
                    s["min"] = min(s["min"], value)
                    s["max"] = max(s["max"], value)
                    s["last"] = value
                return
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(
                    self._bounds, self._interval_s, self._ring_len,
                    time.monotonic(),
                )
            h.observe(value, time.monotonic())

    def time_ns(self, name: str, ns: int) -> None:
        self.observe(name, ns / 1e9)

    def configure_windows(
        self, interval_s: Optional[float] = None, ring: Optional[int] = None
    ) -> None:
        """Operator knob (telemetry { collection_interval }): window
        width/ring depth for histograms created AFTER the call; existing
        histograms keep their interval (cheap, and windows stay
        comparable within one name's ring)."""
        with self._lock:
            if interval_s is not None:
                self._interval_s = max(0.01, float(interval_s))
            if ring is not None:
                self._ring_len = max(1, int(ring))

    # -- push-sink timing capture --------------------------------------

    def enable_timing_capture(self, cap: int = 256) -> object:
        """Register a timing consumer; returns the handle its drains
        and disable use. Each consumer sees every observation."""
        handle = object()
        with self._lock:
            self._timing_sinks[handle] = {}
            self._timings_cap = max(1, int(cap))
        return handle

    def disable_timing_capture(self, handle: object) -> None:
        with self._lock:
            self._timing_sinks.pop(handle, None)

    def drain_timings(self, handle: object) -> dict[str, list[float]]:
        """One consumer's raw observations since its last drain (push
        sinks forward them as statsd |ms timings)."""
        with self._lock:
            buf = self._timing_sinks.get(handle)
            if not buf:
                return {}
            self._timing_sinks[handle] = {}
            return buf

    def register_provider(
        self, name: str, fn: Callable[[], dict[str, float]]
    ) -> object:
        """Sample a subsystem's live stats at snapshot time. The callback
        returns {suffix: value}; published as gauges under name.suffix.
        Returns a handle for unregister_provider."""
        handle = object()
        with self._lock:
            self._providers.setdefault(name, []).append((handle, fn))
        return handle

    def unregister_provider(self, name: str, handle: object = None) -> None:
        """Remove a provider. With a handle, removes exactly that
        registration (other instances under the same name survive);
        without one, removes the newest."""
        with self._lock:
            stack = self._providers.get(name)
            if not stack:
                return
            if handle is None:
                stack.pop()
            else:
                self._providers[name] = [
                    (h, f) for h, f in stack if h is not handle
                ]
            if not self._providers[name]:
                del self._providers[name]

    # -- read side -----------------------------------------------------

    def _counters_and_gauges(self) -> tuple[dict, dict]:
        """Counters + provider-resolved gauges (shared by snapshot and
        prometheus_text so a scrape never reads the registry twice).
        Provider callbacks run OUTSIDE the lock."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            providers = {
                name: stack[-1][1]
                for name, stack in self._providers.items()
                if stack
            }
        for name, fn in providers.items():
            try:
                for suffix, value in (fn() or {}).items():
                    gauges[f"{name}.{suffix}"] = value
            except Exception:
                gauges[f"{name}.error"] = 1
        return counters, gauges

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            raws = {
                name: h.raw(now) for name, h in self._hists.items()
            }
            legacy = {k: dict(v) for k, v in self._samples.items()}
        counters, gauges = self._counters_and_gauges()
        samples = {
            name: _hist_stats(self._bounds, raw, now)
            for name, raw in raws.items()
        }
        for s in legacy.values():
            s["mean"] = s["sum"] / s["count"] if s["count"] else 0.0
        samples.update(legacy)
        return {
            "uptime_seconds": round(time.time() - _START, 3),
            "counters": counters,
            "gauges": gauges,
            "samples": samples,
        }

    def histogram_raw(self, name: str) -> Optional[dict]:
        """Bucket-level view of one histogram (bench/test introspection):
        {bounds, counts, count, sum, min, max, window}."""
        now = time.monotonic()
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            raw = h.raw(now)
        raw["bounds"] = list(self._bounds)
        return raw

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format (0.0.4) —
        what a stock Prometheus scrapes from /v1/metrics?format=prometheus
        (reference: command/agent/command.go:979-1036 wires a prometheus
        sink beside the inmem one).

        counters → <name>_total counter; gauges → gauge; histograms →
        real histogram exposition (_bucket{le=...} cumulative counts,
        _sum, _count) with min/max/last as companion gauges. Bucket
        lines are trimmed past the first bound covering the observed
        max (every higher bucket holds the same cumulative count) —
        +Inf always closes the series."""
        now = time.monotonic()
        with self._lock:
            raws = {n: h.raw(now) for n, h in self._hists.items()}
            legacy = {k: dict(v) for k, v in self._samples.items()}
        counters, gauges = self._counters_and_gauges()
        lines: list[str] = []

        def emit(name: str, kind: str, value: float) -> None:
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {_prom_value(value)}")

        emit(
            "nomad_uptime_seconds", "gauge",
            round(time.time() - _START, 3),
        )
        for name, v in sorted(counters.items()):
            emit(_prom_name(name) + "_total", "counter", v)
        for name, v in sorted(gauges.items()):
            emit(_prom_name(name), "gauge", v)
        for name, raw in sorted(raws.items()):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            vmax = raw["max"] if raw["count"] else 0.0
            for i, bound in enumerate(self._bounds):
                cum += raw["counts"][i]
                lines.append(
                    f'{n}_bucket{{le="{_prom_le(bound)}"}} {cum}'
                )
                if bound >= vmax:
                    break
            lines.append(f'{n}_bucket{{le="+Inf"}} {raw["count"]}')
            lines.append(f"{n}_sum {_prom_value(raw['sum'])}")
            lines.append(f"{n}_count {_prom_value(raw['count'])}")
            for stat in ("min", "max", "last"):
                v = raw[stat]
                if v in (inf, -inf):
                    v = 0.0
                emit(f"{n}_{stat}", "gauge", v)
        for name, s in sorted(legacy.items()):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_sum {_prom_value(s['sum'])}")
            lines.append(f"{n}_count {_prom_value(s['count'])}")
            for stat in ("min", "max", "last"):
                emit(f"{n}_{stat}", "gauge", s[stat])
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Test helper: forget everything (providers included)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._samples.clear()
            self._providers.clear()
            self._timing_sinks.clear()


_global = Registry()


def registry() -> Registry:
    return _global


# Module-level conveniences: the hot paths call these directly (via
# `metrics.observe(...)` — an attribute lookup per call, which is what
# lets _install_registry swap the backing registry for tests/benches).
incr = _global.incr
set_gauge = _global.set_gauge
observe = _global.observe
time_ns = _global.time_ns
register_provider = _global.register_provider
unregister_provider = _global.unregister_provider
snapshot = _global.snapshot
prometheus_text = _global.prometheus_text


def _install_registry(reg: Registry) -> Registry:
    """Swap the process-global registry (returns the previous one).
    Test/bench hook: every call site reads `metrics.<fn>` through the
    module at call time, so rebinding here retargets them all — the
    histogram-vs-sample throughput comparator swaps a legacy-mode
    Registry in with this."""
    global _global, incr, set_gauge, observe, time_ns
    global register_provider, unregister_provider, snapshot, prometheus_text
    old = _global
    _global = reg
    incr = reg.incr
    set_gauge = reg.set_gauge
    observe = reg.observe
    time_ns = reg.time_ns
    register_provider = reg.register_provider
    unregister_provider = reg.unregister_provider
    snapshot = reg.snapshot
    prometheus_text = reg.prometheus_text
    return old


import re as _re


def _prom_name(name: str) -> str:
    out = _re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _prom_le(bound: float) -> str:
    """le label: shortest stable decimal (Prometheus compares le labels
    as strings across scrapes, so formatting must be deterministic)."""
    return f"{bound:.10g}"


class StatsdSink:
    """Push-mode telemetry: periodically emits the registry to a statsd
    daemon over UDP (reference: command/agent/command.go:1002 wires
    statsd_address into a go-metrics fanout sink).

    gauges ride as |g; counters as |c DELTAS since the last push (statsd
    counters are rate-counters, so a monotonic total must be
    differenced); histogram observations as |ms timings (milliseconds —
    drained from the registry's bounded raw-capture buffer, so the
    daemon aggregates real per-observation values, not re-bucketed
    approximations), with per-name count/sum gauges kept for dashboards
    that rate() them."""

    def __init__(self, address: str, interval_s: float = 10.0,
                 reg: Optional[Registry] = None) -> None:
        import socket

        host, sep, port = address.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"statsd_address must be host:port, got {address!r}"
            )
        self.addr = (host.strip("[]") or "127.0.0.1", int(port))
        # a zero/negative interval would busy-loop the sink thread
        self.interval_s = max(1.0, float(interval_s))
        self.reg = reg or _global
        self._timing_handle = self.reg.enable_timing_capture()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._last_counters: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="statsd-sink"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # a stopped sink must not leave the registry capturing raw
        # observations nobody will ever drain
        self.reg.disable_timing_capture(self._timing_handle)
        if self._thread:
            self._thread.join(timeout=2)
        self._sock.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push_once()
            except OSError:
                pass  # daemon away; keep trying

    def _decorate(self, line: str) -> str:
        """Per-line hook for dialect extensions (DogStatsD tags)."""
        return line

    def push_once(self) -> int:
        snap = self.reg.snapshot()
        lines: list[str] = []
        for name, v in snap["counters"].items():
            delta = v - self._last_counters.get(name, 0)
            self._last_counters[name] = v
            if delta:
                lines.append(self._decorate(
                    f"{_prom_name(name)}:{_prom_value(delta)}|c"))
        for name, v in snap["gauges"].items():
            lines.append(self._decorate(
                f"{_prom_name(name)}:{_prom_value(v)}|g"))
        for name, s in snap["samples"].items():
            n = _prom_name(name)
            lines.append(self._decorate(
                f"{n}.count:{_prom_value(s['count'])}|g"))
            lines.append(self._decorate(
                f"{n}.sum:{_prom_value(s['sum'])}|g"))
        # raw observations since the last push, as timings (seconds ->
        # milliseconds per the statsd convention)
        for name, values in self.reg.drain_timings(
            self._timing_handle
        ).items():
            n = _prom_name(name)
            for v in values:
                lines.append(self._decorate(f"{n}:{v * 1000:.3f}|ms"))
        sent = 0
        buf: list[str] = []
        size = 0
        for line in lines:
            if size + len(line) > 1400 and buf:  # stay under typical MTU
                self._sock.sendto("\n".join(buf).encode(), self.addr)
                sent += len(buf)
                buf, size = [], 0
            buf.append(line)
            size += len(line) + 1
        if buf:
            self._sock.sendto("\n".join(buf).encode(), self.addr)
            sent += len(buf)
        return sent


class DatadogSink(StatsdSink):
    """DogStatsD flavor of the statsd push (reference:
    command/agent/command.go:1010 wires datadog_address into a
    datadog.NewDogStatsdSink): same wire protocol plus |#tag:value
    annotations. Constant tags (node name, region, datacenter) ride on
    every metric, which is how the reference's DogStatsd sink attaches
    its host tags."""

    def __init__(self, address: str, interval_s: float = 10.0,
                 reg: Optional[Registry] = None,
                 tags: Optional[dict] = None) -> None:
        super().__init__(address, interval_s, reg)
        self._suffix = ""
        if tags:
            joined = ",".join(f"{k}:{v}" for k, v in sorted(tags.items()))
            self._suffix = f"|#{joined}"

    def _decorate(self, line: str) -> str:
        return line + self._suffix
