"""In-process metrics registry.

Reference: command/agent/command.go:979 setupTelemetry (go-metrics
InmemSink behind /v1/metrics) and the per-eval latencies the workers
emit.

One process-global registry with three primitives:

  * counters    (monotonic; incr)
  * gauges      (last value; set_gauge)
  * histograms  (observe: fixed-boundary exponential buckets + count/sum/
                 min/max/last, with a ring of per-interval snapshots so a
                 snapshot answers both "p99 since boot" and "p99 right
                 now")

plus providers: callbacks a subsystem registers (register_provider) and
a snapshot samples as gauges.

Everything is threadsafe and cheap enough for hot paths: an observe is a
bucket index (bisect over ~50 precomputed bounds) plus bounded array
increments under the registry lock. Percentiles are computed at SNAPSHOT
time from the bucket counts, never on the write path.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque
from math import inf

_START = time.time()

# Fixed exponential boundaries (seconds): 100us .. ~1678s at factor
# sqrt(2) — ~49 buckets plus +Inf. Exponential spacing keeps relative
# quantile-interpolation error bounded (<~20% per bucket) across seven
# decades of latency.
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
    ) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)
        self._interval_s = max(0.01, float(interval_s))
        self._ring_len = max(1, int(ring))
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        # name -> [(handle, fn)]: subsystems sampled at snapshot time
        # (the newest registration under a name is the live one, so a
        # restarted subsystem's stale provider never shadows it)
        self._providers: dict[str, list] = {}

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
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(
                    self._bounds, self._interval_s, self._ring_len,
                    time.monotonic(),
                )
            h.observe(value, time.monotonic())

    def time_ns(self, name: str, ns: int) -> None:
        self.observe(name, ns / 1e9)

    def register_provider(self, name: str, fn) -> object:
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

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            raws = {
                name: h.raw(now) for name, h in self._hists.items()
            }
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            providers = {
                name: stack[-1][1]
                for name, stack in self._providers.items() if stack
            }
        # provider callbacks run OUTSIDE the lock: they may take their
        # own subsystem's locks
        for name, fn in providers.items():
            try:
                for suffix, value in (fn() or {}).items():
                    gauges[f"{name}.{suffix}"] = value
            except Exception:
                gauges[f"{name}.error"] = 1
        return {
            "uptime_seconds": round(time.time() - _START, 3),
            "counters": counters,
            "gauges": gauges,
            "samples": {
                name: _hist_stats(self._bounds, raw, now)
                for name, raw in raws.items()
            },
        }

    def reset(self) -> None:
        """Test helper: forget everything."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._providers.clear()


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
snapshot = _global.snapshot
register_provider = _global.register_provider
unregister_provider = _global.unregister_provider


def _install_registry(reg: Registry) -> Registry:
    """Swap the process-global registry (returns the previous one).
    Every call site reads `metrics.<fn>` through the module at call
    time, so rebinding here retargets them all."""
    global _global, incr, set_gauge, observe, time_ns, snapshot
    global register_provider, unregister_provider
    old = _global
    _global = reg
    incr = reg.incr
    set_gauge = reg.set_gauge
    observe = reg.observe
    time_ns = reg.time_ns
    snapshot = reg.snapshot
    register_provider = reg.register_provider
    unregister_provider = reg.unregister_provider
    return old
