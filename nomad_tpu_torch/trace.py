"""Eval-lifecycle tracing: spans from broker enqueue to raft apply.

Port of ``nomad_tpu/trace.py``.

Reference intent: the observability layer every production orchestrator
grows (the reference ships go-metrics timers per subsystem; OpenTelemetry
spans are the shape modern stacks use) — per-request spans with context
propagation, so the wall time of one evaluation can be decomposed across
broker wait → worker solve → device round-trip → plan queue → verify →
raft apply without hand-wired stage timers.

Design:

  * ``Span`` — name, start/end (monotonic ns), parent link, attrs.
  * ``TraceContext`` — one trace: a root span plus children appended from
    any thread (per-context lock). A per-context *thread-local* active-
    span stack gives automatic parenting: ``ctx.span("x")`` nested inside
    ``ctx.span("y")`` becomes its child, and pre-timed stages recorded via
    :func:`stage` attach to whatever span the recording thread has open.
  * ``TraceRecorder`` — bounded ring buffer of finished traces (the
    server's ``/v1/traces`` surface reads it; ``operator trace`` renders
    it). Drops-oldest on overflow; counters ride the metrics registry.
  * context propagation — a thread-local *current* context
    (:func:`current`/:func:`use`) carries the trace through call chains;
    the RPC fabric forwards ``{"id", "parent"}`` in the request envelope
    and returns the remote segment's spans in the response, so a trace
    stitches client-submit on a follower to raft-apply on the leader
    (rpc/client.py + rpc/server.py).

Zero-allocation no-op path: tracing is OFF by default. When disabled,
:func:`start_trace` returns ``None``, :func:`span` returns a module-level
singleton no-op context manager, and :func:`stage` is a dict lookup + two
attribute reads — nothing is allocated and nothing is locked, so the
solver/broker hot paths pay only a predictable handful of instructions.

Clocks: spans use ``time.monotonic_ns`` (never wall time — NTP steps
would corrupt durations). Remote segments carry their own monotonic base;
the RPC client re-bases merged spans onto the local call span's start, so
a stitched tree renders consistently (absolute cross-host alignment is
not claimed, only per-segment durations).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "Span",
    "TraceContext",
    "TraceRecorder",
    "configure",
    "critical_path",
    "current",
    "enabled",
    "finished_traces",
    "prune_thread_spans",
    "recorder",
    "self_times",
    "set_current",
    "set_enabled",
    "span",
    "stack_self_times",
    "stage",
    "stage_attrs",
    "start_trace",
    "thread_spans",
    "use",
]

now_ns = time.monotonic_ns

# module flag, read without a lock (GIL-atomic; flips are rare operator
# actions — agent config / SIGHUP reload / tests)
_enabled = False

# thread ident -> name of that thread's INNERMOST open (stack-parented)
# span — the host profiler's span-correlation feed (hostobs.py
# attributes each wall-clock sample to thread-role x active span). Plain
# dict mutated with GIL-atomic single-key stores/pops from the owning
# thread only; the sampler reads other threads' entries racily, which
# for a statistical profiler only ever mis-attributes the one sample
# straddling a span boundary. Detached spans (opened on one thread,
# ended on another) never touch it — they are not stack-parented and do
# not represent the opener's current work.
_thread_spans: dict[int, str] = {}


def thread_spans() -> dict[int, str]:
    """Live thread-ident -> active-span-name map (see above). The dict
    object is stable for the process lifetime; callers hold the
    reference and .get() per sample."""
    return _thread_spans


def prune_thread_spans(live_idents) -> None:
    """Drop entries for dead threads (a thread that exited with a span
    still open leaks its entry; the host profiler prunes against the
    idents it actually sampled)."""
    for tid in [t for t in _thread_spans if t not in live_idents]:
        _thread_spans.pop(tid, None)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


class Span:
    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns", "attrs")

    def __init__(
        self,
        name: str,
        span_id: str,
        parent_id: str = "",
        start_ns: int = 0,
        end_ns: int = 0,
        attrs: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.attrs = attrs

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    def to_wire(self) -> dict:
        d = {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "start": self.start_ns,
            "end": self.end_ns,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @staticmethod
    def from_wire(d: dict) -> "Span":
        return Span(
            d.get("name", ""),
            d.get("id", ""),
            d.get("parent", ""),
            int(d.get("start", 0)),
            int(d.get("end", 0)),
            d.get("attrs") or None,
        )


class _SpanHandle:
    """Context-manager handle for an open span (ends it on exit)."""

    __slots__ = ("_ctx", "_span")

    def __init__(self, ctx: "TraceContext", span: Span) -> None:
        self._ctx = ctx
        self._span = span

    @property
    def span(self) -> Span:
        return self._span

    def set_attr(self, key: str, value) -> None:
        if self._span.attrs is None:
            self._span.attrs = {}
        self._span.attrs[key] = value

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.set_attr("error", exc_type.__name__)
        self._ctx.end_span(self._span)


class _NoopSpan:
    """Singleton no-op: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set_attr(self, key, value):
        return None

    span = None


NOOP_SPAN = _NoopSpan()


class TraceContext:
    """One trace: a root span plus concurrently-appended children."""

    __slots__ = (
        "trace_id",
        "name",
        "attrs",
        "spans",
        "root",
        "remote",
        "_lock",
        "_seq",
        "_prefix",
        "_active",
        "_finished",
    )

    def __init__(
        self,
        name: str,
        trace_id: str = "",
        attrs: Optional[dict] = None,
        parent_id: str = "",
        remote: bool = False,
    ) -> None:
        # pooled ids (structs.generate_uuid): a fresh urandom syscall
        # per trace measured ~0.14ms on the bench box — real overhead
        # against the 0.95x enabled-throughput gate
        from .structs import generate_uuid

        uid = generate_uuid().replace("-", "")
        self.trace_id = trace_id or uid[:16]
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        # span-id prefix unique per context so merged remote segments
        # can never collide with local counter-derived ids
        self._prefix = uid[16:24]
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self.remote = remote
        self._finished = False
        # per-THREAD active-span stack: stages recorded by the solve
        # thread parent under the solve thread's open span while the
        # commit thread's stages parent under its own — no cross-talk.
        self._active = threading.local()
        self.root = Span(
            name, f"{self._prefix}-0", parent_id, now_ns(), 0, None
        )
        self.spans: list[Span] = [self.root]

    # -- span lifecycle ------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._active, "stack", None)
        if st is None:
            st = self._active.stack = []
        return st

    def _parent_id(self) -> str:
        st = self._stack()
        return st[-1].span_id if st else self.root.span_id

    def start_span(
        self,
        name: str,
        parent: Optional[Span] = None,
        detached: bool = False,
        **attrs,
    ) -> Span:
        """detached=True skips the active-span stack: for spans opened on
        one thread and ended on another (the broker's queue-wait span),
        where stack discipline would mis-parent the opener's later
        spans."""
        pid = parent.span_id if parent is not None else self._parent_id()
        # lock-free: next() on the shared counter and list.append are
        # both GIL-atomic, and readers (to_wire) snapshot the list —
        # span creation is the enabled path's hottest op (~35us with a
        # lock on the bench box, against the 0.95x throughput gate)
        s = Span(
            name, f"{self._prefix}-{next(self._seq)}", pid,
            now_ns(), 0, attrs or None,
        )
        self.spans.append(s)
        if not detached:
            self._stack().append(s)
            # host-profiler span correlation: one GIL-atomic dict store
            _thread_spans[threading.get_ident()] = name
        return s

    def end_span(self, s: Span) -> None:
        s.end_ns = now_ns()
        st = self._stack()
        if st and st[-1] is s:
            st.pop()
        elif s in st:  # out-of-order end (defensive)
            st.remove(s)
        else:
            return  # detached span: never on the profiler registry
        tid = threading.get_ident()
        if st:
            _thread_spans[tid] = st[-1].name
        elif getattr(_tls, "ctx", None) is self:
            # back to the root: the thread still runs under this trace
            _thread_spans[tid] = self.name
        else:
            _thread_spans.pop(tid, None)

    def span(
        self, name: str, parent: Optional[Span] = None, **attrs
    ) -> _SpanHandle:
        return _SpanHandle(self, self.start_span(name, parent=parent, **attrs))

    def add_span(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        parent: Optional[Span] = None,
        attrs: Optional[dict] = None,
    ) -> Span:
        """Record an already-timed span (stage timers become spans)."""
        pid = parent.span_id if parent is not None else self._parent_id()
        s = Span(
            name, f"{self._prefix}-{next(self._seq)}", pid,
            start_ns, end_ns, attrs,
        )
        self.spans.append(s)
        return s

    def add_stage(
        self, name: str, dur_ns: int, attrs: Optional[dict] = None
    ) -> Span:
        """A stage measured as a duration ending now. Marked pretimed:
        the recording thread's active-span stack never held it, so the
        host profiler attributed those samples to the ENCLOSING span —
        :func:`stack_self_times` needs to tell the two apart."""
        end = now_ns()
        attrs = dict(attrs) if attrs else {}
        attrs.setdefault("pretimed", 1)
        return self.add_span(
            name, end - max(0, int(dur_ns)), end, attrs=attrs
        )

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def merge_remote(self, spans: list[dict], anchor: Optional[Span]) -> None:
        """Fold a remote segment's spans in, re-based so the segment root
        starts at `anchor` (the local rpc.call span) — remote monotonic
        clocks share no base with ours, but durations are trustworthy."""
        if not spans:
            return
        decoded = [Span.from_wire(d) for d in spans]
        # the segment root is the span whose parent is not in the segment
        ids = {s.span_id for s in decoded}
        root = next((s for s in decoded if s.parent_id not in ids), decoded[0])
        shift = (anchor.start_ns if anchor is not None else now_ns()) - root.start_ns
        for s in decoded:
            s.start_ns += shift
            s.end_ns += shift
            if s is root and anchor is not None:
                s.parent_id = anchor.span_id
            self.spans.append(s)

    def finish(self, status: str = "ok", record: bool = True) -> None:
        """End the root span and (idempotently) hand the trace to the
        global recorder's ring buffer."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        if not self.root.end_ns:
            self.root.end_ns = now_ns()
        self.attrs.setdefault("status", status)
        if record and not self.remote:
            recorder().record(self)
            _finished.append(self)

    # -- wire ----------------------------------------------------------

    def to_wire(self) -> dict:
        # snapshot first: spans may still be appended concurrently
        spans = [s.to_wire() for s in list(self.spans)]
        end = self.root.end_ns or now_ns()
        return {
            "id": self.trace_id,
            "name": self.name,
            "attrs": dict(self.attrs),
            "start": self.root.start_ns,
            "end": end,
            "duration_ms": round((end - self.root.start_ns) / 1e6, 3),
            "spans": spans,
        }


# -- bounded ring buffer of finished traces -----------------------------


class TraceRecorder:
    def __init__(self, max_traces: int = 256) -> None:
        self._lock = threading.Lock()
        self.max_traces = max_traces
        # trace_id -> wire dict, insertion-ordered (oldest first)
        self._ring: dict[str, dict] = {}
        self.recorded = 0
        self.dropped = 0

    def configure(self, max_traces: int) -> None:
        with self._lock:
            self.max_traces = max(1, int(max_traces))
            while len(self._ring) > self.max_traces:
                self._evict_one_locked()

    def record(self, ctx: TraceContext) -> None:
        wire = ctx.to_wire()
        from . import metrics

        with self._lock:
            # same-id segments merge (a retried eval finishes twice, a
            # forwarded trace lands leader-side too): newest wins the
            # metadata, spans concatenate
            prev = self._ring.pop(ctx.trace_id, None)
            if prev is not None:
                wire["spans"] = prev["spans"] + wire["spans"]
                wire["start"] = min(wire["start"], prev["start"])
                wire["end"] = max(wire["end"], prev["end"])
                # duration must track the MERGED window, not the last
                # segment's own (a redelivered eval finishes twice)
                wire["duration_ms"] = round(
                    (wire["end"] - wire["start"]) / 1e6, 3
                )
            self._ring[ctx.trace_id] = wire
            self.recorded += 1
            while len(self._ring) > self.max_traces:
                self._evict_one_locked()
        metrics.incr("nomad.trace.recorded")

    def _evict_one_locked(self) -> None:
        """Drop the oldest trace of the MOST POPULATED trace name: a
        chatty name (per-write `http` traces under a job-update loop)
        must not flush the last `eval`/`tpu.batch` traces — the ones
        the surface exists to debug — out of the ring. With all names
        equally represented this degrades to plain drop-oldest."""
        counts: dict[str, int] = {}
        for t in self._ring.values():
            counts[t["name"]] = counts.get(t["name"], 0) + 1
        top = max(counts, key=counts.get)  # ties: oldest-inserted name
        victim = next(
            k for k, t in self._ring.items() if t["name"] == top
        )
        self._ring.pop(victim)
        self.dropped += 1

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            t = self._ring.get(trace_id)
            return dict(t) if t is not None else None

    def list(
        self,
        name: str = "",
        eval_id: str = "",
        job_id: str = "",
        limit: int = 50,
    ) -> list[dict]:
        """Newest-first summaries (no spans), filterable by trace name or
        eval/job id attrs (batch traces list eval ids in attrs)."""
        with self._lock:
            traces = list(self._ring.values())
        out = []
        for t in reversed(traces):
            a = t.get("attrs", {})
            if name and t.get("name") != name:
                continue
            if eval_id and eval_id != a.get("eval_id") and (
                eval_id not in (a.get("eval_ids") or ())
            ):
                continue
            if job_id and job_id != a.get("job_id") and (
                job_id not in (a.get("job_ids") or ())
            ):
                continue
            out.append(
                {
                    "id": t["id"],
                    "name": t["name"],
                    "attrs": a,
                    "start": t["start"],
                    "end": t["end"],
                    "duration_ms": t.get("duration_ms"),
                    "num_spans": len(t.get("spans", ())),
                }
            )
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._ring),
                "recorded": self.recorded,
                "dropped": self.dropped,
                "max": self.max_traces,
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_recorder = TraceRecorder()
_recorder_metrics_handle = None

# The finished contexts themselves, newest last, beside the recorder's
# wire ring: a harness that sums one batch's spans reads them without a
# decode (bounded; a context's spans stay live until it is evicted).
_finished: "deque[TraceContext]" = deque(maxlen=4096)


def finished_traces() -> list[TraceContext]:
    """The finished traces still in the ring, oldest first."""
    return list(_finished)


def clear_finished() -> None:
    _finished.clear()


def recorder() -> TraceRecorder:
    return _recorder


def configure(max_traces: Optional[int] = None, enabled_: Optional[bool] = None) -> None:
    """Operator knob application (agent config / SIGHUP reload)."""
    global _recorder_metrics_handle
    if max_traces is not None:
        _recorder.configure(max_traces)
    if enabled_ is not None:
        set_enabled(enabled_)
    if _recorder_metrics_handle is None:
        from . import metrics

        _recorder_metrics_handle = metrics.register_provider(
            "nomad.trace", lambda: {
                k: float(v) for k, v in _recorder.stats().items()
            }
        )


# -- thread-local current context ---------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    # host-profiler span correlation: with no child span open yet, the
    # thread's work belongs to the trace ROOT (a solve running under
    # `use(ctx)` before any stage span opens must attribute to
    # "tpu.batch"/"bench.batch", not "-")
    tid = threading.get_ident()
    if ctx is None:
        _thread_spans.pop(tid, None)
    else:
        st = ctx._stack()
        _thread_spans[tid] = st[-1].name if st else ctx.name
    return prev


class _Use:
    """`with use(ctx):` — install ctx as the thread's current context.
    Re-entrant and cheap; ctx may be None (no-op)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]) -> None:
        self._ctx = ctx
        self._prev = None

    def __enter__(self) -> Optional[TraceContext]:
        if self._ctx is not None:
            self._prev = set_current(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._ctx is not None:
            set_current(self._prev)


def use(ctx: Optional[TraceContext]) -> _Use:
    return _Use(ctx)


# -- hot-path helpers ----------------------------------------------------


def start_trace(name: str, **attrs) -> Optional[TraceContext]:
    """New trace when tracing is enabled; None (the no-op path) when not."""
    if not _enabled:
        return None
    return TraceContext(name, attrs=attrs)


def span(
    ctx: Optional[TraceContext],
    name: str,
    parent: Optional[Span] = None,
    **attrs,
):
    """Open a child span on ctx, or the singleton no-op when ctx is None."""
    if ctx is None:
        return NOOP_SPAN
    return ctx.span(name, parent=parent, **attrs)


def stage(name: str, dur_ns: int) -> None:
    """Record a pre-timed stage onto the CURRENT context, if any — the
    solver's existing stage timers become spans through this single
    call, and the disabled path is one flag test + one getattr."""
    if not _enabled:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.add_stage(name, dur_ns)


def stage_attrs(name: str, dur_ns: int, **attrs) -> None:
    """:func:`stage` with span attributes — the solver-observability
    spans (solver.compile carries the kernel + shape signature,
    solver.transfer the direction + byte count). Same no-op discipline:
    one flag test + one getattr when tracing is off."""
    if not _enabled:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.add_stage(name, dur_ns, attrs=attrs)


# -- wire helpers for the RPC envelope -----------------------------------
# (the envelope FIELD NAMES live in rpc/wire.py TRACE_KEY/TRACE_SPANS_KEY,
# beside the rest of the framing constants — one source of truth)


def wire_ref(ctx: TraceContext, parent: Optional[Span] = None) -> dict:
    return {
        "id": ctx.trace_id,
        "parent": parent.span_id if parent is not None else ctx.root.span_id,
    }


def open_segment(name: str, ref: dict) -> TraceContext:
    """Server side of an RPC hop: a remote segment of the caller's trace.
    Its spans travel back in the response; it never lands in the local
    ring (the originator owns the stitched trace)."""
    return TraceContext(
        name,
        trace_id=str(ref.get("id", "")),
        parent_id=str(ref.get("parent", "")),
        remote=True,
    )


# -- analysis: span trees, self-times, critical path ---------------------


def _interval_union_ns(intervals: list[tuple[int, int]]) -> int:
    """Total ns covered by the union of [start, end) intervals."""
    total = 0
    last_end = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if last_end is None or s >= last_end:
            total += e - s
            last_end = e
        elif e > last_end:
            total += e - last_end
            last_end = e
    return total


def children_of(trace: dict) -> dict[str, list[dict]]:
    """parent span id -> [child span wire dicts], stable span order."""
    kids: dict[str, list[dict]] = {}
    for s in trace.get("spans", ()):
        if s.get("parent"):
            kids.setdefault(s["parent"], []).append(s)
    return kids


def trace_roots(trace: dict) -> list[dict]:
    ids = {s["id"] for s in trace.get("spans", ())}
    return [
        s for s in trace.get("spans", ()) if s.get("parent", "") not in ids
    ]


def self_times(trace: dict) -> dict[str, int]:
    """Span name -> total SELF time ns across the trace: duration minus
    the union of child intervals (union, not sum — pipelined children
    overlap and a plain sum would go negative)."""
    kids = children_of(trace)
    out: dict[str, int] = {}
    for s in trace.get("spans", ()):
        dur = max(0, s["end"] - s["start"])
        child_cover = _interval_union_ns(
            [
                (max(c["start"], s["start"]), min(c["end"], s["end"]))
                for c in kids.get(s["id"], ())
            ]
        )
        out[s["name"]] = out.get(s["name"], 0) + max(0, dur - child_cover)
    return out


def stack_self_times(trace: dict) -> dict[str, int]:
    """:func:`self_times` over the STACK-PARENTED spans only: pre-timed
    stage spans (``add_stage`` — host_prep, readback, materialize, the
    solver.compile/transfer attributions) are dropped before the child-
    interval subtraction. This is the trace-side quantity comparable to
    the host profiler's span attribution: a sampler attributes the
    wall time of a pre-timed stage to the span the recording thread had
    OPEN (the stage never pushed the stack), so plain self_times — which
    subtracts the stage from its parent — would disagree with the
    profiler by exactly the stage's duration (bench span-agreement,
    docs/profiling.md)."""
    spans = [
        s for s in trace.get("spans", ())
        if not (s.get("attrs") or {}).get("pretimed")
    ]
    return self_times({**trace, "spans": spans})


def coverage(trace: dict) -> float:
    """Fraction of the root span's wall time covered by the union of its
    direct children — the 'named spans account for X% of wall time'
    metric the e2e acceptance gate checks."""
    roots = trace_roots(trace)
    if not roots:
        return 0.0
    root = roots[0]
    dur = max(1, root["end"] - root["start"])
    kids = children_of(trace).get(root["id"], ())
    covered = _interval_union_ns(
        [
            (max(c["start"], root["start"]), min(c["end"], root["end"]))
            for c in kids
        ]
    )
    return covered / dur


def critical_path(traces: list[dict], top: int = 5) -> list[tuple[str, int]]:
    """Top span names by total self-time across the given traces — the
    'where does wall time actually go' summary `operator trace` prints."""
    totals: dict[str, int] = {}
    for t in traces:
        for name, ns in self_times(t).items():
            totals[name] = totals.get(name, 0) + ns
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def render_tree(trace: dict) -> str:
    """ASCII span tree with durations and self-times (CLI + tests)."""
    kids = children_of(trace)
    selfs = self_times(trace)
    lines: list[str] = []
    dur_ms = trace.get("duration_ms")
    header = (
        f"TRACE {trace['id']} {trace.get('name', '')} "
        f"{dur_ms if dur_ms is not None else '?'}ms"
    )
    attrs = trace.get("attrs") or {}
    if attrs:
        compact = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        header += f"  [{compact}]"
    lines.append(header)

    def walk(s: dict, prefix: str, last: bool) -> None:
        dur = (s["end"] - s["start"]) / 1e6
        own = [
            c for c in kids.get(s["id"], ())
        ]
        # per-span self time: duration minus union of ITS children
        cover = _interval_union_ns(
            [
                (max(c["start"], s["start"]), min(c["end"], s["end"]))
                for c in own
            ]
        )
        self_ms = max(0, (s["end"] - s["start"]) - cover) / 1e6
        branch = "└─ " if last else "├─ "
        extra = ""
        shown = {
            k: v for k, v in (s.get("attrs") or {}).items()
            if k != "pretimed"  # bookkeeping marker, not operator signal
        }
        if shown:
            extra = "  " + " ".join(
                f"{k}={v}" for k, v in sorted(shown.items())
            )
        lines.append(
            f"{prefix}{branch}{s['name']:<24} {dur:9.3f}ms"
            f"  (self {self_ms:.3f}ms){extra}"
        )
        child_prefix = prefix + ("   " if last else "│  ")
        for i, c in enumerate(own):
            walk(c, child_prefix, i == len(own) - 1)

    roots = trace_roots(trace)
    for i, r in enumerate(roots):
        walk(r, "", i == len(roots) - 1)
    if selfs:
        lines.append("")
        lines.append("top self-time:")
        for name, ns in critical_path([trace], top=5):
            lines.append(f"  {name:<28} {ns / 1e6:9.3f}ms")
    return "\n".join(lines)
