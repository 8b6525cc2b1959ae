"""Eval-lifecycle tracing: pre-timed solver stages as spans.

The batch solver times its stages (reconcile, host_prep, device.wait,
readback, materialize, plan.assemble) and hands each duration to
:func:`stage`. When tracing is on and the calling thread has a current
trace (:func:`use`), the stage becomes a child span of that trace;
otherwise the call is one flag test.

  * ``Span`` — name, start/end (monotonic ns), parent link, attrs.
  * ``TraceContext`` — one trace: a root span plus children appended from
    any thread; :func:`span` opens a timed child span around a block,
    and a finished trace lands in a bounded ring
    (:func:`finished_traces`).
  * a thread-local *current* context (:func:`current`/:func:`use`)
    carries the trace through call chains;
  * across an RPC hop the caller sends :func:`wire_ref`, the handler
    records into :func:`open_segment`, and the segment's spans ride
    back in the reply for :meth:`TraceContext.merge_remote`.

Tracing is OFF by default: :func:`start_trace` returns ``None`` and
:func:`stage` allocates nothing. Spans use ``time.monotonic_ns`` (never
wall time — NTP steps would corrupt durations).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

now_ns = time.monotonic_ns

# module flag, read without a lock (GIL-atomic; flips are rare)
_enabled = False


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
    """One trace: a root span plus concurrently-appended children.

    Spans opened with :meth:`span` nest on a per-thread active stack: the
    solve thread's stages parent under its own open span while the commit
    thread's parent under its own. Pre-timed stages (:meth:`add_stage`)
    parent under the recording thread's innermost open span, or the
    root."""

    __slots__ = ("trace_id", "name", "attrs", "spans", "root", "remote",
                 "_prefix", "_seq", "_lock", "_active", "_finished")

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 trace_id: str = "", parent_id: str = "",
                 remote: bool = False) -> None:
        from .structs import generate_uuid

        uid = generate_uuid().replace("-", "")
        self.trace_id = trace_id or uid[:16]
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        # span ids are unique per context, so a remote segment merged
        # into its caller's trace never collides with the caller's ids
        self._prefix = uid[16:24]
        self.remote = remote
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._active = threading.local()
        self._finished = False
        self.root = Span(name, f"{self._prefix}-0", parent_id, now_ns(), 0,
                         None)
        # list.append and next() on the counter are GIL-atomic: children
        # may be appended from any thread without a lock
        self.spans: list[Span] = [self.root]

    def _stack(self) -> list:
        st = getattr(self._active, "stack", None)
        if st is None:
            st = self._active.stack = []
        return st

    def _parent_id(self) -> str:
        st = self._stack()
        return st[-1].span_id if st else self.root.span_id

    def start_span(self, name: str, parent: Optional[Span] = None,
                   detached: bool = False, **attrs) -> Span:
        """Open a child span. detached=True skips the active-span stack:
        for spans opened on one thread and ended on another (the
        broker's queue-wait span)."""
        pid = parent.span_id if parent is not None else self._parent_id()
        s = Span(name, f"{self._prefix}-{next(self._seq)}", pid,
                 now_ns(), 0, attrs or None)
        self.spans.append(s)
        if not detached:
            self._stack().append(s)
        return s

    def end_span(self, s: Span) -> None:
        s.end_ns = now_ns()
        st = self._stack()
        if st and st[-1] is s:
            st.pop()
        elif s in st:  # out-of-order end (defensive)
            st.remove(s)

    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> _SpanHandle:
        return _SpanHandle(self, self.start_span(name, parent=parent, **attrs))

    def add_stage(
        self, name: str, dur_ns: int, attrs: Optional[dict] = None
    ) -> Span:
        """A stage measured as a duration ending now, parented on the
        thread's innermost open span (or the root)."""
        end = now_ns()
        s = Span(
            name, f"{self._prefix}-{next(self._seq)}", self._parent_id(),
            end - max(0, int(dur_ns)), end, attrs,
        )
        self.spans.append(s)
        return s

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def merge_remote(self, spans: list[dict], anchor: Optional[Span]) -> None:
        """Fold a remote segment's spans in, re-based so the segment root
        starts at `anchor` (the local rpc.call span): remote monotonic
        clocks share no base with ours, but durations are trustworthy."""
        if not spans:
            return
        decoded = [Span.from_wire(d) for d in spans]
        # the segment root is the span whose parent is not in the segment
        ids = {s.span_id for s in decoded}
        root = next((s for s in decoded if s.parent_id not in ids),
                    decoded[0])
        shift = ((anchor.start_ns if anchor is not None else now_ns())
                 - root.start_ns)
        for s in decoded:
            s.start_ns += shift
            s.end_ns += shift
            if s is root and anchor is not None:
                s.parent_id = anchor.span_id
            self.spans.append(s)

    def finish(self, status: str = "ok", record: bool = True) -> None:
        """End the root span and (once) hand the trace to the recorder's
        ring of finished traces; a remote segment never lands there (its
        spans travel back to the caller)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        if not self.root.end_ns:
            self.root.end_ns = now_ns()
        self.attrs.setdefault("status", status)
        if record and not self.remote:
            _finished.append(self)

    def to_wire(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "attrs": dict(self.attrs),
            "spans": [s.to_wire() for s in list(self.spans)],
        }


# -- bounded ring of finished traces --------------------------------------

_finished: "deque[TraceContext]" = deque(maxlen=4096)


def finished_traces() -> list[TraceContext]:
    """The finished traces still in the ring, oldest first."""
    return list(_finished)


def clear_finished() -> None:
    _finished.clear()


# -- thread-local current context ---------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
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
    """Record a pre-timed stage onto the CURRENT context, if any."""
    if not _enabled:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.add_stage(name, dur_ns)


def stage_attrs(name: str, dur_ns: int, **attrs) -> None:
    """:func:`stage` with span attributes (solver.transfer carries the
    direction + bytes)."""
    if not _enabled:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.add_stage(name, dur_ns, attrs=attrs)


# -- wire helpers for the RPC envelope -------------------------------------
# (the envelope field names live in rpc/wire.py TRACE_KEY/TRACE_SPANS_KEY)


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
