"""Ring-buffer event broker with topic-filtered subscriptions.

Reference: nomad/stream/event_broker.go:55 (EventBroker),
event_buffer.go (ring buffer of event blocks, dropped-tail detection) and
subscription.go (per-subscriber cursor + filter). The TPU-native redesign
keeps the same contract:

  * `publish` appends a block of events sharing one raft index;
  * each `Subscription` holds a cursor into the buffer and blocks until
    events past its cursor arrive;
  * a slow subscriber whose cursor falls off the ring is closed with
    `SubscriptionClosedError` and must re-subscribe (possibly re-reading
    current state first) — exactly the reference's
    ErrSubscriptionClosed discipline.

Port of ``nomad_tpu/stream/event_broker.py``, with one change of
representation: `publish_lazy` appends a block whose events are built
when a subscription first reads it. A store write publishes a block per
table it touches (a c2m plan commit, one event per alloc), so building
every event under the FSM apply costs the commit thread ~0.4 s a c2m
wave on the card's host whether or not anyone subscribes; built on
first read, the events are the same objects' same keys, and a write no
subscriber reads costs one tuple in the ring.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .. import metrics

TOPIC_ALL = "*"
KEY_ALL = "*"

# Topics (reference: nomad/structs/structs.go TopicNode/TopicJob/...)
TOPIC_NODE = "Node"
TOPIC_JOB = "Job"
TOPIC_EVAL = "Evaluation"
TOPIC_ALLOC = "Allocation"
TOPIC_DEPLOYMENT = "Deployment"
TOPIC_SERVICE = "Service"
TOPIC_VOLUME = "Volume"


@dataclass(frozen=True)
class Event:
    """One change event (reference structs.Event)."""

    topic: str
    type: str
    key: str
    index: int
    payload: object
    namespace: str = ""
    filter_keys: tuple = field(default_factory=tuple)

    def matches(self, topics: dict[str, list[str]]) -> bool:
        for topic in (self.topic, TOPIC_ALL):
            keys = topics.get(topic)
            if keys is None:
                continue
            for k in keys:
                if k == KEY_ALL or k == self.key or k in self.filter_keys:
                    return True
        return False


class SubscriptionClosedError(Exception):
    """The subscriber fell off the ring buffer (or the broker closed)."""


class Subscription:
    def __init__(
        self,
        broker: "EventBroker",
        topics: dict[str, list[str]],
        start_seq: int,
        namespace: str = "",
    ):
        self._broker = broker
        self._topics = topics
        self._namespace = namespace  # "" ⇒ all namespaces
        self._seq = start_seq  # next block sequence number to consume
        self._closed = False

    def _match(self, e: Event) -> bool:
        if self._namespace and e.namespace and e.namespace != self._namespace:
            return False
        return e.matches(self._topics)

    def next(self, timeout_s: Optional[float] = 5.0) -> list[Event]:
        """Block for the next matching block of events.

        Returns [] on timeout. Raises SubscriptionClosedError if the ring
        has overwritten our cursor or the broker shut down. The timeout is
        a single deadline across non-matching blocks — a busy broker full
        of filtered-out events can't extend it.
        """
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return []
            block = self._broker._next_block(self, remaining)
            if block is None:
                return []
            events = [e for e in block if self._match(e)]
            if events:
                return events

    def close(self) -> None:
        self._closed = True
        with self._broker._cv:
            self._broker._subs.discard(self)
            self._broker._cv.notify_all()


class EventBroker:
    """Fixed-size ring of event blocks; fan-out to subscriptions.

    Reference: nomad/stream/event_broker.go (size from
    `event_buffer_size` agent config, default 100).
    """

    def __init__(self, size: int = 1024) -> None:
        self._size = size
        # seq -> (raft index, events); insertion-ordered, evicted oldest
        # first. A dict keyed by seq gives O(1) random access for lagging
        # subscribers (a deque would make catch-up O(size) per block).
        # (a lazy block holds the callable that builds its events until
        # a subscription first reads it)
        self._blocks: dict[int, tuple[int, object]] = {}
        self._next_seq = 0
        self._latest_index = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        # live Subscription registry: every subscriber is accounted for
        # from subscribe() until close()/eviction, so a fleet of
        # streamers shows up in `operator top` and a leak is visible as
        # a gauge, not an OOM
        self._subs: set[Subscription] = set()
        self._evicted = 0

    # -- publishing ----------------------------------------------------

    def publish(self, events: list[Event]) -> None:
        if not events:
            return
        self._append(events[0].index, list(events))

    def publish_lazy(self, index: int, build) -> None:
        """Append one block of events at `index` that `build()` returns
        when a subscription first reads the block."""
        self._append(index, build)

    def _append(self, index: int, block) -> None:
        with self._cv:
            self._blocks[self._next_seq] = (index, block)
            self._next_seq += 1
            while len(self._blocks) > self._size:
                self._blocks.pop(next(iter(self._blocks)))
            if index > self._latest_index:
                self._latest_index = index
            self._cv.notify_all()

    def latest_index(self) -> int:
        with self._lock:
            return self._latest_index

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- subscribing ---------------------------------------------------

    def subscribe(
        self,
        topics: Optional[dict[str, list[str]]] = None,
        from_index: int = 0,
        namespace: str = "",
    ) -> Subscription:
        """Subscribe starting at the first buffered block with
        index > from_index (0 ⇒ only new events). A non-empty namespace
        scopes the subscription (reference SubscribeRequest.Namespace)."""
        topics = topics or {TOPIC_ALL: [KEY_ALL]}
        with self._lock:
            start_seq = self._next_seq
            if from_index != 0:
                for seq, (index, _) in self._blocks.items():
                    if index > from_index:
                        start_seq = seq
                        break
            sub = Subscription(self, topics, start_seq, namespace)
            self._subs.add(sub)
            return sub

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def stats(self) -> dict[str, float]:
        """Provider gauges (``nomad.stream.*``): live subscriber count,
        ring depth, and cumulative slow-consumer evictions."""
        with self._lock:
            return {
                "subscribers": len(self._subs),
                "buffered_blocks": len(self._blocks),
                "evicted": self._evicted,
            }

    def _next_block(
        self, sub: Subscription, timeout_s: Optional[float]
    ) -> Optional[list[Event]]:
        with self._cv:
            while True:
                if sub._closed or self._closed:
                    raise SubscriptionClosedError()
                block = self._blocks.get(sub._seq)
                if block is not None:
                    events = block[1]
                    if callable(events):
                        events = events()
                        self._blocks[sub._seq] = (block[0], events)
                    sub._seq += 1
                    return events
                if sub._seq < self._next_seq:
                    # Evicted from the ring before we read it: too slow.
                    # The ring IS the bounded queue — a consumer that
                    # can't keep up is cut loose, never buffered for.
                    sub._closed = True
                    self._subs.discard(sub)
                    self._evicted += 1
                    break
                if not self._cv.wait(timeout_s):
                    return None
        # counter bumped outside the broker lock (lock discipline)
        metrics.incr("nomad.stream.evicted_total")
        raise SubscriptionClosedError("subscriber fell behind")
