"""Event-driven test waits.

Port of ``nomad_tpu/testing/waits.py``. A sleep-poll of the form
`while not cond(): time.sleep(0.05)` burns the very CPU the condition
is waiting on (each poll walks allocs under the GIL) and
re-checks on a fixed cadence regardless of when the state actually
changed. :func:`wait_for_state` instead subscribes to the servers' event
brokers (stream/event_broker.py — every store write publishes) and
re-checks the condition the moment a matching event lands, with a slow
periodic fallback re-check for transitions that publish no event
(leadership changes, snapshot restores, filesystem side effects).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

from ..stream import SubscriptionClosedError
from ..stream.event_broker import KEY_ALL, TOPIC_ALL


def _brokers_of(servers: Iterable) -> list:
    """Accepts core Servers, ClusterServers, or EventBrokers."""
    out = []
    for s in servers:
        broker = getattr(s, "event_broker", None)
        if broker is None:
            inner = getattr(s, "server", None)  # ClusterServer wraps Server
            broker = getattr(inner, "event_broker", None)
        out.append(broker if broker is not None else s)
    return out


def wait_for_state(
    servers: Iterable,
    cond: Callable[[], bool],
    topics: Optional[dict] = None,
    timeout_s: float = 30.0,
    fallback_interval_s: float = 0.5,
) -> bool:
    """Block until cond() is true, re-checking on every matching state
    event from ANY of the given servers' event brokers.

    The per-broker subscription poll uses a short slice so multiple
    brokers multiplex on one thread; `fallback_interval_s` bounds how
    stale the condition check can get when no events fire at all.
    Returns True when the condition held, False on timeout (mirrors the
    wait_until helpers it replaces, so assertions read identically).
    """
    if cond():
        return True
    topics = topics or {TOPIC_ALL: [KEY_ALL]}
    brokers = _brokers_of(servers)
    subs = [b.subscribe(topics) for b in brokers]
    slice_s = max(0.05, fallback_interval_s / max(1, len(subs)))
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            woke = False
            live = 0
            for i, sub in enumerate(subs):
                if sub is None:
                    continue
                live += 1
                try:
                    if sub.next(timeout_s=slice_s):
                        woke = True
                except SubscriptionClosedError:
                    # fell off the ring (or broker restarted): resubscribe
                    # rather than abandoning the wait
                    try:
                        subs[i] = brokers[i].subscribe(topics)
                    except Exception:
                        subs[i] = None
                if cond():
                    return True
            if live == 0:
                # every subscription dead (broker closed, no servers):
                # fall back to paced polling, never a zero-sleep spin
                time.sleep(slice_s)
            if not woke and cond():  # fallback re-check (event-less writes)
                return True
        return cond()
    finally:
        for sub in subs:
            if sub is not None:
                sub.close()
