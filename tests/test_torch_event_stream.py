"""Event broker + state→stream bridge tests, against the port.

The 16 cases of ``tests/test_event_stream.py`` with their imports
pointed at ``nomad_tpu_torch``; the assertions are the reference's. Two
cases at the end hold the port's lazy blocks (``publish_lazy``).
Reference behaviors: nomad/stream/event_broker_test.go,
subscription semantics (close-on-overrun), topic/key filtering.
"""

import threading

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.state.events import wire_events
from nomad_tpu_torch.stream import (
    Event,
    EventBroker,
    SubscriptionClosedError,
)


def _ev(i, topic="Node", key="k", etype="T"):
    return Event(topic=topic, type=etype, key=key, index=i, payload=None)


class TestEventBroker:
    def test_publish_subscribe(self):
        b = EventBroker()
        sub = b.subscribe({"Node": ["*"]})
        b.publish([_ev(1)])
        got = sub.next(timeout_s=1)
        assert len(got) == 1 and got[0].index == 1

    def test_topic_filtering(self):
        b = EventBroker()
        sub = b.subscribe({"Job": ["*"]})
        b.publish([_ev(1, topic="Node")])
        b.publish([_ev(2, topic="Job")])
        got = sub.next(timeout_s=1)
        assert got and all(e.topic == "Job" for e in got)

    def test_key_filtering(self):
        b = EventBroker()
        sub = b.subscribe({"Node": ["n2"]})
        b.publish([_ev(1, key="n1"), _ev(1, key="n2")])
        got = sub.next(timeout_s=1)
        assert [e.key for e in got] == ["n2"]

    def test_from_index_replay(self):
        b = EventBroker()
        for i in range(1, 6):
            b.publish([_ev(i)])
        sub = b.subscribe({"*": ["*"]}, from_index=3)
        got = sub.next(timeout_s=1)
        assert got[0].index == 4

    def test_timeout_returns_empty(self):
        b = EventBroker()
        sub = b.subscribe()
        assert sub.next(timeout_s=0.05) == []

    def test_slow_subscriber_closed(self):
        b = EventBroker(size=4)
        sub = b.subscribe()
        b.publish([_ev(1)])
        for i in range(2, 10):
            b.publish([_ev(i)])
        with pytest.raises(SubscriptionClosedError):
            sub.next(timeout_s=1)

    def test_fell_behind_subscriber_evicted_from_accounting(self):
        """Round 21: a fell-behind subscriber doesn't just get the
        closed error — it leaves the broker's subscriber accounting
        immediately (stats()/subscriber_count feed the nomad.stream.*
        gauges) and bumps the eviction counters."""
        from nomad_tpu_torch import metrics

        before = metrics.registry().snapshot()["counters"].get(
            "nomad.stream.evicted_total", 0
        )
        b = EventBroker(size=4)
        sub = b.subscribe()
        assert b.subscriber_count() == 1
        for i in range(1, 10):
            b.publish([_ev(i)])
        with pytest.raises(SubscriptionClosedError):
            sub.next(timeout_s=1)
        assert b.subscriber_count() == 0
        stats = b.stats()
        assert stats["subscribers"] == 0
        assert stats["evicted"] == 1
        assert (
            metrics.registry().snapshot()["counters"].get(
                "nomad.stream.evicted_total", 0
            )
            == before + 1
        )

    def test_explicit_close_deregisters_subscriber(self):
        b = EventBroker()
        sub = b.subscribe()
        assert b.subscriber_count() == 1
        sub.close()
        assert b.subscriber_count() == 0
        assert b.stats()["evicted"] == 0

    def test_close_wakes_blocked_subscriber(self):
        b = EventBroker()
        sub = b.subscribe()
        errs = []

        def reader():
            try:
                sub.next(timeout_s=5)
            except SubscriptionClosedError:
                errs.append(True)

        t = threading.Thread(target=reader)
        t.start()
        sub.close()
        t.join(2)
        assert errs == [True]


class TestStateEvents:
    def test_node_registration_event(self):
        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        sub = broker.subscribe({"Node": ["*"]})
        n = mock.node()
        store.upsert_node(1, n)
        got = sub.next(timeout_s=1)
        assert got[0].type == "NodeRegistration"
        assert got[0].key == n.id

    def test_job_and_eval_events(self):
        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        sub = broker.subscribe({"Job": ["*"], "Evaluation": ["*"]})
        job = mock.job()
        store.upsert_job(1, job)
        got = sub.next(timeout_s=1)
        assert got[0].topic == "Job" and got[0].type == "JobRegistered"
        ev = mock.eval_for_job(job)
        store.upsert_evals(2, [ev])
        got = sub.next(timeout_s=1)
        assert got[0].topic == "Evaluation"

    def test_alloc_filter_by_job_key(self):
        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        job = mock.job()
        store.upsert_job(1, job)
        sub = broker.subscribe({"Allocation": [job.id]})
        alloc = mock.alloc(job_=job)
        store.upsert_allocs(2, [alloc])
        got = sub.next(timeout_s=1)
        assert got[0].key == alloc.id


class TestStateEventCoverage:
    """Every mutating store path must publish (code-review finding)."""

    def test_delete_events(self):
        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        n = mock.node()
        job = mock.job()
        store.upsert_node(1, n)
        store.upsert_job(2, job)
        sub = broker.subscribe({"Node": ["*"], "Job": ["*"]})
        store.delete_node(3, n.id)
        got = sub.next(timeout_s=1)
        assert got[0].type == "NodeDeregistration"
        store.delete_job(4, job.namespace, job.id)
        got = sub.next(timeout_s=1)
        assert got[0].type == "JobDeregistered"

    def test_desired_transition_publishes(self):
        from nomad_tpu_torch.structs.structs import DesiredTransition

        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        job = mock.job()
        alloc = mock.alloc(job_=job)
        store.upsert_job(1, job)
        store.upsert_allocs(2, [alloc])
        sub = broker.subscribe({"Allocation": ["*"]})
        store.update_alloc_desired_transition(
            3, {alloc.id: DesiredTransition(migrate=True)}, []
        )
        got = sub.next(timeout_s=1)
        assert got[0].type == "AllocationUpdateDesiredStatus"

    def test_namespace_scoped_subscription(self):
        store, broker = StateStore(), EventBroker()
        wire_events(store, broker)
        sub = broker.subscribe({"Job": ["*"]}, namespace="other")
        job = mock.job()  # default namespace
        store.upsert_job(1, job)
        assert sub.next(timeout_s=0.1) == []


def test_service_and_volume_events_flow():
    """Service registrations and volume writes reach subscribers on
    their own topics (reference events.go Service/CSIVolume topics)."""
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs.structs import ServiceRegistration, Volume

    s = Server(num_workers=1)
    s.establish_leadership()
    try:
        sub = s.event_broker.subscribe(topics={"Service": ["*"],
                                               "Volume": ["*"]})
        s.volume_register(Volume(id="ev-vol", name="ev-vol", type="host"))
        s.state.upsert_service_registrations(
            s.state.latest_index() + 1,
            [ServiceRegistration(id="r1", service_name="web",
                                 alloc_id="a1")],
        )
        import time as _t

        got = []
        deadline = _t.monotonic() + 5
        while _t.monotonic() < deadline and len(
            {e.topic for e in got}
        ) < 2:
            got.extend(sub.next(timeout_s=0.5) or [])
        topics = {e.topic for e in got}
        assert "Volume" in topics and "Service" in topics, topics
        svc = next(e for e in got if e.topic == "Service")
        assert svc.key == "web" and svc.type == "ServiceRegistration"
        sub.close()
    finally:
        s.shutdown()


# ---------------------------------------------------------------------------
# The port's lazy blocks (EventBroker.publish_lazy): a block's events are
# built when a subscription first reads it
# ---------------------------------------------------------------------------


def test_lazy_block_built_once_on_first_read():
    b = EventBroker()
    calls = []

    def build():
        calls.append(1)
        return [_ev(7, key="a"), _ev(7, key="b")]

    b.publish_lazy(7, build)
    assert calls == [] and b.latest_index() == 7
    first = b.subscribe({"Node": ["*"]}, from_index=1)
    second = b.subscribe({"Node": ["b"]}, from_index=1)
    assert [e.key for e in first.next(timeout_s=1)] == ["a", "b"]
    assert [e.key for e in second.next(timeout_s=1)] == ["b"]
    assert calls == [1]


def test_store_writes_publish_unbuilt_until_read():
    """A store write costs the broker one unbuilt block; a late
    subscriber replaying from an index reads the same events an eager
    build would have made."""
    store, broker = StateStore(), EventBroker()
    wire_events(store, broker)
    job = mock.job()
    store.upsert_job(1, job)
    alloc = mock.alloc(job_=job)
    store.upsert_allocs(2, [alloc])
    assert all(callable(blk) for _, blk in broker._blocks.values())
    sub = broker.subscribe({"*": ["*"]}, from_index=0)
    assert sub.next(timeout_s=0.05) == []
    sub = broker.subscribe({"*": ["*"]}, from_index=1)
    got = sub.next(timeout_s=1)
    assert [(e.topic, e.key, e.index) for e in got] == [
        ("Allocation", alloc.id, 2)]
    assert got[0].payload.id == alloc.id
    assert job.id in got[0].filter_keys
