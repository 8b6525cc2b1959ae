"""``tests/test_overload.py`` against the port.

Every case, with the reference's assertions, run on
``nomad_tpu_torch``: the broker's admission control, blocked-evals
containment, the batch worker's backpressure, the token buckets and
RetryPolicy, and the front doors' 429s through the port's server agent
(``device="cpu"``), its SDK and its CLI config parsing. No case reads a
client agent.
"""

from __future__ import annotations

import time

import pytest

from nomad_tpu_torch import metrics, mock
from nomad_tpu_torch.metrics import Registry
from nomad_tpu_torch.ratelimit import (
    BrokerSaturatedError,
    KeyedRateLimiter,
    RateLimitError,
    TokenBucket,
    is_throttle_text,
    retry_after_from_text,
)
from nomad_tpu_torch.server.blocked_evals import BlockedEvals
from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.server.worker import Backpressure


@pytest.fixture()
def fresh_registry():
    old = metrics._install_registry(Registry())
    yield metrics.registry()
    metrics._install_registry(old)


def drain(broker, schedulers=("service",), timeout_s=0.2):
    out = []
    while True:
        ev, tok = broker.dequeue(list(schedulers), timeout_s=timeout_s)
        if ev is None:
            return out
        broker.ack(ev.id, tok)
        out.append(ev)


# ---------------------------------------------------------------------------
# Broker admission control
# ---------------------------------------------------------------------------


class TestBrokerAdmission:
    def test_unbounded_by_default(self):
        b = EvalBroker()
        b.set_enabled(True)
        for i in range(200):
            b.enqueue(mock.evaluation(job_id=f"j{i}"))
        assert b.pending_count() == 200
        assert b.shed_total == 0

    def test_depth_sheds_arrival_at_equal_priority(self, fresh_registry):
        b = EvalBroker(admission_depth=3)
        b.set_enabled(True)
        for i in range(3):
            b.enqueue(mock.evaluation(job_id=f"j{i}", priority=50))
        b.enqueue(mock.evaluation(job_id="late", priority=50))
        assert b.pending_count() == 3
        assert b.shed_total == 1
        snap = fresh_registry.snapshot()["counters"]
        assert snap["nomad.broker.shed"] == 1
        assert snap["nomad.broker.shed.depth"] == 1
        assert {e.job_id for e in drain(b)} == {"j0", "j1", "j2"}

    def test_high_priority_displaces_lowest_oldest(self):
        b = EvalBroker(admission_depth=3)
        b.set_enabled(True)
        b.enqueue(mock.evaluation(job_id="low-old", priority=10))
        b.enqueue(mock.evaluation(job_id="low-new", priority=10))
        b.enqueue(mock.evaluation(job_id="mid", priority=50))
        b.enqueue(mock.evaluation(job_id="hi", priority=90))
        assert b.pending_count() == 3
        served = [e.job_id for e in drain(b)]
        # oldest lowest-priority eval gave way; everything else survives
        assert "low-old" not in served
        assert set(served) == {"low-new", "mid", "hi"}
        # the displaced victim is no longer tracked -> a leadership
        # restore may legitimately re-enqueue it
        assert b.pending_count() == 0

    def test_displaced_ready_victim_releases_job_slot(self):
        """A READY victim holds its job's in-flight slot; displacement
        must release it or later evals for that job strand forever."""
        b = EvalBroker(admission_depth=2)
        b.set_enabled(True)
        b.enqueue(mock.evaluation(job_id="victim", priority=10))
        b.enqueue(mock.evaluation(job_id="other", priority=50))
        b.enqueue(mock.evaluation(job_id="hi", priority=90))  # displaces
        assert {e.job_id for e in drain(b)} == {"other", "hi"}
        # the victim's job can be scheduled again immediately
        b.enqueue(mock.evaluation(job_id="victim", priority=50))
        assert [e.job_id for e in drain(b)] == ["victim"]

    def test_duplicate_waiter_displaced_by_newest(self):
        b = EvalBroker(admission_depth=3)
        b.set_enabled(True)
        first = mock.evaluation(job_id="A", priority=50)
        b.enqueue(first)  # ready (holds the job slot)
        old_waiter = mock.evaluation(job_id="A", priority=50)
        b.enqueue(old_waiter)
        b.enqueue(mock.evaluation(job_id="B", priority=50))
        newest = mock.evaluation(job_id="A", priority=50)
        b.enqueue(newest)  # depth full -> displaces old_waiter
        assert b.shed_total == 1
        assert fresh_or_zero("nomad.broker.shed.duplicate") >= 0
        served = [e.id for e in drain(b)]
        assert newest.id in served
        assert old_waiter.id not in served
        assert first.id in served

    def test_namespace_cap_is_fair(self, fresh_registry):
        b = EvalBroker(namespace_cap=2)
        b.set_enabled(True)
        for i in range(5):
            b.enqueue(mock.evaluation(job_id=f"greedy{i}", namespace="big"))
        b.enqueue(mock.evaluation(job_id="small0", namespace="small"))
        assert b.namespace_pending("big") == 2
        assert b.namespace_pending("small") == 1
        counters = fresh_registry.snapshot()["counters"]
        assert counters["nomad.broker.shed.namespace"] == 3

    def test_core_evals_exempt(self):
        b = EvalBroker(admission_depth=1)
        b.set_enabled(True)
        b.enqueue(mock.evaluation(job_id="j0"))
        core = mock.evaluation(job_id="", type="_core")
        b.enqueue(core)
        # the core eval rode past the bound
        assert b.tracks(core.id)

    def test_nack_redelivery_bypasses_admission(self):
        b = EvalBroker(admission_depth=1, nack_delay_s=0.05)
        b.set_enabled(True)
        ev = mock.evaluation(job_id="j0")
        b.enqueue(ev)
        got, tok = b.dequeue(["service"], timeout_s=1)
        # while in-flight, a second eval takes the only pending slot
        b.enqueue(mock.evaluation(job_id="j1"))
        b.nack(got.id, tok)  # redelivery must NOT be shed
        deadline = time.monotonic() + 5
        seen = set()
        while time.monotonic() < deadline and len(seen) < 2:
            e2, t2 = b.dequeue(["service"], timeout_s=0.2)
            if e2 is not None:
                seen.add(e2.job_id)
                b.ack(e2.id, t2)
        assert seen == {"j0", "j1"}

    def test_nack_delayed_retry_never_a_displacement_victim(self):
        """A nack-delayed low-priority retry must not be shed by a
        higher-priority arrival: its job slot was already released at
        nack, so shedding it would strand the job's queued waiters
        (review finding, round 11)."""
        b = EvalBroker(admission_depth=2, nack_delay_s=0.2)
        b.set_enabled(True)
        retry = mock.evaluation(job_id="J", priority=10)
        b.enqueue(retry)
        waiter = mock.evaluation(job_id="J", priority=10)
        b.enqueue(waiter)  # waits behind retry
        got, tok = b.dequeue(["service"], timeout_s=1)
        assert got.id == retry.id
        b.nack(got.id, tok)  # -> delay heap with a live attempt count
        # saturate with a high-priority arrival: the waiter (a fresh
        # pending eval) may be displaced, the mid-retry eval NEVER
        b.enqueue(mock.evaluation(job_id="other", priority=50))
        b.enqueue(mock.evaluation(job_id="hi", priority=90))
        served = set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and retry.id not in served:
            ev, tok = b.dequeue(["service"], timeout_s=0.2)
            if ev is not None:
                served.add(ev.id)
                b.ack(ev.id, tok)
        # the retry redelivered despite the displacement pressure
        assert retry.id in served
        # and nothing is stranded: the broker fully drains
        assert b.pending_count() == 0

    def test_stats_snapshot_live_depths(self):
        b = EvalBroker(admission_depth=10)
        b.set_enabled(True)
        b.enqueue(mock.evaluation(job_id="a"))
        b.enqueue(mock.evaluation(job_id="a"))  # waiter
        b.enqueue(mock.evaluation(job_id="b"))
        ev, tok = b.dequeue(["service"], timeout_s=1)
        s = b.stats_snapshot()
        assert s["total_unacked"] == 1
        assert s["total_blocked"] == 1
        assert s["total_pending"] == 2
        assert s["admission_depth"] == 10
        b.ack(ev.id, tok)

    def test_saturation_probe_and_configure(self):
        b = EvalBroker()
        b.set_enabled(True)
        assert b.saturation("default") is None
        b.configure(admission_depth=2, namespace_cap=1, nack_delay_s=1.0)
        b.enqueue(mock.evaluation(job_id="x", namespace="ns-a"))
        reason, retry = b.saturation("ns-a")
        assert reason == "namespace" and retry > 0
        assert b.saturation("ns-b") is None
        b.enqueue(mock.evaluation(job_id="y", namespace="ns-b"))
        reason, retry = b.saturation("ns-c")
        assert reason == "depth" and retry > 0
        # widen live -> clears
        b.configure(admission_depth=100, namespace_cap=0)
        assert b.saturation("ns-a") is None

    def test_flush_resets_admission_accounting(self):
        b = EvalBroker(admission_depth=2)
        b.set_enabled(True)
        b.enqueue(mock.evaluation(job_id="a"))
        b.enqueue(mock.evaluation(job_id="b"))
        b.set_enabled(False)
        b.set_enabled(True)
        assert b.pending_count() == 0
        for i in range(2):
            b.enqueue(mock.evaluation(job_id=f"n{i}"))
        assert b.pending_count() == 2


class TestBatchEnqueueChurn:
    """The batched enqueue_all path (one lock acquisition, bulk
    heapify, pooled heap entries) preserves the round-11 admission
    semantics per-eval enqueue established; and the `_attempts`
    overflow eviction keeps live delivery counts instead of the old
    blanket clear()."""

    def _mixed(self):
        return [
            mock.evaluation(job_id="low-old", priority=10),
            mock.evaluation(job_id="low-new", priority=10),
            mock.evaluation(job_id="mid", priority=50),
            mock.evaluation(job_id="hi", priority=90),
        ]

    def test_enqueue_all_matches_serial_admission(self):
        serial = EvalBroker(admission_depth=3)
        serial.set_enabled(True)
        batch = EvalBroker(admission_depth=3)
        batch.set_enabled(True)
        evs = self._mixed()
        for ev in evs:
            serial.enqueue(ev)
        batch.enqueue_all([ev.copy() for ev in evs])
        assert batch.pending_count() == serial.pending_count() == 3
        assert batch.shed_total == serial.shed_total == 1
        assert [e.job_id for e in drain(batch)] == [
            e.job_id for e in drain(serial)
        ]

    def test_enqueue_all_displacement_within_one_batch(self):
        """A high-priority eval later in the SAME batch displaces the
        oldest lowest-priority eval admitted earlier in it."""
        b = EvalBroker(admission_depth=3)
        b.set_enabled(True)
        b.enqueue_all(self._mixed())
        assert b.pending_count() == 3
        served = [e.job_id for e in drain(b)]
        assert "low-old" not in served
        assert set(served) == {"low-new", "mid", "hi"}

    def test_enqueue_all_namespace_fairness(self, fresh_registry):
        b = EvalBroker(namespace_cap=2)
        b.set_enabled(True)
        b.enqueue_all(
            [
                mock.evaluation(job_id=f"greedy{i}", namespace="big")
                for i in range(5)
            ]
            + [mock.evaluation(job_id="small0", namespace="small")]
        )
        assert b.namespace_pending("big") == 2
        assert b.namespace_pending("small") == 1
        counters = fresh_registry.snapshot()["counters"]
        assert counters["nomad.broker.shed.namespace"] == 3

    def test_enqueue_all_per_job_serialization(self):
        """Duplicate-job evals inside one batch wait behind the first
        (the per-job in-flight slot), exactly as with serial enqueue."""
        b = EvalBroker()
        b.set_enabled(True)
        first = mock.evaluation(job_id="A")
        waiter = mock.evaluation(job_id="A")
        b.enqueue_all([first, waiter, mock.evaluation(job_id="B")])
        got = drain(b)
        assert [e.id for e in got] == [first.id, mock_id(got, "B"), waiter.id]

    def test_enqueue_all_priority_order_preserved(self):
        b = EvalBroker()
        b.set_enabled(True)
        evs = [
            mock.evaluation(job_id=f"j{i}", priority=p)
            for i, p in enumerate([10, 90, 50, 90, 20])
        ]
        b.enqueue_all(evs)
        served = [e.priority for e in drain(b)]
        assert served == sorted(served, reverse=True)
        # equal priorities keep FIFO arrival order
        b.enqueue_all(
            [mock.evaluation(job_id=f"f{i}", priority=50) for i in range(4)]
        )
        assert [e.job_id for e in drain(b)] == ["f0", "f1", "f2", "f3"]

    def test_attempts_eviction_keeps_live_counts(self):
        """The `_attempts` overflow path evicts only ids the broker no
        longer tracks; a live in-flight eval keeps its delivery count
        across the flush so the delivery_limit cannot be bypassed."""
        b = EvalBroker(delivery_limit=2, nack_delay_s=0.0)
        b.set_enabled(True)
        ev = mock.evaluation(job_id="poison")
        b.enqueue(ev)
        got, tok = b.dequeue(["service"], timeout_s=1)
        assert got.id == ev.id and b._attempts[ev.id] == 1
        # pathological churn: >8192 stale ids from evals acked elsewhere
        for i in range(8300):
            b._attempts[f"stale-{i}"] = 1
        b.set_enabled(False)  # flush hits the overflow eviction
        b.set_enabled(True)
        assert len(b._attempts) == 1, "stale ids must be evicted"
        assert b._attempts[ev.id] == 1, "live delivery count must survive"
        # redelivery now crosses the limit -> dead-letter, not a loop
        b.enqueue(ev.copy())
        got2, tok2 = b.dequeue(["service"], timeout_s=1)
        assert got2.id == ev.id and b._attempts[ev.id] == 2
        b.nack(ev.id, tok2)
        assert b.stats["failed"] == 1

    def test_pooled_entries_never_leak_between_evals(self):
        """Heap-entry/unacked-record pooling must not let one eval's
        identity bleed into another's delivery."""
        b = EvalBroker(nack_delay_s=0.0)
        b.set_enabled(True)
        for round_ in range(3):
            evs = [
                mock.evaluation(job_id=f"r{round_}-j{i}") for i in range(50)
            ]
            b.enqueue_all(evs)
            served = drain(b)
            assert sorted(e.id for e in served) == sorted(e.id for e in evs)
        assert b.pending_count() == 0


def mock_id(served, job_id):
    return next(e.id for e in served if e.job_id == job_id)


def fresh_or_zero(name: str) -> int:
    return metrics.registry().snapshot()["counters"].get(name, 0)


# ---------------------------------------------------------------------------
# Blocked-evals containment (satellite: dedup + cap tests)
# ---------------------------------------------------------------------------


class TestBlockedEvalsContainment:
    def _blocked_eval(self, job="j", ns="default", snap=0, elig=True):
        ev = mock.evaluation(job_id=job, namespace=ns, status="blocked")
        ev.snapshot_index = snap
        ev.class_eligibility = {"c1": elig}
        ev.escaped_computed_class = False
        return ev

    def test_unblock_churn_on_one_job_does_not_grow(self, fresh_registry):
        """Repeated capacity churn re-blocking the same job must keep
        exactly one tracked eval (per-job dedup), not mint duplicates.
        The evals are INeligible for the churning class, so each
        unblock() pass walks (and keeps) them — exactly the storm shape:
        capacity events that never help this job."""
        requeued = []
        be = BlockedEvals(requeued.append)
        be.set_enabled(True)
        for i in range(50):
            be.block(
                self._blocked_eval(job="churny", snap=1000 + i, elig=False)
            )
            be.unblock("c1", index=900 + i)
        assert be.blocked_count() == 1
        assert requeued == []
        assert be.stats["deduped"] == 49
        counters = fresh_registry.snapshot()["counters"]
        assert counters["nomad.blocked_evals.deduped"] == 49

    def test_cap_evicts_oldest_and_reenqueues(self, fresh_registry):
        requeued = []
        be = BlockedEvals(requeued.append, cap=3)
        be.set_enabled(True)
        evs = [self._blocked_eval(job=f"job{i}") for i in range(5)]
        for ev in evs:
            be.block(ev)
        assert be.blocked_count() == 3
        # the two OLDEST were evicted, re-enqueued (not dropped), newest
        # three still tracked
        assert [e.id for e in requeued] == [evs[0].id, evs[1].id]
        assert all(e.status == "pending" for e in requeued)
        assert be.stats["evicted"] == 2
        counters = fresh_registry.snapshot()["counters"]
        assert counters["nomad.blocked_evals.evicted"] == 2

    def test_evicted_job_can_reblock(self):
        requeued = []
        be = BlockedEvals(requeued.append, cap=2)
        be.set_enabled(True)
        for i in range(3):
            be.block(self._blocked_eval(job=f"job{i}"))
        assert be.blocked_count() == 2
        # the evicted oldest comes back (its re-placement failed again)
        be.block(self._blocked_eval(job="job0"))
        assert be.blocked_count() == 2  # displaced the then-oldest
        # unblock everything still works
        got = []
        be.enqueue_fn = got.append
        be.unblock("c1", index=10**9)
        assert len(got) == 2

    def test_untrack_cleans_age_journal(self):
        be = BlockedEvals(lambda ev: None, cap=2)
        be.set_enabled(True)
        be.block(self._blocked_eval(job="gone"))
        be.untrack("default", "gone")
        assert be.blocked_count() == 0
        # journal must not hold the stale id hostage
        be.block(self._blocked_eval(job="a"))
        be.block(self._blocked_eval(job="b"))
        be.block(self._blocked_eval(job="c"))
        assert be.blocked_count() == 2

    def test_configure_reload(self):
        be = BlockedEvals(lambda ev: None)
        assert be.cap == 0
        be.configure(cap=7)
        assert be.cap == 7


# ---------------------------------------------------------------------------
# Backpressure math
# ---------------------------------------------------------------------------


class TestBackpressure:
    def test_wide_open_at_shallow_queue(self, fresh_registry):
        bp = Backpressure(queue_hwm=2, stall_depth=8)
        assert bp.batch_limit(64, 0) == 64
        assert bp.batch_limit(64, 2) == 64
        assert not bp.should_stall(7)

    def test_depth_halves_batch(self, fresh_registry):
        bp = Backpressure(queue_hwm=2, stall_depth=8)
        assert bp.batch_limit(64, 3) == 32
        assert bp.batch_limit(64, 5) == 8
        assert bp.batch_limit(64, 20) == 1  # floor
        g = fresh_registry.snapshot()["gauges"]
        assert g["nomad.worker.batch_limit"] == 1
        assert g["nomad.worker.backpressure_level"] == 1.0

    def test_latency_ewma_halves_batch(self, fresh_registry):
        bp = Backpressure(queue_hwm=2, latency_hwm_s=1.0, alpha=1.0)
        bp.note_submit_latency(0.1)
        assert bp.batch_limit(64, 0) == 64
        bp.note_submit_latency(3.0)
        assert bp.batch_limit(64, 0) == 32
        # recovery: fresh fast submits decay the EWMA
        bp.alpha = 0.9
        for _ in range(10):
            bp.note_submit_latency(0.01)
        assert bp.batch_limit(64, 0) == 64

    def test_stall_threshold(self):
        bp = Backpressure(stall_depth=4)
        assert not bp.should_stall(3)
        assert bp.should_stall(4)

    def test_tpu_worker_wires_backpressure(self):
        from nomad_tpu_torch.server.worker import TPUBatchWorker

        class _Srv:
            eval_broker = None
            plan_queue = None

        w = TPUBatchWorker(_Srv(), batch_size=8)
        assert w.planner.on_submit_latency == (
            w.backpressure.note_submit_latency
        )


# ---------------------------------------------------------------------------
# Token buckets + error plumbing
# ---------------------------------------------------------------------------


class TestRateLimiter:
    def test_token_bucket_deterministic_clock(self):
        tb = TokenBucket(rate=2.0, burst=2.0, now=100.0)
        assert tb.try_take(100.0) == 0.0
        assert tb.try_take(100.0) == 0.0
        wait = tb.try_take(100.0)
        assert wait == pytest.approx(0.5)
        # half a second later one token has refilled
        assert tb.try_take(100.5) == 0.0
        # clock never goes backwards on a stale caller
        assert tb.try_take(100.0) > 0

    def test_keyed_limiter_per_namespace(self):
        lim = KeyedRateLimiter(rate=1.0, burst=1.0)
        assert lim.check("a", now=0.0) == 0.0
        assert lim.check("a", now=0.0) > 0.0
        assert lim.check("b", now=0.0) == 0.0  # independent bucket

    def test_keyed_limiter_bounded_keys(self):
        lim = KeyedRateLimiter(rate=1.0, burst=1.0, max_keys=3)
        for i in range(10):
            lim.check(f"ns{i}", now=0.0)
        assert len(lim._buckets) == 3

    def test_configure_and_disable(self):
        lim = KeyedRateLimiter()
        assert not lim.enabled
        assert lim.check("x") == 0.0
        lim.configure(5.0)
        assert lim.enabled and lim.burst == 5.0
        lim.configure(0.0)
        assert not lim.enabled and not lim._buckets

    def test_enforce_raises_with_hint(self):
        lim = KeyedRateLimiter(rate=1.0, burst=1.0)
        lim.enforce("ns")
        with pytest.raises(RateLimitError) as ei:
            lim.enforce("ns")
        assert ei.value.retry_after_s > 0

    def test_throttle_text_roundtrip(self):
        err = RateLimitError("too fast", retry_after_s=1.25)
        text = f"{type(err).__name__}: {err}"
        assert is_throttle_text(text)
        assert retry_after_from_text(text) == pytest.approx(1.25)
        sat = BrokerSaturatedError("full", retry_after_s=0.5)
        text2 = f"{type(sat).__name__}: {sat}"
        assert is_throttle_text(text2)
        assert retry_after_from_text(text2) == pytest.approx(0.5)
        assert not is_throttle_text("KeyError: job x not found")

    def test_retry_policy_honors_retry_after_floor(self):
        from nomad_tpu_torch.retry import RetryPolicy, call_with_retry

        calls = []
        t0 = time.monotonic()

        def fn():
            calls.append(time.monotonic())
            if len(calls) < 2:
                raise RateLimitError("wait", retry_after_s=0.3)
            return "ok"

        out = call_with_retry(
            fn,
            policy=RetryPolicy(base_s=0.001, max_s=0.002, deadline_s=5.0),
            retry_if=lambda e: isinstance(e, RateLimitError),
            label="unit.test429",
        )
        assert out == "ok"
        # the sleep was floored at the server's hint, not the tiny policy
        assert calls[1] - t0 >= 0.28


# ---------------------------------------------------------------------------
# End-to-end: HTTP 429s, SDK, RPC door, SIGHUP reload, operator top
# ---------------------------------------------------------------------------


@pytest.fixture()
def overload_agent(tmp_path, fresh_registry):
    from nomad_tpu_torch.agent import Agent, AgentConfig

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        yield agent
    finally:
        agent.shutdown()


class TestFrontDoor429:
    def test_http_limiter_429_with_retry_after(self, overload_agent):
        from nomad_tpu_torch.api.client import APIError, NomadClient

        overload_agent.http.set_rate_limits(1.0, 1.0)
        api = NomadClient(
            f"http://127.0.0.1:{overload_agent.http_addr[1]}"
        )
        api.jobs.list()
        with pytest.raises(APIError) as ei:
            for _ in range(3):
                api.jobs.list()
        assert ei.value.status == 429
        assert ei.value.retry_after and ei.value.retry_after > 0
        # observability stays reachable while throttled
        assert overload_agent.server.server is not None
        api.agent.metrics()
        api.agent.self()
        counters = metrics.registry().snapshot()["counters"]
        assert counters["nomad.http.throttled"] >= 1

    def test_http_limiter_charges_body_namespace(self, overload_agent):
        """Job register carries its namespace in the BODY, not the
        query — the limiter must charge the tenant's own bucket, not
        'default' (review finding, round 11)."""
        from nomad_tpu_torch.api.client import APIError, NomadClient
        from nomad_tpu_torch.structs.structs import Namespace

        cs = overload_agent.server
        cs.rpc_self("Namespace.upsert", {"namespace": Namespace(name="t-a")})
        overload_agent.http.set_rate_limits(1.0, 1.0)
        api = NomadClient(
            f"http://127.0.0.1:{overload_agent.http_addr[1]}"
        )
        job = mock.job()
        job.namespace = "t-a"
        api.jobs.register(job)  # drains t-a's bucket
        with pytest.raises(APIError) as ei:
            j2 = mock.job()
            j2.namespace = "t-a"
            api.jobs.register(j2)
        assert ei.value.status == 429
        # default-namespace traffic is NOT starved by t-a's storm
        api.jobs.list(namespace="default")

    def test_sdk_retry_429_honors_hint(self, overload_agent):
        from nomad_tpu_torch.api.client import NomadClient

        overload_agent.http.set_rate_limits(2.0, 2.0)
        api = NomadClient(
            f"http://127.0.0.1:{overload_agent.http_addr[1]}",
            retry_429=5,
        )
        # more requests than the burst: the SDK sleeps out the hints
        for _ in range(4):
            api.jobs.list()

    def test_broker_saturation_maps_to_429_not_500(self, overload_agent):
        from nomad_tpu_torch.api.client import APIError, NomadClient

        srv = overload_agent.server.server
        # leadership establishment starts the workers ASYNCHRONOUSLY
        # (server._establish_leadership): stopping them before it runs
        # just resurrects them mid-test, and the zombies drain the eval
        # meant to saturate the broker. _leader flips True only after
        # the workers started, so wait for it before stopping them.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not srv._leader:
            time.sleep(0.01)
        assert srv._leader, "dev-mode agent never became leader"
        # stop the workers so pending grows, then saturate
        for w in srv.workers:
            w.stop()
            w.join()
        if srv.tpu_worker:
            srv.tpu_worker.stop()
        srv.eval_broker.configure(admission_depth=1)
        api = NomadClient(
            f"http://127.0.0.1:{overload_agent.http_addr[1]}"
        )
        api.jobs.register(mock.job())  # fills the depth
        with pytest.raises(APIError) as ei:
            api.jobs.register(mock.job())
            api.jobs.register(mock.job())
        assert ei.value.status == 429  # used to be a 500
        assert ei.value.retry_after and ei.value.retry_after > 0
        counters = metrics.registry().snapshot()["counters"]
        assert counters["nomad.broker.rejected"] >= 1

    def test_rpc_door_throttles_writes_not_reads(self, overload_agent):
        cs = overload_agent.server
        cs.set_rate_limits(1.0, 1.0)
        cs.rpc_self("Job.register", {"job": mock.job()})
        with pytest.raises(RateLimitError) as ei:
            for _ in range(3):
                cs.rpc_self("Job.register", {"job": mock.job()})
        assert ei.value.retry_after_s > 0
        # reads and node traffic are never throttled
        for _ in range(10):
            cs.rpc_self("Job.list", {"namespace": None})
        node = mock.node()
        cs.rpc_self("Node.register", {"node": node})
        for _ in range(10):
            cs.rpc_self("Node.heartbeat", {"node_id": node.id})
        counters = metrics.registry().snapshot()["counters"]
        assert counters["nomad.rpc.throttled"] >= 1

    def test_sighup_reload_applies_broker_and_limits(self, overload_agent):
        from nomad_tpu_torch.agent import AgentConfig

        old = overload_agent.config
        new = AgentConfig()
        for k, v in vars(old).items():
            setattr(new, k, v)
        new.broker_delivery_limit = 9
        new.broker_nack_delay_s = 1.5
        new.broker_admission_depth = 777
        new.broker_namespace_cap = 111
        new.blocked_evals_cap = 222
        new.http_rate_limit = 33.0
        new.rpc_rate_limit = 44.0
        changed = overload_agent.reload(new)
        assert "broker" in changed and "limits" in changed
        srv = overload_agent.server.server
        assert srv.eval_broker.delivery_limit == 9
        assert srv.eval_broker.nack_delay_s == 1.5
        assert srv.eval_broker.admission_depth == 777
        assert srv.eval_broker.namespace_cap == 111
        assert srv.blocked_evals.cap == 222
        assert overload_agent.http.limiter.rate == 33.0
        assert overload_agent.server.rpc_limiter.rate == 44.0
        # idempotent: same config again reports no change
        again = AgentConfig()
        for k, v in vars(overload_agent.config).items():
            setattr(again, k, v)
        assert overload_agent.reload(again) == []


class TestConfigParsing:
    def test_hcl_broker_and_limits_blocks(self, tmp_path):
        from nomad_tpu_torch.cli.main import _load_agent_config

        p = tmp_path / "agent.hcl"
        p.write_text(
            """
            data_dir = "/tmp/x"
            server { enabled = true }
            broker {
              delivery_limit  = 5
              nack_delay      = "2s"
              admission_depth = 1024
              namespace_cap   = 256
              blocked_cap     = 512
            }
            limits {
              http_rate  = 50
              http_burst = 75
              rpc_rate   = 100
            }
            """
        )
        cfg = _load_agent_config(str(p))
        assert cfg.broker_delivery_limit == 5
        assert cfg.broker_nack_delay_s == 2.0
        assert cfg.broker_admission_depth == 1024
        assert cfg.broker_namespace_cap == 256
        assert cfg.blocked_evals_cap == 512
        assert cfg.http_rate_limit == 50.0
        assert cfg.http_rate_burst == 75.0
        assert cfg.rpc_rate_limit == 100.0
        assert cfg.rpc_rate_burst == 0.0

    def test_json_broker_and_limits(self, tmp_path):
        import json

        from nomad_tpu_torch.cli.main import _load_agent_config

        p = tmp_path / "agent.json"
        p.write_text(json.dumps({
            "server": {"enabled": True},
            "broker": {
                "delivery_limit": 4,
                "nack_delay": "500ms",
                "admission_depth": 64,
            },
            "limits": {"http_rate": 10, "rpc_rate": 20},
        }))
        cfg = _load_agent_config(str(p))
        assert cfg.broker_delivery_limit == 4
        assert cfg.broker_nack_delay_s == 0.5
        assert cfg.broker_admission_depth == 64
        assert cfg.http_rate_limit == 10.0
        assert cfg.rpc_rate_limit == 20.0


class TestOperatorTopOverloadPanel:
    def test_panel_renders_when_signals_fire(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {
                "nomad.broker.shed": 12,
                "nomad.broker.rejected": 3,
                "nomad.http.throttled": 5,
                "nomad.rpc.throttled": 2,
            },
            "gauges": {
                "nomad.broker.total_pending": 90,
                "nomad.broker.admission_depth": 96,
                "nomad.worker.backpressure_level": 0.5,
            },
            "samples": {},
        }
        out = _render_top(snap, None)
        assert "Overload" in out
        assert "shed 12" in out
        assert "rejected(429) 3" in out
        assert "throttled http+rpc 7" in out
        assert "pending 90/96" in out
        assert "backpressure 50%" in out

    def test_panel_hidden_when_quiet(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {},
            "gauges": {},
            "samples": {},
        }
        assert "Overload" not in _render_top(snap, None)


class TestOperatorTopLanePanel:
    def test_lane_panel_renders_when_lane_active(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {
                "nomad.worker.lane.interactive": 7,
                "nomad.worker.lane.micro": 6,
                "nomad.worker.lane.drain_preempted": 2,
            },
            "gauges": {},
            "samples": {
                "nomad.worker.lane.interactive_seconds": {
                    "count": 7, "p50": 0.004, "p95": 0.01, "p99": 0.02,
                },
                "nomad.worker.lane.batch_seconds": {
                    "count": 3, "p50": 0.35, "p95": 0.5, "p99": 0.5,
                },
            },
        }
        out = _render_top(snap, None)
        assert "Lanes" in out
        assert "interactive 7" in out
        assert "micro 6" in out
        assert "drain preempted 2" in out
        assert "batch p50" in out

    def test_lane_panel_hidden_without_lane_traffic(self):
        from nomad_tpu_torch.cli.main import _render_top

        snap = {
            "uptime_seconds": 10,
            "counters": {},
            "gauges": {},
            "samples": {},
        }
        assert "Lanes" not in _render_top(snap, None)
