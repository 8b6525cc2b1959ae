"""``tests/test_preemption.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``; a ``Harness`` pass given no config runs on that
default. The assertions are the reference's.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.preemption import (
    Preemptor,
    basic_resource_distance,
)
from nomad_tpu_torch.structs import Resources
from nomad_tpu_torch.testing import Harness as _PortHarness

from nomad_tpu_torch.scheduler.context import SchedulerConfig as _PortConfig


def SchedulerConfig(**kw):
    """The port's config with the reference's defaults, on the CPU."""
    kw.setdefault("backend", "host")
    if kw["backend"] == "tpu":
        kw["backend"] = "gpu"
    kw.setdefault("device", "cpu")
    return _PortConfig(**kw)


class Harness(_PortHarness):
    """The port's Harness; a pass given no config runs on
    SchedulerConfig()'s defaults above."""

    def process(self, scheduler_name, eval_obj, config=None, **kwargs):
        return super().process(scheduler_name, eval_obj,
                               config or SchedulerConfig(), **kwargs)


def _filled_node(cpu=4000, memory_mb=8192):
    # default mock node, capacity adjusted in place (keeps its networks)
    n = mock.node()
    n.resources.cpu = cpu
    n.resources.memory_mb = memory_mb
    n.reserved.cpu = 0
    n.reserved.memory_mb = 0
    n.reserved.disk_mb = 0
    return n


def _running_alloc(node, priority, cpu, memory_mb, job_id=None):
    j = mock.job(priority=priority)
    if job_id:
        j.id = job_id
    t = j.task_groups[0].tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = memory_mb
    a = mock.alloc(job_=j, node_=node)
    a.resources.tasks["web"].cpu = cpu
    a.resources.tasks["web"].memory_mb = memory_mb
    a.client_status = "running"
    return a


class TestPreemptor:
    def test_no_candidates_within_priority_delta(self):
        """Allocs within 10 priority of the placing job are untouchable."""
        node = _filled_node()
        low = _running_alloc(node, priority=45, cpu=3500, memory_mb=7000)
        p = Preemptor(50, "default", "newjob")
        p.set_node(node)
        p.set_candidates([low])
        assert p.preempt_for_task_group(Resources(cpu=1000, memory_mb=1000)) is None

    def test_preempts_lowest_priority_first(self):
        node = _filled_node()
        lower = _running_alloc(node, priority=10, cpu=2000, memory_mb=4000)
        higher = _running_alloc(node, priority=30, cpu=2000, memory_mb=4000)
        p = Preemptor(70, "default", "newjob")
        p.set_node(node)
        p.set_candidates([higher, lower])
        picks = p.preempt_for_task_group(Resources(cpu=1000, memory_mb=1000))
        assert picks is not None
        assert [a.job.priority for a in picks] == [10]

    def test_multiple_allocs_when_one_is_not_enough(self):
        node = _filled_node()
        a1 = _running_alloc(node, priority=10, cpu=1500, memory_mb=3000)
        a2 = _running_alloc(node, priority=10, cpu=1500, memory_mb=3000)
        a3 = _running_alloc(node, priority=10, cpu=1000, memory_mb=2000)
        p = Preemptor(70, "default", "newjob")
        p.set_node(node)
        p.set_candidates([a1, a2, a3])
        picks = p.preempt_for_task_group(Resources(cpu=2500, memory_mb=5000))
        assert picks is not None
        freed = sum(a.resources.tasks["web"].cpu for a in picks)
        assert freed >= 2500
        assert len(picks) == 2  # not all three

    def test_impossible_ask_returns_none(self):
        node = _filled_node()
        a1 = _running_alloc(node, priority=10, cpu=1000, memory_mb=2000)
        p = Preemptor(70, "default", "newjob")
        p.set_node(node)
        p.set_candidates([a1])
        assert (
            p.preempt_for_task_group(Resources(cpu=9000, memory_mb=1000)) is None
        )

    def test_own_job_never_preempted(self):
        node = _filled_node()
        own = _running_alloc(node, priority=10, cpu=3500, memory_mb=7000, job_id="me")
        own.namespace = "default"
        p = Preemptor(70, "default", "me")
        p.set_node(node)
        p.set_candidates([own])
        assert p.preempt_for_task_group(Resources(cpu=1000, memory_mb=1000)) is None

    def test_distance_prefers_closest_fit(self):
        ask = Resources(cpu=1000, memory_mb=1000)
        close = Resources(cpu=1100, memory_mb=1100)
        far = Resources(cpu=4000, memory_mb=8000)
        assert basic_resource_distance(ask, close) < basic_resource_distance(
            ask, far
        )


class TestSchedulerPreemption:
    """Through the full GenericScheduler via the harness (reference
    generic_sched_test.go preemption cases)."""

    def _setup(self, h, node, low_priority=10):
        low_job = mock.job(priority=low_priority)
        t = low_job.task_groups[0].tasks[0]
        t.resources.cpu = 3600
        t.resources.memory_mb = 7000
        low_job.task_groups[0].count = 1
        h.state.upsert_job(h.next_index(), low_job)
        low_alloc = _running_alloc(node, low_priority, 3600, 7000)
        low_alloc.job = low_job
        low_alloc.job_id = low_job.id
        h.state.upsert_allocs(h.next_index(), [low_alloc])
        return low_job, low_alloc

    def test_high_priority_preempts(self):
        h = Harness()
        node = _filled_node()
        h.state.upsert_node(h.next_index(), node)
        low_job, low_alloc = self._setup(h, node)

        high_job = mock.job(priority=70)
        high_job.task_groups[0].count = 1
        t = high_job.task_groups[0].tasks[0]
        t.resources.cpu = 2000
        t.resources.memory_mb = 4000
        h.state.upsert_job(h.next_index(), high_job)

        ev = mock.eval_for_job(high_job)
        h.process("service", ev)

        assert len(h.plans) == 1
        plan = h.plans[0]
        placed = [a for allocs in plan.node_allocation.values() for a in allocs]
        assert len(placed) == 1
        preempted = [
            a for allocs in plan.node_preemptions.values() for a in allocs
        ]
        assert [a.id for a in preempted] == [low_alloc.id]
        assert preempted[0].desired_status == "evict"
        assert preempted[0].preempted_by_allocation == placed[0].id
        assert placed[0].preempted_allocations == [low_alloc.id]

    def test_no_preemption_when_disabled(self):
        h = Harness()
        node = _filled_node()
        h.state.upsert_node(h.next_index(), node)
        self._setup(h, node)

        high_job = mock.job(priority=70)
        high_job.task_groups[0].count = 1
        t = high_job.task_groups[0].tasks[0]
        t.resources.cpu = 2000
        t.resources.memory_mb = 4000
        h.state.upsert_job(h.next_index(), high_job)

        ev = mock.eval_for_job(high_job)
        h.process(
            "service", ev, config=SchedulerConfig(preemption_service=False)
        )
        placed = [
            a
            for p in h.plans
            for allocs in p.node_allocation.values()
            for a in allocs
        ]
        assert placed == []

    def test_batch_jobs_do_not_preempt_by_default(self):
        h = Harness()
        node = _filled_node()
        h.state.upsert_node(h.next_index(), node)
        self._setup(h, node)

        batch_job = mock.job(priority=70, type="batch")
        batch_job.task_groups[0].count = 1
        t = batch_job.task_groups[0].tasks[0]
        t.resources.cpu = 2000
        t.resources.memory_mb = 4000
        h.state.upsert_job(h.next_index(), batch_job)
        ev = mock.eval_for_job(batch_job)
        h.process("batch", ev)
        placed = [
            a
            for p in h.plans
            for allocs in p.node_allocation.values()
            for a in allocs
        ]
        assert placed == []


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestServerPreemption:
    """End to end through the server pipeline: plan applier commits the
    evictions, the FSM flips desired status, and a preemption-triggered
    follow-up eval reschedules the loser."""

    def test_preempted_alloc_evicted_and_rescheduled(self):
        from nomad_tpu_torch.server import Server

        srv = Server(num_workers=1, scheduler_config=SchedulerConfig())
        srv.establish_leadership()
        try:
            node = _filled_node()
            node.status = "ready"
            srv.node_register(node)

            low_job = mock.job(priority=10)
            low_job.id = "low"
            low_job.task_groups[0].count = 1
            t = low_job.task_groups[0].tasks[0]
            t.resources.cpu = 3600
            t.resources.memory_mb = 7000
            srv.job_register(low_job)
            assert wait_until(
                lambda: len(
                    [
                        a
                        for a in srv.state.allocs_by_job("default", "low")
                        if a.desired_status == "run"
                    ]
                )
                == 1
            ), "low-priority job never placed"

            high_job = mock.job(priority=70)
            high_job.id = "high"
            high_job.task_groups[0].count = 1
            t = high_job.task_groups[0].tasks[0]
            t.resources.cpu = 2000
            t.resources.memory_mb = 4000
            srv.job_register(high_job)

            assert wait_until(
                lambda: len(
                    [
                        a
                        for a in srv.state.allocs_by_job("default", "high")
                        if a.desired_status == "run"
                    ]
                )
                == 1
            ), "high-priority job never placed"
            evicted = [
                a
                for a in srv.state.allocs_by_job("default", "low")
                if a.desired_status == "evict"
            ]
            assert len(evicted) == 1
            assert evicted[0].preempted_by_allocation

            # preemption follow-up eval exists for the loser
            assert wait_until(
                lambda: any(
                    e.triggered_by == "preemption" and e.job_id == "low"
                    for e in srv.state.evals()
                )
            ), "no preemption follow-up eval"
        finally:
            srv.shutdown()


class TestPlanApplyPreemption:
    def test_rejected_node_drops_its_preemptions(self):
        """A node whose placement fails re-verification must not still
        evict its victims (the preemptions exist only to make room for
        that placement)."""
        from nomad_tpu_torch.server.plan_apply import evaluate_plan
        from nomad_tpu_torch.state import StateStore
        from nomad_tpu_torch.structs import Plan

        store = StateStore()
        node = _filled_node()
        store.upsert_node(1, node)
        low_job, low_alloc = None, _running_alloc(node, 10, 3600, 7000)
        store.upsert_job(2, low_alloc.job)
        store.upsert_allocs(3, [low_alloc])

        high_job = mock.job(priority=70)
        t = high_job.task_groups[0].tasks[0]
        # stale plan: placement that does NOT fit current state even
        # after the preemption (low alloc still counted by verifier
        # minus preemption = 0 used; ask exceeds capacity)
        t.resources.cpu = 9999
        t.resources.memory_mb = 9999
        plan = Plan(eval_id="e1", job=high_job)
        big = mock.alloc(job_=high_job, node_=node)
        big.resources.tasks["web"].cpu = 9999
        big.resources.tasks["web"].memory_mb = 9999
        plan.append_alloc(big, high_job)
        plan.append_preempted_alloc(low_alloc, big.id)

        result = evaluate_plan(store.snapshot(), plan)
        assert result.node_allocation == {}
        assert result.node_preemptions == {}, (
            "victims evicted without their placement"
        )

    def test_preemptor_counts_own_job_usage(self):
        """Non-candidate allocs (the placing job's own) still consume
        node capacity; the picker must keep picking victims until the
        ask truly fits."""
        node = _filled_node(cpu=1000, memory_mb=1000)
        own = _running_alloc(node, 50, 200, 200, job_id="me")
        v1 = _running_alloc(node, 10, 300, 300)
        v2 = _running_alloc(node, 10, 300, 300)
        p = Preemptor(70, "default", "me")
        p.set_node(node)
        p.set_candidates([own, v1, v2])
        picks = p.preempt_for_task_group(Resources(cpu=600, memory_mb=600))
        assert picks is not None
        assert len(picks) == 2, "must evict BOTH victims (own alloc stays)"
