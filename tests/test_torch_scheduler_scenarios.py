"""``tests/test_scheduler_scenarios.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``; a ``Harness`` pass given no config runs on that
default. The assertions are the reference's.
"""

from __future__ import annotations

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs import Constraint
from nomad_tpu_torch.structs.structs import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_BLOCKED,
    ReschedulePolicy,
    Resources,
    UpdateStrategy,
    now_ns,
)
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


BACKENDS = ["host", "tpu"]


def cfg(backend, **kw):
    return SchedulerConfig(backend=backend, small_batch_threshold=0, **kw)


def harness(n_nodes=10, **node_kw):
    h = Harness()
    for _ in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node(**node_kw))
    return h


def add_node(h, **meta):
    """Node with meta set BEFORE the class hash — feasibility is
    memoized per computed class, so post-hoc meta edits are a bug."""
    from nomad_tpu_torch.structs.node_class import compute_node_class

    n = mock.node()
    n.meta.update(meta)
    n.computed_class = compute_node_class(n)
    h.state.upsert_node(h.next_index(), n)
    return n


def run(h, job, backend, **ev_kw):
    ev = mock.eval_for_job(job, **ev_kw)
    h.process(job.type, ev, cfg(backend))
    return ev


def live(h, job):
    return [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]


def mark_running(h, job):
    ups = []
    for a in live(h, job):
        u = a.copy()
        u.client_status = ALLOC_CLIENT_STATUS_RUNNING
        ups.append(u)
    h.state.update_allocs_from_client(h.next_index(), ups)


def stored_job(h, job):
    return h.state.job_by_id(job.namespace, job.id)


def update_spec(h, job, **tg_kw):
    """Register a destructive new version (env change) with optional
    task-group field overrides; returns the STORED job."""
    updated = job.copy()
    updated.task_groups[0].tasks[0].env = {
        "REV": str(now_ns())
    }
    for k, v in tg_kw.items():
        setattr(updated.task_groups[0], k, v)
    h.state.upsert_job(h.next_index(), updated)
    return stored_job(h, job)


# ---------------------------------------------------------------------------
# registration shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_count_zero(backend):
    """TestServiceSched_JobRegister_CountZero: a zero-count group
    places nothing and completes."""
    h = harness(4)
    job = mock.job()
    job.task_groups[0].count = 0
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert not h.state.allocs_by_job(job.namespace, job.id)
    assert h.updates[-1].status == "complete"


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_memory_max_honored(backend):
    """TestServiceSched_JobRegister_MemoryMaxHonored: with
    oversubscription ON the scheduler packs by the RESERVE (memory_mb),
    not memory_max; the grant carries memory_max through."""
    h = Harness()
    n = mock.node()
    n.resources.memory_mb = 1000
    h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 2
    tg.tasks[0].resources = Resources(
        cpu=100, memory_mb=400, memory_max_mb=900
    )
    h.state.upsert_job(h.next_index(), job)
    ev = mock.eval_for_job(job)
    h.process(
        "service", ev,
        SchedulerConfig(
            backend=backend, small_batch_threshold=0,
            memory_oversubscription=True,
        ),
    )
    allocs = live(h, job)
    # 2x400 reserve fits in 1000 even though 2x900 max would not
    assert len(allocs) == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_feasible_and_infeasible_groups(backend):
    """TestServiceSched_JobRegister_FeasibleAndInfeasibleTG: one group
    places, the impossible one fails without sinking the other."""
    h = harness(4)
    job = mock.job()
    ok_tg = job.task_groups[0]
    ok_tg.count = 2
    bad_tg = ok_tg.copy()
    bad_tg.name = "impossible"
    bad_tg.count = 2
    bad_tg.constraints = [
        Constraint("${attr.kernel.name}", "not-an-os", "=")
    ]
    job.task_groups.append(bad_tg)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    allocs = live(h, job)
    assert len(allocs) == 2
    assert all(a.task_group == ok_tg.name for a in allocs)
    assert "impossible" in h.updates[-1].failed_tg_allocs


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_distinct_property_with_limit(backend):
    """TestServiceSched_JobRegister_DistinctProperty: rtarget N allows
    N instances per property value."""
    h = Harness()
    for i in range(3):
        add_node(h, rack=f"r{i}")
    job = mock.job()
    job.task_groups[0].count = 6
    job.constraints.append(
        Constraint("${meta.rack}", "2", "distinct_property")
    )
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    allocs = live(h, job)
    assert len(allocs) == 6
    per_rack: dict[str, int] = {}
    for a in allocs:
        node = h.state.node_by_id(a.node_id)
        per_rack[node.meta["rack"]] = per_rack.get(node.meta["rack"], 0) + 1
    assert all(v == 2 for v in per_rack.values()), per_rack


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_distinct_property_overflow_fails(backend):
    """More instances than distinct values x limit: overflow reports as
    failed placements, never a violation."""
    h = Harness()
    for i in range(2):
        add_node(h, rack=f"r{i}")
    job = mock.job()
    job.task_groups[0].count = 4
    job.constraints.append(
        Constraint("${meta.rack}", "1", "distinct_property")
    )
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    allocs = live(h, job)
    assert len(allocs) == 2
    racks = {
        h.state.node_by_id(a.node_id).meta["rack"] for a in allocs
    }
    assert len(racks) == 2
    assert h.updates[-1].failed_tg_allocs


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_task_group_distinct_property_incremental(backend):
    """TestServiceSched_JobRegister_DistinctProperty_TaskGroup_Incr:
    scaling up respects the distinctness of EXISTING allocs."""
    h = Harness()
    nodes = [add_node(h, zone=f"z{i}") for i in range(4)]
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 2
    tg.constraints = [Constraint("${meta.zone}", "", "distinct_property")]
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert len(live(h, job)) == 2
    # scale to 4: the two new placements must take the two FREE zones
    v1 = job.copy()
    v1.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), v1)
    run(h, stored_job(h, job), backend)
    allocs = live(h, job)
    assert len(allocs) == 4
    zones = {h.state.node_by_id(a.node_id).meta["zone"] for a in allocs}
    assert len(zones) == 4


# ---------------------------------------------------------------------------
# job modification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_modify_count_zero_stops_everything(backend):
    """TestServiceSched_JobModify_CountZero."""
    h = harness(6)
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert len(live(h, job)) == 10
    v1 = job.copy()
    v1.task_groups[0].count = 0
    h.state.upsert_job(h.next_index(), v1)
    run(h, stored_job(h, job), backend)
    assert not live(h, job)


@pytest.mark.parametrize("backend", BACKENDS)
def test_modify_datacenters_migrates(backend):
    """TestServiceSched_JobModify_Datacenters: narrowing datacenters
    replaces allocs stranded outside the new set."""
    h = Harness()
    for dc in ("dc1", "dc1", "dc2", "dc2"):
        h.state.upsert_node(h.next_index(), mock.node(datacenter=dc))
    job = mock.job()
    job.datacenters = ["dc1", "dc2"]
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert len(live(h, job)) == 4
    v1 = job.copy()
    v1.datacenters = ["dc1"]
    # also bump the spec so stranded allocs are replaced destructively
    v1.task_groups[0].tasks[0].env = {"REV": "2"}
    h.state.upsert_job(h.next_index(), v1)
    sj = stored_job(h, job)
    for _ in range(4):  # rolling passes
        run(h, sj, backend)
    allocs = live(h, job)
    assert allocs
    for a in allocs:
        node = h.state.node_by_id(a.node_id)
        assert node.datacenter == "dc1", "alloc left outside the dc set"


@pytest.mark.parametrize("backend", BACKENDS)
def test_modify_rolling_respects_max_parallel(backend):
    """TestServiceSched_JobModify_Rolling: destructive updates proceed
    max_parallel at a time, gated on health."""
    h = harness(8)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 6
    tg.update = UpdateStrategy(max_parallel=2, min_healthy_time_s=0)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    d = h.state.latest_deployment_by_job(job.namespace, job.id)
    if d is not None:
        h.state.update_alloc_deployment_health(
            h.next_index(), d.id, [a.id for a in live(h, job)], []
        )

    v1 = update_spec(h, job)
    run(h, v1, backend)
    new = [a for a in live(h, job) if a.job.version == v1.version]
    assert len(new) == 2, "first pass replaces exactly max_parallel"
    old = [a for a in live(h, job) if a.job.version == job.version]
    assert len(old) == 4

    # next pass is gated until the new allocs prove healthy
    run(h, v1, backend)
    new = [a for a in live(h, job) if a.job.version == v1.version]
    assert len(new) == 2, "unhealthy batch must gate the next wave"
    d = h.state.latest_deployment_by_job(job.namespace, job.id)
    h.state.update_alloc_deployment_health(
        h.next_index(), d.id, [a.id for a in new], []
    )
    run(h, v1, backend)
    new = [a for a in live(h, job) if a.job.version == v1.version]
    assert len(new) == 4, "healthy batch unlocks the next wave"


@pytest.mark.parametrize("backend", BACKENDS)
def test_modify_rolling_full_node_reuses_capacity(backend):
    """TestServiceSched_JobModify_Rolling_FullNode: a destructive update
    on a full node lands in the capacity its own stop vacates."""
    h = Harness()
    h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].resources = Resources(cpu=3600, memory_mb=512)
    tg.tasks[0].resources.networks = []
    tg.update = UpdateStrategy(max_parallel=1, min_healthy_time_s=0)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert len(live(h, job)) == 1
    mark_running(h, job)
    d = h.state.latest_deployment_by_job(job.namespace, job.id)
    if d is not None:
        h.state.update_alloc_deployment_health(
            h.next_index(), d.id, [a.id for a in live(h, job)], []
        )
    v1 = update_spec(h, job)
    run(h, v1, backend)
    allocs = live(h, job)
    assert len(allocs) == 1
    assert allocs[0].job.version == v1.version


@pytest.mark.parametrize("backend", BACKENDS)
def test_modify_sticky_allocs_stay_on_node(backend):
    """TestServiceSched_JobRegister_StickyAllocs: sticky ephemeral disk
    pins destructive replacements to their previous nodes."""
    h = harness(8)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 4
    tg.ephemeral_disk.sticky = True
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    before = {a.name: a.node_id for a in live(h, job)}
    v1 = update_spec(h, job)
    for _ in range(5):
        run(h, v1, backend)
        cur = live(h, job)
        if all(a.job.version == v1.version for a in cur) and len(cur) == 4:
            break
    after = {a.name: a.node_id for a in live(h, job)}
    assert len(after) == 4
    assert after == before, "sticky replacement moved off its node"


@pytest.mark.parametrize("backend", BACKENDS)
def test_chained_allocations(backend):
    """TestGenericSched_ChainedAlloc: destructive replacements link to
    their predecessors via previous_allocation."""
    h = harness(6)
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    first_ids = {a.name: a.id for a in live(h, job)}
    v1 = update_spec(h, job)
    for _ in range(5):
        run(h, v1, backend)
        cur = live(h, job)
        if all(a.job.version == v1.version for a in cur):
            break
        mark_running(h, job)
    for a in live(h, job):
        assert a.previous_allocation == first_ids[a.name], (
            "replacement must chain to the alloc it replaced"
        )


# ---------------------------------------------------------------------------
# deregistration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("purge", [True, False])
def test_deregister_stops_allocs(purge):
    """TestServiceSched_JobDeregister_{Purged,Stopped}."""
    h = harness(4)
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    run(h, job, "host")
    assert len(live(h, job)) == 4
    if purge:
        h.state.delete_job(h.next_index(), job.namespace, job.id)
    else:
        stopped = stored_job(h, job).copy()
        stopped.stop = True
        h.state.upsert_job(h.next_index(), stopped)
    h.process(
        "service",
        mock.eval_for_job(job, triggered_by="job-deregister"),
        cfg("host"),
    )
    assert not live(h, job)
    for a in h.state.allocs_by_job(job.namespace, job.id):
        assert a.desired_status == ALLOC_DESIRED_STATUS_STOP


# ---------------------------------------------------------------------------
# node lifecycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_node_down_batch_complete_not_replaced(backend):
    """TestBatchSched_Run_CompleteAlloc + NodeDown: a COMPLETE batch
    alloc on a dead node is not rerun."""
    h = harness(3)
    job = mock.batch_job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    allocs = live(h, job)
    assert len(allocs) == 2
    done = allocs[0].copy()
    done.client_status = ALLOC_CLIENT_STATUS_COMPLETE
    h.state.update_allocs_from_client(h.next_index(), [done])
    h.state.update_node_status(h.next_index(), done.node_id, "down")
    run(h, stored_job(h, job), backend, triggered_by="node-update")
    names = [a.name for a in live(h, job)]
    assert done.name not in names or len(names) <= 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_node_down_batch_running_is_replaced(backend):
    """TestBatchSched_Run_LostAlloc: RUNNING batch work on a dead node
    reruns elsewhere."""
    h = harness(3)
    job = mock.batch_job()
    job.task_groups[0].count = 1
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    victim = live(h, job)[0]
    h.state.update_node_status(h.next_index(), victim.node_id, "down")
    run(h, stored_job(h, job), backend, triggered_by="node-update")
    allocs = live(h, job)
    assert len(allocs) == 1
    assert allocs[0].node_id != victim.node_id
    assert allocs[0].name == victim.name


@pytest.mark.parametrize("backend", BACKENDS)
def test_node_back_up_no_churn(backend):
    """TestServiceSched_NodeUpdate: a node flapping back to ready must
    not move anything."""
    h = harness(4)
    job = mock.job()
    job.task_groups[0].count = 6
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    before = {a.id for a in live(h, job)}
    node = h.state.nodes()[0]
    h.state.update_node_status(h.next_index(), node.id, "ready")
    run(h, stored_job(h, job), backend, triggered_by="node-update")
    assert {a.id for a in live(h, job)} == before


def test_drain_queued_allocations_accounting():
    """TestServiceSched_NodeDrain_Queued_Allocations: when the drain's
    replacements cannot place, they surface as queued."""
    h = Harness()
    n1 = mock.node()
    n2 = mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 2
    tg.tasks[0].resources = Resources(cpu=1800, memory_mb=512)
    tg.tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), job)
    run(h, job, "host")
    mark_running(h, job)
    # drain the node holding allocs; the other node only fits one
    from nomad_tpu_torch.structs.structs import DesiredTransition, DrainStrategy

    by_node: dict[str, list] = {}
    for a in live(h, job):
        by_node.setdefault(a.node_id, []).append(a)
    drain_node = max(by_node, key=lambda k: len(by_node[k]))
    h.state.update_node_drain(
        h.next_index(), drain_node, DrainStrategy(deadline_s=60)
    )
    marks = {
        a.id: DesiredTransition(migrate=True) for a in by_node[drain_node]
    }
    h.state.update_alloc_desired_transition(h.next_index(), marks, [])
    ev = mock.eval_for_job(job, triggered_by="node-drain")
    h.process("service", ev, cfg("host"))
    assert len(live(h, job)) <= 2
    # anything unplaceable queued as blocked
    if len(live(h, job)) < 2:
        assert h.evals and any(
            e.status == EVAL_STATUS_BLOCKED for e in h.evals
        )


# ---------------------------------------------------------------------------
# reschedule policies
# ---------------------------------------------------------------------------


def _resched_job(attempts=1, interval_s=3600.0, delay_s=0.0):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.reschedule_policy = ReschedulePolicy(
        attempts=attempts,
        interval_s=interval_s,
        delay_s=delay_s,
        delay_function="constant",
        unlimited=False,
    )
    return job


@pytest.mark.parametrize("backend", BACKENDS)
def test_reschedule_now_once_then_exhausted(backend):
    """TestServiceSched_Reschedule_OnceNow: one attempt allowed — the
    first failure reschedules, the second stays down."""
    h = harness(4)
    job = _resched_job(attempts=1)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    a1 = live(h, job)[0]
    fail = a1.copy()
    fail.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    allocs = live(h, job)
    assert len(allocs) == 1
    a2 = allocs[0]
    assert a2.id != a1.id
    assert a2.previous_allocation == a1.id
    assert a2.reschedule_tracker is not None
    assert len(a2.reschedule_tracker.events) == 1

    fail2 = a2.copy()
    fail2.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail2])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    replacements = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if a.previous_allocation == a2.id
    ]
    assert not replacements, "attempts exhausted: no further reschedule"


@pytest.mark.parametrize("backend", BACKENDS)
def test_reschedule_later_creates_followup_eval(backend):
    """TestServiceSched_Reschedule_Later: a delay schedules a follow-up
    eval instead of an immediate replacement."""
    h = harness(4)
    job = _resched_job(attempts=3, delay_s=3600.0)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    a1 = live(h, job)[0]
    fail = a1.copy()
    fail.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    # no replacement yet
    replacements = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if a.previous_allocation == a1.id
    ]
    assert not replacements
    followups = [e for e in h.evals if e.wait_until_ns > 0]
    assert followups, "delayed reschedule must create a follow-up eval"
    # the failed alloc is annotated with the follow-up id
    stored = h.state.alloc_by_id(a1.id)
    assert stored.followup_eval_id == followups[0].id


@pytest.mark.parametrize("backend", BACKENDS)
def test_reschedule_avoids_previous_node(backend):
    """TestServiceSched_JobModify_NodeReschedulePenalty: the
    replacement lands on a different node when alternatives exist."""
    h = harness(6)
    job = _resched_job(attempts=5)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    a1 = live(h, job)[0]
    fail = a1.copy()
    fail.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    a2 = live(h, job)[0]
    assert a2.node_id != a1.node_id, "reschedule must avoid the old node"


def test_reschedule_tracker_prunes_old_events():
    """TestServiceSched_Reschedule_PruneEvents: the tracker keeps a
    bounded window of reschedule events."""
    h = harness(8)
    job = _resched_job(attempts=3, interval_s=10.0)
    job.task_groups[0].reschedule_policy.unlimited = True
    h.state.upsert_job(h.next_index(), job)
    run(h, job, "host")
    for _ in range(8):
        a = live(h, job)[0]
        fail = a.copy()
        fail.client_status = ALLOC_CLIENT_STATUS_FAILED
        h.state.update_allocs_from_client(h.next_index(), [fail])
        run(h, stored_job(h, job), "host", triggered_by="alloc-failure")
        if not live(h, job):
            break
    allocs = live(h, job)
    assert allocs
    tracker = allocs[0].reschedule_tracker
    assert tracker is not None
    # bounded: never grows past the reference's event cap (5) + slack
    assert len(tracker.events) <= 6, len(tracker.events)


# ---------------------------------------------------------------------------
# batch semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_rerun_of_finished_job_is_noop(backend):
    """TestBatchSched_ReRun_SuccessfullyFinishedAlloc."""
    h = harness(3)
    job = mock.batch_job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    ups = []
    for a in live(h, job):
        u = a.copy()
        u.client_status = ALLOC_CLIENT_STATUS_COMPLETE
        ups.append(u)
    h.state.update_allocs_from_client(h.next_index(), ups)
    plans_before = len(h.plans)
    run(h, stored_job(h, job), backend)
    assert len(h.plans) == plans_before, "finished batch re-eval is a no-op"


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_failed_alloc_is_rerun(backend):
    """TestBatchSched_Run_FailedAlloc (batch default policy allows a
    retry through the reschedule path)."""
    h = harness(3)
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.reschedule_policy = ReschedulePolicy(
        attempts=1, interval_s=3600.0, delay_s=0.0,
        delay_function="constant", unlimited=False,
    )
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    a1 = live(h, job)[0]
    fail = a1.copy()
    fail.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    allocs = live(h, job)
    assert len(allocs) == 1 and allocs[0].id != a1.id


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_destructive_update_ignores_terminal(backend):
    """TestBatchSched_JobModify_Destructive_Terminal: COMPLETE batch
    allocs of the old version are never replaced by an update."""
    h = harness(3)
    job = mock.batch_job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    ups = []
    for a in live(h, job):
        u = a.copy()
        u.client_status = ALLOC_CLIENT_STATUS_COMPLETE
        ups.append(u)
    h.state.update_allocs_from_client(h.next_index(), ups)
    v1 = job.copy()
    v1.task_groups[0].tasks[0].env = {"REV": "2"}
    h.state.upsert_job(h.next_index(), v1)
    sj = stored_job(h, job)
    run(h, sj, backend)
    # the new version places fresh instances; completed old ones rest
    fresh = [a for a in live(h, job)]
    for a in fresh:
        assert a.job.version == sj.version
    terminal = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == ALLOC_CLIENT_STATUS_COMPLETE
    ]
    for a in terminal:
        assert a.desired_status != ALLOC_DESIRED_STATUS_STOP, (
            "terminal batch allocs must not be churned by updates"
        )


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_scale_down_same_name(backend):
    """TestBatchSched_ScaleDown_SameName: scale-down keeps the
    lowest-indexed names."""
    h = harness(4)
    job = mock.batch_job()
    job.task_groups[0].count = 5
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    mark_running(h, job)
    v1 = job.copy()
    v1.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), v1)
    run(h, stored_job(h, job), backend)
    allocs = live(h, job)
    assert len(allocs) == 2
    assert sorted(a.index() for a in allocs) == [0, 1]


# ---------------------------------------------------------------------------
# misc parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_running_with_next_allocation_ignored(backend):
    """TestServiceSched_RunningWithNextAllocation: a terminal alloc
    whose replacement exists is never double-replaced."""
    h = harness(4)
    job = _resched_job(attempts=5)
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    a1 = live(h, job)[0]
    fail = a1.copy()
    fail.client_status = ALLOC_CLIENT_STATUS_FAILED
    h.state.update_allocs_from_client(h.next_index(), [fail])
    run(h, stored_job(h, job), backend, triggered_by="alloc-failure")
    assert len(live(h, job)) == 1
    # re-evaluating repeatedly must not spawn more replacements
    for _ in range(3):
        run(h, stored_job(h, job), backend)
    assert len(live(h, job)) == 1
    total = len(h.state.allocs_by_job(job.namespace, job.id))
    assert total == 2  # original + one replacement


@pytest.mark.parametrize("backend", BACKENDS)
def test_annotations_on_plan_eval(backend):
    """TestServiceSched_JobRegister_Annotate: annotate_plan surfaces
    per-group DesiredTGUpdates counts."""
    h = harness(4)
    job = mock.job()
    job.task_groups[0].count = 3
    h.state.upsert_job(h.next_index(), job)
    ev = mock.eval_for_job(job)
    ev.annotate_plan = True
    h.process("service", ev, cfg(backend))
    assert h.plans
    ann = h.plans[-1].annotations
    assert ann and "DesiredTGUpdates" in ann
    assert ann["DesiredTGUpdates"]["web"]["place"] == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_disk_constraint_blocks_placement(backend):
    """TestServiceSched_JobRegister_DiskConstraints: an oversized
    ephemeral disk ask fails placement."""
    h = Harness()
    n = mock.node()
    n.resources.disk_mb = 1000
    h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.ephemeral_disk.size_mb = 20_000
    h.state.upsert_job(h.next_index(), job)
    run(h, job, backend)
    assert not live(h, job)
    assert h.updates[-1].failed_tg_allocs


# ---------------------------------------------------------------------------
# system scheduler scenarios (reference scheduler_system_test.go)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_exhaust_resources(backend):
    """TestSystemSched_ExhaustResources: a full node fails the system
    placement instead of overcommitting."""
    h = Harness()
    n = mock.node()
    h.state.upsert_node(h.next_index(), n)
    fat = mock.job(id="fat")
    fat.task_groups[0].count = 1
    fat.task_groups[0].tasks[0].resources = Resources(cpu=3800, memory_mb=256)
    fat.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), fat)
    run(h, fat, backend)
    assert len(live(h, fat)) == 1

    sysjob = mock.system_job(id="sys")
    sysjob.task_groups[0].tasks[0].resources = Resources(
        cpu=500, memory_mb=64
    )
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    ev = mock.eval_for_job(sysjob)
    h.process("system", ev, cfg(backend))
    assert not live(h, sysjob), "system job must not overcommit the node"
    # capacity safety held
    used = sum(
        a.comparable_resources().cpu
        for a in h.state.allocs_by_node_terminal(n.id, False)
    )
    assert used <= n.resources.cpu


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_add_node_gets_constrainted_alloc_only_when_feasible(backend):
    """TestSystemSched_JobConstraint_AddNode: a new node only receives
    the system alloc when it satisfies the job's constraints."""
    h = Harness()
    good = add_node(h, role="edge")
    sysjob = mock.system_job(id="edge-agent")
    sysjob.constraints.append(Constraint("${meta.role}", "edge", "="))
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    h.process("system", mock.eval_for_job(sysjob), cfg(backend))
    assert len(live(h, sysjob)) == 1

    # an ineligible node joins: no new alloc
    plain = mock.node()
    h.state.upsert_node(h.next_index(), plain)
    h.process(
        "system",
        mock.eval_for_job(sysjob, triggered_by="node-update"),
        cfg(backend),
    )
    assert len(live(h, sysjob)) == 1
    # an eligible node joins: one more
    edge2 = add_node(h, role="edge")
    h.process(
        "system",
        mock.eval_for_job(sysjob, triggered_by="node-update"),
        cfg(backend),
    )
    allocs = live(h, sysjob)
    assert len(allocs) == 2
    assert {a.node_id for a in allocs} == {good.id, edge2.id}


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_job_modify_destructive(backend):
    """TestSystemSched_JobModify: a spec change replaces every system
    alloc with the new version."""
    h = harness(4)
    sysjob = mock.system_job(id="sysmod")
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    h.process("system", mock.eval_for_job(sysjob), cfg(backend))
    assert len(live(h, sysjob)) == 4
    sj = update_spec(h, sysjob)
    h.process("system", mock.eval_for_job(sj), cfg(backend))
    allocs = live(h, sysjob)
    assert len(allocs) == 4
    assert all(a.job.version == sj.version for a in allocs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_node_down_marks_lost_no_replacement_elsewhere(backend):
    """TestSystemSched_NodeDown: a system alloc on a dead node is lost;
    system jobs never 'move' it to another node (every live node
    already has its own)."""
    h = harness(3)
    sysjob = mock.system_job(id="sysdown")
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    h.process("system", mock.eval_for_job(sysjob), cfg(backend))
    assert len(live(h, sysjob)) == 3
    victim_node = h.state.nodes()[0]
    h.state.update_node_status(h.next_index(), victim_node.id, "down")
    h.process(
        "system",
        mock.eval_for_job(sysjob, triggered_by="node-update"),
        cfg(backend),
    )
    allocs = live(h, sysjob)
    assert len(allocs) == 2
    assert victim_node.id not in {a.node_id for a in allocs}


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_deregister_stops_all(backend):
    """TestSystemSched_JobDeregister_Stopped."""
    h = harness(3)
    sysjob = mock.system_job(id="sysstop")
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    h.process("system", mock.eval_for_job(sysjob), cfg(backend))
    assert len(live(h, sysjob)) == 3
    stopped = stored_job(h, sysjob).copy()
    stopped.stop = True
    h.state.upsert_job(h.next_index(), stopped)
    h.process(
        "system",
        mock.eval_for_job(stopped, triggered_by="job-deregister"),
        cfg(backend),
    )
    assert not live(h, sysjob)


@pytest.mark.parametrize("backend", BACKENDS)
def test_system_queued_with_constraints(backend):
    """TestSystemSched_Queued_With_Constraints: nodes filtered by
    constraints count as neither queued nor failed placements
    (reference scheduler_system.go:308-322)."""
    h = Harness()
    for i in range(4):
        add_node(h, role="edge" if i == 0 else "core")
    sysjob = mock.system_job(id="sysq")
    sysjob.constraints.append(Constraint("${meta.role}", "edge", "="))
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), sysjob)
    ev = mock.eval_for_job(sysjob)
    h.process("system", ev, cfg(backend))
    assert len(live(h, sysjob)) == 1
    assert ev.queued_allocations.get("web", 0) == 0, ev.queued_allocations
    assert not h.updates[-1].failed_tg_allocs
