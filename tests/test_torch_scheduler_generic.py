"""``tests/test_scheduler_generic.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``; a ``Harness`` pass given no config runs on that
default. The assertions are the reference's.
"""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE,
    Constraint,
    NODE_STATUS_DOWN,
)
from nomad_tpu_torch.structs.structs import EVAL_TRIGGER_NODE_UPDATE
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


def test_job_register_places_all():
    h = Harness()
    for _ in range(10):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    ev = mock.eval_for_job(job)

    h.process("service", ev)

    assert len(h.plans) == 1
    plan = h.plans[0]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 10
    # all named uniquely, resources attached
    names = {a.name for a in placed}
    assert len(names) == 10
    assert all(a.resources is not None for a in placed)
    assert all(a.metrics.nodes_available.get("dc1") == 10 for a in placed)
    # eval marked complete
    assert h.updates[-1].status == EVAL_STATUS_COMPLETE
    # allocs live in state
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 10


def test_job_register_idempotent():
    h = Harness()
    for _ in range(10):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", ev := mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 10
    # re-evaluate same job: nothing to do
    h.process("service", mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 10
    assert len(h.plans) == 1  # second pass produced a no-op (no plan)


def test_no_nodes_creates_blocked_eval():
    h = Harness()
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    assert len(h.evals) == 1
    blocked = h.evals[0]
    assert blocked.status == EVAL_STATUS_BLOCKED
    assert h.updates[-1].status == EVAL_STATUS_COMPLETE
    assert "web" in h.updates[-1].failed_tg_allocs
    assert h.updates[-1].queued_allocations["web"] == 10


def test_partial_capacity_places_some_blocks_rest():
    h = Harness()
    # one node: fits 8 x 500MHz (4000 total)
    h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    placed = h.state.allocs_by_job(job.namespace, job.id)
    assert 0 < len(placed) < 10
    assert len(h.evals) == 1  # blocked eval for the remainder
    assert h.evals[0].status == EVAL_STATUS_BLOCKED


def test_constraint_filters_nodes():
    h = Harness()
    good = mock.node()
    bad = mock.node()
    bad.attributes["kernel.name"] = "windows"
    from nomad_tpu_torch.structs.node_class import compute_node_class
    bad.computed_class = compute_node_class(bad)
    h.state.upsert_node(h.next_index(), good)
    h.state.upsert_node(h.next_index(), bad)
    job = mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    placed = h.state.allocs_by_job(job.namespace, job.id)
    assert len(placed) == 2
    assert all(a.node_id == good.id for a in placed)


def test_scale_down_stops_highest_indexes():
    h = Harness()
    for _ in range(5):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 10

    smaller = h.state.job_by_id(job.namespace, job.id).copy()
    smaller.task_groups[0].count = 3
    h.state.upsert_job(h.next_index(), smaller)
    h.process("service", mock.eval_for_job(smaller))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert len(live) == 3
    assert sorted(a.index() for a in live) == [0, 1, 2]


def test_job_deregister_stops_all():
    h = Harness()
    for _ in range(3):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    stopped = h.state.job_by_id(job.namespace, job.id).copy()
    stopped.stop = True
    h.state.upsert_job(h.next_index(), stopped)
    h.process("service", mock.eval_for_job(stopped))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert live == []


def test_node_down_reschedules():
    h = Harness()
    n1 = mock.node()
    n2 = mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    # make them running
    ups = []
    for a in allocs:
        u = a.copy()
        u.client_status = ALLOC_CLIENT_STATUS_RUNNING
        ups.append(u)
    h.state.update_allocs_from_client(h.next_index(), ups)

    on_n1 = sum(1 for a in allocs if a.node_id == n1.id)
    h.state.update_node_status(h.next_index(), n1.id, NODE_STATUS_DOWN)
    h.process(
        "service",
        mock.eval_for_job(job, triggered_by=EVAL_TRIGGER_NODE_UPDATE, node_id=n1.id),
    )
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert len(live) == 2
    assert all(a.node_id == n2.id for a in live)
    # the allocs that were on the downed node are marked lost
    lost = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == "lost"
    ]
    assert len(lost) == on_n1 > 0


def test_node_drain_migrates():
    h = Harness()
    n1 = mock.node()
    n2 = mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))

    from nomad_tpu_torch.server.drainer import NodeDrainer
    from nomad_tpu_torch.structs import DrainStrategy

    h.state.update_node_drain(h.next_index(), n1.id, DrainStrategy(deadline_s=600))
    # The drainer subsystem marks allocs for migration (rate-limited); the
    # reconciler only migrates marked allocs (reference drainer + reconciler
    # split). Deadline -1 = force-drain everything at once.
    drainer = NodeDrainer(
        h.state, lambda t, p: h.state.update_alloc_desired_transition(
            h.next_index(), *p
        ) if t == "alloc_update_desired_transition" else None
    )
    h.state.update_node_drain(h.next_index(), n1.id, DrainStrategy(deadline_s=-1))
    drainer.run_once()
    h.process("service", mock.eval_for_job(job, triggered_by="node-drain"))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert len(live) == 2
    assert all(a.node_id == n2.id for a in live)


def test_destructive_update_replaces():
    h = Harness()
    for _ in range(4):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    v0_allocs = {a.id for a in h.state.allocs_by_job(job.namespace, job.id)}

    updated = h.state.job_by_id(job.namespace, job.id).copy()
    updated.task_groups[0].tasks[0].env = {"NEW": "env"}
    h.state.upsert_job(h.next_index(), updated)
    stored = h.state.job_by_id(job.namespace, job.id)
    assert stored.version == 1

    # drive rolling update to completion (max_parallel=5 covers all 4)
    h.process("service", mock.eval_for_job(stored))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert len(live) == 4
    assert all(a.id not in v0_allocs for a in live)
    assert all(a.job.version == 1 for a in live)
    # deployment created
    d = h.state.latest_deployment_by_job(job.namespace, job.id)
    assert d is not None
    assert d.job_version == 1


def test_inplace_update_keeps_allocs():
    h = Harness()
    for _ in range(4):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    v0_ids = {a.id for a in h.state.allocs_by_job(job.namespace, job.id)}

    updated = h.state.job_by_id(job.namespace, job.id).copy()
    updated.task_groups[0].reschedule_policy.delay_s = 77  # in-place-safe
    h.state.upsert_job(h.next_index(), updated)
    stored = h.state.job_by_id(job.namespace, job.id)
    assert stored.version == 1
    h.process("service", mock.eval_for_job(stored))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert {a.id for a in live} == v0_ids
    assert all(a.job.version == 1 for a in live)


def test_failed_alloc_rescheduled_with_penalty():
    h = Harness()
    n1 = mock.node()
    n2 = mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.job()
    job.task_groups[0].count = 1
    # immediate reschedule policy
    job.task_groups[0].reschedule_policy.delay_s = 0
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    alloc = h.state.allocs_by_job(job.namespace, job.id)[0]
    failed = alloc.copy()
    failed.client_status = ALLOC_CLIENT_STATUS_FAILED
    import time

    failed.task_states = {}
    h.state.update_allocs_from_client(h.next_index(), [failed])

    h.process("service", mock.eval_for_job(job, triggered_by="alloc-failure"))
    live = [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status() and a.client_status == "pending"
    ]
    assert len(live) == 1
    replacement = live[0]
    assert replacement.previous_allocation == alloc.id
    assert replacement.reschedule_tracker is not None
    assert len(replacement.reschedule_tracker.events) == 1


def test_batch_complete_not_replaced():
    h = Harness()
    h.state.upsert_node(h.next_index(), mock.node())
    job = mock.batch_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("batch", mock.eval_for_job(job))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == 1
    done = allocs[0].copy()
    done.client_status = "complete"
    h.state.update_allocs_from_client(h.next_index(), [done])
    h.process("batch", mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 1  # no new


def test_distinct_hosts():
    h = Harness()
    for _ in range(3):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    job.constraints.append(Constraint(operand="distinct_hosts"))
    job.task_groups[0].count = 5
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    live = h.state.allocs_by_job(job.namespace, job.id)
    # only 3 nodes -> only 3 placements, rest blocked
    assert len(live) == 3
    assert len({a.node_id for a in live}) == 3
    assert h.evals and h.evals[0].status == EVAL_STATUS_BLOCKED


def test_spread_across_datacenters():
    h = Harness()
    for i in range(4):
        n = mock.node()
        n.datacenter = "dc1" if i < 2 else "dc2"
        from nomad_tpu_torch.structs.node_class import compute_node_class

        n.computed_class = compute_node_class(n)
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    job.datacenters = ["dc1", "dc2"]
    from nomad_tpu_torch.structs import Spread

    job.spreads = [Spread(attribute="${node.datacenter}", weight=100)]
    job.task_groups[0].count = 4
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    live = h.state.allocs_by_job(job.namespace, job.id)
    assert len(live) == 4
    by_dc = {}
    for a in live:
        node = h.state.node_by_id(a.node_id)
        by_dc[node.datacenter] = by_dc.get(node.datacenter, 0) + 1
    assert by_dc == {"dc1": 2, "dc2": 2}


def test_affinity_prefers_matching_nodes():
    # Two nodes so the log2(n) candidate limit (=2) visits both and the
    # affinity score decides deterministically.
    h = Harness()
    plain = [mock.node()]
    special = mock.node()
    special.node_class = "special"
    from nomad_tpu_torch.structs.node_class import compute_node_class

    special.computed_class = compute_node_class(special)
    for n in plain + [special]:
        h.state.upsert_node(h.next_index(), n)
    job = mock.job()
    from nomad_tpu_torch.structs import Affinity

    job.affinities = [
        Affinity(ltarget="${node.class}", rtarget="special", operand="=", weight=100)
    ]
    job.task_groups[0].count = 1
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    live = h.state.allocs_by_job(job.namespace, job.id)
    assert len(live) == 1
    assert live[0].node_id == special.id


def test_reject_plan_forces_retry_then_fail():
    from nomad_tpu_torch.testing import RejectPlanHarness as _Rej

    class RejectPlanHarness(_Rej):
        def process(self, scheduler_name, eval_obj, config=None, **kw):
            return super().process(scheduler_name, eval_obj,
                                   config or SchedulerConfig(), **kw)

    h = RejectPlanHarness()
    for _ in range(2):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    # scheduler retried up to the max, then failed the eval
    assert len(h.plans) == 5
    assert h.updates[-1].status == "failed"


def test_dedicated_cores_disjoint_and_exhausting():
    """`resources { cores }` grants DISJOINT core ids per node, derives
    the cpu share from the node's MHz/core, and exhausts once a node's
    cores are spoken for (reference rank.go AllocatedCpuResources)."""
    h = Harness()
    node = mock.node()  # 4 cores, 4000 MHz
    h.state.upsert_node(h.next_index(), node)
    job = mock.job(id="pinned")
    tg = job.task_groups[0]
    tg.count = 2
    tg.tasks[0].resources.cores = 2
    tg.tasks[0].resources.cpu = 100
    h.state.upsert_job(h.next_index(), job)
    h.process("service", mock.eval_for_job(job))
    placed = [
        a
        for plan in h.plans
        for allocs in plan.node_allocation.values()
        for a in allocs
    ]
    assert len(placed) == 2
    grants = [
        list(a.resources.tasks.values())[0].reserved_cores for a in placed
    ]
    assert all(len(g) == 2 for g in grants)
    assert len(set(grants[0]) | set(grants[1])) == 4, (
        f"ids must be disjoint: {grants}"
    )
    # derived cpu: 2 cores x (4000/4) MHz
    assert all(
        list(a.resources.tasks.values())[0].cpu == 2000 for a in placed
    )
    # a third 2-core alloc has nowhere to go: blocked
    job2 = mock.job(id="pinned-2")
    job2.task_groups[0].count = 1
    job2.task_groups[0].tasks[0].resources.cores = 2
    h.state.upsert_job(h.next_index(), job2)
    h.process("service", mock.eval_for_job(job2))
    assert not h.state.allocs_by_job("default", "pinned-2")


def test_dedicated_cores_tpu_backend_parity():
    """The TPU backend's materializer assigns the same disjoint-id
    invariant (counts screened in the dense solve, ids at materialize)."""

    h = Harness()
    for _ in range(2):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.job(id="pinned-tpu")
    tg = job.task_groups[0]
    tg.count = 4
    tg.tasks[0].resources.cores = 2
    h.state.upsert_job(h.next_index(), job)
    h.process(
        "service", mock.eval_for_job(job),
        config=SchedulerConfig(backend="tpu", small_batch_threshold=0),
    )
    placed = [
        a
        for plan in h.plans
        for allocs in plan.node_allocation.values()
        for a in allocs
    ]
    assert len(placed) == 4  # 2 nodes x 4 cores / 2 per alloc
    by_node = {}
    for a in placed:
        ids = list(a.resources.tasks.values())[0].reserved_cores
        assert len(ids) == 2
        by_node.setdefault(a.node_id, []).extend(ids)
    for node_id, ids in by_node.items():
        assert len(ids) == len(set(ids)) == 4, (
            f"core collision on {node_id}: {ids}"
        )


def test_allocs_fit_rejects_core_collision():
    """The plan applier's backstop: duplicate core ids on one node fail
    verification (reference funcs.go AllocsFit)."""
    from nomad_tpu_torch.structs.funcs import allocs_fit
    from nomad_tpu_torch.structs.structs import (
        AllocatedResources,
        AllocatedTaskResources,
    )

    node = mock.node()
    a1 = mock.alloc()
    a1.resources = AllocatedResources(
        tasks={"t": AllocatedTaskResources(
            cpu=1000, memory_mb=64, reserved_cores=[0, 1]
        )}
    )
    a2 = mock.alloc()
    a2.resources = AllocatedResources(
        tasks={"t": AllocatedTaskResources(
            cpu=1000, memory_mb=64, reserved_cores=[1, 2]
        )}
    )
    ok, dim, _ = allocs_fit(node, [a1, a2])
    assert not ok and "cores" in dim
    a2.resources.tasks["t"].reserved_cores = [2, 3]
    ok, _, _ = allocs_fit(node, [a1, a2])
    assert ok
