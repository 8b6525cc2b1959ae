"""``tests/test_state_store.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``. The assertions are the reference's.
"""

import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Plan, PlanResult
from nomad_tpu_torch.structs.structs import (
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_STOP,
    EVAL_STATUS_BLOCKED,
    JOB_STATUS_DEAD,
    JOB_STATUS_RUNNING,
    NODE_SCHEDULING_INELIGIBLE,
    NODE_STATUS_DOWN,
    DrainStrategy,
)


def test_upsert_node_and_indexes():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1000, n)
    got = s.node_by_id(n.id)
    assert got is not None
    assert got.create_index == 1000 and got.modify_index == 1000
    s.update_node_status(1001, n.id, NODE_STATUS_DOWN)
    got2 = s.node_by_id(n.id)
    assert got2.status == NODE_STATUS_DOWN
    assert got2.create_index == 1000 and got2.modify_index == 1001
    assert s.table_index("nodes") == 1001


def test_snapshot_isolation():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    snap = s.snapshot()
    n2 = mock.node()
    s.upsert_node(2, n2)
    s.update_node_status(3, n.id, NODE_STATUS_DOWN)
    # snapshot still sees the old world
    assert len(snap.nodes()) == 1
    assert snap.node_by_id(n.id).status != NODE_STATUS_DOWN
    assert len(s.nodes()) == 2


def test_upsert_job_version_bump():
    s = StateStore()
    j = mock.job()
    s.upsert_job(10, j)
    assert s.job_by_id(j.namespace, j.id).version == 0
    j2 = j.copy()
    j2.task_groups[0].count = 20
    s.upsert_job(11, j2)
    stored = s.job_by_id(j.namespace, j.id)
    assert stored.version == 1
    # old version retained
    assert s.job_version(j.namespace, j.id, 0).task_groups[0].count == 10
    # unchanged spec does not bump
    s.upsert_job(12, stored.copy())
    assert s.job_by_id(j.namespace, j.id).version == 1


def test_stopped_job_is_dead():
    s = StateStore()
    j = mock.job()
    j.stop = True
    s.upsert_job(5, j)
    assert s.job_by_id(j.namespace, j.id).status == JOB_STATUS_DEAD


def test_upsert_plan_results_places_and_stops():
    s = StateStore()
    j = mock.job()
    n = mock.node()
    s.upsert_node(1, n)
    s.upsert_job(2, j)
    a = mock.alloc(j, n)
    s.upsert_allocs(3, [a])
    assert s.job_by_id(j.namespace, j.id).status == JOB_STATUS_RUNNING

    # now stop it and place a replacement through a plan result
    stop = a.copy()
    stop.desired_status = ALLOC_DESIRED_STATUS_STOP
    stop.desired_description = "test"
    replacement = mock.alloc(j, n, index=1)
    result = PlanResult(
        node_update={n.id: [stop]},
        node_allocation={n.id: [replacement]},
        alloc_index=4,
    )
    s.upsert_plan_results(4, result)
    stored_stop = s.alloc_by_id(a.id)
    assert stored_stop.desired_status == ALLOC_DESIRED_STATUS_STOP
    assert stored_stop.create_index == 3  # preserved
    assert s.alloc_by_id(replacement.id) is not None
    assert len(s.allocs_by_node(n.id)) == 2
    assert len(s.allocs_by_node_terminal(n.id, False)) == 1


def test_client_status_merge():
    s = StateStore()
    j = mock.job()
    n = mock.node()
    s.upsert_job(1, j)
    a = mock.alloc(j, n)
    s.upsert_allocs(2, [a])
    update = a.copy()
    update.client_status = ALLOC_CLIENT_STATUS_RUNNING
    s.update_allocs_from_client(3, [update])
    assert s.alloc_by_id(a.id).client_status == ALLOC_CLIENT_STATUS_RUNNING
    # a later server-side upsert without client state keeps it
    server_side = s.alloc_by_id(a.id).copy()
    server_side.client_status = "pending"
    s.upsert_allocs(4, [server_side])
    assert s.alloc_by_id(a.id).client_status == ALLOC_CLIENT_STATUS_RUNNING


def test_blocked_eval_dedup():
    s = StateStore()
    j = mock.job()
    s.upsert_job(1, j)
    e1 = mock.eval_for_job(j, status=EVAL_STATUS_BLOCKED)
    s.upsert_evals(2, [e1])
    e2 = mock.eval_for_job(j, status=EVAL_STATUS_BLOCKED)
    s.upsert_evals(3, [e2])
    assert s.eval_by_id(e1.id).status == "canceled"
    assert s.eval_by_id(e2.id).status == EVAL_STATUS_BLOCKED


def test_wait_for_index_blocks_until_write():
    s = StateStore()
    results = {}

    def waiter():
        results["idx"] = s.wait_for_index(["nodes"], 5, timeout_s=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    s.upsert_node(5, mock.node())
    t.join(timeout=5)
    assert results["idx"] == 5


def test_snapshot_min_index():
    s = StateStore()
    def writer():
        time.sleep(0.05)
        s.upsert_node(7, mock.node())

    t = threading.Thread(target=writer)
    t.start()
    snap = s.snapshot_min_index(7, timeout_s=5)
    t.join()
    assert snap.index >= 7
    with pytest.raises(TimeoutError):
        s.snapshot_min_index(99, timeout_s=0.05)


def test_node_drain_sets_ineligible():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    s.update_node_drain(2, n.id, DrainStrategy(deadline_s=60))
    got = s.node_by_id(n.id)
    assert got.drain
    assert got.scheduling_eligibility == NODE_SCHEDULING_INELIGIBLE
    s.update_node_drain(3, n.id, None, mark_eligible=True)
    assert not s.node_by_id(n.id).drain


def test_job_summary_counts():
    s = StateStore()
    j = mock.job()
    n = mock.node()
    s.upsert_job(1, j)
    a1 = mock.alloc(j, n, index=0)
    a2 = mock.alloc(j, n, index=1)
    s.upsert_allocs(2, [a1, a2])
    upd = a1.copy()
    upd.client_status = ALLOC_CLIENT_STATUS_RUNNING
    s.update_allocs_from_client(3, [upd])
    summary = s.job_summary_by_id(j.namespace, j.id)
    assert summary.summary["web"]["running"] == 1
    assert summary.summary["web"]["starting"] == 1
