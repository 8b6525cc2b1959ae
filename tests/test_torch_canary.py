"""The reference's canary battery against the port, on the CPU: the 20
cases of tests/test_canary.py (scenario shapes from the reference's
reconcile_test.go canary families plus the state store's canary
bookkeeping), with the same assertions, on the port's Harness.
Placement-bearing scenarios run on both of the port's backends: the host
iterator stack ("host") and the card's batch solver on its plain twins
("gpu", device "cpu", small_batch_threshold=0 so the kernel route really
runs), where nomad_tpu runs "host" and "tpu".
"""

from __future__ import annotations

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.structs.structs import (
    DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    UpdateStrategy,
)
from nomad_tpu_torch.testing import Harness

BACKENDS = ["host", "gpu"]


def cfg(backend):
    return SchedulerConfig(backend=backend, small_batch_threshold=0,
                           device="cpu")


def make_cluster(n_nodes=8):
    h = Harness()
    for _ in range(n_nodes):
        h.state.upsert_node(h.next_index(), mock.node())
    return h


def canary_job(count=4, canary=2, max_parallel=2, auto_promote=False):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.networks = []
    tg.update = UpdateStrategy(
        max_parallel=max_parallel, canary=canary, auto_promote=auto_promote
    )
    return job


def run_eval(h, job, backend, **ev_kw):
    h.process(job.type, mock.eval_for_job(job, **ev_kw), cfg(backend))


def live(h, job):
    return [
        a
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]


def canaries_of(h, job):
    return [
        a
        for a in live(h, job)
        if a.deployment_status is not None and a.deployment_status.canary
    ]


def latest_deployment(h, job):
    return h.state.latest_deployment_by_job(job.namespace, job.id)


def mark_deployment_healthy(h, dep_id, ids):
    h.state.update_alloc_deployment_health(h.next_index(), dep_id, list(ids), [])


def update_job(h, job, count=None):
    """Register a destructively-changed new version; the store bumps the
    version itself, so return the STORED job."""
    updated = job.copy()
    updated.task_groups[0].tasks[0].env = {"V": str(job.version + 1)}
    if count is not None:
        updated.task_groups[0].count = count
    h.state.upsert_job(h.next_index(), updated)
    return h.state.job_by_id(job.namespace, job.id)


def deploy_v0(h, job, backend):
    """Place v0 and drive its deployment to successful."""
    h.state.upsert_job(h.next_index(), job)
    run_eval(h, job, backend)
    assert len(live(h, job)) == job.task_groups[0].count
    d = latest_deployment(h, job)
    if d is not None:
        mark_deployment_healthy(h, d.id, [a.id for a in live(h, job)])
        run_eval(h, job, backend)
        d = latest_deployment(h, job)
        assert d.status == DEPLOYMENT_STATUS_SUCCESSFUL, d.status
    return job


# ---------------------------------------------------------------------------
# placement of new canaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_new_canaries_placed_old_untouched(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)

    cs = canaries_of(h, v1)
    assert len(cs) == 2
    for a in cs:
        assert a.job.version == v1.version
    # old allocs all still running at v0 (no destructive yet)
    old = [a for a in live(h, v1) if a.job.version == job.version]
    assert len(old) == 4
    d = latest_deployment(h, v1)
    ds = d.task_groups["web"]
    assert ds.desired_canaries == 2
    assert not ds.promoted
    assert sorted(ds.placed_canaries) == sorted(a.id for a in cs)
    assert "promotion" in d.status_description


@pytest.mark.parametrize("backend", BACKENDS)
def test_canary_names_prefer_destructive_indexes(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    names = sorted(a.name for a in canaries_of(h, v1))
    # canaries take the lowest destructive indexes: [0] and [1]
    assert names == [f"{v1.id}.web[0]", f"{v1.id}.web[1]"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_canary_count_greater_than_group_count(backend):
    h = make_cluster(10)
    job = deploy_v0(h, canary_job(count=3, canary=5), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    names = sorted(a.name for a in canaries_of(h, v1))
    # 3 destructive indexes, then overflow past count: [3], [4]
    assert names == [f"{v1.id}.web[{i}]" for i in range(5)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_second_eval_places_no_more_canaries(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    run_eval(h, v1, backend)  # idempotent while unpromoted
    assert len(canaries_of(h, v1)) == 2
    assert len(live(h, v1)) == 6  # 4 old + 2 canaries


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_destructive_updates_before_promotion(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    d = latest_deployment(h, v1)
    mark_deployment_healthy(h, d.id, [a.id for a in canaries_of(h, v1)])
    run_eval(h, v1, backend)  # healthy but NOT promoted: still gated
    old = [a for a in live(h, v1) if a.job.version == job.version]
    assert len(old) == 4


def test_zero_canary_update_rolls_immediately():
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=0, max_parallel=2), "host")
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    new = [a for a in live(h, v1) if a.job.version == v1.version]
    assert len(new) == 2  # max_parallel destructive updates, no canaries
    assert not canaries_of(h, v1)


# ---------------------------------------------------------------------------
# promotion
# ---------------------------------------------------------------------------


def promote(h, job, backend):
    d = latest_deployment(h, job)
    mark_deployment_healthy(h, d.id, [a.id for a in canaries_of(h, job)])
    h.state.update_deployment_promotion(h.next_index(), d.id)
    return latest_deployment(h, job)


@pytest.mark.parametrize("backend", BACKENDS)
def test_promotion_unblocks_rollout_and_stops_duplicates(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2, max_parallel=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    canary_names = {a.name for a in canaries_of(h, v1)}
    d = promote(h, v1, backend)
    assert d.task_groups["web"].promoted

    run_eval(h, v1, backend)
    # old allocs sharing the canaries' names are stopped first
    live_old = [a for a in live(h, v1) if a.job.version == job.version]
    assert not ({a.name for a in live_old} & canary_names)
    # rollout proceeds: total live never exceeds count + in-flight updates
    assert len(live(h, v1)) <= 6


@pytest.mark.parametrize("backend", BACKENDS)
def test_promoted_rollout_runs_to_completion(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2, max_parallel=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    promote(h, v1, backend)
    # drive eval + health until stable
    for _ in range(8):
        run_eval(h, v1, backend)
        d = latest_deployment(h, v1)
        cur = [a for a in live(h, v1) if a.job.version == v1.version]
        mark_deployment_healthy(h, d.id, [a.id for a in cur])
    allocs = live(h, v1)
    assert len(allocs) == 4
    assert all(a.job.version == v1.version for a in allocs)
    # distinct names [0..3]
    assert sorted(a.name for a in allocs) == [
        f"{v1.id}.web[{i}]" for i in range(4)
    ]
    d = latest_deployment(h, v1)
    assert d.status == DEPLOYMENT_STATUS_SUCCESSFUL


def test_promotion_clears_canary_flags_keeps_placed_list():
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), "host")
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    ids = sorted(a.id for a in canaries_of(h, v1))
    promote(h, v1, "host")
    d = latest_deployment(h, v1)
    assert sorted(d.task_groups["web"].placed_canaries) == ids
    for aid in ids:
        a = h.state.alloc_by_id(aid)
        assert a.deployment_status is not None
        assert not a.deployment_status.canary  # flag cleared on promote


# ---------------------------------------------------------------------------
# paused / failed deployments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("status", [DEPLOYMENT_STATUS_PAUSED, DEPLOYMENT_STATUS_FAILED])
def test_paused_or_failed_deployment_places_nothing_new(status):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), "host")
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    before_live = len(live(h, v1))
    d = latest_deployment(h, v1)
    from nomad_tpu_torch.structs.structs import DeploymentStatusUpdate

    h.state.update_deployment_status(
        h.next_index(),
        DeploymentStatusUpdate(deployment_id=d.id, status=status),
    )
    run_eval(h, v1, "host")
    if status == DEPLOYMENT_STATUS_PAUSED:
        # frozen: nothing placed, nothing stopped
        assert len(live(h, v1)) == before_live
    else:
        # failed: its canaries are stopped, old version keeps running
        assert not canaries_of(h, v1)
        old = [a for a in live(h, v1) if a.job.version == job.version]
        assert len(old) == 4


def test_failed_deployment_does_not_reschedule_its_failures():
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), "host")
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    d = latest_deployment(h, v1)
    # one canary fails, then the deployment fails
    cs = canaries_of(h, v1)
    failed = cs[0].copy()
    failed.client_status = "failed"
    h.state.upsert_allocs(h.next_index(), [failed])
    from nomad_tpu_torch.structs.structs import DeploymentStatusUpdate

    h.state.update_deployment_status(
        h.next_index(),
        DeploymentStatusUpdate(
            deployment_id=d.id, status=DEPLOYMENT_STATUS_FAILED
        ),
    )
    run_eval(h, v1, "host")
    # the failed canary must NOT be rescheduled (it belongs to the failed
    # deployment); all canaries stopped
    assert not canaries_of(h, v1)
    replacements = [
        a
        for a in live(h, v1)
        if a.previous_allocation == failed.id
    ]
    assert not replacements


# ---------------------------------------------------------------------------
# stale canaries / new versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_newer_version_stops_old_canaries_places_new(backend):
    h = make_cluster(10)
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    old_canary_ids = {a.id for a in canaries_of(h, v1)}
    v2 = update_job(h, v1)
    run_eval(h, v2, backend)
    cs = canaries_of(h, v2)
    # old canaries gone, two fresh v2 canaries
    assert not (old_canary_ids & {a.id for a in cs})
    assert len(cs) == 2
    assert all(a.job.version == v2.version for a in cs)
    # the v1 deployment was cancelled
    deps = h.state.deployments_by_job(v2.namespace, v2.id)
    v1_deps = [d for d in deps if d.job_version == v1.version]
    assert v1_deps and all(d.status == "cancelled" for d in v1_deps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lost_canary_replaced_by_new_canary(backend):
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    victim = canaries_of(h, v1)[0]
    h.state.update_node_status(h.next_index(), victim.node_id, "down")
    run_eval(h, v1, backend, triggered_by="node-update")
    # binpack may have colocated old allocs with the victim; one more
    # eval converges (v0 replacements become destructive -> canaries)
    run_eval(h, v1, backend)
    cs = canaries_of(h, v1)
    assert len(cs) == 2, "lost canary must be replaced to desired_canaries"
    assert victim.id not in {a.id for a in cs}
    d = latest_deployment(h, v1)
    # the replacement is recorded as a placed canary
    assert len(d.task_groups["web"].placed_canaries) >= 2


# ---------------------------------------------------------------------------
# non-canary churn during canary state runs the OLD version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_lost_noncanary_replacement_downgraded(backend):
    h = make_cluster(12)
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job)
    run_eval(h, v1, backend)
    old = [a for a in live(h, v1) if a.job.version == job.version][0]
    h.state.update_node_status(h.next_index(), old.node_id, "down")
    run_eval(h, v1, backend, triggered_by="node-update")
    repl = [a for a in live(h, v1) if a.previous_allocation == old.id]
    assert len(repl) == 1
    assert repl[0].job.version == job.version, (
        "replacement during canary state must run the OLD version"
    )
    # binpack may have colocated the canaries with the victim; a follow-up
    # eval re-places them (the replacements are destructive again)
    run_eval(h, v1, backend)
    assert len(canaries_of(h, v1)) == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_scale_up_during_canary_gates_fills(backend):
    """Reference TestReconciler_NewCanaries_ScaleUp: scale-up in the same
    update places ONLY the canaries; the fills wait for promotion."""
    h = make_cluster(12)
    job = deploy_v0(h, canary_job(count=4, canary=2), backend)
    v1 = update_job(h, job, count=6)  # scale up in the same update
    run_eval(h, v1, backend)
    assert len(canaries_of(h, v1)) == 2
    old = [a for a in live(h, v1) if a.job.version == job.version]
    assert len(old) == 4  # no fills while unpromoted
    # after promotion + rollout, all 6 run the new version
    promote(h, v1, backend)
    for _ in range(8):
        run_eval(h, v1, backend)
        d = latest_deployment(h, v1)
        cur = [a for a in live(h, v1) if a.job.version == v1.version]
        mark_deployment_healthy(h, d.id, [a.id for a in cur])
    allocs = live(h, v1)
    assert len(allocs) == 6
    assert all(a.job.version == v1.version for a in allocs)


def test_scale_down_during_canary_stops_highest_indexes():
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=6, canary=2), "host")
    v1 = update_job(h, job, count=4)
    run_eval(h, v1, "host")
    old = [a for a in live(h, v1) if a.job.version == job.version]
    assert len(old) == 4
    assert sorted(a.index() for a in old) == [0, 1, 2, 3]
    assert len(canaries_of(h, v1)) == 2


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------


def test_auto_promote_recorded_on_dstate():
    h = make_cluster()
    job = deploy_v0(
        h, canary_job(count=4, canary=2, auto_promote=True), "host"
    )
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    d = latest_deployment(h, v1)
    ds = d.task_groups["web"]
    assert ds.auto_promote
    assert "automatic promotion" in d.status_description


def test_job_stop_cancels_canary_deployment():
    h = make_cluster()
    job = deploy_v0(h, canary_job(count=4, canary=2), "host")
    v1 = update_job(h, job)
    run_eval(h, v1, "host")
    d = latest_deployment(h, v1)
    stopped = v1.copy()
    stopped.stop = True
    h.state.upsert_job(h.next_index(), stopped)
    run_eval(h, stopped, "host", triggered_by="job-deregister")
    assert not live(h, stopped)
    d = h.state.deployment_by_id(d.id)
    assert d.status == "cancelled"


def test_canary_battery_host_gpu_equivalence():
    """The whole canary flow produces the same observable state on both
    backends: same live counts, canary counts, versions at each step."""
    snapshots = {}
    for backend in BACKENDS:
        h = make_cluster()
        job = deploy_v0(h, canary_job(count=4, canary=2), backend)
        v1 = update_job(h, job)
        run_eval(h, v1, backend)
        step1 = (
            len(live(h, v1)),
            len(canaries_of(h, v1)),
            sorted(a.name.split(".", 1)[1] for a in canaries_of(h, v1)),
        )
        promote(h, v1, backend)
        for _ in range(8):
            run_eval(h, v1, backend)
            d = latest_deployment(h, v1)
            cur = [a for a in live(h, v1) if a.job.version == v1.version]
            mark_deployment_healthy(h, d.id, [a.id for a in cur])
        step2 = (
            len(live(h, v1)),
            sorted(a.name.split(".", 1)[1] for a in live(h, v1)),
            all(a.job.version == v1.version for a in live(h, v1)),
            latest_deployment(h, v1).status,
        )
        snapshots[backend] = (step1, step2)
    assert snapshots["host"] == snapshots["gpu"]


def test_batch_job_with_update_stanza_never_canaries():
    """Canaries ride deployments; batch jobs get neither. A stray update
    stanza on a batch job must roll destructively, not churn canaries."""
    h = make_cluster()
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 3
    tg.update = UpdateStrategy(max_parallel=1, canary=1)
    h.state.upsert_job(h.next_index(), job)
    h.process("batch", mock.eval_for_job(job), cfg("host"))
    assert len(live(h, job)) == 3

    v1 = update_job(h, job)
    for _ in range(4):
        h.process("batch", mock.eval_for_job(v1), cfg("host"))
    allocs = live(h, v1)
    assert not canaries_of(h, v1)
    assert len(allocs) == 3
    assert all(a.job.version == v1.version for a in allocs)
