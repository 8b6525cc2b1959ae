"""The reference's Job.Plan cases against the port, on the CPU: the 7
cases of tests/test_job_plan.py that need no agent, with the same
assertions, on the port's Server with its workers on the kernels' plain
twins (``SchedulerConfig(device="cpu")``). The two cases that go through
the HTTP agent and the SDK wait for the port's agent and api. The plan's
equality with nomad_tpu's, annotation for annotation, is held by
tests/test_torch_lifecycle.py's lockstep differential."""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server


@pytest.fixture
def server():
    s = Server(num_workers=2,
               scheduler_config=SchedulerConfig(device="cpu"))
    s.establish_leadership()
    yield s
    s.shutdown()


def register_and_place(server, job):
    server.job_register(job)
    assert server.wait_for_evals(10)


def test_plan_new_job_annotates_creates(server):
    for _ in range(3):
        server.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    resp = server.job_plan(job)
    assert resp["Changes"] is True
    tg = resp["Annotations"]["DesiredTGUpdates"][job.task_groups[0].name]
    assert tg["place"] == 4
    assert resp["Diff"]["Type"] == "Added"
    # dry-run: nothing committed
    assert server.state.job_by_id(job.namespace, job.id) is None
    assert server.state.allocs_by_job(job.namespace, job.id) == []


def test_plan_no_changes(server):
    for _ in range(3):
        server.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    register_and_place(server, job)
    resp = server.job_plan(job.copy())
    assert resp["Changes"] is False
    tg = resp["Annotations"]["DesiredTGUpdates"].get(
        job.task_groups[0].name, {}
    )
    assert tg.get("place", 0) == 0
    assert tg.get("destructive", 0) == 0


def test_plan_flags_task_env_change_destructive(server):
    """The round-2 criticism: a client-side count diff says 'no changes'
    for a task-config edit; the server-side plan must flag it destructive."""
    for _ in range(3):
        server.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    register_and_place(server, job)

    update = job.copy()
    update.task_groups[0].tasks[0].env = {"NEW_VAR": "destructive"}
    resp = server.job_plan(update)
    assert resp["Changes"] is True
    tg = resp["Annotations"]["DesiredTGUpdates"][job.task_groups[0].name]
    assert tg["destructive"] == 3, f"expected 3 destructive, got {tg}"
    # the diff names the env change
    flat = str(resp["Diff"])
    assert "NEW_VAR" in flat
    # and still nothing committed: live allocs untouched
    live = [
        a
        for a in server.state.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    ]
    assert len(live) == 3


def test_plan_count_change_in_place_vs_create(server):
    for _ in range(3):
        server.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    register_and_place(server, job)

    update = job.copy()
    update.task_groups[0].count = 5
    resp = server.job_plan(update)
    tg = resp["Annotations"]["DesiredTGUpdates"][job.task_groups[0].name]
    assert tg["place"] == 3
    # count is a spec change, so the 2 keeps get the new version in place
    assert tg["in_place"] == 2
    assert tg["destructive"] == 0
    assert resp["JobModifyIndex"] > 0


def test_plan_reports_placement_failure(server):
    """A job no node can hold comes back with FailedTGAllocs, not silence."""
    server.node_register(mock.node())
    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = 10**9
    resp = server.job_plan(job)
    assert resp["Changes"] is True
    assert job.task_groups[0].name in resp["FailedTGAllocs"]


def test_plan_system_job_annotates(server):
    """System jobs go through SystemScheduler, which must annotate too."""
    for _ in range(4):
        server.node_register(mock.node())
    sysjob = mock.system_job()
    resp = server.job_plan(sysjob)
    assert resp["Changes"] is True
    tg = resp["Annotations"]["DesiredTGUpdates"][sysjob.task_groups[0].name]
    assert tg["place"] == 4  # one per eligible node
    assert server.state.job_by_id(sysjob.namespace, sysjob.id) is None


def test_diff_bool_flip_renders_edited():
    from nomad_tpu_torch.structs.diff import field_diff

    d = field_diff("leader", False, True)
    assert d["Type"] == "Edited"
    assert d["Old"] == "false" and d["New"] == "true"
    d = field_diff("leader", True, False)
    assert d["Type"] == "Edited"
