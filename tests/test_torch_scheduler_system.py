"""``tests/test_scheduler_system.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``; a ``Harness`` pass given no config runs on that
default. The assertions are the reference's.
"""

from nomad_tpu_torch import mock
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import DrainStrategy, NODE_STATUS_DOWN
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


def test_system_job_on_every_node():
    h = Harness()
    nodes = [mock.node() for _ in range(5)]
    for n in nodes:
        h.state.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == 5
    assert {a.node_id for a in allocs} == {n.id for n in nodes}


def test_system_new_node_gets_alloc():
    h = Harness()
    for _ in range(2):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 2

    new_node = mock.node()
    h.state.upsert_node(h.next_index(), new_node)
    h.process("system", mock.eval_for_job(job, triggered_by="node-update", node_id=new_node.id))
    allocs = [a for a in h.state.allocs_by_job(job.namespace, job.id) if not a.terminal_status()]
    assert len(allocs) == 3
    assert any(a.node_id == new_node.id for a in allocs)


def test_system_drain_stops():
    h = Harness()
    n1, n2 = mock.node(), mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    h.state.update_node_drain(h.next_index(), n1.id, DrainStrategy(deadline_s=60))
    # The drainer (not the scheduler) owns the migrate decision for system
    # allocs — it withholds the mark until services have drained. Mark the
    # alloc the way the drainer does, then the scheduler acts on it.
    from nomad_tpu_torch.structs.structs import DesiredTransition

    marked = {
        a.id: DesiredTransition(migrate=True)
        for a in h.state.allocs_by_job(job.namespace, job.id)
        if a.node_id == n1.id and not a.terminal_status()
    }
    h.state.update_alloc_desired_transition(h.next_index(), marked, [])
    h.process("system", mock.eval_for_job(job, triggered_by="node-drain"))
    live = [a for a in h.state.allocs_by_job(job.namespace, job.id) if not a.terminal_status()]
    assert len(live) == 1
    assert live[0].node_id == n2.id


def test_system_node_down_lost():
    h = Harness()
    n1, n2 = mock.node(), mock.node()
    h.state.upsert_node(h.next_index(), n1)
    h.state.upsert_node(h.next_index(), n2)
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    h.state.update_node_status(h.next_index(), n1.id, NODE_STATUS_DOWN)
    h.process("system", mock.eval_for_job(job, triggered_by="node-update", node_id=n1.id))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    lost = [a for a in allocs if a.client_status == "lost"]
    assert len(lost) == 1 and lost[0].node_id == n1.id
    live = [a for a in allocs if not a.terminal_status()]
    assert len(live) == 1 and live[0].node_id == n2.id


def test_sysbatch_completed_not_rerun():
    h = Harness()
    n = mock.node()
    h.state.upsert_node(h.next_index(), n)
    job = mock.sysbatch_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("sysbatch", mock.eval_for_job(job))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == 1
    done = allocs[0].copy()
    done.client_status = "complete"
    h.state.update_allocs_from_client(h.next_index(), [done])
    h.process("sysbatch", mock.eval_for_job(job))
    assert len(h.state.allocs_by_job(job.namespace, job.id)) == 1


def test_system_job_deregister():
    h = Harness()
    for _ in range(3):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    stopped = h.state.job_by_id(job.namespace, job.id).copy()
    stopped.stop = True
    h.state.upsert_job(h.next_index(), stopped)
    h.process("system", mock.eval_for_job(stopped, triggered_by="job-deregister"))
    live = [a for a in h.state.allocs_by_job(job.namespace, job.id) if not a.terminal_status()]
    assert live == []


def test_system_infeasible_node_skipped():
    h = Harness()
    good = mock.node()
    bad = mock.node()
    del bad.drivers["mock"]
    bad.attributes.pop("driver.mock", None)
    from nomad_tpu_torch.structs.node_class import compute_node_class
    bad.computed_class = compute_node_class(bad)
    h.state.upsert_node(h.next_index(), good)
    h.state.upsert_node(h.next_index(), bad)
    job = mock.system_job()
    h.state.upsert_job(h.next_index(), job)
    h.process("system", mock.eval_for_job(job))
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == 1
    assert allocs[0].node_id == good.id
    # a feasibility-filtered node (no driver) is neither queued nor a
    # failure — the alloc was never meant to run there (reference
    # scheduler_system.go:308-322 + TestSystemSched_Queued_With_Constraints)
    assert h.updates[-1].queued_allocations.get("web", 0) == 0


def test_system_job_cores_assigned_on_tpu_backend():
    """System jobs asking dedicated cores route through the per-node
    walk on the TPU backend so every alloc carries real core ids."""

    h = Harness()
    for _ in range(3):
        h.state.upsert_node(h.next_index(), mock.node())
    job = mock.system_job(id="sys-pinned")
    job.task_groups[0].tasks[0].resources.cores = 1
    h.state.upsert_job(h.next_index(), job)
    h.process(
        "system", mock.eval_for_job(job),
        config=SchedulerConfig(backend="tpu"),
    )
    allocs = [
        a for a in h.state.allocs_by_job("default", "sys-pinned")
        if a.desired_status == "run"
    ]
    assert len(allocs) == 3
    for a in allocs:
        tr = list(a.resources.tasks.values())[0]
        assert len(tr.reserved_cores) == 1, a.node_id
        assert tr.cpu == 1000  # 4000 MHz / 4 cores
