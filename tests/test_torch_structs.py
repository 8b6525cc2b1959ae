"""``tests/test_structs.py`` against the port.

Its cases with their imports pointed at ``nomad_tpu_torch``
(``scheduler.tpu`` read as ``scheduler.gpu``) and the reference's
scheduler defaults written out in place of a conftest: a
``SchedulerConfig`` built here defaults to ``backend="host"`` (the
reference's default), reads the backend ``"tpu"`` as ``"gpu"`` and runs
on ``device="cpu"``. The assertions are the reference's.
"""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs import (
    Allocation,
    Constraint,
    Job,
    NetworkIndex,
    NetworkResource,
    Plan,
    Port,
    Resources,
    allocs_fit,
    compute_node_class,
    filter_terminal_allocs,
    score_fit_binpack,
    score_fit_spread,
)
from nomad_tpu_torch.structs.structs import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_DESIRED_STATUS_STOP,
)


def test_job_validate_ok():
    j = mock.job()
    j.validate()


def test_job_validate_missing_groups():
    j = mock.job()
    j.task_groups = []
    with pytest.raises(ValueError, match="task group"):
        j.validate()


def test_job_validate_duplicate_group():
    j = mock.job()
    j.task_groups.append(j.task_groups[0].copy())
    with pytest.raises(ValueError, match="duplicate"):
        j.validate()


def test_job_copy_is_deep():
    j = mock.job()
    c = j.copy()
    c.task_groups[0].count = 99
    c.task_groups[0].tasks[0].resources.cpu = 1
    assert j.task_groups[0].count == 10
    assert j.task_groups[0].tasks[0].resources.cpu == 500


def test_job_spec_changed_ignores_bookkeeping():
    j = mock.job()
    c = j.copy()
    c.modify_index += 10
    c.status = "running"
    assert not j.specification_changed(c)
    c.task_groups[0].count += 1
    assert j.specification_changed(c)


def test_alloc_terminal_status():
    a = mock.alloc()
    assert not a.terminal_status()
    a.desired_status = ALLOC_DESIRED_STATUS_STOP
    assert a.terminal_status()
    b = mock.alloc()
    b.client_status = ALLOC_CLIENT_STATUS_FAILED
    assert b.terminal_status()


def test_alloc_index_parsing():
    a = mock.alloc(index=7)
    assert a.index() == 7


def test_score_fit_binpack_bounds():
    n = mock.node()
    empty = Resources(cpu=0, memory_mb=0)
    full = Resources(cpu=n.resources.cpu, memory_mb=n.resources.memory_mb)
    assert score_fit_binpack(n, empty) == 0.0
    assert score_fit_binpack(n, full) == 18.0
    assert score_fit_spread(n, empty) == 18.0
    assert score_fit_spread(n, full) == 0.0
    half = Resources(cpu=n.resources.cpu // 2, memory_mb=n.resources.memory_mb // 2)
    s = score_fit_binpack(n, half)
    assert 0 < s < 18
    # binpack + spread are mirror images
    assert abs(score_fit_binpack(n, half) + score_fit_spread(n, half) - 18.0) < 1e-9


def test_allocs_fit_cpu_exhaustion():
    n = mock.node()
    j = mock.job()
    a1 = mock.alloc(j, n)
    fits, dim, used = allocs_fit(n, [a1])
    assert fits
    assert used.cpu == 500
    # 9 more of the same fits (4000 = 8 x 500)
    many = [mock.alloc(j, n, index=i) for i in range(9)]
    fits, dim, _ = allocs_fit(n, many)
    assert not fits
    assert dim == "cpu"


def test_allocs_fit_ignores_terminal():
    n = mock.node()
    j = mock.job()
    allocs = [mock.alloc(j, n, index=i) for i in range(8)]
    fits, _, _ = allocs_fit(n, allocs)
    assert fits
    extra = mock.alloc(j, n, index=9)
    fits, dim, _ = allocs_fit(n, allocs + [extra])
    assert not fits
    extra.client_status = ALLOC_CLIENT_STATUS_COMPLETE
    fits, _, _ = allocs_fit(n, allocs + [extra])
    assert fits


def test_network_index_port_collision():
    n = mock.node()
    idx = NetworkIndex()
    assert not idx.set_node(n)
    ask = NetworkResource(mbits=50, reserved_ports=[Port("http", 80)])
    offer = idx.assign_network(ask)
    assert offer is not None
    assert offer.reserved_ports[0].value == 80
    idx.add_reserved(offer)
    # same static port again must fail
    assert idx.assign_network(ask) is None


def test_network_index_dynamic_ports():
    n = mock.node()
    idx = NetworkIndex()
    idx.set_node(n)
    ask = NetworkResource(mbits=10, dynamic_ports=[Port("a"), Port("b")])
    offer = idx.assign_network(ask)
    assert offer is not None
    got = {p.value for p in offer.dynamic_ports}
    assert len(got) == 2
    assert all(20000 <= p <= 32000 for p in got)


def test_network_index_bandwidth():
    n = mock.node()
    idx = NetworkIndex()
    idx.set_node(n)
    ask = NetworkResource(mbits=800)
    offer = idx.assign_network(ask)
    assert offer is not None
    idx.add_reserved(offer)
    assert idx.assign_network(NetworkResource(mbits=500)) is None


def test_computed_class_stable_and_sensitive():
    n1 = mock.node()
    n2 = mock.node()
    # ids/names differ but scheduling-relevant attrs match
    assert compute_node_class(n1) == compute_node_class(n2)
    n2.attributes["kernel.name"] = "windows"
    assert compute_node_class(n1) != compute_node_class(n2)
    n3 = mock.node()
    n3.attributes["unique.hostname"] = "xyz"
    assert compute_node_class(n1) == compute_node_class(n3)


def test_filter_terminal_keeps_newest():
    j = mock.job()
    a1 = mock.alloc(j, index=0)
    a1.desired_status = ALLOC_DESIRED_STATUS_STOP
    a1.create_index = 5
    a2 = mock.alloc(j, index=0)
    a2.name = a1.name
    a2.desired_status = ALLOC_DESIRED_STATUS_STOP
    a2.create_index = 9
    live = mock.alloc(j, index=1)
    got_live, got_term = filter_terminal_allocs([a1, a2, live])
    assert got_live == [live]
    assert len(got_term) == 1 and got_term[0].create_index == 9


def test_plan_append_and_pop():
    j = mock.job()
    n = mock.node()
    plan = Plan(eval_id="e1", job=j)
    a = mock.alloc(j, n)
    plan.append_stopped_alloc(a, "node drain")
    assert len(plan.node_update[n.id]) == 1
    assert plan.node_update[n.id][0].desired_status == ALLOC_DESIRED_STATUS_STOP
    plan.pop_update(a)
    assert n.id not in plan.node_update
    b = mock.alloc(j, n)
    plan.append_alloc(b)
    assert not plan.is_no_op()


def test_reschedule_delay_exponential():
    from nomad_tpu_torch.structs import ReschedulePolicy
    from nomad_tpu_torch.structs.structs import RescheduleEvent, RescheduleTracker

    a = mock.alloc()
    pol = ReschedulePolicy(delay_s=5, delay_function="exponential", max_delay_s=100)
    assert a.reschedule_delay(pol) == 5
    a.reschedule_tracker = RescheduleTracker(events=[RescheduleEvent()] * 3)
    assert a.reschedule_delay(pol) == 40
    a.reschedule_tracker = RescheduleTracker(events=[RescheduleEvent()] * 10)
    assert a.reschedule_delay(pol) == 100  # capped
