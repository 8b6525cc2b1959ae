"""Native service registrations against the port.

The store and service-GC cases of ``tests/test_services.py`` (its
registration builder, check watcher and e2e cases wait for ``client/``),
with imports pointed at ``nomad_tpu_torch`` and the Server's scheduler
config written out (``backend="host"``, ``device="cpu"``). The
assertions are the reference's.
Reference intent: nomad/service_registration_endpoint.go, rebuilt
against the cluster's own catalog.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import ServiceRegistration


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestStateStore:
    def test_upsert_list_delete(self):
        from nomad_tpu_torch.state.store import StateStore

        state = StateStore()
        regs = [
            ServiceRegistration(
                id=f"r{i}", service_name="web", alloc_id=f"a{i}",
                tags=["v1"], address="10.0.0.1", port=8000 + i,
            )
            for i in range(3)
        ]
        state.upsert_service_registrations(10, regs)
        names = state.service_names("default")
        assert names == [
            {
                "namespace": "default", "service_name": "web",
                "tags": ["v1"], "instances": 3,
            }
        ]
        got = state.service_registrations("default", "web")
        assert [r.id for r in got] == ["r0", "r1", "r2"]
        assert got[0].create_index == 10
        # status update keeps create_index
        regs[0].status = "critical"
        state.upsert_service_registrations(11, [regs[0]])
        got = state.service_registrations("default", "web")
        assert got[0].status == "critical" and got[0].create_index == 10
        # delete by alloc
        n = state.delete_services_by_alloc(12, ["a0", "a2"])
        assert n == 2
        assert len(state.service_registrations("default", "web")) == 1


@pytest.fixture
def server():
    s = Server(num_workers=2, scheduler_config=SchedulerConfig(
        backend="host", device="cpu"))
    s.establish_leadership()
    yield s
    s.shutdown()


def test_service_gc_reaps_orphans(server):
    """Registrations whose alloc is gone/terminal are swept
    (core_sched service-gc)."""
    from nomad_tpu_torch.server.core_sched import CoreScheduler

    n = mock.node()
    server.node_register(n)
    server.node_heartbeat(n.id)
    job = mock.job(id="gc-svc")
    server.job_register(job)
    assert wait_until(
        lambda: server.state.allocs_by_job("default", "gc-svc"), 10
    )
    alloc = server.state.allocs_by_job("default", "gc-svc")[0]
    live = ServiceRegistration(
        id="live", service_name="web", alloc_id=alloc.id
    )
    orphan = ServiceRegistration(
        id="orphan", service_name="web", alloc_id="no-such-alloc"
    )
    server.state.upsert_service_registrations(
        server.state.latest_index() + 1, [live, orphan]
    )
    CoreScheduler(server, server.state.snapshot()).service_gc()
    ids = {r.id for r in server.state.service_registrations("default", "web")}
    assert ids == {"live"}


def test_services_endpoints(server):
    """services_register refuses a registration without an owner and one
    whose alloc is unknown; deregistering by alloc drops that alloc's
    rows and no other."""
    n = mock.node()
    server.node_register(n)
    job = mock.job(id="svc")
    job.task_groups[0].count = 2
    server.job_register(job)
    assert wait_until(
        lambda: len(server.state.allocs_by_job("default", "svc")) == 2, 10)
    a0, a1 = sorted(server.state.allocs_by_job("default", "svc"),
                    key=lambda a: a.name)
    with pytest.raises(ValueError, match="requires id"):
        server.services_register([ServiceRegistration(id="x")])
    with pytest.raises(KeyError):
        server.services_register([ServiceRegistration(
            id="x", service_name="web", alloc_id="nope")])
    server.services_register([
        ServiceRegistration(id=f"r-{a.name}", service_name="web",
                            alloc_id=a.id, job_id="svc", node_id=n.id)
        for a in (a0, a1)])
    assert len(server.state.service_registrations("default", "web")) == 2
    server.services_deregister_alloc(a0.id)
    assert [r.alloc_id for r in
            server.state.service_registrations("default", "web")] == [a1.id]
    server.services_deregister([f"r-{a1.name}"])
    assert server.state.service_names() == []
