"""Native service registrations against the port.

The cases of ``tests/test_services.py`` (its registration builder,
check watcher and e2e cases on the port's ``client/``),
with imports pointed at ``nomad_tpu_torch`` and the Server's scheduler
config written out (``backend="host"``, ``device="cpu"``). The
assertions are the reference's.
Reference intent: nomad/service_registration_endpoint.go, rebuilt
against the cluster's own catalog.
"""

import http.server
import os
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.serviceregistration import (
    ServiceWatcher,
    build_registrations,
)
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import (
    AllocatedResources,
    AllocatedTaskResources,
    NetworkResource,
    Port,
    Service,
    ServiceRegistration,
)


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


def _alloc_with_services():
    job = mock.job(id="svc-job")
    tg = job.task_groups[0]
    tg.services = [Service(name="web-lb", port_label="http", tags=["lb"])]
    task = tg.tasks[0]
    task.services = [Service(name="web", port_label="http", tags=["v1"])]
    alloc = mock.alloc(job=job)
    alloc.resources = AllocatedResources(
        tasks={
            task.name: AllocatedTaskResources(
                cpu=100,
                memory_mb=64,
                networks=[
                    NetworkResource(
                        ip="127.0.0.1",
                        dynamic_ports=[Port(label="http", value=23456)],
                    )
                ],
            )
        }
    )
    return alloc


class TestBuildRegistrations:
    def test_group_and_task_services(self):
        alloc = _alloc_with_services()
        node = mock.node()
        node.attributes["unique.network.ip-address"] = "10.0.0.7"
        regs = build_registrations(alloc, node)
        assert {r.service_name for r in regs} == {"web-lb", "web"}
        for r in regs:
            assert r.address == "10.0.0.7"
            assert r.port == 23456, "port resolved from allocated ports"
            assert r.alloc_id == alloc.id
            assert r.node_id == node.id
        task_reg = next(r for r in regs if r.service_name == "web")
        assert task_reg.task_name == "web"

    def test_numeric_port_label(self):
        alloc = _alloc_with_services()
        alloc.job.task_groups[0].services = [
            Service(name="static", port_label="8300")
        ]
        alloc.job.task_groups[0].tasks[0].services = []
        regs = build_registrations(alloc, mock.node())
        assert regs[0].port == 8300


def test_service_registration_e2e(tmp_path, monkeypatch):
    """Full stack: a job's services register on run, resolve through the
    template {{ service }} function, and deregister on stop."""
    monkeypatch.setenv("NOMAD_CHECK_POLL_INTERVAL", "0.2")
    from nomad_tpu_torch.client import Client, ServerRPC

    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    client = None
    try:
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        assert client.wait_registered(10)

        job = mock.job(id="svc-e2e")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "mock"
        task.config = {}
        task.services = [Service(name="db", port_label="5432")]
        server.job_register(job)

        assert wait_until(
            lambda: server.state.service_registrations("default", "db"), 15
        )
        regs = server.state.service_registrations("default", "db")
        assert len(regs) == 1
        assert regs[0].port == 5432
        assert regs[0].job_id == "svc-e2e"

        # the template engine resolves {{ service "db" }}
        from nomad_tpu_torch.client.template import compute_template
        from nomad_tpu_torch.structs.structs import Template

        tmpl = Template(
            embedded_tmpl='upstream {{ service "db" }}',
            dest_path="local/out.conf",
        )
        _, content = compute_template(
            tmpl, str(tmp_path / "c0"), {},
            service_fn=lambda n: client.rpc.service_lookup("default", n),
        )
        assert content == f"upstream {regs[0].address}:5432"

        # stop the job: the watcher deregisters
        server.job_deregister("default", "svc-e2e", purge=False)
        assert wait_until(
            lambda: not server.state.service_registrations("default", "db"),
            15,
        )
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()


def test_check_watcher_flips_status(tmp_path):
    """An http check marks the registration passing while the endpoint
    answers 2xx and critical when it dies."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    try:
        job = mock.job(id="checked")
        tg = job.task_groups[0]
        svc = Service(name="checked-web", port_label=str(port))
        svc.checks = [{"name": "up", "type": "http", "path": "/"}]
        tg.tasks[0].services = [svc]
        alloc = mock.alloc(job=job)
        server.state.upsert_allocs(
            server.state.latest_index() + 1, [alloc]
        )
        node = mock.node()
        node.attributes["unique.network.ip-address"] = "127.0.0.1"

        class RPC:
            def services_register(self, regs):
                server.state.upsert_service_registrations(
                    server.state.latest_index() + 1, regs
                )

            def services_deregister_alloc(self, alloc_id):
                server.state.delete_services_by_alloc(
                    server.state.latest_index() + 1, [alloc_id]
                )

        w = ServiceWatcher(alloc, node, RPC(), poll_interval_s=0.1)
        w.start()
        try:
            assert wait_until(
                lambda: any(
                    r.status == "passing"
                    for r in server.state.service_registrations(
                        "default", "checked-web"
                    )
                ),
                5,
            ), "live endpoint should report passing"
            httpd.shutdown()
            httpd.server_close()
            assert wait_until(
                lambda: any(
                    r.status == "critical"
                    for r in server.state.service_registrations(
                        "default", "checked-web"
                    )
                ),
                5,
            ), "dead endpoint should report critical"
        finally:
            w.stop()
        assert server.state.service_registrations(
            "default", "checked-web"
        ) == [], "stop deregisters"
    finally:
        server.shutdown()


def test_script_check_execs_in_task(tmp_path):
    """A `script` check runs its command through the driver's exec and
    passes on exit 0 (reference structs.go ServiceCheck Command +
    check_watcher script path)."""
    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    try:
        job = mock.job(id="scripted")
        tg = job.task_groups[0]
        svc = Service(name="scripted-web", port_label="8080")
        svc.checks = [{
            "name": "probe", "type": "script",
            "command": "/bin/true", "args": [],
        }]
        tg.tasks[0].services = [svc]
        alloc = mock.alloc(job=job)
        server.state.upsert_allocs(server.state.latest_index() + 1, [alloc])
        node = mock.node()
        node.attributes["unique.network.ip-address"] = "127.0.0.1"

        class RPC:
            def services_register(self, regs):
                server.state.upsert_service_registrations(
                    server.state.latest_index() + 1, regs
                )

            def services_deregister_alloc(self, alloc_id):
                server.state.delete_services_by_alloc(
                    server.state.latest_index() + 1, [alloc_id]
                )

        calls = []

        def exec_fn(task_name, cmd, timeout_s):
            calls.append((task_name, list(cmd)))
            return 0 if cmd[0] == "/bin/true" else 1

        w = ServiceWatcher(alloc, node, RPC(), poll_interval_s=0.1,
                           exec_fn=exec_fn)
        w.start()
        try:
            assert wait_until(
                lambda: any(
                    r.status == "passing"
                    for r in server.state.service_registrations(
                        "default", "scripted-web"
                    )
                ),
                5,
            )
            assert calls and calls[0][0] == tg.tasks[0].name
            assert calls[0][1] == ["/bin/true"]
            # flip the command outcome → critical
            w._checks[w.regs[0].id][0]["command"] = "/bin/false"
            assert wait_until(
                lambda: any(
                    r.status == "critical"
                    for r in server.state.service_registrations(
                        "default", "scripted-web"
                    )
                ),
                5,
            )
        finally:
            w.stop()
    finally:
        server.shutdown()


def test_check_restart_trips_after_limit(tmp_path):
    """check_restart { limit } restarts the owning task after `limit`
    consecutive failures once grace has elapsed, and a passing check
    resets the count (reference check_watcher.go)."""
    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    try:
        job = mock.job(id="flappy")
        tg = job.task_groups[0]
        svc = Service(name="flappy-web", port_label="1")  # closed port
        svc.checks = [{
            "name": "up", "type": "tcp", "timeout_s": 0.2,
            "check_restart": {"limit": 3, "grace_s": 0.0},
        }]
        tg.tasks[0].services = [svc]
        alloc = mock.alloc(job=job)
        node = mock.node()
        node.attributes["unique.network.ip-address"] = "127.0.0.1"

        class RPC:
            def services_register(self, regs):
                pass

            def services_deregister_alloc(self, alloc_id):
                pass

        restarts = []
        w = ServiceWatcher(
            alloc, node, RPC(), poll_interval_s=0.05,
            restart_fn=lambda task, reason: restarts.append((task, reason)),
        )
        w.start()
        try:
            assert wait_until(lambda: len(restarts) >= 1, 10)
            task, reason = restarts[0]
            assert task == tg.tasks[0].name
            assert "unhealthy 3x" in reason
            # the counter reset: a second trip needs 3 MORE failures
            assert wait_until(lambda: len(restarts) >= 2, 10)
        finally:
            w.stop()
        # grace: a fresh watcher with a long grace never trips
        restarts2 = []
        w2 = ServiceWatcher(
            alloc, node, RPC(), poll_interval_s=0.05,
            restart_fn=lambda t, r: restarts2.append(t),
        )
        w2._checks[w2.regs[0].id][0]["check_restart"]["grace_s"] = 60.0
        w2.start()
        try:
            time.sleep(0.5)
            assert restarts2 == []
        finally:
            w2.stop()
    finally:
        server.shutdown()


def test_check_restart_consumes_restart_budget(tmp_path):
    """End to end: a task whose check keeps failing is restarted through
    the restart POLICY (budget), so it converges to failed instead of
    flapping forever — the reference's restartTracker failure path."""
    import os as _os

    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.structs.structs import RestartPolicy

    _os.environ["NOMAD_CHECK_POLL_INTERVAL"] = "0.1"
    try:
        server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
        server.establish_leadership()
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        try:
            assert client.wait_registered(15)
            job = mock.job(id="sickly")
            tg = job.task_groups[0]
            tg.count = 1
            tg.restart_policy = RestartPolicy(
                attempts=1, interval_s=3600.0, delay_s=0.1, mode="fail"
            )
            t = job.task_groups[0].tasks[0]
            t.driver = "mock"
            t.config = {"run_for_s": 3600}
            svc = Service(name="sick-svc", port_label="1")
            svc.checks = [{
                "name": "up", "type": "tcp", "timeout_s": 0.2,
                "check_restart": {"limit": 2, "grace_s": 0.0},
            }]
            t.services = [svc]
            server.job_register(job)

            def failed_alloc():
                allocs = server.state.allocs_by_job("default", "sickly")
                return any(
                    a.client_status == "failed"
                    or any(
                        ts.failed for ts in (a.task_states or {}).values()
                    )
                    for a in allocs
                )

            assert wait_until(failed_alloc, 30), (
                "restart budget must exhaust into a failed task"
            )
        finally:
            client.shutdown()
            server.shutdown()
    finally:
        _os.environ.pop("NOMAD_CHECK_POLL_INTERVAL", None)


def test_group_script_check_task_field():
    """A group-level service names its script-exec task via the check's
    `task` attribute (reference ServiceCheck.TaskName): the exec runs in
    that task and a check_restart trip restarts IT, not the group."""
    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    try:
        job = mock.job(id="grouped")
        tg = job.task_groups[0]
        svc = Service(name="grp-svc", port_label="8080")
        svc.checks = [{
            "name": "probe", "type": "script", "task": tg.tasks[0].name,
            "command": "/bin/false",
            "check_restart": {"limit": 2, "grace_s": 0.0},
        }]
        tg.services = [svc]
        alloc = mock.alloc(job=job)
        node = mock.node()
        node.attributes["unique.network.ip-address"] = "127.0.0.1"

        class RPC:
            def services_register(self, regs):
                pass

            def services_deregister_alloc(self, alloc_id):
                pass

        execs, restarts = [], []
        w = ServiceWatcher(
            alloc, node, RPC(), poll_interval_s=0.05,
            exec_fn=lambda task, cmd, t: (execs.append(task), 1)[1],
            restart_fn=lambda task, reason: restarts.append(task),
        )
        w.start()
        try:
            assert wait_until(lambda: len(restarts) >= 1, 10)
            assert execs and all(t == tg.tasks[0].name for t in execs)
            assert restarts[0] == tg.tasks[0].name
        finally:
            w.stop()
    finally:
        server.shutdown()
