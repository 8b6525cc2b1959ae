"""``tests/test_e2e_lifecycle.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

E2E lifecycle: deployments, drain, periodic, GC through the live
server + client (reference analog: e2e/rescheduling, e2e/nodedrain,
e2e/periodic suites — run in-process per SURVEY.md §4).
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ServerRPC
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs import DrainStrategy
from nomad_tpu_torch.structs.structs import PeriodicConfig, UpdateStrategy
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def cluster(tmp_path):
    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.deployment_watcher.poll_interval_s = 0.05
    server.drainer.poll_interval_s = 0.05
    server.establish_leadership()
    clients = []

    def add_client(**kw):
        c = Client(
            ServerRPC(server), data_dir=str(tmp_path / f"c{len(clients)}"), **kw
        )
        c.start()
        clients.append(c)
        return c

    yield server, add_client
    for c in clients:
        c.shutdown()
    server.shutdown()


def test_e2e_deployment_completes_and_drain_migrates(cluster):
    server, add_client = cluster
    c1 = add_client()
    c2 = add_client()

    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {}
    job.datacenters = [c1.node.datacenter]
    job.update = UpdateStrategy(max_parallel=1, min_healthy_time_s=0.0)
    job.task_groups[0].update = job.update.copy()
    server.job_register(job)

    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running"
        )
        == 2
    ), "allocs should run"
    deps = server.state.deployments_by_job(job.namespace, job.id)
    assert deps, "scheduler should create a deployment"
    assert wait_until(
        lambda: server.state.deployments_by_job(job.namespace, job.id)[0].status
        == "successful"
    ), "deployment should complete via client health reports"
    assert wait_until(
        lambda: server.state.job_by_id(job.namespace, job.id).stable
    ), "job version should be marked stable"

    # drain c1: allocs migrate to c2, drain clears itself
    server.node_update_drain(c1.node.id, DrainStrategy(deadline_s=600))
    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running" and a.node_id == c2.node.id
        )
        == 2
    ), "allocs should migrate to the other node"
    assert wait_until(
        lambda: not server.state.node_by_id(c1.node.id).drain
    ), "drain should complete and clear"


def test_e2e_periodic_force_launch_and_gc(cluster):
    server, add_client = cluster
    c = add_client()

    pj = mock.job(id="cron-job")
    pj.type = "batch"
    pj.datacenters = [c.node.datacenter]
    pj.task_groups[0].count = 1
    pj.task_groups[0].tasks[0].config = {"run_for": 0.1}
    pj.periodic = PeriodicConfig(enabled=True, spec="0 0 1 1 *")
    server.job_register(pj)

    assert wait_until(lambda: len(server.periodic.tracked()) == 1)
    child_id = server.periodic.force_launch(pj.namespace, pj.id)
    assert wait_until(
        lambda: any(
            a.client_status == "complete"
            for a in server.state.allocs_by_job(pj.namespace, child_id)
        )
    ), "periodic child should run to completion"

    server.job_deregister(pj.namespace, child_id, purge=False)
    assert wait_until(
        lambda: (j := server.state.job_by_id(pj.namespace, child_id)) is not None
        and j.status == "dead"
    )
    # force_gc is best-effort per pass (a concurrently in-flight eval for
    # the child blocks its purge), so retry it like the reference's e2e
    # suites do until the purge lands.
    def purged():
        server.force_gc()
        return server.state.job_by_id(pj.namespace, child_id) is None

    assert wait_until(purged), "force GC should purge the dead child"


def test_e2e_canary_auto_promote_rollout(cluster):
    """v0 deploy -> update with canary + auto_promote -> canary reports
    healthy via the client health watcher -> deployment watcher promotes
    -> rollout completes at the new version (reference: the full
    canary lifecycle across scheduler, client allochealth, and
    deployment watcher)."""
    from nomad_tpu_torch.structs.structs import UpdateStrategy

    server, add_client = cluster
    add_client()
    add_client()
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 3
    tg.tasks[0].resources.networks = []
    tg.update = UpdateStrategy(
        max_parallel=2, canary=1, auto_promote=True, min_healthy_time_s=0.01
    )
    server.job_register(job)

    def live():
        return [
            a
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()
        ]

    wait_until(
        lambda: len(live()) == 3
        and all(a.client_status == "running" for a in live())
    )
    d0 = server.state.latest_deployment_by_job(job.namespace, job.id)
    wait_until(
        lambda: server.state.deployment_by_id(d0.id).status == "successful"
    )

    v1 = job.copy()
    v1.task_groups[0].tasks[0].env = {"V": "2"}
    server.job_register(v1)
    stored = server.state.job_by_id(job.namespace, job.id)

    wait_until(
        lambda: any(
            a.deployment_status is not None and a.deployment_status.canary
            for a in live()
        )
    )
    d1 = server.state.latest_deployment_by_job(job.namespace, job.id)
    assert d1.id != d0.id
    wait_until(
        lambda: server.state.deployment_by_id(d1.id)
        .task_groups["web"]
        .promoted,
        timeout_s=20,
    )
    wait_until(
        lambda: len(live()) == 3
        and all(
            a.job.version == stored.version and a.client_status == "running"
            for a in live()
        ),
        timeout_s=20,
    )
    wait_until(
        lambda: server.state.deployment_by_id(d1.id).status == "successful",
        timeout_s=20,
    )
