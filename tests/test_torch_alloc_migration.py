"""``tests/test_alloc_migration.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Previous-alloc ephemeral disk migration (reference client/allocwatcher):
sticky data survives same-node replacement; migrate=true streams it across
nodes over the client fabric.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ServerRPC
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs import DrainStrategy
from nomad_tpu_torch.structs.structs import Resources, Task
from nomad_tpu_torch.testing import wait_for_state
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=40.0, interval=0.05):
    """Filesystem conditions only (no store event fires for a file
    appearing); alloc/task-state conditions use the event-driven
    wait_for_state instead of this sleep-poll — the known flake mode
    under load on this 1-core box (VERDICT r6 item 7)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _disk_job(job_id, marker):
    job = mock.job(id=job_id)
    tg = job.task_groups[0]
    tg.count = 1
    tg.ephemeral_disk.sticky = True
    tg.ephemeral_disk.migrate = True
    tg.tasks = [
        Task(
            name="keeper",
            driver="rawexec",
            config={
                "command": "/bin/sh",
                "args": [
                    "-c",
                    f"echo {marker} > ${{NOMAD_ALLOC_DIR}}/data/state.txt; "
                    "sleep 120",
                ],
            },
            resources=Resources(cpu=100, memory_mb=64),
        )
    ]
    return job


def _running(server, job):
    return [
        a
        for a in server.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == "running"
    ]


def test_sticky_disk_survives_destructive_update(tmp_path):
    """Same-node replacement: the new alloc inherits alloc/data by local
    move before its tasks start."""
    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    client = None
    try:
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        job = _disk_job("sticky-job", "generation-one")
        job.datacenters = [client.node.datacenter]
        server.job_register(job)
        assert wait_for_state(
            [server], lambda: bool(_running(server, job)), timeout_s=60
        )
        first = _running(server, job)[0]
        first_dir = client.alloc_runners[first.id].allocdir.data_dir
        assert wait_until(
            lambda: os.path.exists(os.path.join(first_dir, "state.txt")), 10
        )

        # destructive update (env change): replacement carries
        # previous_allocation and must inherit the data dir
        update = job.copy()
        update.task_groups[0].tasks[0].env = {"GEN": "two"}
        server.job_register(update)
        assert wait_for_state(
            [server],
            lambda: any(
                a.id != first.id and a.previous_allocation == first.id
                for a in _running(server, job)
            ),
            timeout_s=60,
        ), "replacement alloc should run with previous_allocation set"
        repl = next(a for a in _running(server, job) if a.id != first.id)
        new_dir = client.alloc_runners[repl.id].allocdir.data_dir
        inherited = os.path.join(new_dir, "state.txt")
        assert os.path.exists(inherited), "sticky data not migrated"
        assert "generation-one" in open(inherited).read()
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()


def test_migrate_streams_data_across_nodes(tmp_path):
    """Drain the first node: the replacement on the second node pulls
    alloc/data over the client fabric (FS.ls/FS.cat)."""
    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    c1 = c2 = None
    try:
        c1 = Client(ServerRPC(server), data_dir=str(tmp_path / "c1"))
        c1.start()
        assert c1.wait_registered(10)
        job = _disk_job("migrate-job", "cross-node-data")
        job.datacenters = [c1.node.datacenter]
        server.job_register(job)
        assert wait_for_state(
            [server], lambda: bool(_running(server, job)), timeout_s=60
        )
        first = _running(server, job)[0]
        assert first.node_id == c1.node.id
        first_dir = c1.alloc_runners[first.id].allocdir.data_dir
        assert wait_until(
            lambda: os.path.exists(os.path.join(first_dir, "state.txt")), 10
        )

        c2 = Client(ServerRPC(server), data_dir=str(tmp_path / "c2"))
        c2.start()
        assert c2.wait_registered(10)

        server.node_update_drain(
            c1.node.id, DrainStrategy(deadline_s=60)
        )
        assert wait_for_state(
            [server],
            lambda: any(
                a.node_id == c2.node.id and a.previous_allocation == first.id
                for a in _running(server, job)
            ),
            timeout_s=60,
        ), "replacement should land on the second node"
        repl = next(a for a in _running(server, job) if a.node_id == c2.node.id)
        inherited = os.path.join(
            c2.alloc_runners[repl.id].allocdir.data_dir, "state.txt"
        )
        assert wait_until(lambda: os.path.exists(inherited), 30), (
            "migrated data not streamed across nodes"
        )
        assert "cross-node-data" in open(inherited).read()
    finally:
        for c in (c1, c2):
            if c is not None:
                c.shutdown()
        server.shutdown()
