"""``tests/test_e2e.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

End-to-end tests: server + client + drivers in one process.

Reference analog: nomad/testing.go TestServer + client/testing.go
TestClient joined in-process (SURVEY.md §4 — multi-node without a real
cluster).
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ServerRPC
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


@pytest.fixture
def cluster(tmp_path):
    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    clients = []

    def add_client(**kw):
        c = Client(ServerRPC(server), data_dir=str(tmp_path / f"c{len(clients)}"), **kw)
        c.start()
        clients.append(c)
        return c

    yield server, add_client
    for c in clients:
        c.shutdown()
    server.shutdown()


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def test_e2e_service_job_runs(cluster):
    server, add_client = cluster
    client = add_client()
    job = mock.job()
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].config = {}  # mock driver, runs forever
    job.datacenters = [client.node.datacenter]
    server.job_register(job)

    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running"
        )
        == 3
    ), "3 allocs should reach running"
    assert client.num_allocs() == 3
    assert server.state.job_by_id(job.namespace, job.id).status == "running"


def test_e2e_batch_job_completes(cluster):
    server, add_client = cluster
    client = add_client()
    job = mock.batch_job()
    job.task_groups[0].tasks[0].config = {"run_for": "0.1s"}
    job.datacenters = [client.node.datacenter]
    server.job_register(job)

    assert wait_until(
        lambda: all(
            a.client_status == "complete"
            for a in server.state.allocs_by_job(job.namespace, job.id)
        )
        and len(server.state.allocs_by_job(job.namespace, job.id)) == 1
    ), "batch alloc should complete"
    assert wait_until(
        lambda: server.state.job_by_id(job.namespace, job.id).status == "dead"
    )


def test_e2e_rawexec_real_process(cluster, tmp_path):
    server, add_client = cluster
    client = add_client()
    marker = tmp_path / "ran.txt"
    job = mock.batch_job()
    job.task_groups[0].tasks[0].driver = "rawexec"
    job.task_groups[0].tasks[0].config = {
        "command": "/bin/sh",
        "args": ["-c", f"echo $NOMAD_ALLOC_ID > {marker}"],
    }
    job.datacenters = [client.node.datacenter]
    server.job_register(job)

    assert wait_until(
        lambda: all(
            a.client_status == "complete"
            for a in server.state.allocs_by_job(job.namespace, job.id)
        )
        and len(server.state.allocs_by_job(job.namespace, job.id)) == 1
    )
    assert marker.exists()
    alloc = server.state.allocs_by_job(job.namespace, job.id)[0]
    assert marker.read_text().strip() == alloc.id


def test_e2e_stop_job_kills_tasks(cluster):
    server, add_client = cluster
    client = add_client()
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {}  # run forever
    job.datacenters = [client.node.datacenter]
    server.job_register(job)
    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running"
        )
        == 2
    )
    server.job_deregister(job.namespace, job.id)
    assert wait_until(
        lambda: all(
            a.client_status in ("complete", "failed")
            for a in server.state.allocs_by_job(job.namespace, job.id)
        )
    ), "allocs should be stopped on the client"


def test_e2e_failing_task_restarts_then_reschedules(cluster):
    server, add_client = cluster
    client = add_client()
    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].config = {"run_for": "0.05s", "exit_code": 1}
    job.task_groups[0].restart_policy.attempts = 1
    job.task_groups[0].restart_policy.delay_s = 0.05
    job.task_groups[0].restart_policy.interval_s = 10.0
    job.task_groups[0].restart_policy.mode = "fail"
    job.task_groups[0].reschedule_policy.delay_s = 0
    job.datacenters = [client.node.datacenter]
    server.job_register(job)

    # first alloc fails after exhausting restarts, then the server
    # reschedules a replacement
    assert wait_until(
        lambda: any(
            a.client_status == "failed"
            for a in server.state.allocs_by_job(job.namespace, job.id)
        ),
        timeout_s=15,
    ), "alloc should fail"
    assert wait_until(
        lambda: len(server.state.allocs_by_job(job.namespace, job.id)) >= 2,
        timeout_s=15,
    ), "replacement alloc should be created"
    replacement = [
        a
        for a in server.state.allocs_by_job(job.namespace, job.id)
        if a.previous_allocation
    ]
    assert replacement


def test_e2e_two_clients_node_down(cluster):
    server, add_client = cluster
    c1 = add_client()
    c2 = add_client()
    job = mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].config = {}  # run forever
    job.datacenters = [c1.node.datacenter]
    server.job_register(job)
    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running"
        )
        == 4
    )
    # hard-kill client 1's node
    c1.shutdown()
    server.node_update_status(c1.node.id, "down")
    assert wait_until(
        lambda: sum(
            1
            for a in server.state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running" and a.node_id == c2.node.id
        )
        == 4,
        timeout_s=15,
    ), "all 4 allocs should come back on the surviving node"


def test_e2e_dedicated_cores_pin_and_env(cluster, tmp_path):
    """A `cores` task sees NOMAD_CPU_CORES and actually runs pinned to
    exactly those cores (reference: cpuset via LinuxResources; here
    sched_setaffinity)."""
    import sys as _sys

    server, add_client = cluster
    client = add_client()
    # the client fingerprints the REAL host core count; ask for 1 core
    marker = tmp_path / "cores.txt"
    job = mock.batch_job()
    t = job.task_groups[0].tasks[0]
    t.driver = "rawexec"
    t.resources.cores = 1
    t.config = {
        "command": _sys.executable,
        "args": [
            "-c",
            "import os; print(os.environ['NOMAD_CPU_CORES']);"
            "print(sorted(os.sched_getaffinity(0)))",
        ],
    }
    job.datacenters = [client.node.datacenter]
    server.job_register(job)
    assert wait_until(
        lambda: all(
            a.client_status == "complete"
            for a in server.state.allocs_by_job(job.namespace, job.id)
        )
        and len(server.state.allocs_by_job(job.namespace, job.id)) == 1,
        20,
    )
    alloc = server.state.allocs_by_job(job.namespace, job.id)[0]
    granted = list(alloc.resources.tasks.values())[0].reserved_cores
    assert len(granted) == 1
    out = client.alloc_runners[alloc.id].allocdir.stdout_path(t.name)
    with open(out) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    assert lines[0] == ",".join(str(c) for c in granted)
    assert lines[1] == str(sorted(int(c) for c in granted))


def test_e2e_artifacts_git_and_archive(cluster, tmp_path):
    """Artifact stanza end-to-end: a git ref clone AND an auto-unpacked
    tarball land in the task dir before the task starts (reference:
    go-getter through the taskrunner's artifact hook)."""
    import hashlib
    import subprocess
    import tarfile

    from nomad_tpu_torch.structs.structs import TaskArtifact

    import os as _os

    server, add_client = cluster
    client = add_client()

    # a git repo with a tagged version
    repo = tmp_path / "src"
    repo.mkdir()
    env = dict(_os.environ)
    env.update({
        "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
    })
    subprocess.run(["git", "init", "-q", "-b", "main", str(repo)],
                   check=True, env=env)
    (repo / "app.conf").write_text("version=1\n")
    subprocess.run(["git", "-C", str(repo), "add", "."], check=True, env=env)
    subprocess.run(["git", "-C", str(repo), "commit", "-qm", "v1"],
                   check=True, env=env)
    subprocess.run(["git", "-C", str(repo), "tag", "v1.0"], check=True, env=env)
    (repo / "app.conf").write_text("version=2\n")
    subprocess.run(["git", "-C", str(repo), "commit", "-qam", "v2"],
                   check=True, env=env)

    # a tarball with a checksum
    (tmp_path / "data.txt").write_text("payload\n")
    tarball = tmp_path / "bundle.tar.gz"
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(tmp_path / "data.txt", arcname="data.txt")
    digest = hashlib.sha256(tarball.read_bytes()).hexdigest()

    out = tmp_path / "out.txt"
    job = mock.batch_job()
    task = job.task_groups[0].tasks[0]
    task.driver = "rawexec"
    task.artifacts = [
        TaskArtifact(
            getter_source=f"git::file://{repo}?ref=v1.0",
            relative_dest="local/repo",
        ),
        TaskArtifact(
            getter_source=str(tarball),
            getter_options={"checksum": f"sha256:{digest}"},
            relative_dest="local/bundle",
        ),
    ]
    task.config = {
        "command": "/bin/sh",
        "args": [
            "-c",
            "cat ${NOMAD_TASK_DIR}/repo/app.conf "
            f"${{NOMAD_TASK_DIR}}/bundle/data.txt > {out}",
        ],
    }
    job.datacenters = [client.node.datacenter]
    server.job_register(job)

    assert wait_until(
        lambda: server.state.allocs_by_job(job.namespace, job.id)
        and all(
            a.client_status == "complete"
            for a in server.state.allocs_by_job(job.namespace, job.id)
        )
    )
    assert out.read_text() == "version=1\npayload\n"
