"""``tests/test_docker_driver.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Docker driver tests against the fake Engine daemon (tests/fake_docker.py
backs "containers" with real processes), plus a real-dockerd e2e that skips
when /var/run/docker.sock is absent.

Reference parity targets: drivers/docker/driver.go (lifecycle, stats,
exec), coordinator.go (pull dedup), docklog (logs into the task's
stdout/stderr files).
"""

import os
import threading
import time

import pytest

from nomad_tpu_torch.drivers import new_driver
from nomad_tpu_torch.drivers.base import DriverError, TaskConfig
from nomad_tpu_torch.drivers.docker import DockerDriver

from fake_docker import FakeDockerDaemon
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


@pytest.fixture
def daemon(tmp_path):
    sock = str(tmp_path / "d.sock")
    d = FakeDockerDaemon(sock)
    d.start()
    yield d
    d.stop()


@pytest.fixture
def driver(daemon):
    return DockerDriver(socket_path=daemon.socket_path)


def _cfg(tmp_path, task_id="a1/web", image="busybox:latest", command="/bin/sh",
         args=None, env=None):
    logs = tmp_path / "logs"
    logs.mkdir(exist_ok=True)
    return TaskConfig(
        id=task_id,
        name="web",
        alloc_id="a1",
        env=env or {},
        config={
            "image": image,
            "command": command,
            "args": args or [],
        },
        resources_cpu=100,
        resources_memory_mb=64,
        task_dir=str(tmp_path),
        stdout_path=str(logs / "web.stdout.0"),
        stderr_path=str(logs / "web.stderr.0"),
    )


def test_fingerprint_undetected(tmp_path):
    d = DockerDriver(socket_path=str(tmp_path / "nope.sock"))
    fp = d.fingerprint()
    assert fp.health == "undetected"


def test_fingerprint_healthy(driver):
    fp = driver.fingerprint()
    assert fp.health == "healthy"
    assert fp.attributes["driver.docker"] == "1"
    assert fp.attributes["driver.docker.version"] == "fake-24.0"


def test_start_wait_exit_code_and_logs(driver, daemon, tmp_path):
    cfg = _cfg(
        tmp_path,
        args=["-c", "echo hello-out; echo hello-err >&2; exit 3"],
    )
    handle = driver.start_task(cfg)
    assert handle.state["container_id"]
    res = driver.wait_task(cfg.id, timeout_s=10)
    assert res is not None and res.exit_code == 3
    # docklog: container output landed in the task's log files
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        out = open(cfg.stdout_path, "rb").read() if os.path.exists(cfg.stdout_path) else b""
        err = open(cfg.stderr_path, "rb").read() if os.path.exists(cfg.stderr_path) else b""
        if b"hello-out" in out and b"hello-err" in err:
            break
        time.sleep(0.05)
    assert b"hello-out" in open(cfg.stdout_path, "rb").read()
    assert b"hello-err" in open(cfg.stderr_path, "rb").read()
    driver.destroy_task(cfg.id)
    assert daemon.pull_count.get("busybox:latest") == 1


def test_env_reaches_container(driver, tmp_path):
    cfg = _cfg(tmp_path, args=["-c", "echo VAL=$MY_VAR"],
               env={"MY_VAR": "from-nomad"})
    driver.start_task(cfg)
    assert driver.wait_task(cfg.id, timeout_s=10).exit_code == 0
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if os.path.exists(cfg.stdout_path) and (
            b"VAL=from-nomad" in open(cfg.stdout_path, "rb").read()
        ):
            break
        time.sleep(0.05)
    assert b"VAL=from-nomad" in open(cfg.stdout_path, "rb").read()
    driver.destroy_task(cfg.id)


def test_pull_coordinator_dedupes_concurrent_pulls(tmp_path):
    sock = str(tmp_path / "slow.sock")
    d = FakeDockerDaemon(sock, pull_delay_s=0.3)
    d.start()
    try:
        drv = DockerDriver(socket_path=sock)
        errs = []

        def run(i):
            cfg = _cfg(tmp_path, task_id=f"a{i}/web",
                       args=["-c", "exit 0"])
            try:
                drv.start_task(cfg)
                drv.wait_task(cfg.id, timeout_s=10)
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        assert d.pull_count.get("busybox:latest") == 1, (
            f"coordinator should dedupe: {d.pull_count}"
        )
    finally:
        d.stop()


def test_pull_failure_propagates(driver, tmp_path):
    cfg = _cfg(tmp_path, image="missing/image:latest")
    with pytest.raises(DriverError, match="not found"):
        driver.start_task(cfg)


def test_stop_task_sigterm(driver, tmp_path):
    cfg = _cfg(tmp_path, args=["-c", "trap 'exit 0' TERM; sleep 30 & wait"])
    driver.start_task(cfg)
    time.sleep(0.3)
    assert driver.inspect_task(cfg.id).state == "running"
    driver.stop_task(cfg.id, timeout_s=5)
    res = driver.wait_task(cfg.id, timeout_s=10)
    assert res is not None
    driver.destroy_task(cfg.id)


def test_stats_and_signal(driver, tmp_path):
    cfg = _cfg(tmp_path, args=["-c", "sleep 30"])
    driver.start_task(cfg)
    stats = driver.task_stats(cfg.id)
    assert stats["cpu_user_s"] == 1.0
    assert stats["memory_rss_bytes"] == 1 << 20
    driver.signal_task(cfg.id, "SIGKILL")
    res = driver.wait_task(cfg.id, timeout_s=10)
    assert res is not None and res.exit_code != 0
    driver.destroy_task(cfg.id)


def test_exec_task(driver, tmp_path):
    cfg = _cfg(tmp_path, args=["-c", "sleep 30"])
    driver.start_task(cfg)
    out, code = driver.exec_task(cfg.id, ["/bin/echo", "exec-hi"])
    assert code == 0 and b"exec-hi" in out
    out, code = driver.exec_task(cfg.id, ["/bin/sh", "-c", "exit 7"])
    assert code == 7
    driver.stop_task(cfg.id, timeout_s=2)
    driver.destroy_task(cfg.id, force=True)


def test_recover_task(driver, daemon, tmp_path):
    cfg = _cfg(tmp_path, args=["-c", "sleep 30"])
    handle = driver.start_task(cfg)
    # a fresh driver instance (client restart) reattaches by container id
    drv2 = DockerDriver(socket_path=daemon.socket_path)
    drv2.recover_task(handle)
    assert drv2.inspect_task(cfg.id).state == "running"
    drv2.signal_task(cfg.id, "SIGKILL")
    assert drv2.wait_task(cfg.id, timeout_s=10) is not None
    drv2.destroy_task(cfg.id)


def test_e2e_container_job_via_client(tmp_path, monkeypatch):
    """A docker job through server + client + task runner against the
    fake daemon (the 'runs a container job' e2e; real dockerd variant
    below)."""
    sock = str(tmp_path / "e2e.sock")
    d = FakeDockerDaemon(sock)
    d.start()
    monkeypatch.setenv("NOMAD_DOCKER_SOCKET", sock)
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.server import Server

    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    client = None
    try:
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        job = mock.job(id="containerized")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        tg.tasks[0].driver = "docker"
        tg.tasks[0].config = {
            "image": "busybox:latest",
            "command": "/bin/sh",
            "args": ["-c", "echo containerized-ok; sleep 30"],
        }
        server.job_register(job)

        deadline = time.monotonic() + 15
        running = []
        while time.monotonic() < deadline:
            running = [
                a
                for a in server.state.allocs_by_job(job.namespace, job.id)
                if a.client_status == "running"
            ]
            if running:
                break
            time.sleep(0.1)
        assert running, "docker alloc should reach running"
        assert d.pull_count.get("busybox:latest") == 1
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()
        d.stop()


needs_docker = pytest.mark.skipif(
    not os.path.exists("/var/run/docker.sock"),
    reason="no docker daemon on this host",
)


@needs_docker
def test_real_docker_roundtrip(tmp_path):
    drv = DockerDriver()
    if drv.fingerprint().health != "healthy":
        pytest.skip("docker socket exists but daemon unhealthy")
    cfg = _cfg(tmp_path, image="busybox:latest", command="echo",
               args=["real-docker-ok"])
    drv.start_task(cfg)
    res = drv.wait_task(cfg.id, timeout_s=60)
    assert res is not None and res.exit_code == 0
    drv.destroy_task(cfg.id)


def test_periodic_refingerprint_detects_daemon(tmp_path, monkeypatch):
    """Agent boots before dockerd: docker is undetected; when the daemon
    appears, the periodic re-fingerprint flips it healthy and pushes a
    node update (reference: periodic fingerprinters)."""
    sock = str(tmp_path / "late.sock")
    monkeypatch.setenv("NOMAD_DOCKER_SOCKET", sock)
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.server import Server

    server = Server(num_workers=1, scheduler_config=cpu_config())
    server.establish_leadership()
    client = None
    d = None
    try:
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.fingerprint_interval_s = 0.2
        client.start()
        assert client.wait_registered(10)
        node = server.state.node_by_id(client.node.id)
        info = node.drivers.get("docker")
        assert info is not None and not info.detected

        d = FakeDockerDaemon(sock)
        d.start()
        deadline = time.monotonic() + 10
        healthy = False
        while time.monotonic() < deadline:
            node = server.state.node_by_id(client.node.id)
            info = node.drivers.get("docker")
            if info is not None and info.healthy:
                healthy = True
                break
            time.sleep(0.1)
        assert healthy, "re-fingerprint should detect the late daemon"
        assert node.attributes.get("driver.docker") == "1"
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()
        if d is not None:
            d.stop()


def test_reregistration_preserves_server_owned_node_state(tmp_path):
    """A periodic re-fingerprint re-register must not erase an operator's
    drain/eligibility or flip a ready node back to initializing."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs import DrainStrategy

    server = Server(num_workers=1, scheduler_config=cpu_config())
    server.establish_leadership()
    try:
        node = mock.node()
        server.node_register(node)
        server.node_heartbeat(node.id)  # -> ready
        server.node_update_drain(node.id, DrainStrategy(deadline_s=600))
        stored = server.state.node_by_id(node.id)
        assert stored.drain_strategy is not None
        assert stored.scheduling_eligibility == "ineligible"

        # client-side re-register (fingerprint change): fresh copy with
        # client defaults for the server-owned fields
        again = node.copy()
        again.drain_strategy = None
        again.scheduling_eligibility = "eligible"
        again.status = "initializing"
        again.attributes = dict(node.attributes)
        again.attributes["driver.docker"] = "1"
        server.node_register(again)

        stored = server.state.node_by_id(node.id)
        assert stored.drain_strategy is not None, "drain erased by re-register"
        assert stored.scheduling_eligibility == "ineligible"
        assert stored.status == "ready"
        assert stored.attributes.get("driver.docker") == "1"
    finally:
        server.shutdown()
