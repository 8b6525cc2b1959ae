"""``tests/test_streaming.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Streaming alloc surface: logs / fs / exec across the full path
(API consumer → server → client agent → driver/executor).

Reference: SURVEY §3.5 — nomad/client_fs_endpoint.go, client/fs_endpoint.go,
plugins/drivers/execstreaming.go, command/alloc_{logs,fs,exec}.go.
"""

import socket
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.client import Client
from nomad_tpu_torch.rpc import ConnPool
from nomad_tpu_torch.server.cluster import ClusterRPC, ClusterServer
from nomad_tpu_torch.structs.structs import Resources, Task
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=30.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def streaming_cluster(tmp_path_factory):
    """3 servers + HTTP agent + a networked client running one exec job."""
    from nomad_tpu_torch.agent.http import HTTPAgentServer

    tmp = tmp_path_factory.mktemp("streamc")
    ports = []
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(3)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    ids = [f"s{i}" for i in range(3)]
    addrs = {nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(ids)}
    servers = {
        nid: ClusterServer(
            nid,
            scheduler_config=cpu_config(),
            peers={p: a for p, a in addrs.items() if p != nid},
            port=addrs[nid][1],
            num_workers=1,
        )
        for nid in ids
    }
    for s in servers.values():
        s.start()
    leader = lambda: next((s for s in servers.values() if s.is_leader()), None)
    assert wait_until(lambda: leader() is not None)

    # HTTP API on a FOLLOWER (the fs path must work from any server)
    follower = next(s for s in servers.values() if not s.is_leader())
    http = HTTPAgentServer(follower, host="127.0.0.1", port=0)
    http.start()

    client = Client(
        ClusterRPC([s.addr for s in servers.values()]),
        data_dir=str(tmp / "client"),
    )
    client.start()

    job = mock.job()
    job.id = "stream-job"
    job.datacenters = [client.node.datacenter]
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0] = Task(
        name="web",
        driver="exec",
        config={
            "command": "/bin/sh",
            "args": [
                "-c",
                "echo line-one; echo err-one >&2; "
                "echo filedata > local/data.txt; "
                "i=0; while true; do echo tick-$i; i=$((i+1)); sleep 1; done",
            ],
        },
        resources=Resources(cpu=100, memory_mb=64),
    )
    pool = ConnPool()
    pool.call(leader().addr, "Job.register", {"job": job})
    assert wait_until(
        lambda: any(
            a.client_status == "running"
            for a in leader().server.state.allocs_by_job("default", job.id)
        ),
        40,
    ), "stream job never ran"
    alloc = next(
        a
        for a in leader().server.state.allocs_by_job("default", job.id)
        if a.client_status == "running"
    )
    api = NomadClient(f"http://{http.addr[0]}:{http.addr[1]}")
    yield api, alloc, client, servers

    pool.shutdown()
    client.shutdown()
    http.shutdown()
    for s in servers.values():
        s.shutdown()


def test_alloc_logs(streaming_cluster):
    api, alloc, *_ = streaming_cluster
    data = b"".join(api.allocations.logs(alloc.id, task="web"))
    assert b"line-one" in data


def test_alloc_logs_stderr(streaming_cluster):
    api, alloc, *_ = streaming_cluster
    data = b"".join(
        api.allocations.logs(alloc.id, task="web", log_type="stderr")
    )
    assert b"err-one" in data


def test_alloc_logs_follow(streaming_cluster):
    """-f streams new output as the task produces it."""
    api, alloc, *_ = streaming_cluster
    seen = []
    gen = api.allocations.logs(alloc.id, task="web", follow=True)
    deadline = time.monotonic() + 20
    ticks = set()
    while time.monotonic() < deadline:
        chunk = next(gen)
        seen.append(chunk)
        for tok in b"".join(seen).split():
            if tok.startswith(b"tick-"):
                ticks.add(tok)
        if len(ticks) >= 2:
            break
    assert len(ticks) >= 2, f"follow never saw new ticks: {b''.join(seen)!r}"


def test_alloc_fs_ls_and_cat(streaming_cluster):
    api, alloc, *_ = streaming_cluster
    assert wait_until(
        lambda: any(
            e["name"] == "data.txt"
            for e in api.allocations.fs_ls(alloc.id, "web/local")
        ),
        10,
    )
    st = api.allocations.fs_stat(alloc.id, "web/local/data.txt")
    assert st["size"] > 0 and not st["is_dir"]
    data = api.allocations.fs_cat(alloc.id, "web/local/data.txt")
    assert data == b"filedata\n"
    # root listing shows the task dir + shared alloc dir
    names = {e["name"] for e in api.allocations.fs_ls(alloc.id, "")}
    assert {"web", "alloc"} <= names


def test_alloc_fs_escape_rejected(streaming_cluster):
    from nomad_tpu_torch.api.client import APIError

    api, alloc, *_ = streaming_cluster
    with pytest.raises(APIError, match="escapes"):
        api.allocations.fs_ls(alloc.id, "../../../etc")


def test_alloc_exec_roundtrip(streaming_cluster):
    """Interactive exec through server splice → client → native pty."""
    api, alloc, *_ = streaming_cluster
    session = api.allocations.exec_session(
        alloc.id, ["/bin/sh", "-c", "echo exec-works; cat"], task="web"
    )
    try:
        out = b""
        deadline = time.monotonic() + 15
        while b"exec-works" not in out and time.monotonic() < deadline:
            msg = session.recv(timeout_s=1)
            if msg and msg.get("data"):
                out += msg["data"]
        assert b"exec-works" in out
        session.send_stdin(b"stdin-roundtrip\n")
        out2 = b""
        deadline = time.monotonic() + 15
        while b"stdin-roundtrip" not in out2 and time.monotonic() < deadline:
            msg = session.recv(timeout_s=1)
            if msg and msg.get("data"):
                out2 += msg["data"]
        assert b"stdin-roundtrip" in out2
    finally:
        session.close()


def test_alloc_exec_unknown_alloc(streaming_cluster):
    from nomad_tpu_torch.api.client import APIError

    api, *_ = streaming_cluster
    with pytest.raises(APIError, match="not found"):
        api.allocations.exec_session("deadbeef-nope", ["/bin/true"])


def test_logs_task_traversal_rejected(streaming_cluster):
    """A path-shaped task name must not escape the alloc's log dir."""
    from nomad_tpu_torch.api.client import APIError

    api, alloc, *_ = streaming_cluster
    with pytest.raises(APIError, match="unknown task"):
        b"".join(
            api.allocations.logs(alloc.id, task="../../../../etc/passwd")
        )


def test_exec_task_exit_code(streaming_cluster):
    """One-shot exec reports the command's real exit status."""
    api, alloc, client, _ = streaming_cluster
    runner = client.alloc_runners[alloc.id]
    tr = runner.task_runners["web"]
    out, code = tr.driver.exec_task(tr.task_id, ["true"])
    assert code == 0
    out, code = tr.driver.exec_task(tr.task_id, ["sh", "-c", "exit 7"])
    assert code == 7
    out, code = tr.driver.exec_task(tr.task_id, ["echo", "hi"])
    assert code == 0 and b"hi" in out


def test_reverse_dial_fallback_when_forward_unreachable(tmp_path):
    """NAT'd client: the advertised forward-dial address is dead, but the
    client parked reverse sessions on the server — logs still stream
    (reference nomad/client_rpc.go's server->client session reuse)."""
    from nomad_tpu_torch.agent.http import HTTPAgentServer

    server = ClusterServer("rev0", scheduler_config=cpu_config(), port=0, num_workers=2)
    server.start()
    assert wait_until(lambda: server.is_leader())
    http = HTTPAgentServer(server, host="127.0.0.1", port=0)
    http.start()
    client = None
    try:
        client = Client(
            ClusterRPC([server.addr]), data_dir=str(tmp_path / "client")
        )
        client.start()
        assert client.wait_registered(10)
        # the reverse dialer parks sessions on the server
        assert wait_until(
            lambda: server._reverse.get(client.node.id), 10
        ), "reverse sessions should park"

        job = mock.job(id="rev-job")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        tg.tasks[0] = Task(
            name="web",
            driver="rawexec",
            config={
                "command": "/bin/sh",
                "args": ["-c", "echo reverse-hello; sleep 60"],
            },
            resources=Resources(cpu=100, memory_mb=64),
        )
        pool = ConnPool()
        pool.call(server.addr, "Job.register", {"job": job})
        assert wait_until(
            lambda: any(
                a.client_status == "running"
                for a in server.server.state.allocs_by_job("default", job.id)
            ),
            30,
        )
        alloc = next(
            a
            for a in server.server.state.allocs_by_job("default", job.id)
            if a.client_status == "running"
        )

        # Simulate NAT: re-advertise a dead forward-dial address. The
        # store preserves server-owned fields, so re-registering with the
        # poisoned attribute is exactly what a NAT'd client would do.
        poisoned = client.node.copy()
        poisoned.attributes["unique.client.rpc"] = "127.0.0.1:1"
        pool.call(server.addr, "Node.register", {"node": poisoned})
        stored = server.server.state.node_by_id(client.node.id)
        assert stored.attributes["unique.client.rpc"] == "127.0.0.1:1"

        api = NomadClient(f"http://{http.addr[0]}:{http.addr[1]}")
        data = b"".join(api.allocations.logs(alloc.id, task="web"))
        assert b"reverse-hello" in data
        pool.shutdown()
    finally:
        if client is not None:
            client.shutdown()
        http.shutdown()
        server.shutdown()
