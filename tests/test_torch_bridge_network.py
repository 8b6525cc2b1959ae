"""``tests/test_bridge_network.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Bridge networking e2e (VERDICT r3 #5; reference
client/allocrunner/networking_bridge_linux.go).

The flagship criterion: two allocs on ONE node each bind the SAME
container port inside their own network namespace, reachable from the
host through the two DISTINCT host ports the scheduler granted.
"""

import json
import socket
import time
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.network import BridgeNetwork, PortProxy
from nomad_tpu_torch.structs.structs import NetworkResource, Port
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")

needs_netns = pytest.mark.skipif(
    not BridgeNetwork.available(), reason="needs root + netns capability"
)


@needs_netns
def test_netns_lifecycle_and_connectivity():
    """Create two namespaces on the bridge; each gets its own IP, both
    reachable from the host; teardown leaves nothing behind."""
    br = BridgeNetwork()
    a = br.create("aaaaaaaa-1111-2222-3333-444444444444")
    b = br.create("bbbbbbbb-1111-2222-3333-444444444444")
    try:
        assert a.ip != b.ip
        # same-bridge connectivity: bind in ns A, connect from host
        import subprocess

        srv = subprocess.Popen(
            [
                "ip", "netns", "exec", a.ns_name,
                "python3", "-c",
                "import socket;"
                "s=socket.socket();s.bind(('0.0.0.0',8080));s.listen(1);"
                "c,_=s.accept();c.sendall(b'hello-from-ns');c.close()",
            ]
        )
        try:
            deadline = time.time() + 5
            data = b""
            while time.time() < deadline:
                try:
                    conn = socket.create_connection((a.ip, 8080), timeout=1)
                    data = conn.recv(64)
                    conn.close()
                    break
                except OSError:
                    time.sleep(0.05)
            assert data == b"hello-from-ns"
        finally:
            srv.kill()
            srv.wait()
    finally:
        br.destroy("aaaaaaaa-1111-2222-3333-444444444444")
        br.destroy("bbbbbbbb-1111-2222-3333-444444444444")
    import subprocess as sp

    out = sp.run(["ip", "netns", "list"], capture_output=True, text=True)
    assert "nt-aaaaaaaa" not in out.stdout
    assert "nt-bbbbbbbb" not in out.stdout


@needs_netns
def test_port_proxy_relays():
    br = BridgeNetwork()
    a = br.create("cccccccc-1111-2222-3333-444444444444")
    import subprocess

    srv = subprocess.Popen(
        [
            "ip", "netns", "exec", a.ns_name,
            "python3", "-u", "-c",
            "import socket\n"
            "s=socket.socket()\n"
            "s.bind(('0.0.0.0',9000))\n"
            "s.listen(4)\n"
            "print('listening',flush=True)\n"
            "while True:\n"
            "    c,_=s.accept();c.sendall(b'via-proxy');c.close()",
        ],
        stdout=subprocess.PIPE,
        text=True,
    )
    proxy = None
    try:
        assert srv.stdout.readline().strip() == "listening"
        host_port = _free_port()
        proxy = PortProxy(host_port, a.ip, 9000)
        deadline = time.time() + 5
        data = b""
        while time.time() < deadline:
            try:
                conn = socket.create_connection(("127.0.0.1", host_port), 1)
                data = conn.recv(64)
                conn.close()
                if data:
                    break
            except OSError:
                time.sleep(0.05)
        assert data == b"via-proxy"
    finally:
        if proxy:
            proxy.stop()
        srv.kill()
        srv.wait()
        br.destroy("cccccccc-1111-2222-3333-444444444444")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@needs_netns
def test_e2e_two_allocs_same_container_port(tmp_path):
    """Two service jobs, one node, both binding container port 8080 in
    bridge mode: each is reachable on its own granted host port and
    answers with its own payload (the VERDICT done-criterion)."""
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.server import Server

    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
    client.start()
    try:
        jobs = []
        for tag in ("alpha", "beta"):
            job = mock.job(id=f"web-{tag}")
            tg = job.task_groups[0]
            tg.count = 1
            tg.networks = [
                NetworkResource(
                    mode="bridge",
                    dynamic_ports=[Port(label="http", to=8080)],
                )
            ]
            task = tg.tasks[0]
            task.driver = "rawexec"
            task.resources.networks = []
            task.config = {
                "command": "python3",
                "args": [
                    "-c",
                    (
                        "import http.server,functools\n"
                        "class H(http.server.BaseHTTPRequestHandler):\n"
                        "  def do_GET(self):\n"
                        f"    body=b'hello-{tag}'\n"
                        "    self.send_response(200)\n"
                        "    self.send_header('Content-Length',len(body))\n"
                        "    self.end_headers();self.wfile.write(body)\n"
                        "  def log_message(self,*a): pass\n"
                        "http.server.HTTPServer(('0.0.0.0',8080),H)"
                        ".serve_forever()"
                    ),
                ],
            }
            job.datacenters = ["dc1"]
            server.job_register(job)
            jobs.append(job)

        def running():
            allocs = [
                a
                for j in jobs
                for a in server.state.allocs_by_job(j.namespace, j.id)
                if a.client_status == "running"
            ]
            return allocs if len(allocs) == 2 else None

        deadline = time.time() + 20
        allocs = None
        while time.time() < deadline and not (allocs := running()):
            time.sleep(0.1)
        assert allocs, "both bridge allocs must reach running"
        assert len({a.node_id for a in allocs}) == 1, "one node"

        host_ports = {}
        for a in allocs:
            ports = [
                p
                for net in a.resources.shared_networks
                for p in net.dynamic_ports
            ]
            assert ports and ports[0].to == 8080
            host_ports[a.job_id] = ports[0].value
        assert host_ports["web-alpha"] != host_ports["web-beta"], (
            "same container port must map to distinct host ports"
        )

        for tag in ("alpha", "beta"):
            port = host_ports[f"web-{tag}"]
            deadline = time.time() + 10
            body = b""
            while time.time() < deadline:
                try:
                    body = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/", timeout=2
                    ).read()
                    break
                except Exception:
                    time.sleep(0.1)
            assert body == f"hello-{tag}".encode(), (
                f"{tag} on host port {port}: got {body!r}"
            )
    finally:
        for j in jobs:
            try:
                server.job_deregister(j.namespace, j.id)
            except Exception:
                pass
        client.shutdown()
        server.shutdown()


@needs_netns
def test_netns_adoption_across_incarnations():
    """Agent-restart semantics: keep_namespaces leaves the netns; the
    next incarnation adopts it with the SAME address instead of
    recreating (a recreate would sever the live task)."""
    aid = "eeeeeeee-1111-2222-3333-444444444444"
    br1 = BridgeNetwork()
    net1 = br1.create(aid)
    ip1, ns1 = net1.ip, net1.ns_name
    br1.shutdown(keep_namespaces=True)
    import subprocess as sp

    out = sp.run(["ip", "netns", "list"], capture_output=True, text=True)
    assert ns1 in out.stdout, "namespace must survive a keep shutdown"
    br2 = BridgeNetwork()
    try:
        net2 = br2.create(aid)
        assert net2.ip == ip1, "adoption must keep the address"
        assert net2.ns_name == ns1
    finally:
        br2.destroy(aid)


@needs_netns
def test_exec_driver_enters_netns_via_executor(tmp_path):
    """The native executor enters the netns from the spec (before any
    chroot/privilege drop) — the task's network view is the namespace."""
    from nomad_tpu_torch.drivers.base import TaskConfig
    from nomad_tpu_torch.drivers.exec import ExecDriver

    br = BridgeNetwork()
    net = br.create("ffffffff-1111-2222-3333-444444444444")
    drv = ExecDriver()
    out = tmp_path / "ifaces.txt"
    try:
        cfg = TaskConfig(
            id="nstest/task",
            name="task",
            alloc_id="ffffffff",
            config={
                "command": "/bin/sh",
                "args": ["-c", f"ip -o -4 addr show > {out}"],
                "cgroup_v2": False,
            },
            task_dir=str(tmp_path / "task"),
            network_ns=net.ns_path,
        )
        (tmp_path / "task").mkdir()
        drv.start_task(cfg)
        res = drv.wait_task("nstest/task", timeout_s=10)
        assert res is not None and res.exit_code == 0
        text = out.read_text()
        assert net.ip in text, f"task saw host interfaces: {text}"
        assert "eth0" in text
    finally:
        try:
            drv.destroy_task("nstest/task", force=True)
        except Exception:
            pass
        br.destroy("ffffffff-1111-2222-3333-444444444444")
