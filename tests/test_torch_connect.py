"""``tests/test_connect.py`` against the port (nomad_tpu_torch/connect/,
ported whole), with the reference's assertions: imports pointed at
``nomad_tpu_torch``, the e2e's server on ``device="cpu"`` with the
reference's host backend.

The reference's docstring: service mesh (Connect analog) tests.

Reference shapes: nomad/job_endpoint_hooks.go:60 (sidecar injection),
command/agent/consul/connect.go (mesh registration), envoy's data path
(here: the nomad_tpu_torch.connect.sidecar relay). The e2e drives two
bridge-mode jobs whose tasks talk ONLY through the mesh:
B's task -> B's sidecar (upstream listener) -> A's advertised sidecar
(host port) -> A's inbound relay -> A's service, across namespaces.
"""

import json
import time
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client.network import BridgeNetwork
from nomad_tpu_torch.connect import inject_connect_sidecars
from nomad_tpu_torch.connect.hook import ConnectValidationError
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.structs.structs import (
    Connect,
    ConnectUpstream,
    NetworkResource,
    Port,
    Service,
    SidecarService,
)

# the e2e server's schedulers: the reference's host backend, on the CPU
DEVICE = "cpu"

needs_netns = pytest.mark.skipif(
    not BridgeNetwork.available(), reason="needs root + netns capability"
)


def connect_job(job_id, upstreams=(), port_to=8080):
    job = mock.job(id=job_id)
    tg = job.task_groups[0]
    tg.count = 1
    tg.networks = [
        NetworkResource(
            mode="bridge",
            dynamic_ports=[Port(label="http", to=port_to)],
        )
    ]
    tg.tasks[0].resources.networks = []
    tg.services = [
        Service(
            name=job_id,
            port_label="http",
            connect=Connect(
                sidecar_service=SidecarService(
                    upstreams=[
                        ConnectUpstream(
                            destination_name=d, local_bind_port=p
                        )
                        for d, p in upstreams
                    ]
                )
            ),
        )
    ]
    return job


# ---------------------------------------------------------------------------
# admission hook
# ---------------------------------------------------------------------------


def test_injection_adds_sidecar_task_port_and_mesh_service():
    job = connect_job("api")
    inject_connect_sidecars(job)
    tg = job.task_groups[0]
    names = [t.name for t in tg.tasks]
    assert "connect-proxy-api" in names
    labels = [p.label for p in tg.networks[0].dynamic_ports]
    assert "connect-proxy-api" in labels
    svc_names = [s.name for s in tg.services]
    assert "api-sidecar-proxy" in svc_names
    sidecar = next(t for t in tg.tasks if t.name == "connect-proxy-api")
    cfg = json.loads(sidecar.templates[0].embedded_tmpl)
    assert cfg["inbound"]["local_port"] == 8080


def test_sidecar_gateway_fallback_scoped_to_own_host(monkeypatch):
    """The bridge-gateway dial fallback exists for the NAT-less hairpin
    (a netns'd dialer reaching THIS host's advertised IP); a cross-host
    target must never grow a gateway candidate — EHOSTUNREACH to a dead
    remote peer would otherwise reroute the stream to whatever occupies
    the same port at the gateway."""
    from nomad_tpu_torch.connect import sidecar as sc

    monkeypatch.setattr(sc, "_default_gateway", lambda: "172.26.64.1")
    monkeypatch.setenv("NOMAD_HOST_IP", "10.0.0.5")
    relay = sc._Relay.__new__(sc._Relay)
    relay._rr = __import__("itertools").count()
    relay._gateway = "172.26.64.1"
    relay._host_ip = "10.0.0.5"
    # own advertised IP: hairpin — gateway fallback offered
    relay._targets = ["10.0.0.5:21000"]
    assert relay._pick() == [("10.0.0.5", 21000), ("172.26.64.1", 21000)]
    # cross-host target: no fallback, a dead peer must fail
    relay._targets = ["10.0.0.7:21000"]
    assert relay._pick() == [("10.0.0.7", 21000)]
    # unknown host ip (pre-upgrade client): errno-guarded legacy shape
    relay._host_ip = ""
    relay._targets = ["10.0.0.7:21000"]
    assert relay._pick() == [("10.0.0.7", 21000), ("172.26.64.1", 21000)]
    relay._targets = ["127.0.0.1:9000"]
    assert relay._pick() == [("127.0.0.1", 9000)]


def test_task_env_carries_host_ip():
    """build_env must expose the node's advertised IP (the service-
    registration address selection) as NOMAD_HOST_IP so netns'd tasks
    can recognize their own host."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client.taskenv import build_env

    node = mock.node()
    node.attributes["unique.network.ip-address"] = "10.0.0.5"
    job = connect_job("api")
    alloc = mock.alloc(node_=node, job=job)
    env = build_env(alloc, job.task_groups[0].tasks[0], node=node)
    assert env["NOMAD_HOST_IP"] == "10.0.0.5"


def test_injection_is_idempotent():
    job = connect_job("api")
    inject_connect_sidecars(job)
    snapshot = (
        len(job.task_groups[0].tasks),
        len(job.task_groups[0].services),
        len(job.task_groups[0].networks[0].dynamic_ports),
    )
    inject_connect_sidecars(job)
    assert snapshot == (
        len(job.task_groups[0].tasks),
        len(job.task_groups[0].services),
        len(job.task_groups[0].networks[0].dynamic_ports),
    )


def test_injection_requires_bridge_mode():
    job = connect_job("api")
    job.task_groups[0].networks[0].mode = "host"
    with pytest.raises(ConnectValidationError, match="bridge"):
        inject_connect_sidecars(job)


def test_injection_requires_known_port():
    job = connect_job("api")
    job.task_groups[0].services[0].port_label = "nope"
    with pytest.raises(ConnectValidationError, match="not defined"):
        inject_connect_sidecars(job)


def test_upstreams_render_templates_and_env():
    job = connect_job("web", upstreams=[("api", 5000)])
    inject_connect_sidecars(job)
    tg = job.task_groups[0]
    sidecar = next(t for t in tg.tasks if t.name == "connect-proxy-web")
    dests = [t.dest_path for t in sidecar.templates]
    assert "local/upstream-api.addrs" in dests
    addr_tmpl = next(
        t for t in sidecar.templates
        if t.dest_path == "local/upstream-api.addrs"
    )
    assert 'service "api-sidecar-proxy"' in addr_tmpl.embedded_tmpl

    # main tasks see the upstream locals in env
    from nomad_tpu_torch.client.taskenv import build_env

    alloc = mock.alloc(job, mock.node())
    env = build_env(alloc, tg.tasks[0], None, "/tmp")
    assert env["NOMAD_UPSTREAM_ADDR_API"] == "127.0.0.1:5000"


def test_jobspec_parses_connect_stanza():
    from nomad_tpu_torch.jobspec.parse import parse_job as parse_job_hcl

    hcl = """
job "web" {
  group "g" {
    network {
      mode = "bridge"
      port "http" { to = 8080 }
    }
    service {
      name = "web"
      port = "http"
      connect {
        sidecar_service {
          proxy {
            upstreams {
              destination_name = "api"
              local_bind_port  = 5000
            }
          }
        }
      }
    }
    task "t" {
      driver = "mock"
    }
  }
}
"""
    job = parse_job_hcl(hcl)
    svc = job.task_groups[0].services[0]
    assert svc.connect is not None
    ups = svc.connect.sidecar_service.upstreams
    assert len(ups) == 1
    assert ups[0].destination_name == "api"
    assert ups[0].local_bind_port == 5000


# ---------------------------------------------------------------------------
# e2e: two services talking only through the mesh
# ---------------------------------------------------------------------------


@needs_netns
def test_e2e_mesh_roundtrip(tmp_path):
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.server import Server

    server = Server(num_workers=2, scheduler_config=SchedulerConfig(
        backend="host", device=DEVICE))
    server.establish_leadership()
    client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
    client.start()
    out = tmp_path / "fetched.txt"
    try:
        # service A: an http server answering "hello-from-api"
        api = connect_job("api")
        api.task_groups[0].tasks[0].driver = "rawexec"
        api.task_groups[0].tasks[0].config = {
            "command": "python3",
            "args": [
                "-c",
                (
                    "import http.server\n"
                    "class H(http.server.BaseHTTPRequestHandler):\n"
                    "  def do_GET(self):\n"
                    "    b=b'hello-from-api'\n"
                    "    self.send_response(200)\n"
                    "    self.send_header('Content-Length',len(b))\n"
                    "    self.end_headers();self.wfile.write(b)\n"
                    "  def log_message(self,*a): pass\n"
                    "http.server.HTTPServer(('0.0.0.0',8080),H)"
                    ".serve_forever()"
                ),
            ],
        }
        api.datacenters = ["dc1"]
        server.job_register(api)

        # service B: fetches A through ITS OWN sidecar's upstream local
        web = connect_job("web", upstreams=[("api", 5000)], port_to=8081)
        web.task_groups[0].tasks[0].driver = "rawexec"
        web.task_groups[0].tasks[0].config = {
            "command": "/bin/sh",
            "args": [
                "-c",
                "for i in $(seq 1 120); do "
                "  if wget -q -O - http://$NOMAD_UPSTREAM_ADDR_API/ "
                f"   > {out} 2>/dev/null; then break; fi; sleep 0.5; "
                "done; sleep 300",
            ],
        }
        web.datacenters = ["dc1"]
        server.job_register(web)

        deadline = time.time() + 45
        while time.time() < deadline:
            if out.exists() and out.read_text().strip():
                break
            time.sleep(0.2)
        assert out.exists() and out.read_text().strip() == "hello-from-api", (
            "mesh roundtrip failed: "
            + (out.read_text() if out.exists() else "<no file>")
        )
        # the catalog advertises both mesh services
        regs = server.state.service_registrations("default", "api-sidecar-proxy")
        assert regs and regs[0].port > 0
    finally:
        for j in ("api", "web"):
            try:
                server.job_deregister("default", j)
            except Exception:
                pass
        client.shutdown()
        server.shutdown()
