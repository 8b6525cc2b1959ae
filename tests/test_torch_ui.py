"""``tests/test_ui.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Web UI serving tests (reference: ui/ served by command/agent/http.go
with / redirecting to /ui/).
"""

import json
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig


@pytest.fixture
def agent(tmp_path):
    cfg = AgentConfig()
    cfg.device = "cpu"
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    a = Agent(cfg)
    a.start()
    yield a
    a.shutdown()


def _get(agent, path, raw=False):
    url = f"http://127.0.0.1:{agent.http_addr[1]}{path}"
    with urllib.request.urlopen(url) as resp:
        body = resp.read()
        return resp.status, (body if raw else json.loads(body))


def test_ui_serves_shell(agent):
    url = f"http://127.0.0.1:{agent.http_addr[1]}/ui/"
    with urllib.request.urlopen(url) as resp:
        assert resp.status == 200
        assert "text/html" in resp.headers["Content-Type"]
        html = resp.read().decode()
    assert "nomad-tpu" in html
    assert "async jobs()" in html, "SPA script embedded"


def test_root_redirects_to_ui(agent):
    import urllib.error

    url = f"http://127.0.0.1:{agent.http_addr[1]}/"
    req = urllib.request.Request(url)

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(NoRedirect)
    try:
        resp = opener.open(req)
        status, location = resp.status, resp.headers.get("Location")
    except urllib.error.HTTPError as e:
        status, location = e.code, e.headers.get("Location")
    assert status == 307
    assert location == "/ui/"


def test_ui_api_contract(agent):
    """Every endpoint the SPA consumes answers 200 with the shape the
    JS reads (field names are load-bearing for the UI)."""
    srv = agent.server.server
    n = mock.node()
    srv.node_register(n)
    srv.node_heartbeat(n.id)
    srv.job_register(mock.job(id="ui-job"))
    srv.wait_for_evals(10)

    status, jobs = _get(agent, "/v1/jobs?namespace=*")
    assert status == 200 and jobs[0]["id"] == "ui-job"
    assert {"namespace", "type", "priority", "status"} <= jobs[0].keys()

    status, nodes = _get(agent, "/v1/nodes")
    assert status == 200
    assert {"id", "name", "datacenter", "status",
            "scheduling_eligibility"} <= nodes[0].keys()

    for ep in (
        "/v1/allocations?namespace=*",
        "/v1/evaluations",
        "/v1/services",
        "/v1/plugins",
        "/v1/operator/raft/configuration",
        "/v1/status/leader",
    ):
        status, _ = _get(agent, ep)
        assert status == 200, ep


# ---------------------------------------------------------------------------
# Browser exec + job submit (VERDICT r4 item 9)
# ---------------------------------------------------------------------------


class _WSClient:
    """Minimal RFC6455 client for the exec bridge test."""

    def __init__(self, host, port, path):
        import base64
        import os
        import socket

        self.sock = socket.create_connection((host, port), timeout=10)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode()
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake EOF")
            resp += chunk
        assert b"101" in resp.split(b"\r\n", 1)[0], resp
        self.buf = resp.split(b"\r\n\r\n", 1)[1]

    def _read(self, n):
        while len(self.buf) < n:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("ws EOF")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send_json(self, obj):
        import json as _json
        import os
        import struct

        payload = _json.dumps(obj).encode()
        mask = os.urandom(4)
        head = bytearray([0x81])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        else:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(bytes(head) + mask + masked)

    def recv_json(self, timeout_s=10):
        import json as _json
        import struct

        self.sock.settimeout(timeout_s)
        hdr = self._read(2)
        opcode = hdr[0] & 0x0F
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        data = self._read(n) if n else b""
        if opcode == 0x8:
            return None
        return _json.loads(data) if data else {}

    def close(self):
        self.sock.close()


@pytest.fixture
def full_agent(tmp_path):
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.data_dir = str(tmp_path / "agent")
    a = Agent(cfg)
    a.start()
    assert a.client.wait_registered(15)
    yield a
    a.shutdown()


def wait_until(fn, timeout_s=15.0, interval=0.05):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def test_browser_exec_into_live_alloc(full_agent):
    """The VERDICT item-9 done-criterion: exec a shell into a live alloc
    from the browser — here the browser half is a raw websocket client
    speaking the UI terminal's exact frame protocol."""
    import base64

    a = full_agent
    srv = a.server.server
    job = mock.job(id="ws-exec")
    tg = job.task_groups[0]
    tg.count = 1
    t = tg.tasks[0]
    t.driver = "rawexec"
    t.config = {"command": "/bin/sh", "args": ["-c", "sleep 300"]}
    srv.job_register(job)

    def running():
        return [
            x
            for x in srv.state.allocs_by_job("default", "ws-exec")
            if x.client_status == "running"
        ]

    assert wait_until(lambda: running(), 20)
    alloc = running()[0]
    ws = _WSClient(
        "127.0.0.1",
        a.http_addr[1],
        f"/v1/client/allocation/{alloc.id}/exec"
        f"?command=/bin/sh&task=web",
    )
    try:
        ws.send_json(
            {
                "stdin": base64.b64encode(
                    b"echo exec-roundtrip-$((40+2))\n"
                ).decode()
            }
        )
        got = b""
        for _ in range(40):
            msg = ws.recv_json(timeout_s=10)
            if msg is None:
                break
            if msg.get("stdout"):
                got += base64.b64decode(msg["stdout"])
            if b"exec-roundtrip-42" in got:
                break
        assert b"exec-roundtrip-42" in got, got
    finally:
        ws.close()
    srv.job_deregister("default", "ws-exec", purge=True)


def test_jobs_parse_and_submit_roundtrip(full_agent):
    """The UI's Run view path: POST /v1/jobs/parse (HCL -> job), plan it,
    then register the parsed job through PUT /v1/jobs."""
    import urllib.request

    a = full_agent
    base = f"http://127.0.0.1:{a.http_addr[1]}"

    def post(path, body, method="POST"):
        req = urllib.request.Request(
            base + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method=method,
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    src = '''
job "ui-submitted" {
  group "g" {
    count = 2
    task "t" { driver = "mock"
      config {} }
  }
}
'''
    parsed = post("/v1/jobs/parse", {"JobHCL": src})
    assert parsed["Job"]["id"] == "ui-submitted"
    plan = post(
        "/v1/job/ui-submitted/plan",
        {"Job": parsed["Job"], "Diff": True},
        method="PUT",
    )
    assert plan  # plan dry-run answered
    out = post("/v1/jobs", {"Job": parsed["Job"]}, method="PUT")
    # register replies with the eval id (string), as the SDK expects
    assert isinstance(out, str) and out
    srv = a.server.server
    assert wait_until(
        lambda: len(
            [
                x
                for x in srv.state.allocs_by_job("default", "ui-submitted")
                if x.client_status == "running"
            ]
        )
        == 2,
        20,
    ), "UI-submitted job must run"
    # bad HCL is a clean 400
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as e:
        post("/v1/jobs/parse", {"JobHCL": "job {{{{"})
    assert e.value.code == 400


def test_ui_deployment_and_node_action_contracts(full_agent):
    """The deployments view and node drain/eligibility buttons ride
    these exact payload shapes — raw JSON, no codec tagging (the
    browser can't build $t-tagged structs)."""
    import urllib.request

    a = full_agent
    base = f"http://127.0.0.1:{a.http_addr[1]}"

    def req(path, body=None, method="GET"):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(
            base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(r, timeout=10) as resp:
            return json.loads(resp.read() or b"null")

    deps = req("/v1/deployments")
    assert isinstance(deps, list)
    node_id = a.client.node.id
    # drain on with the PLAIN reference shape, then off
    req(f"/v1/node/{node_id}/drain", {"DrainSpec": {"Deadline": 3600e9}},
        "PUT")
    srv = a.server.server

    def drained():
        n = srv.state.node_by_id(node_id)
        return n.drain and n.scheduling_eligibility == "ineligible"

    assert wait_until(drained, 10)
    req(f"/v1/node/{node_id}/drain",
        {"DrainSpec": None, "MarkEligible": True}, "PUT")
    assert wait_until(
        lambda: not srv.state.node_by_id(node_id).drain, 10
    )
    # eligibility toggle
    req(f"/v1/node/{node_id}/eligibility",
        {"Eligibility": "ineligible"}, "PUT")
    assert (
        srv.state.node_by_id(node_id).scheduling_eligibility
        == "ineligible"
    )
    req(f"/v1/node/{node_id}/eligibility",
        {"Eligibility": "eligible"}, "PUT")
    assert (
        srv.state.node_by_id(node_id).scheduling_eligibility
        == "eligible"
    )
