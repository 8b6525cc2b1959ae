"""``tests/test_ui.py`` against the port.

The reference's web UI cases, with its assertions, on the port's server
agent (``device="cpu"``). Its ``full_agent`` is a dev agent; here it is a
server agent with one mock node registered on its server
(``tests/torch_agent_kit.py``), and the cases read that node where the
reference read ``agent.client.node``.

Waiting for the client agent (ROADMAP A12 part 8):
``test_browser_exec_into_live_alloc`` execs a shell into an alloc a
client runs. ``test_jobs_parse_and_submit_roundtrip`` waits here for
its two allocs to be placed, where the reference waits for a client to
report them ``running``.
"""

import json
import urllib.request

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig

from torch_agent_kit import server_config, start_server_agent


@pytest.fixture
def agent(tmp_path):
    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
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


@pytest.fixture
def full_agent(tmp_path):
    a = start_server_agent(server_config(str(tmp_path / "agent")))
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
                if x.desired_status == "run"
            ]
        )
        == 2,
        20,
    ), "UI-submitted job must be placed"
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
    node_id = a.nodes[0].id
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
