"""``tests/test_cli.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

CLI tests against a live dev agent (reference: command/*_test.go
against TestAgent).
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import NomadClient
from nomad_tpu_torch.cli import main


def wait_until(fn, timeout_s=20.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


JOBFILE = """
job "cli-test" {
  datacenters = ["dc1"]
  group "g" {
    count = 2
    task "t" {
      driver = "mock"
    }
  }
}
"""


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.data_dir = str(tmp_path_factory.mktemp("cli-agent"))
    a = Agent(cfg)
    a.start()
    assert wait_until(lambda: a.server.is_leader(), 15)
    yield a
    a.shutdown()


@pytest.fixture
def addr(agent):
    host, port = agent.http_addr
    return f"http://{host}:{port}"


def run_cli(addr, *argv):
    return main(["-address", addr, *argv])


def test_version(capsys):
    assert main(["version"]) == 0
    assert "nomad-tpu" in capsys.readouterr().out


def test_job_run_status_stop(agent, addr, tmp_path, capsys):
    jobfile = tmp_path / "job.hcl"
    jobfile.write_text(JOBFILE)
    # plan on a new job: exit 1 (changes)
    assert run_cli(addr, "job", "plan", str(jobfile)) == 1
    out = capsys.readouterr().out
    assert "cli-test" in out and "create" in out

    assert run_cli(addr, "job", "run", str(jobfile)) == 0
    out = capsys.readouterr().out
    assert "registered" in out

    assert wait_until(
        lambda: all(
            a.client_status == "running"
            for a in NomadClient(addr).jobs.allocations("cli-test")
        )
        and len(NomadClient(addr).jobs.allocations("cli-test")) == 2
    )

    # plan now: no changes, exit 0
    assert run_cli(addr, "job", "plan", str(jobfile)) == 0

    assert run_cli(addr, "job", "status") == 0
    out = capsys.readouterr().out
    assert "cli-test" in out

    assert run_cli(addr, "job", "status", "cli-test") == 0
    out = capsys.readouterr().out
    assert "running" in out and "Allocations" in out

    assert run_cli(addr, "status") == 0
    capsys.readouterr()

    assert run_cli(addr, "job", "inspect", "cli-test") == 0
    out = capsys.readouterr().out
    assert '"cli-test"' in out

    assert run_cli(addr, "job", "history", "cli-test") == 0
    capsys.readouterr()

    # alloc + eval status via prefix
    api = NomadClient(addr)
    alloc = api.jobs.allocations("cli-test")[0]
    assert run_cli(addr, "alloc", "status", alloc.id[:8]) == 0
    out = capsys.readouterr().out
    assert alloc.id in out

    evs = api.jobs.evaluations("cli-test")
    assert run_cli(addr, "eval", "status", evs[0].id[:8]) == 0
    capsys.readouterr()
    assert run_cli(addr, "eval", "list") == 0
    capsys.readouterr()

    assert run_cli(addr, "job", "stop", "-purge", "cli-test") == 0
    capsys.readouterr()


def test_node_commands(agent, addr, capsys):
    assert run_cli(addr, "node", "status") == 0
    out = capsys.readouterr().out
    assert "ready" in out
    node_id = agent.client.node.id
    assert run_cli(addr, "node", "status", node_id[:8]) == 0
    out = capsys.readouterr().out
    assert node_id in out

    assert run_cli(addr, "node", "eligibility", node_id[:8], "-disable") == 0
    capsys.readouterr()
    assert wait_until(
        lambda: NomadClient(addr).nodes.get(node_id).scheduling_eligibility
        == "ineligible"
    )
    assert run_cli(addr, "node", "eligibility", node_id[:8], "-enable") == 0
    capsys.readouterr()


def test_server_members(agent, addr, capsys):
    assert run_cli(addr, "server", "members") == 0
    out = capsys.readouterr().out
    assert "alive" in out


def test_missing_job_errors(addr, capsys):
    assert run_cli(addr, "job", "status", "definitely-not-there") == 1
