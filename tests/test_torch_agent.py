"""The port's server agent, held to nomad_tpu's on the CPU.

``agent_lockstep`` (chip_smoke.py; its ``small`` phase runs it on the
card and on the CPU twins) on both packages' agents: a server agent with
the batch worker in batches of 8 and every solve on the batch solver
(nomad_tpu's with ``backend="tpu"`` on conftest's CPU devices, the
port's with ``device="cpu"``), 200 nodes built with nomad_tpu's mocks
registered over each agent's RPC fabric (the port's carried over the
wire), and six jobs of 50 written as HCL and submitted through each
package's CLI ``job run``, each eval complete before the next.
Placements by (job, alloc name, node), eval outcomes and the bodies of
a fixed list of HTTP reads (minted ids named by what they name, raft
indexes and times dropped) must be equal. Tolerance: exact.

Then the client agent (``client_enabled``, ``agent -dev``, ``agent
-client``) running an alloc and joining a server, and what the port's
agent refuses until its missing parts come: ``operator vet`` (ROADMAP
A12 part 9), and a "cuda" agent with no card. Last, the solver observatory's compile ledger (``record_call``,
``compiles``, ``steady_recompiles``) against nomad_tpu's on one call
sequence, and ``/v1/solver/status`` with the port's built variants under
the reference's ``jit_cache_sizes`` key.
"""

import functools

import pytest

from nomad_tpu import codec as jcodec

from nomad_tpu_torch.codec import from_wire

from torch_agent_kit import server_config, start_server_agent


def _chip_smoke():
    import importlib.util
    import pathlib
    import sys

    if "chip_smoke" in sys.modules:
        return sys.modules["chip_smoke"]
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _ref_fleet(n_nodes):
    """chip_smoke.c2m_nodes' fleet, built with nomad_tpu's mocks."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs.node_class import compute_node_class

    cs = _chip_smoke()
    nodes = []
    for i in range(n_nodes):
        n = jmock.node()
        n.datacenter = cs.DCS[i % 4]
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.computed_class = compute_node_class(n)
        nodes.append(n)
    return nodes


def _boot_ref(data_dir):
    from nomad_tpu.agent import Agent, AgentConfig
    from nomad_tpu.rpc import ConnPool

    cs = _chip_smoke()
    agent = Agent(AgentConfig(server_enabled=True, use_tpu_batch_worker=True,
                              data_dir=data_dir, node_name="agent-0"))
    cs.cluster_tune(agent.server)
    agent.start()
    cs.cluster_wait(lambda: agent.server.is_leader()
                    and agent.server.server._leader,
                    "reference agent: no established leader", 120)
    return agent, ConnPool()


def test_agent_lockstep_matches_nomad_tpu(monkeypatch):
    import nomad_tpu.server.cluster as jcluster
    from nomad_tpu.cli.main import main as jmain
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig

    from nomad_tpu_torch.cli.main import main as tmain
    from nomad_tpu_torch.rpc import ConnPool

    cs = _chip_smoke()
    nodes = _ref_fleet(cs.AGENT_SMALL["nodes"])
    # nomad_tpu's ClusterServer builds its Server with the default
    # config; hand it the batch solver's, as its Server accepts
    monkeypatch.setattr(jcluster, "Server", functools.partial(
        jcluster.Server,
        scheduler_config=JConfig(backend="tpu", small_batch_threshold=0)))

    def tboot(data_dir):
        return cs.start_agent("cpu", data_dir, every_solve=True), ConnPool()

    jout = cs.agent_lockstep(_boot_ref, jmain, nodes)
    tout = cs.agent_lockstep(
        tboot, tmain, [from_wire(jcodec.to_wire(n)) for n in nodes])
    assert sorted(tout) == sorted(jout)
    for key in ("allocs", "placed", "evals", "versions"):
        assert tout[key] == jout[key], key
    assert sorted(tout["reads"]) == sorted(jout["reads"])
    for path in jout["reads"]:
        assert tout["reads"][path] == jout["reads"][path], path
    cfg = cs.AGENT_SMALL
    assert len(tout["allocs"]) == cfg["jobs"] * cfg["count"]
    assert all(e[2] == "complete" for e in tout["evals"])
    allocs_read = tout["reads"]["/v1/allocations"]
    assert len(allocs_read) == cfg["jobs"] * cfg["count"]
    assert {a["id"] for a in allocs_read} == {
        f"alloc:{job}/{name}" for job, name, _ in tout["allocs"]}


def _mock_job(datacenter, count=1):
    from nomad_tpu_torch import mock

    job = mock.job()
    job.datacenters = [datacenter]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].driver = "mock"
    tg.tasks[0].config = {"run_for": "60s"}
    return job


def test_client_enabled_raises_naming_part_8(tmp_path):
    """A dev agent's client (``AgentConfig.dev()``, the server on the
    CPU) registers its node, fingerprints its drivers and runs an alloc
    the server places on it; ``client_enabled`` without servers is the
    refusal left. (The name is the case's from before the client was
    ported, when this config raised.)"""
    from nomad_tpu_torch.agent import Agent, AgentConfig

    from torch_agent_kit import wait_until

    with pytest.raises(ValueError, match="servers"):
        Agent(AgentConfig(client_enabled=True, device="cpu",
                          data_dir=str(tmp_path / "lone")))
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path / "dev")
    agent = Agent(cfg)
    agent.start()
    try:
        assert agent.client.wait_registered(15)
        state = agent.server.server.state
        node = state.node_by_id(agent.client.node.id)
        assert node.status == "ready"
        assert {"driver.mock", "driver.rawexec"} <= set(node.attributes)
        job = _mock_job(node.datacenter)
        agent.server.rpc_self("Job.register", {"job": job})
        assert wait_until(lambda: [
            a for a in state.allocs_by_job(job.namespace, job.id)
            if a.client_status == "running"
            and a.node_id == node.id], 20)
    finally:
        agent.shutdown()


def _cli_agent(args, cwd):
    """Start ``python -m nomad_tpu_torch.cli agent <args>`` and return
    the process once it has printed its start line."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=cwd, env=env)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "Agent started" in line:
            return proc, lines
    proc.wait(10)
    raise AssertionError("agent exited before starting:\n" + "".join(lines))


def _stop_cli_agent(proc):
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0


@pytest.mark.parametrize("flag", ["-dev", "-client"])
def test_cli_agent_without_client_fails_naming_part_8(flag, tmp_path,
                                                       capsys):
    """``agent -dev`` runs a server with a client whose node goes ready
    and runs an alloc; ``agent -client -servers`` joins a server agent
    and its node goes ready there. Both read ``device = "cpu"`` from a
    config file and stop cleanly on SIGTERM. (The name is the case's
    from before the client was ported, when both flags failed.)"""
    import pathlib

    from nomad_tpu_torch.api import NomadClient

    from torch_agent_kit import wait_until

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    conf = tmp_path / "agent.hcl"
    conf.write_text('device = "cpu"\n')
    common = ["-config", str(conf), "-data-dir", str(tmp_path / "data"),
              "-http-port", "0", "-rpc-port", "0"]
    if flag == "-dev":
        proc, lines = _cli_agent(["-dev", *common], repo)
        try:
            url = next(l.split("HTTP API: ")[1].strip() for l in lines
                       if "HTTP API: " in l)
            api = NomadClient(url)
            assert wait_until(lambda: [
                n for n in api.nodes.list() if n.status == "ready"], 20)
            node = api.nodes.list()[0]
            job = _mock_job(node.datacenter)
            api.jobs.register(job)
            assert wait_until(lambda: [
                a for a in api.jobs.allocations(job.id)
                if a.client_status == "running"], 20)
        finally:
            _stop_cli_agent(proc)
        return
    server = start_server_agent(
        server_config(str(tmp_path / "server")), nodes=0)
    try:
        host, port = server.server.addr
        proc, _ = _cli_agent(
            ["-client", "-servers", f"{host}:{port}", *common], repo)
        try:
            state = server.server.server.state
            assert wait_until(lambda: [
                n for n in state.nodes() if n.status == "ready"], 20)
        finally:
            _stop_cli_agent(proc)
    finally:
        server.shutdown()


def test_operator_vet_exits_2_naming_part_9(capsys):
    from nomad_tpu_torch.cli import main

    assert main(["operator", "vet"]) == 2
    err = capsys.readouterr().err
    assert "A12 part 9" in err


def test_agent_config_file_names_the_device(tmp_path):
    from nomad_tpu_torch.agent import AgentConfig
    from nomad_tpu_torch.cli.main import _load_agent_config

    assert AgentConfig().device == "cuda"
    hcl = tmp_path / "agent.hcl"
    hcl.write_text('device = "cpu"\nserver {\n  enabled = true\n}\n')
    assert _load_agent_config(str(hcl)).device == "cpu"
    js = tmp_path / "agent.json"
    js.write_text('{"device": "cpu", "server": {"enabled": true}}')
    assert _load_agent_config(str(js)).device == "cpu"


def test_cuda_agent_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    from nomad_tpu_torch.agent import Agent, AgentConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AgentConfig(server_enabled=True, dev_mode=True,
                      data_dir=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(cfg)


# (kernel, padded-shape signature) calls: two buckets warm, repeats, then
# a third bucket after the repeats (a steady recompile)
LEDGER_CALLS = [("k1", (256, 16)), ("k1", (512, 16)), ("k1", (256, 16)),
                ("k1", (256, 16)), ("k2", (256,)), ("k1", (1024, 16)),
                ("k2", (256,))]


def test_compile_ledger_matches_nomad_tpu():
    from nomad_tpu import solverobs as jobs_

    from nomad_tpu_torch import solverobs as tobs

    outs = []
    for mod in (jobs_, tobs):
        old = mod._install(mod.SolverObservatory())
        try:
            new = [mod.record_call(k, sig, 1000 * (i + 1))
                   for i, (k, sig) in enumerate(LEDGER_CALLS)]
            snap = mod.snapshot(sample=False)["ledger"]
            outs.append((new, mod.compiles(), mod.compiles("k1"),
                         mod.steady_recompiles(),
                         {k: snap[k] for k in ("compiles", "cache_hits",
                                               "steady_recompiles")},
                         {name: {f: kl[f] for f in (
                             "compiles", "cache_hits", "steady_recompiles",
                             "first_compile_ms", "steady_compile_ms",
                             "signatures")}
                          for name, kl in snap["kernels"].items()}))
        finally:
            mod._install(old)
    assert outs[1] == outs[0]
    assert outs[1][3] == 1


def test_solver_status_serves_built_variants(tmp_path):
    from nomad_tpu_torch.api import NomadClient
    from nomad_tpu_torch.scheduler.gpu import kernels

    agent = start_server_agent(server_config(str(tmp_path)), nodes=0)
    try:
        api = NomadClient("http://{}:{}".format(*agent.http_addr))
        snap = api.agent.solver_status()
        assert snap["jit_cache_sizes"] == kernels.built_variants()
        assert {"library", "solve_placement_compact",
                "sharded_solver_preempt_graphs"} <= set(
                    snap["jit_cache_sizes"])
        assert snap["ledger"]["compiles"] == snap["ledger"]["new_shapes"]
        assert snap["worker"] is None
    finally:
        agent.shutdown()
