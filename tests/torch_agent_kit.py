"""Agents of the port for the CPU tests (``device="cpu"``: the kernels'
plain twins).

``start_dev_agent`` starts what the reference's agent tests start: a dev
agent, a server with a client in one process, its client's node
registered and ready. ``start_server_agent`` starts a server agent and
registers mock nodes on its server, as an operator's nodes register over
the fabric. No client heartbeats them: the heartbeat wheel's TTL floor
is an hour, so the registered nodes stay ready.
"""

import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig

# no client heartbeats: a registered node keeps its TTL for an hour
TTL_FLOOR_S = 3600.0


def wait_until(fn, timeout_s=20.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def server_config(data_dir: str, **kw) -> AgentConfig:
    """An in-memory server agent's config, its schedulers on the CPU."""
    cfg = AgentConfig(server_enabled=True, dev_mode=True, device="cpu",
                      data_dir=data_dir, **kw)
    return cfg


def dev_config(data_dir: str, **kw) -> AgentConfig:
    """A dev agent's config (server and client, in-memory raft), its
    schedulers on the CPU."""
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.data_dir = data_dir
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def start_dev_agent(cfg: AgentConfig) -> Agent:
    """Start the agent and wait for its client's node to be ready on its
    server; the node is `agent.nodes[0]`."""
    agent = Agent(cfg)
    agent.start()
    assert agent.client.wait_registered(15)
    state = agent.server.server.state
    assert wait_until(lambda: getattr(
        state.node_by_id(agent.client.node.id), "status", "") == "ready", 15)
    agent.nodes = [agent.client.node]
    return agent


def start_server_agent(cfg: AgentConfig, nodes: int = 1) -> Agent:
    """Start the agent, wait for its leadership and register `nodes`
    mock nodes on its server; the nodes are `agent.nodes`."""
    agent = Agent(cfg)
    agent.server.server.heartbeaters.min_ttl_s = TTL_FLOOR_S
    agent.start()
    assert wait_until(lambda: agent.server.is_leader()
                      and agent.server.server._leader, 15)
    agent.nodes = []
    for _ in range(nodes):
        n = mock.node()
        agent.server.rpc_self("Node.register", {"node": n})
        agent.nodes.append(n)
    assert wait_until(lambda: len(agent.server.server.state.nodes())
                      >= nodes, 15)
    return agent
