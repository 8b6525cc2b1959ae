"""``tests/test_keyring.py``'s ``TestAgentReloadKeyring`` and
``TestOperatorSurfaces`` against the port (its keyring units and fabric
cases are in ``tests/test_torch_rpc.py``), with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, every agent on
``device="cpu"``.

The reference's docstring: dual-accept keyring on the RPC fabric
(rpc/keyring.py): rotation windows, the ConnPool dial-time secret read
+ auth-failure recovery, Agent.reload keyring transitions (the SIGHUP
push), and the operator surfaces (/v1/agent/keyring, `operator keyring
status|rotate`).
"""

import time

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.rpc import AuthFailedError, ConnPool

# every agent's schedulers on the CPU
DEVICE = "cpu"


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# Agent.reload keyring transitions (the SIGHUP path)
# ---------------------------------------------------------------------------


def _agent_cfg(tmp_path, secret, window_s=5.0, **kw):
    return AgentConfig(
        server_enabled=True,
        dev_mode=True,
        data_dir=str(tmp_path / "data"),
        rpc_secret=secret,
        rpc_secret_window_s=window_s,
        device=DEVICE,
        **kw,
    )


@pytest.fixture
def secret_agent(tmp_path):
    a = Agent(_agent_cfg(tmp_path, "gen1-secret"))
    a.start()
    assert wait_until(lambda: a.server.is_leader(), 15)
    yield a, tmp_path
    a.shutdown()


class TestAgentReloadKeyring:
    def test_rotate_then_idempotent_resighup(self, secret_agent):
        a, tmp_path = secret_agent
        changed = a.reload(_agent_cfg(tmp_path, "gen2-secret"))
        assert "rpc_secret" in changed
        assert a.keyring.current == "gen2-secret"
        assert a.keyring.status()["dual_accept"]
        # the same config re-applied (a second SIGHUP) is a no-op: no
        # new window, no reported change
        gen = a.keyring.generation
        assert a.reload(_agent_cfg(tmp_path, "gen2-secret")) == []
        assert a.keyring.generation == gen

    def test_rotate_back_within_window(self, secret_agent):
        a, tmp_path = secret_agent
        a.reload(_agent_cfg(tmp_path, "gen2-secret"))
        changed = a.reload(_agent_cfg(tmp_path, "gen1-secret"))
        assert "rpc_secret" in changed
        assert a.keyring.current == "gen1-secret"
        # the aborted secret still drains through its window
        assert a.keyring.accepts(b"gen2-secret")

    def test_window_expiry_rejects_old_secret_on_fabric(self, secret_agent):
        a, tmp_path = secret_agent
        a.reload(
            _agent_cfg(tmp_path, "gen2-secret", window_s=0.2)
        )
        addr = tuple(a.server.rpc.addr)
        pool = ConnPool(secret="gen1-secret")
        try:
            assert pool.call(addr, "Status.ping", {}) == "pong"
        finally:
            pool.shutdown()
        time.sleep(0.4)
        pool = ConnPool(secret="gen1-secret")
        try:
            with pytest.raises(AuthFailedError):
                pool.call(addr, "Status.ping", {}, timeout_s=10)
        finally:
            pool.shutdown()
        pool = ConnPool(secret="gen2-secret")
        try:
            assert pool.call(addr, "Status.ping", {}) == "pong"
        finally:
            pool.shutdown()

    def test_reload_refuses_secret_removal(self, secret_agent):
        a, tmp_path = secret_agent
        with pytest.raises(ValueError):
            a.reload(_agent_cfg(tmp_path, ""))
        assert a.keyring.current == "gen1-secret"

    def test_window_width_reload_applies_to_next_rotation(self, secret_agent):
        a, tmp_path = secret_agent
        a.reload(_agent_cfg(tmp_path, "gen1-secret", window_s=0.05))
        assert a.keyring.window_s == 0.05
        a.reload(_agent_cfg(tmp_path, "gen2-secret", window_s=0.05))
        time.sleep(0.1)
        assert not a.keyring.accepts(b"gen1-secret")

    def test_server_and_client_share_the_agent_keyring(self, tmp_path):
        cfg = _agent_cfg(tmp_path, "shared-secret", client_enabled=True)
        a = Agent(cfg)
        try:
            assert a.server.keyring is a.keyring
            assert a.client.keyring is a.keyring
            assert a.server.pool.keyring is a.keyring
            assert a.server.rpc.keyring is a.keyring
            assert a.client.endpoints.rpc.keyring is a.keyring
        finally:
            a.shutdown()


# ---------------------------------------------------------------------------
# Operator surfaces: /v1/agent/self + /v1/agent/keyring + CLI
# ---------------------------------------------------------------------------


class TestOperatorSurfaces:
    def test_agent_self_and_keyring_route(self, secret_agent):
        from nomad_tpu_torch.api.client import NomadClient

        a, _ = secret_agent
        api = NomadClient(f"http://127.0.0.1:{a.http_addr[1]}")
        info = api.agent.self()
        assert info["keyring"]["enabled"] is True
        assert info["keyring"]["generation"] == 0
        st = api.agent.keyring_status()
        assert st == info["keyring"] or st["enabled"]
        assert "gen1-secret" not in str(st)

    def test_http_rotate_then_status(self, secret_agent):
        from nomad_tpu_torch.api.client import NomadClient

        a, _ = secret_agent
        api = NomadClient(f"http://127.0.0.1:{a.http_addr[1]}")
        out = api.agent.keyring_rotate("gen2-secret", window_s=30)
        assert out["rotated"] is True
        assert out["dual_accept"] is True
        assert out["persisted"] is False  # process state only
        assert a.keyring.current == "gen2-secret"
        # the in-memory config moved with it, so a later SIGHUP diffs
        # against the LIVE secret (the config FILE stays the operator's
        # problem — runbook: persist it or the next restart reverts)
        assert a.config.rpc_secret == "gen2-secret"
        # idempotent re-post
        out = api.agent.keyring_rotate("gen2-secret")
        assert out["rotated"] is False

    def test_cli_keyring_status_and_rotate(self, secret_agent, capsys):
        from nomad_tpu_torch.cli.main import main

        a, _ = secret_agent
        addr = f"http://127.0.0.1:{a.http_addr[1]}"
        assert main(["-address", addr, "operator", "keyring", "status"]) == 0
        out = capsys.readouterr().out
        assert "Generation" in out and "Dual-Accept" in out
        assert "gen1-secret" not in out
        assert (
            main([
                "-address", addr, "operator", "keyring", "rotate",
                "-secret", "gen2-secret", "-window", "45s",
            ])
            == 0
        )
        out = capsys.readouterr().out
        assert "Keyring rotated!" in out
        assert a.keyring.current == "gen2-secret"
        assert a.keyring.previous_active() == "gen1-secret"

    def test_keyring_rotate_requires_agent_write_acl(self, tmp_path):
        """ACL battery: anon 401; node-scoped token 403; management
        200 — keyring rotation is agent:write like pprof/join."""
        from nomad_tpu_torch.api.client import APIError, NomadClient

        cfg = _agent_cfg(tmp_path, "acl-secret", acl_enabled=True)
        a = Agent(cfg)
        a.start()
        try:
            assert wait_until(lambda: a.server.is_leader(), 15)
            base = f"http://127.0.0.1:{a.http_addr[1]}"
            boot = NomadClient(base).acl.bootstrap()
            mgmt = NomadClient(base, token=boot.secret_id)
            with pytest.raises(APIError) as e:
                NomadClient(base).agent.keyring_rotate("x-secret")
            assert e.value.status == 401
            mgmt.acl.policy_apply(
                "ns-only", 'namespace "default" { policy = "read" }'
            )
            ns_tok = mgmt.acl.token_create(
                name="t", policies=["ns-only"]
            )
            limited = NomadClient(base, token=ns_tok.secret_id)
            with pytest.raises(APIError) as e:
                limited.agent.keyring_rotate("x-secret")
            assert e.value.status == 403
            # status needs agent:read — the limited token lacks it too
            with pytest.raises(APIError):
                limited.agent.keyring_status()
            out = mgmt.agent.keyring_rotate("x2-secret")
            assert out["rotated"] is True
        finally:
            a.shutdown()
