"""``tests/test_agent_reload.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Agent reload (SIGHUP path): TLS cert rotation without dropping the
fabric, client meta re-registration under live traffic.

Reference: command/agent/agent.go Agent.Reload + command.go
handleSignals/handleReload (VERDICT r4 item 5).
"""

import subprocess
import time

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def make_cert(path, cn):
    cert, key = path / f"{cn}.pem", path / f"{cn}-key.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", str(key), "-out", str(cert), "-days", "1",
            "-nodes", "-subj", f"/CN={cn}",
        ],
        check=True,
        capture_output=True,
    )
    return str(cert), str(key)


@pytest.fixture
def agent(tmp_path):
    cert, key = make_cert(tmp_path, "gen1")
    cfg = AgentConfig(
        server_enabled=True,
        device="cpu",
        client_enabled=True,
        dev_mode=True,
        data_dir=str(tmp_path / "data"),
        tls_http=True,
        tls_rpc=True,
        tls_cert_file=cert,
        tls_key_file=key,
    )
    a = Agent(cfg)
    a.start()
    assert wait_until(lambda: a.server.is_leader(), 15)
    assert a.client.wait_registered(20)
    yield a, tmp_path
    a.shutdown()


def _https_cert_cn(addr):
    """Connect with verification off and return the served cert's CN."""
    import socket
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    with socket.create_connection(addr, timeout=5) as raw:
        with ctx.wrap_socket(raw) as s:
            der = s.getpeercert(binary_form=True)
    # avoid a full ASN.1 parser: the CN string is embedded verbatim
    for cn in (b"gen1", b"gen2"):
        if cn in der:
            return cn.decode()
    return "?"


def test_reload_rotates_tls_and_meta_under_live_traffic(agent):
    from nomad_tpu_torch import mock

    a, tmp_path = agent
    # live traffic: a running job placed BEFORE the reload
    job = mock.job(id="pre-reload")
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].config = {}
    job.datacenters = [a.client.node.datacenter]
    a.server.server.job_register(job)
    assert wait_until(
        lambda: any(
            x.client_status == "running"
            for x in a.server.server.state.allocs_by_job("default", job.id)
        ),
        20,
    )

    assert _https_cert_cn(a.http_addr) == "gen1"

    # rotate: new cert generation + new client meta in the "re-read" file
    cert2, key2 = make_cert(tmp_path, "gen2")
    new_cfg = AgentConfig(
        server_enabled=True,
        device="cpu",
        client_enabled=True,
        dev_mode=True,
        data_dir=a.config.data_dir,
        tls_http=True,
        tls_rpc=True,
        tls_cert_file=cert2,
        tls_key_file=key2,
        node_meta={"rack": "r2", "team": "core"},
    )
    changed = a.reload(new_cfg)
    assert "tls_rpc_material" in changed
    assert "tls_http_material" in changed
    assert "client_node_meta" in changed

    # new handshakes see the rotated cert, same listener, no restart
    assert _https_cert_cn(a.http_addr) == "gen2"

    # the client re-registered with the new meta
    assert wait_until(
        lambda: (
            a.server.server.state.node_by_id(a.client.node.id) is not None
            and a.server.server.state.node_by_id(
                a.client.node.id
            ).meta.get("rack")
            == "r2"
        ),
        10,
    ), "server must see the reloaded client meta"

    # the fabric never dropped: the pre-reload alloc is still running
    # and NEW work schedules over the (rotated) fabric
    job2 = mock.job(id="post-reload")
    job2.task_groups[0].count = 1
    job2.task_groups[0].tasks[0].config = {}
    job2.datacenters = [a.client.node.datacenter]
    a.server.server.job_register(job2)
    assert wait_until(
        lambda: any(
            x.client_status == "running"
            for x in a.server.server.state.allocs_by_job("default", job2.id)
        ),
        20,
    ), "scheduling must keep working across the TLS rotation"
    assert any(
        x.client_status == "running"
        for x in a.server.server.state.allocs_by_job("default", job.id)
    ), "pre-reload alloc must survive"


def test_reload_is_noop_without_changes(agent):
    a, _ = agent
    same = AgentConfig(
        server_enabled=True,
        device="cpu",
        client_enabled=True,
        dev_mode=True,
        data_dir=a.config.data_dir,
        tls_http=True,
        tls_rpc=True,
        tls_cert_file=a.config.tls_cert_file,
        tls_key_file=a.config.tls_key_file,
    )
    assert a.reload(same) == []
