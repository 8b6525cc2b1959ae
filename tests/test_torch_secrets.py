"""The secrets store and task tokens against the port.

The cases of ``tests/test_secrets.py`` (its VaultClient renewal loop,
template and Vault task e2e cases on the port's ``client/``), with
imports pointed at ``nomad_tpu_torch`` and the Server's scheduler
config written out (``backend="host"``,
``device="cpu"``). The assertions are the reference's.
Reference intent: nomad/vault.go (server-side token derivation),
rebuilt as a cluster-native subsystem.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import SecretEntry, Template


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def server():
    s = Server(num_workers=2, scheduler_config=SchedulerConfig(
        backend="host", device="cpu"))
    s.establish_leadership()
    yield s
    s.shutdown()


class TestSecretsStore:
    def test_crud(self, server):
        server.secret_upsert(
            SecretEntry(path="db/creds", items={"user": "u", "pass": "p"})
        )
        entry = server.state.secret_by_path("default", "db/creds")
        assert entry.items == {"user": "u", "pass": "p"}
        # update keeps create_index
        ci = entry.create_index
        server.secret_upsert(
            SecretEntry(path="db/creds", items={"user": "u2"})
        )
        entry = server.state.secret_by_path("default", "db/creds")
        assert entry.items == {"user": "u2"} and entry.create_index == ci
        server.secret_delete("default", "db/creds")
        assert server.state.secret_by_path("default", "db/creds") is None
        with pytest.raises(KeyError):
            server.secret_delete("default", "db/creds")

    def test_event_stream_never_sees_values(self, server):
        """Secret VALUES must never reach event subscribers — the
        secrets table is not topic-mapped (and the store publishes only
        redacted rows anyway), so nothing containing a value may arrive."""
        sub = server.event_broker.subscribe(topics={"*": ["*"]})
        try:
            server.secret_upsert(
                SecretEntry(path="api/key", items={"token": "hunter2"})
            )
            # flush: a job write that DOES produce events
            server.job_register(mock.job(id="after-secret"))
            deadline = time.monotonic() + 5
            seen = []
            while time.monotonic() < deadline:
                events = sub.next(timeout_s=0.5)
                if events:
                    seen.extend(events)
                    if any(e.type == "JobEvent" for e in events):
                        break
            assert seen, "the flush write should produce events"
            for e in seen:
                assert "hunter2" not in repr(e.payload), (
                    "secret value leaked into the event stream"
                )
        finally:
            sub.close()


class TestTokenLifecycle:
    def _running_alloc(self, server):
        n = mock.node()
        server.node_register(n)
        server.node_heartbeat(n.id)
        job = mock.job(id="vaulted")
        job.task_groups[0].tasks[0].vault = {"policies": ["db-read"]}
        server.job_register(job)
        assert wait_until(
            lambda: server.state.allocs_by_job("default", "vaulted"), 10
        )
        return server.state.allocs_by_job("default", "vaulted")[0]

    def test_derive_renew_revoke(self, server):
        alloc = self._running_alloc(server)
        out = server.derive_task_token(alloc.id, "web")
        assert out["ttl_s"] > 0
        token = server.state.acl_token_by_secret(out["secret_id"])
        assert token.policies == ["db-read"]
        assert token.expiration_time_ns > 0
        # renewal pushes expiry forward
        before = token.expiration_time_ns
        time.sleep(0.01)
        server.renew_task_token(out["accessor_id"])
        token = server.state.acl_token_by_accessor(out["accessor_id"])
        assert token.expiration_time_ns > before
        # revoke
        server.acl_token_delete([out["accessor_id"]])
        assert server.state.acl_token_by_secret(out["secret_id"]) is None

    def test_derive_unknown_task_fails(self, server):
        alloc = self._running_alloc(server)
        with pytest.raises(KeyError):
            server.derive_task_token(alloc.id, "nope")
        with pytest.raises(KeyError):
            server.derive_task_token("no-such-alloc", "web")

    def test_expired_token_rejected_and_gcd(self, server):
        from nomad_tpu_torch.server.core_sched import CoreScheduler

        alloc = self._running_alloc(server)
        out = server.derive_task_token(alloc.id, "web")
        # force-expire it
        token = server.state.acl_token_by_accessor(out["accessor_id"])
        import dataclasses

        expired = dataclasses.replace(token, expiration_time_ns=1)
        server.raft_apply("acl_token_upsert", [expired])
        with pytest.raises(PermissionError, match="expired"):
            server.resolve_token(out["secret_id"])
        n = CoreScheduler(server, server.state.snapshot()).token_gc()
        assert n == 1
        assert server.state.acl_token_by_secret(out["secret_id"]) is None

    def test_vaultclient_renewal_loop(self, server):
        """The client-side heap loop renews at half TTL."""
        from nomad_tpu_torch.client.vaultclient import VaultClient

        alloc = self._running_alloc(server)
        server.DERIVED_TOKEN_TTL_S = 0.4  # tiny TTL to see renewals

        class RPC:
            def derive_token(self, a, t):
                return server.derive_task_token(a, t)

            def renew_token(self, acc):
                return server.renew_task_token(acc)

            def revoke_token(self, acc):
                server.acl_token_delete([acc])

        vc = VaultClient(RPC())
        vc.start()
        try:
            out = vc.derive_token(alloc.id, "web")
            acc = out["accessor_id"]
            exp0 = server.state.acl_token_by_accessor(acc).expiration_time_ns
            assert wait_until(
                lambda: server.state.acl_token_by_accessor(
                    acc
                ).expiration_time_ns > exp0,
                5,
            ), "renewal loop should extend the TTL"
            vc.stop_renew(acc, revoke=True)
            assert server.state.acl_token_by_accessor(acc) is None
            assert vc.tracked() == 0
        finally:
            vc.stop()


def test_vault_policy_allowlist(server):
    """Operator allowlist rejects escalation via jobspec vault policies
    (reference: vault allowed_policies validation)."""
    server.vault_allowed_policies = ["app-read"]
    ok = mock.job(id="allowed")
    ok.task_groups[0].tasks[0].vault = {"policies": ["app-read"]}
    server.job_register(ok)  # fine
    bad = mock.job(id="escalator")
    bad.task_groups[0].tasks[0].vault = {"policies": ["ops-admin"]}
    with pytest.raises(PermissionError, match="ops-admin"):
        server.job_register(bad)


def test_vault_allowlist_at_admission_and_mint():
    """With an operator allowlist, a job asking for a policy outside it
    is refused at register and nothing is stored; a job inside it is
    admitted, and its task token carries exactly its policies."""
    s = Server(num_workers=2, scheduler_config=SchedulerConfig(
        backend="host", device="cpu"))
    s.vault_allowed_policies = ["db-read"]
    s.establish_leadership()
    try:
        n = mock.node()
        s.node_register(n)
        bad = mock.job(id="too-much")
        bad.task_groups[0].tasks[0].vault = {"policies": ["root"]}
        before = s.state.latest_index()
        with pytest.raises(PermissionError, match="allowlist"):
            s.job_register(bad)
        assert s.state.latest_index() == before
        assert s.state.job_by_id("default", "too-much") is None
        good = mock.job(id="vaulted")
        good.task_groups[0].tasks[0].vault = {"policies": ["db-read"]}
        s.job_register(good)
        assert wait_until(
            lambda: s.state.allocs_by_job("default", "vaulted"), 10)
        alloc = s.state.allocs_by_job("default", "vaulted")[0]
        out = s.derive_task_token(alloc.id, "web")
        token = s.state.acl_token_by_secret(out["secret_id"])
        assert token.policies == ["db-read"]
        assert s.renew_task_token(out["accessor_id"]) == out["ttl_s"]
    finally:
        s.shutdown()


def test_template_secret_function(tmp_path):
    entry = SecretEntry(path="db/creds", items={"pass": "s3cr3t", "user": "app"})

    tmpl = Template(
        embedded_tmpl='password={{ secret "db/creds:pass" }}',
        dest_path="local/db.conf",
    )
    from nomad_tpu_torch.client.template import compute_template

    _, content = compute_template(
        tmpl, str(tmp_path), {}, secret_fn=lambda p: entry if p == "db/creds" else None
    )
    assert content == "password=s3cr3t"
    # whole-document form
    tmpl2 = Template(
        embedded_tmpl='{{ secret "db/creds" }}', dest_path="local/all.env"
    )
    _, content = compute_template(
        tmpl2, str(tmp_path), {}, secret_fn=lambda p: entry
    )
    assert content == "pass=s3cr3t\nuser=app"
    # missing secret renders empty, not an error
    _, content = compute_template(
        tmpl, str(tmp_path), {}, secret_fn=lambda p: None
    )
    assert content == "password="


def test_vault_task_e2e(tmp_path, monkeypatch):
    """Full stack: a task with a vault stanza gets a token file in its
    secrets dir, VAULT_TOKEN in env, templates can read the store, and
    the token is revoked when the task stops."""
    from nomad_tpu_torch.client import Client, ServerRPC

    server = Server(num_workers=2, scheduler_config=SchedulerConfig(backend="host", device="cpu"))
    server.establish_leadership()
    client = None
    try:
        server.secret_upsert(
            SecretEntry(path="app/cfg", items={"greeting": "hello"})
        )
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        assert client.wait_registered(10)

        job = mock.job(id="vault-e2e")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "mock"
        task.config = {}
        task.vault = {"policies": ["app-read"], "env": True}
        task.templates = [
            Template(
                embedded_tmpl='greet={{ secret "app/cfg:greeting" }}',
                dest_path="local/app.conf",
                change_mode="noop",
            )
        ]
        server.job_register(job)

        def running():
            return [
                a
                for a in server.state.allocs_by_job("default", "vault-e2e")
                if a.client_status == "running"
            ]

        assert wait_until(lambda: running(), 15)
        alloc = running()[0]
        runner = client.alloc_runners[alloc.id]
        task_dir = os.path.join(runner.alloc_dir, task.name)
        token_file = os.path.join(task_dir, "secrets", "vault_token")
        assert wait_until(lambda: os.path.exists(token_file), 5)
        secret_id = open(token_file).read()
        token = server.state.acl_token_by_secret(secret_id)
        assert token is not None and token.policies == ["app-read"]
        rendered = os.path.join(task_dir, "local", "app.conf")
        assert wait_until(lambda: os.path.exists(rendered), 5)
        assert open(rendered).read() == "greet=hello"
        # stop the job: token revoked
        server.job_deregister("default", "vault-e2e", purge=False)
        assert wait_until(
            lambda: server.state.acl_token_by_secret(secret_id) is None, 15
        ), "derived token must be revoked when the task dies"
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()
