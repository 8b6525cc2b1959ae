"""The secrets store and task tokens against the port.

The cases of ``tests/test_secrets.py`` that need no client (its
VaultClient renewal loop, template and Vault task e2e cases wait for
``client/``), with imports pointed at ``nomad_tpu_torch`` and the
Server's scheduler config written out (``backend="host"``,
``device="cpu"``). The assertions are the reference's.
Reference intent: nomad/vault.go (server-side token derivation),
rebuilt as a cluster-native subsystem.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import SecretEntry


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
