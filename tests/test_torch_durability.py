"""Server durability: on-disk raft log/stable-store/snapshots survive a
full-cluster restart, and operator snapshot save/restore.

The cases of ``tests/test_durability.py`` against the port, imports
changed only and the reference's assertions unchanged; every server
states its scheduler config (the reference's default, ``backend="host"``,
on ``device="cpu"``); ``test_snapshot_save_restore_http`` drives the
port's server agent and its HTTP API (the reference's dev agent runs a
client too, which the case does not use). ``tests/test_torch_cluster.py``
holds the same save/restore round trip through a ClusterServer's
``Operator`` endpoints.

Reference analogs: hashicorp/raft-boltdb semantics (§5.1 persistent
state), nomad/fsm.go:1367 Snapshot / :1381 Restore, helper/snapshot/,
command/operator_snapshot_{save,restore}.go.
"""

import socket
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import ConnPool
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.cluster import ClusterServer
from nomad_tpu_torch.server.raft_replication import LogEntry
from nomad_tpu_torch.server.raft_store import RaftLogStore
from nomad_tpu_torch.testing import wait_for_state


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler config, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=45.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestRaftLogStore:
    def test_log_roundtrip(self, tmp_path):
        from nomad_tpu_torch import codec

        store = RaftLogStore(str(tmp_path / "raft.db"))
        job = mock.job()
        store.append(
            [
                LogEntry(1, 1, "noop", codec.pack(None)),
                LogEntry(2, 1, "job_register", codec.pack((job, None))),
            ]
        )
        store.close()

        store2 = RaftLogStore(str(tmp_path / "raft.db"))
        log = store2.load_log()
        assert [e.index for e in log] == [1, 2]
        assert codec.unpack(log[1].payload)[0].id == job.id
        store2.close()

    def test_stable_state(self, tmp_path):
        store = RaftLogStore(str(tmp_path / "raft.db"))
        assert store.get_state() == (0, None)
        store.set_state(7, "node-a")
        store.close()
        store2 = RaftLogStore(str(tmp_path / "raft.db"))
        assert store2.get_state() == (7, "node-a")
        store2.close()

    def test_truncate_and_compact(self, tmp_path):
        store = RaftLogStore(str(tmp_path / "raft.db"))
        store.append([LogEntry(i, 1, "noop", None) for i in range(1, 11)])
        store.truncate_from(8)
        assert [e.index for e in store.load_log()] == list(range(1, 8))
        store.compact_to(3)
        assert [e.index for e in store.load_log()] == [4, 5, 6, 7]
        store.close()

    def test_snapshot_roundtrip_compacts_log(self, tmp_path):
        store = RaftLogStore(str(tmp_path / "raft.db"))
        store.append([LogEntry(i, 2, "noop", None) for i in range(1, 6)])
        store.store_snapshot(b"snap-bytes", 3, 2)
        assert store.load_snapshot() == (b"snap-bytes", 3, 2)
        assert [e.index for e in store.load_log()] == [4, 5]
        store.close()


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _boot_cluster(tmp_path, ports):
    ids = [f"s{i}" for i in range(len(ports))]
    addrs = {nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(ids)}
    servers = {}
    for nid in ids:
        servers[nid] = ClusterServer(
            nid,
            peers={p: a for p, a in addrs.items() if p != nid},
            port=addrs[nid][1],
            num_workers=1,
            data_dir=str(tmp_path / nid),
            scheduler_config=cpu_config(),
        )
    for s in servers.values():
        s.start()
    return servers


def _leader(servers):
    return next((s for s in servers.values() if s.is_leader()), None)


class TestClusterRestart:
    def test_full_cluster_restart_preserves_state(self, tmp_path):
        """Kill all three servers; restart from disk; jobs, node, and
        allocs are intact."""
        ports = _free_ports(3)
        servers = _boot_cluster(tmp_path, ports)
        pool = ConnPool()
        try:
            assert wait_until(lambda: _leader(servers) is not None)
            leader = _leader(servers)

            node = mock.node()
            pool.call(leader.addr, "Node.register", {"node": node})
            job = mock.job()
            job.task_groups[0].count = 3
            pool.call(leader.addr, "Job.register", {"job": job})

            # event-driven (alloc upserts replicate to every server's
            # store, each publishing to its event broker): re-check on
            # each event instead of burning a core on a 50ms
            # sleep-poll under full-suite load
            def placed():
                lead = _leader(servers)
                return bool(lead) and len(
                    lead.server.state.allocs_by_job(job.namespace, job.id)
                ) == 3

            assert wait_for_state(
                servers.values(), placed, timeout_s=45
            ), "allocs never placed"
        finally:
            pool.shutdown()
            # hard stop: no graceful dance, mimic kill -9 as closely as
            # an in-process harness can (threads die with the sockets)
            for s in servers.values():
                s.shutdown()

        # full restart from disk
        servers2 = _boot_cluster(tmp_path, ports)
        try:
            assert wait_until(
                lambda: _leader(servers2) is not None, 30
            ), "restarted cluster never elected a leader"
            # every server recovered the job, node, and allocs
            def recovered():
                for s in servers2.values():
                    st = s.server.state
                    if st.job_by_id(job.namespace, job.id) is None:
                        return False
                    if st.node_by_id(node.id) is None:
                        return False
                    if len(st.allocs_by_job(job.namespace, job.id)) != 3:
                        return False
                return True

            # log replay publishes store events as it applies; the
            # helper's periodic fallback covers replays that finished
            # before the subscription opened
            assert wait_for_state(
                servers2.values(), recovered, timeout_s=45
            ), "state not recovered from disk"
        finally:
            for s in servers2.values():
                s.shutdown()

    def test_restart_preserves_term_and_vote(self, tmp_path):
        """§5.1: a rebooted node must remember its term + vote."""
        ports = _free_ports(1)
        servers = _boot_cluster(tmp_path, ports[:1])
        try:
            s0 = servers["s0"]
            assert wait_until(lambda: s0.is_leader())
            term_before = s0.raft.current_term
            assert term_before >= 1
        finally:
            for s in servers.values():
                s.shutdown()
        servers2 = _boot_cluster(tmp_path, ports[:1])
        try:
            s0 = servers2["s0"]
            assert s0.raft.current_term >= term_before
        finally:
            for s in servers2.values():
                s.shutdown()


class TestOperatorSnapshot:
    def test_snapshot_save_restore_http(self, tmp_path):
        """operator snapshot save → register extra job → restore: the
        extra job is gone, original intact."""
        from nomad_tpu_torch.agent import Agent, AgentConfig
        from nomad_tpu_torch.api import NomadClient

        cfg = AgentConfig.dev()
        cfg.device = "cpu"
        cfg.data_dir = str(tmp_path / "agent")
        agent = Agent(cfg)
        agent.start()
        try:
            host, port = agent.http_addr
            api = NomadClient(f"http://{host}:{port}")
            job1 = mock.job()
            job1.id = "keep-me"
            api.jobs.register(job1)
            assert wait_until(
                lambda: api.jobs.get("keep-me") is not None
            )

            snap = api.operator.snapshot_save()
            assert len(snap) > 0

            job2 = mock.job()
            job2.id = "drop-me"
            api.jobs.register(job2)
            assert wait_until(lambda: api.jobs.get("drop-me") is not None)

            api.operator.snapshot_restore(snap)
            assert wait_until(
                lambda: not any(
                    j.id == "drop-me" for j in api.jobs.list()
                )
            ), "restored state still has the post-snapshot job"
            assert any(j.id == "keep-me" for j in api.jobs.list())

            peers = api.operator.raft_configuration()
            assert len(peers) == 1 and peers[0]["leader"]
        finally:
            agent.shutdown()


class TestStoreExclusivity:
    def test_second_open_fails_fast(self, tmp_path):
        """Two agents sharing a data_dir must not silently corrupt each
        other's raft state (raft-boltdb file-lock behavior)."""
        store = RaftLogStore(str(tmp_path / "raft.db"))
        with pytest.raises(RuntimeError, match="locked"):
            RaftLogStore(str(tmp_path / "raft.db"))
        store.close()
        # released on close: reopen succeeds
        store2 = RaftLogStore(str(tmp_path / "raft.db"))
        store2.close()


class TestRestoreIndexRebase:
    def test_restore_rebases_indexes(self, tmp_path):
        """A snapshot from a 'newer' cluster must not leave table indexes
        ahead of the raft log (blocking queries would stall)."""
        from nomad_tpu_torch.server import Server

        donor = Server(num_workers=0, scheduler_config=cpu_config())
        donor.establish_leadership()
        job = mock.job()
        job.id = "donated"
        donor.state.upsert_job(5000, job)
        snap = donor.state.serialize()
        donor.shutdown()

        srv = Server(num_workers=0, scheduler_config=cpu_config())
        srv.establish_leadership()
        try:
            srv.raft_apply("snapshot_restore", snap)
            latest = srv.state.latest_index()
            assert latest < 5000, "indexes not rebased after restore"
            assert srv.state.job_by_id("default", "donated") is not None
            # subsequent writes stamp monotonically above the rebased point
            idx = srv.raft_apply("job_register", (mock.job(), None))
            assert srv.state.latest_index() >= idx > latest - 1
        finally:
            srv.shutdown()


def test_restart_preserves_round3_tables(tmp_path):
    """Services, secrets, CSI volumes, and operator config all ride
    raft — a full single-server kill/restart must bring every one of
    them back (snapshot + log replay)."""
    import socket as _socket

    from nomad_tpu_torch.structs.structs import (
        SecretEntry,
        ServiceRegistration,
        Volume,
    )

    s = _socket.create_server(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    def boot():
        cs = ClusterServer(
            "solo", port=port, num_workers=1,
            data_dir=str(tmp_path / "solo"), bootstrap_expect=1,
            scheduler_config=cpu_config(),
        )
        cs.start()
        assert wait_until(lambda: cs.is_leader(), 10)
        return cs

    cs = boot()
    try:
        srv = cs.server
        n = mock.node()
        srv.node_register(n)
        job = mock.job(id="dur3")
        srv.job_register(job)
        assert wait_until(
            lambda: srv.state.allocs_by_job("default", "dur3"), 10
        )
        alloc = srv.state.allocs_by_job("default", "dur3")[0]
        srv.secret_upsert(SecretEntry(path="d/s", items={"k": "v"}))
        srv.services_register([
            ServiceRegistration(
                id="reg1", service_name="web", alloc_id=alloc.id
            )
        ])
        srv.volume_register(Volume(
            id="cv", name="cv", type="csi", plugin_id="hp",
            external_id="ext-cv",
        ))
        srv.raft_apply(
            "operator_config_upsert",
            ("autopilot", {"CleanupDeadServers": False}),
        )
    finally:
        cs.shutdown()

    cs2 = boot()
    try:
        st = cs2.server.state
        assert wait_until(
            lambda: st.secret_by_path("default", "d/s") is not None, 10
        )
        assert st.secret_by_path("default", "d/s").items == {"k": "v"}
        regs = st.service_registrations("default", "web")
        assert [r.id for r in regs] == ["reg1"]
        vol = st.volume_by_id("default", "cv")
        assert vol is not None and vol.external_id == "ext-cv"
        assert st.operator_config("autopilot") == {
            "CleanupDeadServers": False
        }
    finally:
        cs2.shutdown()
