"""Gossip membership + dynamic raft peer reconciliation tests.

The cases of ``tests/test_membership.py`` against the port: imports
changed only, the reference's assertions unchanged, and every
ClusterServer states its scheduler config (the reference's default,
``backend="host"``, on ``device="cpu"``).
``TestGossipBootstrap.test_bootstrap_expect_cluster`` runs a job on the
port's ``Client`` through ``ClusterRPC``.

Reference analog: serf membership events driving leader reconcileMember
(nomad/serf.go, nomad/leader.go:1121).
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import ConnPool, RPCServer
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.cluster import ClusterServer
from nomad_tpu_torch.server.membership import ALIVE, FAILED, Membership


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler config, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestMembership:
    def _mk(self, n, **kw):
        """n members, each with its own RPC server."""
        rpcs, mgrs = [], []
        for i in range(n):
            rpc = RPCServer()
            mgr = Membership(
                f"m{i}",
                rpc.addr,
                tags={"role": "server"},
                probe_interval_s=0.1,
                probe_timeout_s=0.3,
                suspicion_timeout_s=0.8,
                **kw,
            )
            rpc.register("Serf", mgr.endpoint)
            rpc.start()
            mgr.start()
            rpcs.append(rpc)
            mgrs.append(mgr)
        return rpcs, mgrs

    def test_join_and_converge(self):
        rpcs, mgrs = self._mk(3)
        try:
            mgrs[1].join([rpcs[0].addr])
            mgrs[2].join([rpcs[0].addr])
            assert wait_until(
                lambda: all(len(m.alive_members()) == 3 for m in mgrs), 10
            ), "all three should converge on 3 alive members"
        finally:
            for r in rpcs:
                r.shutdown()
            for m in mgrs:
                m.stop()

    def test_failure_detection(self):
        rpcs, mgrs = self._mk(3)
        events = []
        mgrs[0].on_event = lambda kind, m: events.append((kind, m.id))
        try:
            mgrs[1].join([rpcs[0].addr])
            mgrs[2].join([rpcs[0].addr])
            assert wait_until(
                lambda: all(len(m.alive_members()) == 3 for m in mgrs), 10
            )
            # kill m2 hard (no graceful leave)
            rpcs[2].shutdown()
            mgrs[2].stop()
            assert wait_until(
                lambda: any(
                    m.id == "m2" and m.status == FAILED
                    for m in mgrs[0].members()
                ),
                10,
            ), "m0 should detect m2 failed"
            assert ("member-failed", "m2") in events
        finally:
            for r in rpcs[:2]:
                r.shutdown()
            for m in mgrs[:2]:
                m.stop()

    def test_graceful_leave(self):
        rpcs, mgrs = self._mk(2)
        try:
            mgrs[1].join([rpcs[0].addr])
            assert wait_until(
                lambda: len(mgrs[0].alive_members()) == 2, 10
            )
            mgrs[1].leave()
            assert wait_until(
                lambda: any(
                    m.id == "m1" and m.status == "left"
                    for m in mgrs[0].members()
                ),
                5,
            )
        finally:
            for r in rpcs:
                r.shutdown()
            mgrs[0].stop()


class TestGossipBootstrap:
    def test_new_server_adopted(self):
        """A server gossip-joining a live cluster is added to raft by the
        leader and receives the replicated state."""
        import socket

        ports = []
        for _ in range(3):
            s = socket.create_server(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            s.close()
        ids = [f"s{i}" for i in range(3)]
        addrs = {nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(ids)}
        servers = {
            nid: ClusterServer(
                nid,
                peers={p: a for p, a in addrs.items() if p != nid},
                port=addrs[nid][1],
                num_workers=1,
                scheduler_config=cpu_config(),
            )
            for nid in ids
        }
        extra = None
        try:
            for s in servers.values():
                s.start()
            leader = lambda: next(
                (s for s in servers.values() if s.is_leader()), None
            )
            assert wait_until(lambda: leader() is not None, 20)
            job = mock.job()
            leader().server.job_register(job)

            # join a fourth, blank server via gossip only
            extra = ClusterServer(
                "s3", bootstrap_expect=0, num_workers=1,
                scheduler_config=cpu_config(),
            )
            extra.start()
            extra.join([leader().addr])
            assert wait_until(
                lambda: "s3" in leader().raft.peers, 20
            ), "leader should adopt s3 into raft"
            assert wait_until(
                lambda: extra.server.state.job_by_id(job.namespace, job.id)
                is not None,
                20,
            ), "adopted server should receive replicated state"
        finally:
            if extra:
                extra.shutdown()
            for s in servers.values():
                s.shutdown()

    def test_bootstrap_expect_cluster(self, tmp_path):
        """Three blank servers discover each other by gossip and bootstrap
        raft once bootstrap_expect is reached; a job then runs."""
        from nomad_tpu_torch.client import Client
        from nomad_tpu_torch.server.cluster import ClusterRPC

        servers = [
            ClusterServer(f"g{i}", scheduler_config=cpu_config(),
                          bootstrap_expect=3, num_workers=1)
            for i in range(3)
        ]
        client = None
        try:
            for s in servers:
                s.start()
            for s in servers[1:]:
                s.join([servers[0].addr])
            leader = lambda: next(
                (s for s in servers if s.is_leader()), None
            )
            assert wait_until(lambda: leader() is not None, 20), (
                "gossip-bootstrapped cluster should elect a leader"
            )
            client = Client(
                ClusterRPC([s.addr for s in servers]),
                data_dir=str(tmp_path / "c0"),
            )
            client.start()
            job = mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].config = {}
            job.datacenters = [client.node.datacenter]
            pool = ConnPool()
            try:
                pool.call(leader().addr, "Job.register", {"job": job})
                assert wait_until(
                    lambda: any(
                        a.client_status == "running"
                        for a in leader().server.state.allocs_by_job(
                            job.namespace, job.id
                        )
                    ),
                    20,
                )
            finally:
                pool.shutdown()
        finally:
            if client:
                client.shutdown()
            for s in servers:
                s.shutdown()
