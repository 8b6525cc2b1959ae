"""Replication and the cluster on both packages' ClusterServers.

chip_smoke.py's ``cluster_lockstep`` (the three-server cluster its
``small`` phase runs on the card and on the CPU twins: 200 nodes, jobs of
50, each registered through a follower and its eval completed before the
next, a leader kill at a quiet point, more jobs, a restart from disk, one
job scaled) runs on nomad_tpu's ChaosCluster (the batch worker with
``backend="tpu"``) and on the port's (``device="cpu"``), on the same
nodes and jobs, built with nomad_tpu's mocks and carried over the wire.
Inside each run every server's store must be equal alloc for alloc and
table for table; across the two runs the placements (job, group, node),
the eval outcomes and the job versions must be equal, no tolerance.

The other cases hold properties the cluster layer owes, each on both
packages: a write forwarded from a follower lands on every replica; the
forwarder retries a pre-submit NotLeaderError but never a
LeadershipLostError; the replay barrier holds establish_leadership until
the leader's barrier entry is applied; a ``snapshot_restore`` entry
rebases the store's indexes, and the ``Operator`` endpoints' snapshot
save and restore round-trip through the log.

Last, the cases of ``tests/test_cluster.py`` on the port: a job run on
``Client``s talking to a three-server cluster through ``ClusterRPC``
(registered through a follower, and rescheduled after a leader kill),
and the TLS fabric; imports pointed at ``nomad_tpu_torch``, every
ClusterServer on ``backend="host"``, ``device="cpu"``, the reference's
assertions.
"""

import functools
import importlib
import random
import threading
import time

import pytest

from nomad_tpu import codec as jcodec

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client
from nomad_tpu_torch.codec import from_wire
from nomad_tpu_torch.rpc import ConnPool
from nomad_tpu_torch.scheduler.context import SchedulerConfig
from nomad_tpu_torch.server.cluster import ClusterRPC, ClusterServer

PACKAGES = ("nomad_tpu", "nomad_tpu_torch")


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


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _server_kw(pkg) -> dict:
    """The reference's default scheduler config; the port's written out
    on the CPU (the reference's ClusterServer takes none)."""
    if pkg == "nomad_tpu":
        return {}
    cfg = _mod(pkg, "scheduler.context").SchedulerConfig
    return {"scheduler_config": cfg(backend="host", device="cpu")}


def wait_until(fn, timeout_s=30.0, interval=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


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


def _ref_make(job_id, count):
    """chip_smoke.make_job's c2m job, built with nomad_tpu's mocks."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.structs import Constraint, Spread

    job = jmock.job(id=job_id)
    job.datacenters = ["dc1", "dc2", "dc3", "dc4"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 250
    tg.tasks[0].resources.memory_mb = 128
    tg.tasks[0].resources.networks = []
    job.constraints.append(Constraint("${attr.kernel.name}", "linux", "="))
    job.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    return job


def _wire(obj):
    return from_wire(jcodec.to_wire(obj))


def test_cluster_lockstep_matches_nomad_tpu(tmp_path, monkeypatch):
    import nomad_tpu.server.cluster as jcluster
    from nomad_tpu.rpc import ConnPool as JPool
    from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
    from nomad_tpu.testing.chaos import ChaosCluster as JChaos

    from nomad_tpu_torch.rpc import ConnPool as TPool
    from nomad_tpu_torch.scheduler.context import SchedulerConfig
    from nomad_tpu_torch.testing.chaos import ChaosCluster as TChaos

    cs = _chip_smoke()
    random.seed(0)
    nodes = _ref_fleet(cs.CLUSTER_SMALL["nodes"])
    # nomad_tpu's ClusterServer builds its Server with the default
    # config; hand it the batch solver's, as its Server accepts
    monkeypatch.setattr(jcluster, "Server", functools.partial(
        jcluster.Server,
        scheduler_config=JConfig(backend="tpu", small_batch_threshold=0)))

    def jboot():
        cluster = JChaos(3, str(tmp_path / "ref"), use_tpu_batch_worker=True)
        return cluster.start(), JPool()

    def tboot():
        cluster = TChaos(
            3, str(tmp_path / "port"), use_tpu_batch_worker=True,
            scheduler_config=SchedulerConfig(
                device="cpu", small_batch_threshold=0))
        return cluster.start(), TPool()

    jout = cs.cluster_lockstep(jboot, _ref_make, nodes)
    tout = cs.cluster_lockstep(
        tboot, lambda jid, c: _wire(_ref_make(jid, c)),
        [_wire(n) for n in nodes])
    assert sorted(tout) == sorted(jout)
    for key in jout:
        assert tout[key] == jout[key], key
    cfg = cs.CLUSTER_SMALL
    jobs = cfg["before"] + cfg["after"]
    placed = sum(n for _, n in tout["placed"])
    assert placed == (jobs - 1) * cfg["count"] + cfg["scaled"]
    assert tout["servers_compared"] == 3
    assert ("lock-0", 1) in tout["versions"]
    assert all(e[2] == "complete" for e in tout["evals"])


def _cluster(pkg, tmp_path, **kw):
    chaos = _mod(pkg, "testing.chaos")
    c = chaos.ChaosCluster(3, str(tmp_path / pkg), **_server_kw(pkg), **kw)
    return c.start()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_follower_forwards_write_to_leader(pkg, tmp_path):
    mock = _mod(pkg, "mock")
    cluster = _cluster(pkg, tmp_path)
    try:
        lead = cluster.wait_for_stable_leader(30)
        assert lead is not None
        fol = next(c for c in cluster.servers.values() if c is not lead)
        assert not fol.is_leader()
        job = mock.job(id="fwd-job")
        eval_id = fol.rpc_self("Job.register", {"job": job})
        assert isinstance(eval_id, str) and eval_id
        # the write was applied by the leader's log: every replica holds
        # the job and its eval at the same index
        assert wait_until(lambda: all(
            c.server.state.eval_by_id(eval_id) is not None
            for c in cluster.servers.values()))
        idx = {c.server.state.job_by_id("default", "fwd-job").modify_index
               for c in cluster.servers.values()}
        assert len(idx) == 1
        assert lead.raft.last_index >= idx.pop()
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_forwarder_does_not_retry_leadership_lost(pkg):
    import types

    cluster_mod = _mod(pkg, "server.cluster")
    rr = _mod(pkg, "server.raft_replication")
    retry = _mod(pkg, "retry")
    cs = types.SimpleNamespace(
        raft=types.SimpleNamespace(is_leader=lambda: True),
        forward_retry=retry.RetryPolicy(base_s=0.001, max_s=0.002,
                                        deadline_s=5.0),
    )
    fwd = cluster_mod._Forwarder(cs)
    calls = []

    def lost(args):
        calls.append(args)
        raise rr.LeadershipLostError(None)

    with pytest.raises(rr.LeadershipLostError):
        fwd._forward("Job.register", {"n": 1}, lost)
    assert len(calls) == 1, "an outcome-unknown write must not be retried"

    def not_leader_twice(args):
        calls.append(args)
        if len(calls) < 4:
            raise rr.NotLeaderError(None)
        return "ok"

    assert fwd._forward("Job.register", {"n": 2}, not_leader_twice) == "ok"
    assert len(calls) == 4, "a pre-submit NotLeaderError is retried"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replay_barrier_holds_establish_leadership(pkg, tmp_path):
    cluster_mod = _mod(pkg, "server.cluster")
    cs = cluster_mod.ClusterServer(
        "solo", bootstrap_expect=1, data_dir=str(tmp_path / "solo"),
        **_server_kw(pkg))
    release = threading.Event()
    real_apply = cs.server.fsm.apply

    def apply(index, msg_type, payload):
        # the new leader's barrier entry waits until released
        if msg_type == "noop":
            release.wait(30)
        return real_apply(index, msg_type, payload)

    cs.server.fsm.apply = apply
    try:
        cs.start()
        assert wait_until(cs.is_leader, 10)
        time.sleep(0.5)
        # raft leads, but the barrier entry is unapplied: nothing of the
        # leader's subsystems is up
        assert cs.raft.last_applied < cs.raft._barrier_index
        assert not cs.server._leader
        assert not cs.server.eval_broker.enabled
        release.set()
        assert wait_until(lambda: cs.server._leader, 10)
        assert cs.server.eval_broker.enabled
        assert cs.raft.last_applied >= cs.raft._barrier_index
    finally:
        release.set()
        cs.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_restore_rebases_indexes(pkg):
    mock = _mod(pkg, "mock")
    Server = _mod(pkg, "server").Server
    kw = _server_kw(pkg)
    donor = Server(num_workers=0, **kw)
    job = mock.job(id="donated")
    donor.state.upsert_job(5000, job)
    snap = donor.state.serialize()
    donor.shutdown()
    srv = Server(num_workers=0, **kw)
    try:
        for _ in range(3):
            srv.raft_apply("job_register", (mock.job(), None))
        idx = srv.raft_apply("snapshot_restore", snap)
        st = srv.state
        # every table index rebased to the restore entry's index
        assert st.latest_index() == idx
        assert all(v == idx for v in st._indexes.values())
        assert st.job_by_id("default", "donated") is not None
        assert len(st.jobs()) == 1
        after = srv.raft_apply("job_register", (mock.job(), None))
        assert after == idx + 1 and st.latest_index() == after
    finally:
        srv.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_operator_snapshot_round_trip(pkg, tmp_path):
    mock = _mod(pkg, "mock")
    cluster = _cluster(pkg, tmp_path)
    try:
        lead = cluster.wait_for_stable_leader(30)
        fol = next(c for c in cluster.servers.values() if c is not lead)
        keep = mock.job(id="keep-me")
        fol.rpc_self("Job.register", {"job": keep})
        assert cluster.converged(30)
        snap = fol.rpc_self("Operator.snapshot_save", {})["snapshot"]
        fol.rpc_self("Job.register", {"job": mock.job(id="drop-me")})
        assert cluster.converged(30)
        fol.rpc_self("Operator.snapshot_restore", {"data": snap})
        assert cluster.converged(30)
        for c in cluster.servers.values():
            ids = {j.id for j in c.server.state.jobs()}
            assert "keep-me" in ids and "drop-me" not in ids
        peers = lead.rpc_self("Operator.raft_configuration", {})
        assert sum(1 for p in peers if p["leader"]) == 1
        assert len(peers) == 3
    finally:
        cluster.shutdown()


@pytest.fixture
def cluster3(tmp_path):
    # Three servers with static peer wiring (serf-style discovery is the
    # membership layer's job; raft takes a fixed member map).
    import socket

    ports = []
    socks = []
    for _ in range(3):
        s = socket.create_server(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    ids = [f"s{i}" for i in range(3)]
    addrs = {nid: ("127.0.0.1", ports[i]) for i, nid in enumerate(ids)}
    servers = {}
    for nid in ids:
        servers[nid] = ClusterServer(
            nid,
            scheduler_config=SchedulerConfig(backend="host", device="cpu"),
            peers={p: a for p, a in addrs.items() if p != nid},
            port=addrs[nid][1],
            num_workers=1,
        )
    for s in servers.values():
        s.start()
    clients = []

    def add_client(**kw):
        c = Client(
            ClusterRPC([s.addr for s in servers.values()]),
            data_dir=str(tmp_path / f"c{len(clients)}"),
            **kw,
        )
        c.start()
        clients.append(c)
        return c

    yield servers, add_client
    for c in clients:
        c.shutdown()
    for s in servers.values():
        s.shutdown()


def _leader(servers):
    for s in servers.values():
        if s.is_leader():
            return s
    return None


def test_cluster_runs_job_via_follower(cluster3):
    servers, add_client = cluster3
    assert wait_until(lambda: _leader(servers) is not None)
    client = add_client()
    leader = _leader(servers)
    follower = next(s for s in servers.values() if s is not leader)

    # Register through a FOLLOWER: must forward to the leader.
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {}
    job.datacenters = [client.node.datacenter]
    pool = ConnPool()
    try:
        eval_id = pool.call(follower.addr, "Job.register", {"job": job})
        assert eval_id

        def running_everywhere():
            for s in servers.values():
                allocs = s.server.state.allocs_by_job(job.namespace, job.id)
                if len(allocs) != 2:
                    return False
                if not all(a.client_status == "running" for a in allocs):
                    return False
            return True

        assert wait_until(running_everywhere, 20), (
            "2 allocs should reach running and replicate to every server"
        )
    finally:
        pool.shutdown()


def test_leader_failover_reschedules(cluster3):
    servers, add_client = cluster3
    assert wait_until(lambda: _leader(servers) is not None)
    client = add_client()
    leader = _leader(servers)

    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].config = {}
    job.datacenters = [client.node.datacenter]
    pool = ConnPool()
    try:
        pool.call(leader.addr, "Job.register", {"job": job})
        assert wait_until(
            lambda: any(
                a.client_status == "running"
                for a in leader.server.state.allocs_by_job(job.namespace, job.id)
            ),
            20,
        )

        # Kill the leader. A new one must take over and keep serving.
        dead_id = leader.node_id
        leader.shutdown()
        del servers[dead_id]
        assert wait_until(lambda: _leader(servers) is not None, 20), (
            "a new leader should be elected"
        )
        new_leader = _leader(servers)

        # The surviving cluster accepts and runs a second job (the client
        # fails over between servers transparently).
        job2 = mock.job(id="after-failover")
        job2.task_groups[0].count = 1
        job2.task_groups[0].tasks[0].config = {}
        job2.datacenters = [client.node.datacenter]
        pool.call(new_leader.addr, "Job.register", {"job": job2})
        assert wait_until(
            lambda: any(
                a.client_status == "running"
                for a in new_leader.server.state.allocs_by_job(
                    job2.namespace, job2.id
                )
            ),
            25,
        ), "job registered after failover should run"
    finally:
        pool.shutdown()


def test_tls_rpc_fabric(tmp_path):
    """tls { rpc = true }: the whole fabric — raft replication between
    servers, client registration/heartbeats, and plan placement — runs
    over mTLS, and a plaintext dialer is rejected at the handshake
    (reference nomad/rpc.go rpcTLS + tlsutil verify_incoming)."""
    import subprocess

    from nomad_tpu_torch.rpc.tls import fabric_contexts

    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", str(key), "-out", str(cert), "-days", "1",
            "-nodes", "-subj", "/CN=fabric",
        ],
        check=True,
        capture_output=True,
    )
    # self-signed cert doubles as the CA: full mTLS both directions
    tls = fabric_contexts(str(cert), str(key), ca_file=str(cert))

    import socket as _socket

    ports = []
    for _ in range(2):
        s = _socket.create_server(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    addrs = {f"s{i}": ("127.0.0.1", p) for i, p in enumerate(ports)}
    servers = {
        nid: ClusterServer(
            nid,
            scheduler_config=SchedulerConfig(backend="host", device="cpu"),
            peers={p: a for p, a in addrs.items() if p != nid},
            port=addrs[nid][1],
            num_workers=1,
            tls=tls,
        )
        for nid in addrs
    }
    for s in servers.values():
        s.start()
    client = None
    try:
        assert wait_until(
            lambda: any(s.is_leader() for s in servers.values())
        )
        client = Client(
            ClusterRPC(
                [s.addr for s in servers.values()], tls_context=tls[1]
            ),
            data_dir=str(tmp_path / "c0"),
            tls=tls,
        )
        client.start()
        assert client.wait_registered(15)
        leader = next(s for s in servers.values() if s.is_leader())
        job = mock.job(id="tls-fabric")
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].driver = "mock"
        job.task_groups[0].tasks[0].config = {}
        leader.server.job_register(job)
        assert wait_until(
            lambda: any(
                a.client_status == "running"
                for a in leader.server.state.allocs_by_job(
                    "default", "tls-fabric"
                )
            ),
            timeout_s=15,
        )
        # a non-TLS dialer must not get through the fabric
        with pytest.raises((ConnectionError, OSError, TimeoutError)):
            ConnPool(connect_timeout_s=2.0).call(
                servers["s0"].rpc.addr, "Status.ping", {}, timeout_s=3.0
            )
    finally:
        if client is not None:
            client.shutdown()
        for s in servers.values():
            s.shutdown()
