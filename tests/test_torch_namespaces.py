"""Namespaces on both packages' Servers, on the CPU.

nomad_tpu's ``Server.job_register`` checks the job's namespace against
the store's namespace table (``_ensure_namespace``): ``default`` is
bootstrapped at leadership (and on first use), any other namespace must
have been registered. The port's register once stored a job in a
namespace that did not exist and returned an eval id. The differential
cases give both Servers the same inputs (built with nomad_tpu's mocks,
carried over the wire) and hold them to the same outcome; the last four
cases are the reference's own ``tests/test_namespaces.py`` cases that
need no agent, against the port.
"""

import pytest

from nomad_tpu import codec as jcodec
from nomad_tpu import mock as jmock
from nomad_tpu.scheduler.context import SchedulerConfig as JConfig
from nomad_tpu.server import Server as JServer
from nomad_tpu.structs.structs import Namespace as JNamespace
from nomad_tpu.structs.structs import Volume as JVolume

from nomad_tpu_torch import codec as tcodec
from nomad_tpu_torch import mock
from nomad_tpu_torch.scheduler.context import SchedulerConfig as TConfig
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import Namespace


def _w(obj):
    return tcodec.from_wire(jcodec.to_wire(obj))


class Pair:
    """nomad_tpu's Server and the port's, with one node each."""

    def __init__(self, lead=True):
        self.j = JServer(num_workers=1, scheduler_config=JConfig())
        self.t = Server(num_workers=1, scheduler_config=TConfig(device="cpu"))
        if lead:
            for s in (self.j, self.t):
                s.establish_leadership()
        n = jmock.node()
        self.j.node_register(n)
        self.t.node_register(_w(n))

    def both(self, fn):
        """fn(server, wire) on both; returns the two results, or the two
        exceptions' (type name, message)."""
        out = []
        for srv, wire in ((self.j, lambda o: o), (self.t, _w)):
            try:
                out.append(fn(srv, wire))
            except Exception as e:  # compared, then re-checked by type
                out.append((type(e).__name__, str(e)))
        return out

    def indexes(self):
        return self.j.state.latest_index(), self.t.state.latest_index()

    def shutdown(self):
        self.j.shutdown()
        self.t.shutdown()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.shutdown()


def _job(ns):
    job = jmock.job(id=f"job-{ns}")
    job.namespace = ns
    return job


def test_missing_namespace_refused_and_nothing_stored(pair):
    """Both refuse a job in an unregistered namespace with the same
    error, and neither store moves."""
    before = pair.indexes()
    job = _job("team-a")
    got = pair.both(lambda s, w: s.job_register(w(job)))
    assert got[0] == got[1] == (
        "ValueError", "namespace 'team-a' does not exist")
    assert pair.indexes() == before
    for s in (pair.j, pair.t):
        assert s.state.job_by_id("team-a", job.id) is None
        assert not s.state.evals()


def test_default_bootstrapped_at_leadership_and_on_first_use():
    """Leadership bootstraps `default` at the same index on both. A
    server that never led writes the `default` row as one more raft
    entry at its first register, on both."""
    led = Pair()
    try:
        rows = [s.state.namespace_by_name("default") for s in (led.j, led.t)]
        assert all(r is not None for r in rows)
        assert rows[0].create_index == rows[1].create_index
        assert rows[0].description == rows[1].description
    finally:
        led.shutdown()
    cold = Pair(lead=False)
    try:
        assert cold.j.state.namespace_by_name("default") is None
        assert cold.t.state.namespace_by_name("default") is None
        before = cold.indexes()
        job = _job("default")
        cold.both(lambda s, w: s.job_register(w(job)))
        after = cold.indexes()
        # the namespace row, then the job and its eval
        assert after[0] - before[0] == after[1] - before[1] == 2
        for s in (cold.j, cold.t):
            ns = s.state.namespace_by_name("default")
            assert ns is not None and ns.create_index == before[0] + 1
            assert s.state.job_by_id("default", job.id) is not None
    finally:
        cold.shutdown()


def test_registered_namespace_admitted(pair):
    """After namespace_upsert, both admit the job, store it at the same
    index and mint its eval."""
    pair.both(lambda s, w: s.namespace_upsert(w(JNamespace(name="team-a"))))
    job = _job("team-a")
    ids = pair.both(lambda s, w: s.job_register(w(job)))
    assert all(isinstance(i, str) and i for i in ids)
    js = pair.j.state.job_by_id("team-a", job.id)
    ts = pair.t.state.job_by_id("team-a", job.id)
    assert js is not None and ts is not None
    assert js.modify_index == ts.modify_index
    assert pair.j.state.eval_by_id(ids[0]).namespace == "team-a"
    assert pair.t.state.eval_by_id(ids[1]).namespace == "team-a"


def test_namespace_with_live_job_or_volume_not_deleted(pair):
    """A namespace holding a live job, or a registered volume, refuses
    deletion on both with the same error; a stopped job does not hold
    it; `default` never goes."""
    for name in ("busy", "vols"):
        pair.both(lambda s, w: s.namespace_upsert(w(JNamespace(name=name))))
    job = _job("busy")
    pair.both(lambda s, w: s.job_register(w(job)))
    vol = JVolume(id="v1", namespace="vols", name="data", type="csi",
                  plugin_id="ebs")
    pair.both(lambda s, w: s.volume_register(w(vol)))
    got = pair.both(lambda s, w: s.namespace_delete("busy"))
    assert got[0] == got[1] == ("ValueError", "namespace busy has 1 jobs/volumes")
    got = pair.both(lambda s, w: s.namespace_delete("vols"))
    assert got[0] == got[1] == ("ValueError", "namespace vols has 1 jobs/volumes")
    got = pair.both(lambda s, w: s.namespace_delete("default"))
    assert got[0] == got[1] == (
        "ValueError", "the default namespace cannot be deleted")
    pair.both(lambda s, w: s.job_deregister("busy", job.id))
    assert pair.both(lambda s, w: s.namespace_delete("busy")) == [None, None]
    pair.both(lambda s, w: s.volume_deregister("vols", "v1"))
    assert pair.both(lambda s, w: s.namespace_delete("vols")) == [None, None]
    for s in (pair.j, pair.t):
        assert [n.name for n in s.state.namespaces()] == ["default"]


# ---------------------------------------------------------------------------
# tests/test_namespaces.py's cases that need no agent, against the port
# ---------------------------------------------------------------------------


@pytest.fixture
def server():
    s = Server(num_workers=1, scheduler_config=TConfig(backend="host",
                                                      device="cpu"))
    s.establish_leadership()
    yield s
    s.shutdown()


def test_namespace_crud(server):
    server.namespace_upsert(Namespace(name="prod", description="production"))
    ns = server.state.namespace_by_name("prod")
    assert ns is not None and ns.description == "production"

    # update keeps create_index
    ci = ns.create_index
    server.namespace_upsert(Namespace(name="prod", description="prod v2"))
    ns = server.state.namespace_by_name("prod")
    assert ns.description == "prod v2" and ns.create_index == ci

    server.namespace_delete("prod")
    assert server.state.namespace_by_name("prod") is None


def test_namespace_name_validated(server):
    with pytest.raises(ValueError):
        server.namespace_upsert(Namespace(name="bad name!"))


def test_job_register_requires_namespace(server):
    server.node_register(mock.node())
    job = mock.job()
    job.namespace = "nonexistent"
    with pytest.raises(ValueError, match="does not exist"):
        server.job_register(job)
    # default is bootstrapped on first use
    ok = mock.job()
    server.job_register(ok)
    assert server.state.namespace_by_name("default") is not None


def test_namespace_delete_refuses_in_use(server):
    server.node_register(mock.node())
    server.namespace_upsert(Namespace(name="busy"))
    job = mock.job()
    job.namespace = "busy"
    server.job_register(job)
    with pytest.raises(ValueError, match="jobs/volumes"):
        server.namespace_delete("busy")
    with pytest.raises(ValueError, match="cannot be deleted"):
        server.namespace_delete("default")
