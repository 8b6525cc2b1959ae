"""Namespaces on both packages' Servers, on the CPU.

nomad_tpu's ``Server.job_register`` checks the job's namespace against
the store's namespace table (``_ensure_namespace``): ``default`` is
bootstrapped at leadership (and on first use), any other namespace must
have been registered. The port's register once stored a job in a
namespace that did not exist and returned an eval id. The differential
cases give both Servers the same inputs (built with nomad_tpu's mocks,
carried over the wire) and hold them to the same outcome; the rest are
the reference's own ``tests/test_namespaces.py`` cases against the port:
four on a Server, then its HTTP cases on the port's server agent
(``AgentConfig(device="cpu")``) and SDK.
"""

import time

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


def test_namespace_http_surface(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import APIError, NomadClient

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        api.namespaces.apply(Namespace(name="team-a", description="a"))
        names = [n.name for n in api.namespaces.list()]
        assert "team-a" in names
        got = api.namespaces.get("team-a")
        assert got.description == "a"
        # registering a job into it now works end to end
        srv = agent.server.server
        srv.node_register(mock.node())
        job = mock.job()
        job.namespace = "team-a"
        api.jobs.register(job)
        with pytest.raises(APIError) as e:
            api.namespaces.delete("team-a")
        assert e.value.status == 409
        with pytest.raises(APIError) as e:
            api.namespaces.get("nope")
        assert e.value.status == 404
    finally:
        agent.shutdown()


def test_regions_endpoint(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import NomadClient

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        assert api.status.regions() == ["global"]
    finally:
        agent.shutdown()


def test_pprof_and_debug_surface(tmp_path):
    """pprof analogs + operator debug bundle (reference command/agent/
    pprof + operator_debug.go)."""
    import json
    import tarfile
    from types import SimpleNamespace

    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.agent.debug import debug_bundle
    from nomad_tpu_torch.api.client import NomadClient

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        threads = api.get("/v1/agent/pprof/goroutine")["profile"]
        assert "rpc" in threads  # the fabric's worker threads show up
        heap = api.get("/v1/agent/pprof/heap")
        assert heap["gc_objects"] > 0 and heap["threads"] > 1
        prof = api.get("/v1/agent/pprof/profile", params={"seconds": "0.2"})
        assert "cumulative" in prof["profile"]

        bundle = debug_bundle(api)
        for key in ("agent_self", "metrics", "nodes", "threads", "heap"):
            assert key in bundle, f"bundle missing {key}"
            assert not (
                isinstance(bundle[key], dict) and "error" in bundle[key]
            ), f"bundle {key} errored: {bundle[key]}"

        # the CLI path: archive assembly + wire-lowering of every payload
        from nomad_tpu_torch.cli.main import cmd_operator_debug

        out = str(tmp_path / "bundle.tar.gz")
        rc = cmd_operator_debug(
            SimpleNamespace(
                address=f"http://127.0.0.1:{agent.http_addr[1]}",
                token="",
                output=out,
            )
        )
        assert rc == 0
        with tarfile.open(out) as tar:
            names = tar.getnames()
            assert "debug/metrics.json" in names
            data = json.load(tar.extractfile("debug/metrics.json"))
            assert "gauges" in data
    finally:
        agent.shutdown()


def test_pprof_disabled_outside_debug_mode(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import APIError, NomadClient

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = False
    cfg.enable_debug = False
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        with pytest.raises(APIError) as e:
            api.get("/v1/agent/pprof/goroutine")
        assert e.value.status == 404
    finally:
        agent.shutdown()


def test_search_endpoints(tmp_path):
    """Prefix + fuzzy search (reference nomad/search_endpoint.go)."""
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import NomadClient

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        srv = agent.server.server
        for _ in range(2):
            srv.node_register(mock.node())
        job = mock.job(id="search-target")
        srv.job_register(job)
        srv.wait_for_evals(10)

        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        out = api.search.prefix("search-")
        assert out["Matches"]["jobs"] == ["search-target"]
        # alloc ids are uuids; nothing prefix-matches "search-"
        assert "allocs" not in out["Matches"]

        out = api.search.prefix("search-", context="jobs")
        assert list(out["Matches"].keys()) == ["jobs"]

        fz = api.search.fuzzy("web")  # the mock job's group/task name
        hits = fz["Matches"]["jobs"]
        scopes = {tuple(h["Scope"]) for h in hits}
        assert ("default", "search-target") in scopes
    finally:
        agent.shutdown()


def test_search_is_namespace_scoped(tmp_path):
    """Search must not leak other namespaces' eval/alloc ids (reference
    search_endpoint.go per-namespace filtering)."""
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import NomadClient
    from nomad_tpu_torch.structs.structs import Namespace

    cfg = AgentConfig()
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    cfg.device = "cpu"
    agent = Agent(cfg)
    agent.start()
    try:
        srv = agent.server.server
        n = mock.node()
        srv.node_register(n)
        srv.node_heartbeat(n.id)
        srv.namespace_upsert(Namespace(name="other"))
        job = mock.job(id="scoped-job")
        job.namespace = "other"
        srv.job_register(job)
        srv.wait_for_evals(10)
        deadline = time.monotonic() + 10
        other_allocs = srv.state.allocs_by_job("other", job.id)
        while time.monotonic() < deadline and not other_allocs:
            time.sleep(0.05)
            other_allocs = srv.state.allocs_by_job("other", job.id)
        assert other_allocs

        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        # searching the DEFAULT namespace with an empty prefix must not
        # surface other-namespace evals/allocs/jobs
        out = api.search.prefix("", namespace="default")
        assert "scoped-job" not in out["Matches"].get("jobs", [])
        leaked = set(out["Matches"].get("allocs", [])) & {
            a.id for a in other_allocs
        }
        assert not leaked
        # but searching the right namespace finds them
        out = api.search.prefix("scoped-", namespace="other")
        assert out["Matches"]["jobs"] == ["scoped-job"]
    finally:
        agent.shutdown()
