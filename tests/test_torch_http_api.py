"""``tests/test_http_api.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

HTTP API + SDK tests against a dev-mode agent.

Reference analog: command/agent/testagent.go TestAgent used by endpoint
tests; api/* SDK tests against it.
"""

import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import APIError, NomadClient
from nomad_tpu_torch.api.client import event_stream


def wait_until(fn, timeout_s=20.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    cfg = AgentConfig.dev()
    cfg.device = "cpu"
    cfg.data_dir = str(tmp_path_factory.mktemp("dev-agent"))
    a = Agent(cfg)
    a.start()
    assert wait_until(lambda: a.server.is_leader(), 15)
    yield a
    a.shutdown()


@pytest.fixture
def api(agent):
    host, port = agent.http_addr
    return NomadClient(f"http://{host}:{port}")


def _runnable_job(agent, **kw):
    job = mock.job(**kw)
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].config = {}
    job.datacenters = [agent.client.node.datacenter]
    return job


class TestHTTPJobs:
    def test_register_get_list(self, agent, api):
        job = _runnable_job(agent)
        eval_id = api.jobs.register(job)
        assert eval_id
        got = api.jobs.get(job.id)
        assert got.id == job.id and type(got).__name__ == "Job"
        assert any(j.id == job.id for j in api.jobs.list())
        assert any(j.id == job.id for j in api.jobs.list(prefix=job.id[:8]))

    def test_job_runs_and_allocs_visible(self, agent, api):
        job = _runnable_job(agent)
        api.jobs.register(job)
        assert wait_until(
            lambda: any(
                a.client_status == "running"
                for a in api.jobs.allocations(job.id)
            )
        )
        allocs = api.jobs.allocations(job.id)
        alloc = api.allocations.get(allocs[0].id)
        assert alloc.job_id == job.id
        evs = api.jobs.evaluations(job.id)
        assert evs and evs[0].job_id == job.id
        summary = api.jobs.summary(job.id)
        assert summary.job_id == job.id

    def test_job_allocs_visible(self, agent, api):
        job = _runnable_job(agent)
        api.jobs.register(job)
        assert wait_until(lambda: len(api.jobs.allocations(job.id)) == 1)
        allocs = api.jobs.allocations(job.id)
        alloc = api.allocations.get(allocs[0].id)
        assert alloc.job_id == job.id
        assert alloc.node_id == agent.client.node.id
        assert alloc.desired_status == "run"
        evs = api.jobs.evaluations(job.id)
        assert evs and evs[0].job_id == job.id
        summary = api.jobs.summary(job.id)
        assert summary.job_id == job.id

    def test_deregister(self, agent, api):
        job = _runnable_job(agent)
        api.jobs.register(job)
        api.jobs.deregister(job.id, purge=True)
        with pytest.raises(APIError) as e:
            api.jobs.get(job.id)
        assert e.value.status == 404

    def test_404s(self, api):
        for fn in (
            lambda: api.jobs.get("nope"),
            lambda: api.nodes.get("nope"),
            lambda: api.allocations.get("nope"),
            lambda: api.evaluations.get("nope"),
            lambda: api.deployments.get("nope"),
        ):
            with pytest.raises(APIError) as e:
                fn()
            assert e.value.status == 404


class TestHTTPNodes:
    def test_list_get_drain(self, agent, api):
        nodes = api.nodes.list()
        assert len(nodes) == 1
        node = api.nodes.get(nodes[0].id)
        assert node.id == agent.client.node.id
        api.nodes.eligibility(node.id, False)
        assert wait_until(
            lambda: api.nodes.get(node.id).scheduling_eligibility
            == "ineligible"
        )
        api.nodes.eligibility(node.id, True)
        assert wait_until(
            lambda: api.nodes.get(node.id).scheduling_eligibility == "eligible"
        )


class TestHTTPStatus:
    def test_leader_peers_members(self, agent, api):
        assert api.status.leader()
        peers = api.status.peers()
        assert len(peers) == 1
        members = api.agent.members()
        assert members[0]["tags"]["role"] == "server"
        info = api.agent.self()
        assert info["stats"]["leader"] is True
        assert api.agent.health()["server"]["ok"] is True


class TestBlockingQueries:
    def test_blocking_job_list_unblocks_on_register(self, agent, api):
        # initial non-blocking fetch for the index
        _, idx = api.get_raw_jobs()
        results = {}

        def blocked():
            t0 = time.monotonic()
            _, new_idx = api.get_raw_jobs(index=idx, wait="10s")
            results["elapsed"] = time.monotonic() - t0
            results["index"] = new_idx

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.3)
        job = _runnable_job(agent)
        api.jobs.register(job)
        t.join(12)
        assert not t.is_alive()
        assert results["index"] > idx
        assert results["elapsed"] < 9, "should unblock on write, not timeout"


class TestEventStream:
    def test_stream_receives_job_events(self, agent, api):
        frames = []
        done = threading.Event()

        def consume():
            for frame in event_stream(api, {"Job": ["*"]}):
                frames.append(frame)
                done.set()
                return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)
        job = _runnable_job(agent)
        api.jobs.register(job)
        assert done.wait(10), "should receive a job event frame"
        evs = frames[0]["Events"]
        assert evs[0]["Topic"] == "Job"
        assert type(evs[0]["Payload"]).__name__ == "Job"

    def test_killed_streamer_reaped_promptly(self, agent):
        """Regression (round 21): a streaming client that dies without
        closing cleanly must not pin its broker subscription until the
        next event happens to flush — the streamer probes the socket
        between 2s holds and reaps the subscription within seconds."""
        import socket as socket_mod

        from nomad_tpu_torch import metrics

        broker = agent.server.server.event_broker
        base = broker.subscriber_count()
        host, port = agent.http_addr
        sock = socket_mod.create_connection((host, port))
        try:
            sock.sendall(
                b"GET /v1/event/stream?topic=Job HTTP/1.1\r\n"
                b"Host: test\r\n\r\n"
            )
            assert wait_until(
                lambda: broker.subscriber_count() == base + 1, 10
            ), "stream subscription never registered"
        finally:
            before = metrics.registry().snapshot()["counters"].get(
                "nomad.stream.reaped", 0
            )
            sock.close()  # the client dies; no FIN-wait niceties
        assert wait_until(
            lambda: broker.subscriber_count() <= base, 10
        ), "dead streamer's subscription never reaped"
        assert (
            metrics.registry().snapshot()["counters"].get(
                "nomad.stream.reaped", 0
            )
            >= before + 1
        )


# small helpers on the client for the blocking test
def _get_raw_jobs(self, index=None, wait=None):
    params = {"namespace": self.namespace}
    if index is not None:
        params["index"] = str(index)
    if wait is not None:
        params["wait"] = wait
    return self.get_with_index("/v1/jobs", params=params)


NomadClient.get_raw_jobs = _get_raw_jobs


def test_gzip_response_negotiation(agent):
    """Accept-Encoding: gzip compresses large list payloads
    (reference command/agent/http.go:248 gzip wrap); absent the header,
    plain JSON."""
    import gzip
    import json as _json
    import urllib.request

    base = f"http://127.0.0.1:{agent.http_addr[1]}"
    srv = agent.server.server
    # enough nodes that the /v1/nodes payload crosses the 1KiB threshold
    for _ in range(8):
        srv.node_register(mock.node())
    req = urllib.request.Request(
        f"{base}/v1/nodes", headers={"Accept-Encoding": "gzip"}
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.headers.get("Content-Encoding") == "gzip"
        nodes = _json.loads(gzip.decompress(resp.read()))
    assert len(nodes) >= 8
    with urllib.request.urlopen(f"{base}/v1/nodes", timeout=10) as resp:
        assert resp.headers.get("Content-Encoding") is None
        assert len(_json.loads(resp.read())) >= 8
