"""``tests/test_templates_volumes.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Template re-render loop + volume claim lifecycle tests.

Reference: client/allocrunner/taskrunner/template/template.go (re-render +
change_mode) and nomad/volumewatcher/volumes_watcher.go (claim release on
alloc termination).
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs.structs import Template
from nomad_tpu_torch.structs.structs import (
    VOLUME_ACCESS_SINGLE_WRITER,
    Volume,
    VolumeRequest,
)
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=10.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# TemplateWatcher unit tests
# ---------------------------------------------------------------------------


class TestTemplateWatcher:
    def _watcher(self, tmp_path, tmpl, signal_fn=None, restart_fn=None):
        from nomad_tpu_torch.client.template import TemplateWatcher

        return TemplateWatcher(
            [tmpl],
            str(tmp_path),
            {"NOMAD_TASK_NAME": "t"},
            signal_fn=signal_fn or (lambda sig: None),
            restart_fn=restart_fn or (lambda: None),
            poll_interval_s=0.05,
        )

    def test_rerender_fires_restart(self, tmp_path):
        src = tmp_path / "src.tpl"
        src.write_text("v1")
        tmpl = Template(
            source_path=str(src), dest_path="out.conf",
            change_mode="restart", splay_s=0,
        )
        from nomad_tpu_torch.client.template import render_template

        render_template(tmpl, str(tmp_path), {})
        fired = []
        w = self._watcher(tmp_path, tmpl, restart_fn=lambda: fired.append(1))
        w.prime()
        w.start()
        try:
            src.write_text("v2")
            assert wait_until(lambda: fired, 5)
            assert (tmp_path / "out.conf").read_text() == "v2"
        finally:
            w.stop()

    def test_rerender_fires_signal(self, tmp_path):
        src = tmp_path / "src.tpl"
        src.write_text("v1")
        tmpl = Template(
            source_path=str(src), dest_path="out.conf",
            change_mode="signal", change_signal="SIGHUP", splay_s=0,
        )
        from nomad_tpu_torch.client.template import render_template

        render_template(tmpl, str(tmp_path), {})
        sigs = []
        w = self._watcher(tmp_path, tmpl, signal_fn=sigs.append)
        w.prime()
        w.start()
        try:
            src.write_text("v2")
            assert wait_until(lambda: sigs == ["SIGHUP"], 5)
        finally:
            w.stop()

    def test_unchanged_content_fires_nothing(self, tmp_path):
        src = tmp_path / "src.tpl"
        src.write_text("same")
        tmpl = Template(
            source_path=str(src), dest_path="out.conf",
            change_mode="restart", splay_s=0,
        )
        from nomad_tpu_torch.client.template import render_template

        render_template(tmpl, str(tmp_path), {})
        fired = []
        w = self._watcher(tmp_path, tmpl, restart_fn=lambda: fired.append(1))
        w.prime()
        w.start()
        try:
            src.write_text("same")  # rewrite, identical content
            time.sleep(0.4)
            assert not fired
        finally:
            w.stop()


def test_template_restart_end_to_end(tmp_path, monkeypatch):
    """Full stack: artifact-sourced template re-renders and restarts the
    task without consuming the restart policy budget."""
    monkeypatch.setenv("NOMAD_TEMPLATE_POLL_INTERVAL", "0.1")
    monkeypatch.setenv("NOMAD_ARTIFACT_ALLOW_FILE", "1")
    from nomad_tpu_torch.client import Client, ServerRPC
    from nomad_tpu_torch.structs.structs import TaskArtifact

    artifact_src = tmp_path / "app.conf.tpl"
    artifact_src.write_text("config-v1")

    server = Server(num_workers=2, scheduler_config=cpu_config())
    server.establish_leadership()
    client = None
    try:
        client = Client(ServerRPC(server), data_dir=str(tmp_path / "c0"))
        client.start()
        job = mock.job(id="templated")
        job.datacenters = [client.node.datacenter]
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "mock"
        task.config = {}
        task.artifacts = [
            TaskArtifact(
                getter_source=f"file://{artifact_src}", relative_dest="local/"
            )
        ]
        task.templates = [
            Template(
                source_path="local/app.conf.tpl",
                dest_path="local/app.conf",
                change_mode="restart",
                splay_s=0,
            )
        ]
        server.job_register(job)

        def running():
            return [
                a
                for a in server.state.allocs_by_job(job.namespace, job.id)
                if a.client_status == "running"
            ]

        assert wait_until(lambda: running(), 15)
        alloc = running()[0]
        runner = client.alloc_runners[alloc.id]
        tr = runner.task_runners[task.name]
        # the artifact-downloaded source lives in the task dir
        task_dir = os.path.join(runner.alloc_dir, task.name)
        rendered = os.path.join(task_dir, "local", "app.conf")
        assert wait_until(lambda: os.path.exists(rendered), 5)
        assert open(rendered).read() == "config-v1"
        restarts_before = tr.state.restarts

        # update the origin FIRST (the restart's artifact re-fetch must
        # see v2 — the reference's equivalent is Consul data changing),
        # then the in-place copy the watcher polls
        artifact_src.write_text("config-v2")
        with open(os.path.join(task_dir, "local", "app.conf.tpl"), "w") as f:
            f.write("config-v2")
        assert wait_until(
            lambda: tr.state.restarts > restarts_before, 10
        ), "template change should restart the task"
        assert wait_until(lambda: open(rendered).read() == "config-v2", 5)
        assert wait_until(lambda: tr.state.state == "running", 10)
    finally:
        if client is not None:
            client.shutdown()
        server.shutdown()


# ---------------------------------------------------------------------------
# Volume lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture
def server():
    s = Server(num_workers=2, scheduler_config=cpu_config())
    s.volume_watcher.poll_interval_s = 0.1
    s.establish_leadership()
    yield s
    s.shutdown()


def _vol(vol_id="shared-data", name="shared-data", access=None):
    return Volume(
        id=vol_id,
        name=name,
        type="host",
        path="/srv/data",
        access_mode=access or "multi-node-multi-writer",
    )


def _vol_job(job_id, source="shared-data", read_only=False, count=1):
    job = mock.job(id=job_id)
    tg = job.task_groups[0]
    tg.count = count
    tg.volumes = {
        "data": VolumeRequest(name="data", type="host", source=source,
                              read_only=read_only)
    }
    return job


def _vol_node():
    from nomad_tpu_torch.structs.structs import HostVolumeConfig

    n = mock.node()
    n.host_volumes["shared-data"] = HostVolumeConfig(
        name="shared-data", path="/srv/data"
    )
    return n


def test_volume_register_claim_release_lifecycle(server):
    node = _vol_node()
    server.node_register(node)
    server.volume_register(_vol())
    job = _vol_job("vol-user")
    server.job_register(job)
    assert server.wait_for_evals(10)

    vol = server.state.volume_by_id("default", "shared-data")
    assert len(vol.claims) == 1, "placement should claim the volume"
    claim = next(iter(vol.claims.values()))
    allocs = server.state.allocs_by_job(job.namespace, job.id)
    assert claim.alloc_id == allocs[0].id

    # deregister refuses while claimed
    with pytest.raises(ValueError, match="active claims"):
        server.volume_deregister("default", "shared-data")

    # stop the job: the volume watcher releases the claim
    server.job_deregister(job.namespace, job.id)
    server.wait_for_evals(10)
    assert wait_until(
        lambda: not server.state.volume_by_id("default", "shared-data").claims,
        10,
    ), "watcher should release claims of terminal allocs"
    server.volume_deregister("default", "shared-data")
    assert server.state.volume_by_id("default", "shared-data") is None


def test_single_writer_volume_blocks_second_writer(server):
    server.node_register(_vol_node())
    server.node_register(_vol_node())
    server.volume_register(_vol(access=VOLUME_ACCESS_SINGLE_WRITER))

    server.job_register(_vol_job("writer-1"))
    assert server.wait_for_evals(10)
    vol = server.state.volume_by_id("default", "shared-data")
    assert len(vol.write_claims()) == 1

    server.job_register(_vol_job("writer-2"))
    server.wait_for_evals(10)
    live2 = [
        a
        for a in server.state.allocs_by_job("default", "writer-2")
        if not a.terminal_status()
    ]
    assert live2 == [], "second writer must not place on a claimed volume"

    # read-only claims are fine alongside nothing-but-one-writer? No:
    # single-node-writer still allows readers
    server.job_register(_vol_job("reader-1", read_only=True))
    assert server.wait_for_evals(10)
    vol = server.state.volume_by_id("default", "shared-data")
    ro = [c for c in vol.claims.values() if c.read_only]
    assert len(ro) == 1

    # once the writer dies, the watcher releases its claim and the
    # release pokes blocked evals: writer-2 places and claims the volume
    server.job_deregister("default", "writer-1")
    server.wait_for_evals(10)

    def writer2_claimed():
        vol = server.state.volume_by_id("default", "shared-data")
        live2 = {
            a.id
            for a in server.state.allocs_by_job("default", "writer-2")
            if not a.terminal_status()
        }
        return any(
            c.alloc_id in live2 for c in vol.write_claims()
        )

    assert wait_until(writer2_claimed, 10), (
        "claim release should unblock and place the waiting writer"
    )


def test_volume_http_and_cli_surface(tmp_path):
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import NomadClient

    cfg = AgentConfig()

    cfg.device = "cpu"
    cfg.server_enabled = True
    cfg.client_enabled = False
    cfg.dev_mode = True
    cfg.http_port = 0
    cfg.data_dir = str(tmp_path)
    agent = Agent(cfg)
    agent.start()
    try:
        api = NomadClient(f"http://127.0.0.1:{agent.http_addr[1]}")
        api.volumes.register(_vol())
        vols = api.volumes.list()
        assert [v.id for v in vols] == ["shared-data"]
        got = api.volumes.get("shared-data")
        assert got.access_mode == "multi-node-multi-writer"
        api.volumes.deregister("shared-data")
        assert api.volumes.list() == []
    finally:
        agent.shutdown()


def test_claim_matches_the_allocs_node_volume(server):
    """Node-pinned volumes only serve allocs on their node: the claim must
    attach to the placement node's volume, not the first name match."""
    node = _vol_node()
    server.node_register(node)
    other = _vol(vol_id="data-other-node")
    other.node_id = "not-the-placement-node"
    server.volume_register(other)
    mine = _vol(vol_id="data-this-node")
    mine.node_id = node.id
    server.volume_register(mine)

    server.job_register(_vol_job("pinned-user"))
    assert server.wait_for_evals(10)
    assert not server.state.volume_by_id(
        "default", "data-other-node"
    ).claims, "claim must not attach to another node's volume"
    assert len(
        server.state.volume_by_id("default", "data-this-node").claims
    ) == 1


def test_single_writer_enforced_within_one_plan(server):
    """Two writers placed in the SAME plan must not both commit: the
    feasibility screen only sees committed claims, so the plan applier's
    volume admission is the backstop."""
    server.node_register(_vol_node())
    server.node_register(_vol_node())
    server.volume_register(_vol(access=VOLUME_ACCESS_SINGLE_WRITER))
    server.job_register(_vol_job("double-writer", count=2))
    server.wait_for_evals(10)

    vol = server.state.volume_by_id("default", "shared-data")
    assert len(vol.write_claims()) == 1, (
        f"exactly one writer may claim, got {len(vol.write_claims())}"
    )
    live = [
        a
        for a in server.state.allocs_by_job("default", "double-writer")
        if not a.terminal_status()
    ]
    assert len(live) == 1


def test_volume_register_rejects_bad_access_mode(server):
    with pytest.raises(ValueError, match="invalid access_mode"):
        server.volume_register(_vol(access="single-node-writer-typo"))
