"""``tests/test_client_state.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Client execution plane: state DB, allocdir, taskenv, artifacts,
templates, logmon, and restart/reattach.

Reference analogs: client/state/state_database_test.go,
client/allocdir tests, client/taskenv/env_test.go, getter tests,
template tests, and the restore path in client/client_test.go.
"""

import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ServerRPC
from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.getter import ArtifactError, fetch_artifact
from nomad_tpu_torch.client.logmon import LogRotator
from nomad_tpu_torch.client.state_db import StateDB
from nomad_tpu_torch.client.taskenv import build_env, interpolate
from nomad_tpu_torch.client.template import TemplateError, render_template
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.structs import TaskState
from nomad_tpu_torch.structs.structs import TaskArtifact, Template
from nomad_tpu_torch.scheduler.context import SchedulerConfig


def cpu_config() -> SchedulerConfig:
    """The reference's default scheduler backend, on the CPU."""
    return SchedulerConfig(backend="host", device="cpu")


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestStateDB:
    def test_alloc_roundtrip(self, tmp_path):
        db = StateDB(str(tmp_path))
        alloc = mock.alloc()
        db.put_alloc(alloc)
        got = db.get_allocs()
        assert len(got) == 1 and got[0].id == alloc.id
        db.delete_alloc(alloc.id)
        assert db.get_allocs() == []
        db.close()

    def test_task_state_and_handles(self, tmp_path):
        db = StateDB(str(tmp_path))
        db.put_task_state("a1", "web", TaskState(state="running"))
        db.put_task_handle("a1", "web", {"task_id": "x", "driver": "exec", "state": {"pid": 42}})
        assert db.get_task_states("a1")["web"].state == "running"
        assert db.get_task_handle("a1", "web")["state"]["pid"] == 42
        db.delete_alloc("a1")
        assert db.get_task_states("a1") == {}
        db.close()

    def test_survives_reopen(self, tmp_path):
        db = StateDB(str(tmp_path))
        alloc = mock.alloc()
        db.put_alloc(alloc)
        db.put_meta("node_id", "n-123")
        db.close()
        db2 = StateDB(str(tmp_path))
        assert db2.get_allocs()[0].id == alloc.id
        assert db2.get_meta("node_id") == "n-123"
        db2.close()

    def test_writes_after_close_dropped(self, tmp_path):
        db = StateDB(str(tmp_path))
        db.close()
        db.put_task_state("a", "t", TaskState())  # must not raise


class TestAllocDir:
    def test_tree(self, tmp_path):
        ad = AllocDir(str(tmp_path), "alloc-1")
        ad.build()
        td = ad.build_task_dir("web")
        for d in (ad.logs_dir, ad.data_dir, td.local_dir, td.secrets_dir):
            assert os.path.isdir(d)
        assert oct(os.stat(td.secrets_dir).st_mode & 0o777) == "0o700"
        ad.destroy()
        assert not os.path.exists(ad.alloc_dir)


class TestTaskEnv:
    def _env(self):
        node = mock.node()
        job = mock.job()
        job.meta = {"tier": "gold"}
        alloc = mock.alloc(job_=job, node_=node)
        task = job.task_groups[0].tasks[0]
        task.meta = {"owner": "web-team"}
        task.env = {"MY_DC": "${node.datacenter}"}
        return build_env(alloc, task, node=node, alloc_dir="/a", task_dir="/t", secrets_dir="/s"), alloc, node

    def test_core_vars(self):
        env, alloc, node = self._env()
        assert env["NOMAD_ALLOC_ID"] == alloc.id
        assert env["NOMAD_TASK_DIR"] == "/t"
        assert env["NOMAD_META_TIER"] == "gold"
        assert env["NOMAD_META_OWNER"] == "web-team"
        assert env["NOMAD_DC"] == node.datacenter
        # user env interpolation against node attrs
        assert env["MY_DC"] == node.datacenter

    def test_interpolate(self):
        env = {"NOMAD_PORT_http": "8080", "attr.cpu.arch": "amd64"}
        assert interpolate("-p ${NOMAD_PORT_http}", env) == "-p 8080"
        assert interpolate(["${attr.cpu.arch}"], env) == ["amd64"]
        assert interpolate("${unknown.thing}", env) == "${unknown.thing}"


class TestGetter:
    def test_file_artifact(self, tmp_path):
        src = tmp_path / "payload.txt"
        src.write_text("data!")
        task_dir = tmp_path / "task"
        art = TaskArtifact(getter_source=str(src), relative_dest="local/")
        fetch_artifact(art, str(task_dir))
        assert (task_dir / "local" / "payload.txt").read_text() == "data!"

    def test_archive_unpacked(self, tmp_path):
        import tarfile

        content = tmp_path / "inner.txt"
        content.write_text("inner")
        tar = tmp_path / "bundle.tar.gz"
        with tarfile.open(tar, "w:gz") as tf:
            tf.add(content, arcname="inner.txt")
        task_dir = tmp_path / "task"
        art = TaskArtifact(getter_source=str(tar), relative_dest="local/")
        fetch_artifact(art, str(task_dir))
        assert (task_dir / "local" / "inner.txt").read_text() == "inner"
        assert not (task_dir / "local" / "bundle.tar.gz").exists()

    def test_checksum(self, tmp_path):
        import hashlib

        src = tmp_path / "f.bin"
        src.write_bytes(b"abc")
        good = hashlib.sha256(b"abc").hexdigest()
        art = TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": f"sha256:{good}"},
        )
        fetch_artifact(art, str(tmp_path / "t1"))
        bad = TaskArtifact(
            getter_source=str(src),
            getter_options={"checksum": "sha256:" + "0" * 64},
        )
        with pytest.raises(ArtifactError, match="checksum"):
            fetch_artifact(bad, str(tmp_path / "t2"))

    def test_missing_artifact(self, tmp_path):
        art = TaskArtifact(getter_source="/does/not/exist")
        with pytest.raises(ArtifactError):
            fetch_artifact(art, str(tmp_path))


class TestTemplate:
    def test_render_env_function(self, tmp_path):
        tmpl = Template(
            embedded_tmpl='port={{ env "NOMAD_PORT_http" }} meta={{ meta "tier" }}\naddr=${NOMAD_ALLOC_ID}\n',
            dest_path="local/app.conf",
        )
        env = {
            "NOMAD_PORT_http": "8080",
            "NOMAD_META_tier": "gold",
            "NOMAD_ALLOC_ID": "aaa",
        }
        dest = render_template(tmpl, str(tmp_path), env)
        text = open(dest).read()
        assert "port=8080" in text
        assert "meta=gold" in text
        assert "addr=aaa" in text

    def test_perms(self, tmp_path):
        tmpl = Template(
            embedded_tmpl="secret", dest_path="secrets/s.txt", perms="0600"
        )
        dest = render_template(tmpl, str(tmp_path), {})
        assert oct(os.stat(dest).st_mode & 0o777) == "0o600"


class TestLogRotation:
    def test_copytruncate(self, tmp_path):
        live = tmp_path / "web.stdout.0"
        live.write_bytes(b"x" * 2048)
        rot = LogRotator(str(live), max_files=3, max_file_size_mb=1)
        rot.max_bytes = 1024  # shrink for the test
        assert rot.rotate_if_needed()
        assert live.stat().st_size == 0
        assert (tmp_path / "web.stdout.1").stat().st_size == 2048
        # second rotation shifts
        live.write_bytes(b"y" * 2048)
        assert rot.rotate_if_needed()
        assert (tmp_path / "web.stdout.1").read_bytes()[0:1] == b"y"
        assert (tmp_path / "web.stdout.2").read_bytes()[0:1] == b"x"


class TestRestartReattach:
    def test_client_restart_reattaches_exec_task(self, tmp_path):
        """Full restart semantics: client dies (not killing tasks), a new
        client restores from the state DB and reattaches to the live
        native-executor task (reference client restore + RecoverTask)."""
        server = Server(num_workers=1, scheduler_config=cpu_config())
        server.establish_leadership()
        data_dir = str(tmp_path / "client")
        c1 = Client(ServerRPC(server), data_dir=data_dir)
        c1.start()
        assert c1.wait_registered(10)

        job = mock.job(id="reattach-job")
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "exec"
        task.config = {"command": "/bin/sleep", "args": ["120"]}
        job.datacenters = [c1.node.datacenter]
        server.job_register(job)
        # Event-driven (testing/waits.py): the transitions waited on
        # here are store writes, so the broker wakes the check the
        # moment they land — a fixed-cadence poll on a loaded 2-CPU box
        # burns the very CPU the exec task needs to start (the
        # repeat-offender load flake in this test).
        from nomad_tpu_torch.testing.waits import wait_for_state

        assert wait_for_state(
            [server],
            lambda: any(
                a.client_status == "running"
                for a in server.state.allocs_by_job(job.namespace, job.id)
            ),
            timeout_s=30,
        )
        alloc = server.state.allocs_by_job(job.namespace, job.id)[0]
        handle = c1.state_db.get_task_handle(alloc.id, task.name)
        assert handle is not None and handle["state"]["socket_path"]

        # agent restart: stop WITHOUT killing allocs
        c1.shutdown(kill_allocs=False)

        c2 = Client(ServerRPC(server), data_dir=data_dir)
        assert c2.node.id == c1.node.id, "node identity must persist"
        c2.start()
        # the restore publishes alloc updates through the same store;
        # the fallback re-check covers the client-local runner state
        # that writes no event
        assert wait_for_state(
            [server],
            lambda: alloc.id in c2.alloc_runners
            and c2.alloc_runners[alloc.id].alloc.client_status
            == "running",
            timeout_s=30,
            fallback_interval_s=0.3,
        ), "restored alloc should be running again via reattach"
        tr = c2.alloc_runners[alloc.id].task_runners[task.name]
        assert any(
            e["type"] == "Restored" for e in tr.state.events
        ), "task must have reattached, not restarted"
        c2.shutdown()  # kills the task this time
        server.shutdown()
        # the reattached task outlives c2's shutdown in this one process,
        # as in nomad_tpu's client: end it and its executor
        from nomad_tpu_torch.drivers.executor import ExecutorHandle

        eh = ExecutorHandle(handle["state"]["socket_path"])
        if eh.alive():
            eh.stop(grace_s=1)
            eh.shutdown()


class TestSandbox:
    """Job-controlled paths are confined to the alloc dir (upstream had
    CVEs for both template path escapes and go-getter dest escapes)."""

    def _tree(self, tmp_path):
        alloc_dir = tmp_path / "allocs" / "a1"
        task_dir = alloc_dir / "web"
        task_dir.mkdir(parents=True)
        return alloc_dir, task_dir

    def test_template_dest_escape_rejected(self, tmp_path):
        _, task_dir = self._tree(tmp_path)
        victim = tmp_path / "victim.txt"
        for dest in (str(victim), "../../victim.txt"):
            tmpl = Template(embedded_tmpl="owned", dest_path=dest)
            with pytest.raises(TemplateError, match="escapes"):
                render_template(tmpl, str(task_dir), {})
        assert not victim.exists()

    def test_template_source_escape_rejected(self, tmp_path):
        _, task_dir = self._tree(tmp_path)
        secret = tmp_path / "host-secret"
        secret.write_text("root:*")
        tmpl = Template(
            source_path="../../host-secret", dest_path="local/out"
        )
        with pytest.raises(TemplateError, match="escapes"):
            render_template(tmpl, str(task_dir), {})

    def test_template_shared_alloc_dir_allowed(self, tmp_path):
        alloc_dir, task_dir = self._tree(tmp_path)
        tmpl = Template(embedded_tmpl="ok", dest_path="../alloc/data/x")
        (alloc_dir / "alloc" / "data").mkdir(parents=True)
        dest = render_template(tmpl, str(task_dir), {})
        assert open(dest).read() == "ok"

    def test_artifact_dest_escape_rejected(self, tmp_path):
        _, task_dir = self._tree(tmp_path)
        src = tmp_path / "p.txt"
        src.write_text("x")
        art = TaskArtifact(
            getter_source=str(src), relative_dest="../../escaped/"
        )
        with pytest.raises(ArtifactError, match="escapes"):
            fetch_artifact(art, str(task_dir))

    def test_file_artifacts_gated(self, tmp_path, monkeypatch):
        _, task_dir = self._tree(tmp_path)
        src = tmp_path / "p.txt"
        src.write_text("x")
        art = TaskArtifact(getter_source=str(src), relative_dest="local/")
        monkeypatch.setenv("NOMAD_TPU_ARTIFACT_ALLOW_FILE", "0")
        with pytest.raises(ArtifactError, match="disabled"):
            fetch_artifact(art, str(task_dir))

    def test_tar_traversal_blocked(self, tmp_path):
        import io
        import tarfile

        _, task_dir = self._tree(tmp_path)
        evil = tmp_path / "evil.tar.gz"
        with tarfile.open(evil, "w:gz") as tf:
            info = tarfile.TarInfo("../../../../pwned.txt")
            data = b"owned"
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        art = TaskArtifact(getter_source=str(evil), relative_dest="local/")
        with pytest.raises(ArtifactError, match="unsafe archive"):
            fetch_artifact(art, str(task_dir))
        assert not (tmp_path / "pwned.txt").exists()


class TestSpecEscaping:
    """Executor spec values are job-controlled; newlines/tabs must not
    inject spec directives (drivers/executor.py _esc)."""

    def test_env_newline_does_not_inject(self, tmp_path):
        from nomad_tpu_torch.drivers.executor import launch_executor

        task_dir = tmp_path / "t"
        out = tmp_path / "out.txt"
        evil_dest = tmp_path / "injected.txt"
        h = launch_executor(
            task_dir=str(task_dir),
            command="/bin/sh",
            args=["-c", "printf '%s' \"$EVIL\" > " + str(out)],
            env={"EVIL": f"x\nstdout\t{evil_dest}"},
        )
        res = h.wait(timeout_s=10)
        assert res is not None and res.get("exit_code") == 0
        h.shutdown()
        assert not evil_dest.exists()
        assert out.read_text() == f"x\nstdout\t{evil_dest}"

    def test_socket_path_short_under_deep_tmp(self, tmp_path):
        from nomad_tpu_torch.drivers.executor import _socket_path

        deep = tmp_path / ("d" * 50) / ("e" * 50) / ("f" * 50)
        sock = _socket_path(str(deep))
        assert len(sock) <= 100
