"""``tests/test_exec_driver.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Native executor + exec driver + plugin boundary tests.

Reference analogs: drivers/shared/executor/executor_test.go,
drivers/exec/driver_test.go, plugins/drivers client/server tests.
"""

import os
import time

import pytest

from nomad_tpu_torch.drivers.base import TaskConfig, TaskHandle
from nomad_tpu_torch.drivers.exec import ExecDriver
from nomad_tpu_torch.drivers.executor import (
    ExecutorHandle,
    executor_binary,
    launch_executor,
)
from nomad_tpu_torch.drivers.plugin import ExternalDriver


class TestExecutor:
    def test_binary_builds_and_caches(self):
        p1 = executor_binary()
        p2 = executor_binary()
        assert p1 == p2 and os.path.exists(p1)

    def test_run_to_completion(self, tmp_path):
        h = launch_executor(
            str(tmp_path),
            "/bin/sh",
            ["-c", "echo out-line; echo err-line >&2; exit 3"],
            {"X": "1"},
            stdout_path=str(tmp_path / "stdout"),
            stderr_path=str(tmp_path / "stderr"),
        )
        res = h.wait(timeout_s=10)
        assert res["exit_code"] == 3
        assert "out-line" in (tmp_path / "stdout").read_text()
        assert "err-line" in (tmp_path / "stderr").read_text()
        h.shutdown()

    def test_env_passed(self, tmp_path):
        h = launch_executor(
            str(tmp_path),
            "/bin/sh",
            ["-c", 'echo "V=$MYVAR"'],
            {"MYVAR": "hello42"},
            stdout_path=str(tmp_path / "stdout"),
        )
        h.wait(timeout_s=10)
        assert "V=hello42" in (tmp_path / "stdout").read_text()
        h.shutdown()

    def test_stop_grace_then_kill(self, tmp_path):
        # process ignores TERM; must be SIGKILLed after grace
        h = launch_executor(
            str(tmp_path),
            "/bin/sh",
            ["-c", "trap '' TERM; sleep 60"],
            {},
        )
        time.sleep(0.3)
        t0 = time.monotonic()
        h.stop(grace_s=0.5)
        res = h.wait(timeout_s=10)
        elapsed = time.monotonic() - t0
        assert res["state"] == "exited"
        assert res["signal"] == 9, "should have been SIGKILLed"
        assert elapsed < 8
        h.shutdown()

    def test_signal_forwarding(self, tmp_path):
        h = launch_executor(
            str(tmp_path),
            "/bin/sh",
            ["-c", "trap 'exit 42' USR1; while true; do sleep 0.1; done"],
            {},
        )
        time.sleep(0.3)
        h.signal(10)  # SIGUSR1
        res = h.wait(timeout_s=10)
        assert res["exit_code"] == 42
        h.shutdown()

    def test_reattach_after_launcher_death(self, tmp_path):
        """The supervisor daemonizes: a NEW handle (fresh process state)
        can reconnect and control the task."""
        h = launch_executor(str(tmp_path), "/bin/sleep", ["30"], {})
        sock = h.socket_path
        del h  # launcher-side state gone
        h2 = ExecutorHandle(sock)
        assert h2.status()["state"] == "running"
        h2.stop(grace_s=1)
        assert h2.wait(10)["state"] == "exited"
        h2.shutdown()

    def test_stats(self, tmp_path):
        h = launch_executor(
            str(tmp_path),
            "/bin/sh",
            ["-c", "while true; do :; done"],
            {},
        )
        time.sleep(0.5)
        s = h.stats()
        assert s["rss_bytes"] > 0
        h.stop(grace_s=0.2)
        h.wait(10)
        h.shutdown()


def _cfg(tmp_path, task_id, command, args, **kw):
    d = tmp_path / task_id.replace("/", "_")
    d.mkdir(parents=True, exist_ok=True)
    return TaskConfig(
        id=task_id,
        name="t",
        alloc_id="a1",
        config={"command": command, "args": args, **kw.pop("config", {})},
        env=kw.pop("env", {}),
        task_dir=str(d),
        stdout_path=str(d / "stdout"),
        stderr_path=str(d / "stderr"),
        **kw,
    )


class TestExecDriver:
    def test_fingerprint(self):
        fp = ExecDriver().fingerprint()
        assert fp.attributes.get("driver.exec") == "1"

    def test_lifecycle(self, tmp_path):
        d = ExecDriver()
        cfg = _cfg(tmp_path, "a1/t1", "/bin/sh", ["-c", "echo hi; exit 0"])
        handle = d.start_task(cfg)
        assert handle.state["socket_path"]
        res = d.wait_task("a1/t1", timeout_s=10)
        assert res.exit_code == 0
        status = d.inspect_task("a1/t1")
        assert status.state == "exited"
        d.destroy_task("a1/t1", force=True)

    def test_recover(self, tmp_path):
        d = ExecDriver()
        cfg = _cfg(tmp_path, "a1/t2", "/bin/sleep", ["30"])
        handle = d.start_task(cfg)
        # simulate client restart: fresh driver instance + stored handle
        d2 = ExecDriver()
        d2.recover_task(TaskHandle.from_dict(handle.to_dict()))
        st = d2.inspect_task("a1/t2")
        assert st.state == "running"
        d2.stop_task("a1/t2", timeout_s=1)
        d2.destroy_task("a1/t2", force=True)

    def test_stats(self, tmp_path):
        d = ExecDriver()
        _ = d.start_task(
            _cfg(tmp_path, "a1/t3", "/bin/sleep", ["5"])
        )
        time.sleep(0.3)
        stats = d.task_stats("a1/t3")
        assert stats["memory_rss_bytes"] >= 0
        d.stop_task("a1/t3", timeout_s=1)
        d.destroy_task("a1/t3", force=True)


class TestPluginBoundary:
    def test_external_driver_lifecycle(self, tmp_path):
        ext = ExternalDriver("rawexec", "nomad_tpu_torch.drivers.rawexec:RawExecDriver")
        try:
            fp = ext.fingerprint()
            assert fp.attributes.get("driver.rawexec") == "1"
            cfg = _cfg(tmp_path, "a9/t1", "/bin/sh", ["-c", "echo plugged; exit 5"])
            handle = ext.start_task(cfg)
            assert handle.task_id == "a9/t1"
            res = ext.wait_task("a9/t1", timeout_s=10)
            assert res.exit_code == 5
            assert "plugged" in (tmp_path / "a9_t1" / "stdout").read_text()
            ext.destroy_task("a9/t1", force=True)
        finally:
            ext.shutdown_plugin()

    def test_plugin_dies_with_parent_stdin(self, tmp_path):
        ext = ExternalDriver("mock", "nomad_tpu_torch.drivers.mock:MockDriver")
        try:
            ext.fingerprint()
            proc = ext._proc._proc  # the launcher's subprocess handle
            assert proc.poll() is None
        finally:
            ext.shutdown_plugin()
        assert proc.poll() is not None, "plugin should exit when stdin closes"


def test_chroot_env_isolates_filesystem(tmp_path):
    """chroot_env materializes a root fs into the task dir and the task
    runs chrooted into it (reference: exec's libcontainer chroot)."""
    import subprocess

    if os.geteuid() != 0:
        pytest.skip("chroot needs root")
    # what /bin/sh needs, discovered from the loader
    ldd = subprocess.run(
        ["ldd", "/bin/sh"], capture_output=True, text=True
    ).stdout
    libs = [tok for tok in ldd.split() if tok.startswith("/")]
    # map REAL files onto the canonical paths the loader expects —
    # /bin/sh and the libs are typically symlink chains on the host
    chroot_env = {os.path.realpath(p): p for p in libs}
    chroot_env[os.path.realpath("/bin/sh")] = "/bin/sh"

    from nomad_tpu_torch.drivers.base import TaskConfig
    from nomad_tpu_torch.drivers.exec import ExecDriver

    task_dir = tmp_path / "task"
    task_dir.mkdir()
    logs = tmp_path / "logs"
    logs.mkdir()
    # chroot_env is OPERATOR config on the driver, never jobspec config
    d = ExecDriver(chroot_env=chroot_env)
    cfg = TaskConfig(
        id="chroot1",
        name="t",
        config={
            "command": "/bin/sh",
            "args": [
                "-c",
                "pwd > /result.txt; "
                "test -e /root && echo HOST-LEAK >> /result.txt; "
                "echo done >> /result.txt",
            ],
        },
        task_dir=str(task_dir),
        stdout_path=str(logs / "out.log"),
        stderr_path=str(logs / "err.log"),
        resources_memory_mb=64,
    )
    d.start_task(cfg)
    res = d.wait_task("chroot1", timeout_s=20)
    assert res is not None and res.exit_code == 0, (
        res,
        (logs / "err.log").read_text()
        if (logs / "err.log").exists()
        else "",
    )
    # the task's / was the task dir: result.txt landed there
    out = (task_dir / "result.txt").read_text()
    assert out.splitlines()[0] == "/"
    assert "HOST-LEAK" not in out, "host fs must not be visible"
    assert "done" in out
    d.destroy_task("chroot1", force=True)


def test_chroot_env_rejects_traversal(tmp_path):
    """A job-controlled dst escaping the chroot must be refused — this
    walk runs as root (allocdir.build_chroot confinement)."""
    from nomad_tpu_torch.client.allocdir import EscapeError, build_chroot

    victim = tmp_path / "victim"
    with pytest.raises(EscapeError):
        build_chroot(
            str(tmp_path / "jail"),
            {"/etc/hostname": f"../victim"},
        )
    assert not victim.exists()
