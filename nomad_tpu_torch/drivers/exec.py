"""Exec driver: isolated execution via the native C++ executor.

Port of ``nomad_tpu/drivers/exec.py``.

Reference: drivers/exec (852 LoC) — fork/exec under the shared executor
with cgroup isolation (libcontainer there; cgroup v2 best-effort here —
full namespace isolation needs root and is gated the same way the
reference gates on Linux capabilities). The executor daemonizes, so
tasks survive client-agent restarts and `recover_task` reconnects to the
executor's unix socket (reference RecoverTask → ReattachConfig).

Config keys: command (required), args, cgroup_v2 (bool, default auto).
"""

from __future__ import annotations

import os
import signal as _signal
import threading
from pathlib import Path
from typing import Any, Optional

from ..structs import now_ns
from .base import (
    TASK_STATE_EXITED,
    TASK_STATE_RUNNING,
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)
from .executor import ExecutorError, ExecutorHandle, executor_binary, launch_executor

CGROUP_ROOT = "/sys/fs/cgroup"


def _cgroup_available() -> bool:
    path = Path(CGROUP_ROOT)
    return (path / "cgroup.controllers").exists() and os.access(
        CGROUP_ROOT, os.W_OK
    )


class _ExecTask:
    def __init__(self, cfg: TaskConfig, handle: ExecutorHandle):
        self.cfg = cfg
        self.handle = handle


class ExecDriver(Driver):
    name = "exec"

    def __init__(self, chroot_env=None) -> None:
        # operator-configured {host_src: dst} chroot map (agent config)
        self.chroot_env = dict(chroot_env or {})
        self.tasks: dict[str, _ExecTask] = {}
        self._lock = threading.Lock()

    def fingerprint(self) -> Fingerprint:
        try:
            executor_binary()
        except ExecutorError as e:
            return Fingerprint(
                attributes={},
                health="unhealthy",
                health_description=str(e),
            )
        return Fingerprint(
            attributes={
                "driver.exec": "1",
                "driver.exec.cgroups": "1" if _cgroup_available() else "0",
            }
        )

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        from .configspec import EXEC_SPEC

        conf = EXEC_SPEC.validate(cfg.config, "exec")
        chroot = ""
        if self.chroot_env:
            # chroot sources are OPERATOR config (constructor), never
            # jobspec config — a job-chosen source map would let any
            # submitter hard-link arbitrary host files (/etc/shadow)
            # into a root-owned chroot. Reference: chroot_env is client
            # agent config for exactly this reason.
            if os.geteuid() != 0:
                raise DriverError(
                    "exec: chroot_env is configured but the agent is "
                    "not root — refusing to run without the requested "
                    "isolation"
                )
            from ..client.allocdir import build_chroot

            build_chroot(cfg.task_dir, self.chroot_env)
            chroot = cfg.task_dir
        command = conf.get("command")
        if not command:
            raise DriverError("exec: missing 'command' in task config")
        args = [str(a) for a in conf.get("args", [])]
        cgroup = ""
        if conf.get("cgroup_v2", True) and _cgroup_available():
            cgroup = f"{CGROUP_ROOT}/nomad-tpu-{cfg.id.replace('/', '-')}"
        try:
            handle = launch_executor(
                task_dir=cfg.task_dir or "/tmp",
                command=command,
                args=args,
                env=cfg.env,
                stdout_path=cfg.stdout_path,
                stderr_path=cfg.stderr_path,
                cwd="/" if chroot else cfg.task_dir,
                chroot=chroot,
                user=cfg.user,
                cgroup=cgroup,
                memory_max_bytes=(
                    cfg.resources_memory_max_mb or cfg.resources_memory_mb
                ) * 1024 * 1024,
                # cgroup v2 cpu.weight range 1..10000; map MHz shares
                cpu_weight=min(10000, max(1, cfg.resources_cpu // 10)) if cfg.resources_cpu else 0,
                cores=cfg.reserved_cores,
                # the executor enters the netns before chroot/privdrop
                netns=cfg.network_ns,
            )
        except ExecutorError as e:
            raise DriverError(f"exec: {e}") from e
        with self._lock:
            self.tasks[cfg.id] = _ExecTask(cfg, handle)
        return TaskHandle(
            cfg.id,
            self.name,
            {
                "socket_path": handle.socket_path,
                "daemon_pid": handle.daemon_pid,
                "task_name": cfg.name,
            },
        )

    def wait_task(
        self, task_id: str, timeout_s: Optional[float] = None
    ) -> Optional[ExitResult]:
        task = self._get(task_id)
        res = task.handle.wait(timeout_s=timeout_s)
        if res is None:
            return None
        return ExitResult(
            exit_code=res.get("exit_code", 0), signal=res.get("signal", 0)
        )

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        task = self._get(task_id)
        signo = (
            int(getattr(_signal, signal))
            if signal and hasattr(_signal, signal)
            else _signal.SIGTERM
        )
        try:
            task.handle.stop(grace_s=timeout_s, signo=int(signo))
            task.handle.wait(timeout_s=timeout_s + 5)
        except (ExecutorError, OSError):
            pass

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return
        try:
            st = task.handle.status()
            if st.get("state") == "running":
                if not force:
                    raise DriverError("task still running")
                self.stop_task(task_id, timeout_s=2)
        except (ExecutorError, OSError):
            pass
        # ALWAYS attempt the supervisor shutdown — a failed status probe
        # must not leave the daemonized supervisor listening forever
        try:
            task.handle.shutdown()
        except (ExecutorError, OSError):
            pass
        with self._lock:
            self.tasks.pop(task_id, None)

    def inspect_task(self, task_id: str) -> TaskStatus:
        task = self._get(task_id)
        try:
            st = task.handle.status()
        except (ExecutorError, OSError):
            return TaskStatus(id=task_id, state="unknown")
        running = st.get("state") == "running"
        return TaskStatus(
            id=task_id,
            name=task.cfg.name,
            state=TASK_STATE_RUNNING if running else TASK_STATE_EXITED,
            started_at_ns=st.get("start_ns", 0),
            completed_at_ns=st.get("end_ns", 0),
            exit_result=None
            if running
            else ExitResult(
                exit_code=st.get("exit_code", 0), signal=st.get("signal", 0)
            ),
        )

    def task_stats(self, task_id: str) -> dict[str, Any]:
        task = self._get(task_id)
        try:
            s = task.handle.stats()
        except (ExecutorError, OSError):
            return {}
        hz = s.get("hz", 100) or 100
        return {
            "cpu_user_s": s.get("utime_ticks", 0) / hz,
            "cpu_system_s": s.get("stime_ticks", 0) / hz,
            "memory_rss_bytes": s.get("rss_bytes", 0),
            "memory_cgroup_bytes": s.get("cgroup_mem_bytes", -1),
        }

    def signal_task(self, task_id: str, signal: str) -> None:
        task = self._get(task_id)
        sig = getattr(_signal, signal, None)
        if sig is None:
            raise DriverError(f"unknown signal {signal}")
        task.handle.signal(int(sig))

    def exec_task_streaming(self, task_id: str, cmd: list[str], tty: bool = False):
        task = self._get(task_id)
        try:
            return task.handle.exec_stream(cmd, tty=tty)
        except (ExecutorError, OSError) as e:
            raise DriverError(f"exec: {e}") from e

    def exec_task(
        self, task_id: str, cmd: list[str], timeout_s: float = 30.0
    ) -> tuple[bytes, int]:
        """One-shot exec: run, collect output until EOF.

        The raw bridge carries no exit-status trailer, so the command is
        wrapped to append one (stripped before returning)."""
        import re as _re
        import shlex as _shlex
        import time as _time

        wrapped = [
            "/bin/sh",
            "-c",
            _shlex.join(cmd) + '; printf "\\n__NOMAD_EXIT:%d\\n" $?',
        ]
        sock = self.exec_task_streaming(task_id, wrapped, tty=False)
        out = b""
        sock.settimeout(timeout_s)
        deadline = _time.monotonic() + timeout_s
        timed_out = True
        try:
            while _time.monotonic() < deadline:
                try:
                    chunk = sock.recv(65536)
                except TimeoutError:
                    # socket.timeout: the deadline elapsed mid-recv. Must
                    # stay timed_out=True — it is an OSError subclass, and
                    # catching it below misreported timeouts as exit -1.
                    break
                except OSError:
                    timed_out = False
                    break
                if not chunk:
                    timed_out = False
                    break
                out += chunk
        finally:
            sock.close()
        m = _re.search(rb"\n__NOMAD_EXIT:(\d+)\n", out)
        if m:
            return out[: m.start()], int(m.group(1))
        return out, 124 if timed_out else -1

    def recover_task(self, handle: TaskHandle) -> None:
        """Reconnect to the surviving executor daemon."""
        sock = handle.state.get("socket_path")
        if not sock:
            raise DriverError("no socket_path in handle")
        eh = ExecutorHandle(sock, handle.state.get("daemon_pid", 0))
        if not eh.alive():
            raise DriverError("executor is gone")
        cfg = TaskConfig(id=handle.task_id, name=handle.state.get("task_name", ""))
        with self._lock:
            self.tasks[handle.task_id] = _ExecTask(cfg, eh)

    def _get(self, task_id: str) -> _ExecTask:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            raise DriverError(f"unknown task {task_id}")
        return task
