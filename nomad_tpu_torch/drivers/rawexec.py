"""Raw fork/exec driver: real processes, no isolation.

Port of ``nomad_tpu/drivers/rawexec.py``.

Reference: drivers/rawexec (703 LoC). Config keys:
  command   executable path (required)
  args      list of arguments
The process group is killed on stop so children don't leak. Reattach after
a client restart works via the pid recorded in the handle (reference:
rawexec recoverTask using the executor reattach config).
"""

from __future__ import annotations

import os
import signal as _signal
import subprocess
import threading
import time
from typing import Any, Optional

from ..structs import now_ns
from .base import (
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
    TASK_STATE_EXITED,
    TASK_STATE_RUNNING,
)


def _pin_cores(pid: int, cores: list) -> None:
    """Parent-side affinity pin for scheduler-granted dedicated cores
    (reference: cpuset cgroup via LinuxResources.CpusetCpus). Runs
    immediately after spawn — NOT via preexec_fn, which executes Python
    between fork and exec in this heavily threaded process (documented
    deadlock hazard). The window before the pin is microseconds; tasks
    needing fork-safe pinning from the first instruction use the exec
    driver, whose C++ supervisor pins in the child natively.
    Best-effort: an out-of-range id (host shrank) must not fail the
    start."""
    try:
        os.sched_setaffinity(pid, {int(c) for c in cores})
    except (OSError, AttributeError, ValueError):
        import logging

        logging.getLogger("nomad_tpu_torch.drivers").warning(
            "could not pin pid %d to cores %s", pid, cores
        )



class _RawTask:
    def __init__(self, cfg: TaskConfig, proc: subprocess.Popen):
        self.cfg = cfg
        self.proc = proc
        self.started_at = now_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self._waiter = threading.Thread(
            target=self._wait, name="rawexec-waiter", daemon=True
        )
        self._waiter.start()

    def _wait(self) -> None:
        code = self.proc.wait()
        self.completed_at = now_ns()
        if code < 0:
            self.exit_result = ExitResult(exit_code=128 - code, signal=-code)
        else:
            self.exit_result = ExitResult(exit_code=code)
        self.done.set()


def _spawn_streaming(cmd: list[str], tty: bool):
    """Un-contained streaming exec: subprocess over a socketpair (or a
    pty when tty=True); returns the caller's socket end."""
    import socket as _socket

    if tty:
        import pty as _pty

        pid, master = _pty.fork()
        if pid == 0:
            try:
                os.execvp(cmd[0], cmd)
            finally:
                os._exit(127)
        # a pty master is not a socket: bridge it onto a socketpair
        parent, inner = _socket.socketpair()

        def _pump_out():
            try:
                while True:
                    data = os.read(master, 4096)
                    if not data:
                        break
                    inner.sendall(data)
            except OSError:
                pass
            finally:
                try:
                    inner.shutdown(_socket.SHUT_WR)
                except OSError:
                    pass
                try:
                    os.waitpid(pid, 0)  # reap: no zombie per exec
                except OSError:
                    pass

        def _pump_in():
            try:
                while True:
                    data = inner.recv(4096)
                    if not data:
                        break
                    os.write(master, data)
            except OSError:
                pass
            finally:
                try:
                    os.close(master)
                except OSError:
                    pass

        threading.Thread(
            target=_pump_out, name="exec-pty-out", daemon=True
        ).start()
        threading.Thread(
            target=_pump_in, name="exec-pty-in", daemon=True
        ).start()
        return parent
    parent, child = _socket.socketpair()
    try:
        proc = subprocess.Popen(
            cmd,
            stdin=child,
            stdout=child,
            stderr=child,
            start_new_session=True,
        )
    except OSError as e:
        parent.close()
        raise DriverError(f"exec spawn: {e}") from e
    finally:
        child.close()
    # reap in the background so exec children never pile up as zombies
    threading.Thread(
        target=proc.wait, name="exec-reaper", daemon=True
    ).start()
    return parent


class RawExecDriver(Driver):
    name = "rawexec"

    def __init__(self) -> None:
        self.tasks: dict[str, _RawTask] = {}
        self._lock = threading.Lock()

    def fingerprint(self) -> Fingerprint:
        return Fingerprint(attributes={"driver.rawexec": "1"})

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        from .configspec import RAWEXEC_SPEC

        conf = RAWEXEC_SPEC.validate(cfg.config, "rawexec")
        command = conf.get("command")
        if not command:
            raise DriverError("rawexec: missing 'command' in task config")
        args = [str(a) for a in conf.get("args", [])]
        stdout = open(cfg.stdout_path, "ab") if cfg.stdout_path else subprocess.DEVNULL
        stderr = open(cfg.stderr_path, "ab") if cfg.stderr_path else subprocess.DEVNULL
        env = dict(os.environ)
        env.update(cfg.env)
        argv = [command] + args
        if cfg.network_ns:
            # bridge mode: run inside the alloc's network namespace
            argv = ["nsenter", f"--net={cfg.network_ns}", "--"] + argv
        try:
            proc = subprocess.Popen(
                argv,
                stdout=stdout,
                stderr=stderr,
                env=env,
                cwd=cfg.task_dir or None,
                start_new_session=True,  # own process group for clean kill
            )
        except OSError as e:
            raise DriverError(f"rawexec: failed to start: {e}") from e
        finally:
            for f in (stdout, stderr):
                if hasattr(f, "close"):
                    f.close()
        if cfg.reserved_cores:
            _pin_cores(proc.pid, cfg.reserved_cores)
        task = _RawTask(cfg, proc)
        with self._lock:
            self.tasks[cfg.id] = task
        return TaskHandle(cfg.id, self.name, {"pid": proc.pid})

    def wait_task(self, task_id: str, timeout_s: Optional[float] = None) -> Optional[ExitResult]:
        task = self._get(task_id)
        if not task.done.wait(timeout_s):
            return None
        return task.exit_result

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        task = self._get(task_id)
        if task.done.is_set():
            return
        sig = getattr(_signal, signal, _signal.SIGTERM) if signal else _signal.SIGTERM
        try:
            os.killpg(os.getpgid(task.proc.pid), sig)
        except ProcessLookupError:
            return
        if not task.done.wait(timeout_s):
            try:
                os.killpg(os.getpgid(task.proc.pid), _signal.SIGKILL)
            except ProcessLookupError:
                pass
            task.done.wait(5)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return
        if not task.done.is_set():
            if not force:
                raise DriverError("task still running")
            self.stop_task(task_id, timeout_s=2)
        with self._lock:
            self.tasks.pop(task_id, None)

    def inspect_task(self, task_id: str) -> TaskStatus:
        task = self._get(task_id)
        return TaskStatus(
            id=task_id,
            name=task.cfg.name,
            state=TASK_STATE_EXITED if task.done.is_set() else TASK_STATE_RUNNING,
            started_at_ns=task.started_at,
            completed_at_ns=task.completed_at,
            exit_result=task.exit_result,
        )

    def signal_task(self, task_id: str, signal: str) -> None:
        task = self._get(task_id)
        sig = getattr(_signal, signal, None)
        if sig is None:
            raise DriverError(f"unknown signal {signal}")
        os.kill(task.proc.pid, sig)

    def exec_task(self, task_id: str, cmd: list[str], timeout_s: float = 30.0) -> tuple[bytes, int]:
        # rawexec has no container: exec runs in the same namespace
        out = subprocess.run(
            cmd, capture_output=True, timeout=timeout_s
        )
        return out.stdout + out.stderr, out.returncode

    def exec_task_streaming(self, task_id: str, cmd: list[str], tty: bool = False):
        self._get(task_id)  # validate the task exists
        return _spawn_streaming(cmd, tty)

    def recover_task(self, handle: TaskHandle) -> None:
        pid = handle.state.get("pid")
        if pid is None:
            raise DriverError("no pid in handle")
        with self._lock:
            if handle.task_id in self.tasks:
                return
        try:
            os.kill(pid, 0)  # liveness probe
        except ProcessLookupError:
            raise DriverError(f"pid {pid} is gone") from None
        # Re-adopt: poll the pid (we are not its parent after restart).
        cfg = TaskConfig(id=handle.task_id)
        task = _RawTask.__new__(_RawTask)
        task.cfg = cfg
        task.proc = _AdoptedProcess(pid)
        task.started_at = now_ns()
        task.completed_at = 0
        task.exit_result = None
        task.done = threading.Event()
        task._waiter = threading.Thread(
            target=task._wait, name="rawexec-waiter", daemon=True
        )
        task._waiter.start()
        with self._lock:
            self.tasks[handle.task_id] = task

    def _get(self, task_id: str) -> _RawTask:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            raise DriverError(f"unknown task {task_id}")
        return task


class _AdoptedProcess:
    """Popen-alike for a re-attached pid we didn't spawn."""

    def __init__(self, pid: int):
        self.pid = pid

    def wait(self) -> int:
        while True:
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                return 0  # exit status unknowable once reparented
            time.sleep(0.2)
