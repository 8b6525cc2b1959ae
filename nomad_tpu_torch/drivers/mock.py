"""Mock driver: configurable fake for tests and fault injection.

Port of ``nomad_tpu/drivers/mock.py``.

Reference: drivers/mock (918 LoC) — start errors, run_for durations, exit
codes, signal errors, kill-after. Config keys (per task config dict):
  run_for          seconds the task "runs" ("0s"/float/str; default forever)
  exit_code        exit code when run_for elapses
  start_error      error string raised on start
  start_block_for  seconds start_task blocks before returning
  kill_after       seconds after which the task kills itself with exit 9
"""

from __future__ import annotations

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


def _parse_duration(v) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    if s.endswith("m"):
        return float(s[:-1]) * 60
    if s.endswith("h"):
        return float(s[:-1]) * 3600
    return float(s)


class _MockTask:
    def __init__(self, cfg: TaskConfig):
        self.cfg = cfg
        self.started_at = now_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self.timer: Optional[threading.Timer] = None

    def finish(self, result: ExitResult) -> None:
        if self.done.is_set():
            return
        self.exit_result = result
        self.completed_at = now_ns()
        self.done.set()


class MockDriver(Driver):
    name = "mock"

    def __init__(self) -> None:
        self.tasks: dict[str, _MockTask] = {}
        self._lock = threading.Lock()

    def fingerprint(self) -> Fingerprint:
        return Fingerprint(attributes={"driver.mock": "1"})

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        conf = cfg.config
        if conf.get("start_error"):
            raise DriverError(str(conf["start_error"]))
        block = _parse_duration(conf.get("start_block_for"))
        if block:
            time.sleep(block)
        task = _MockTask(cfg)
        with self._lock:
            if cfg.id in self.tasks and not self.tasks[cfg.id].done.is_set():
                raise DriverError(f"task {cfg.id} already running")
            self.tasks[cfg.id] = task

        run_for = _parse_duration(conf.get("run_for"))
        kill_after = _parse_duration(conf.get("kill_after"))
        if run_for is not None:
            exit_code = int(conf.get("exit_code", 0))
            t = threading.Timer(
                run_for, task.finish, args=(ExitResult(exit_code=exit_code),)
            )
            t.daemon = True
            task.timer = t
            t.start()
        if kill_after is not None:
            t = threading.Timer(
                kill_after, task.finish, args=(ExitResult(exit_code=9, signal=9),)
            )
            t.daemon = True
            t.start()
        return TaskHandle(cfg.id, self.name, {"started_at": task.started_at})

    def wait_task(self, task_id: str, timeout_s: Optional[float] = None) -> Optional[ExitResult]:
        task = self._get(task_id)
        if not task.done.wait(timeout_s):
            return None
        return task.exit_result

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        task = self._get(task_id)
        task.finish(ExitResult(exit_code=0, signal=15))

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
            if task is None:
                return
            if not task.done.is_set():
                if not force:
                    raise DriverError("task still running")
                task.finish(ExitResult(exit_code=9, signal=9))
            del self.tasks[task_id]

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
        if task.cfg.config.get("signal_error"):
            raise DriverError(str(task.cfg.config["signal_error"]))

    def exec_task(self, task_id: str, cmd: list[str], timeout_s: float = 30.0) -> tuple[bytes, int]:
        self._get(task_id)
        return (" ".join(cmd)).encode() + b"\n", 0

    def exec_task_streaming(self, task_id: str, cmd: list[str], tty: bool = False):
        """Echo server standing in for a real exec session (tests)."""
        import socket as _socket

        self._get(task_id)
        parent, inner = _socket.socketpair()

        def _echo():
            try:
                inner.sendall((" ".join(cmd)).encode() + b"\n")
                while True:
                    data = inner.recv(4096)
                    if not data:
                        break
                    inner.sendall(data)
            except OSError:
                pass
            finally:
                inner.close()

        threading.Thread(
            target=_echo, name="mock-exec-echo", daemon=True
        ).start()
        return parent

    def recover_task(self, handle: TaskHandle) -> None:
        with self._lock:
            if handle.task_id in self.tasks:
                return
        raise DriverError("mock task lost on restart")

    def _get(self, task_id: str) -> _MockTask:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            raise DriverError(f"unknown task {task_id}")
        return task
