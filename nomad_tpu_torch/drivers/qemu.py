"""QEMU virtual-machine driver.

Port of ``nomad_tpu/drivers/qemu.py``.

Reference: drivers/qemu/driver.go (875 LoC) — StartTask :341 builds the
qemu-system command line (machine/accel, -m, -drive, -nographic, user
netdev hostfwd port maps, passthrough args), graceful shutdown sends
``system_powerdown`` over a unix monitor socket (:42 monitor name, :69
the 108-byte socket-path truncation guard), fingerprint shells out for
the qemu version (:226), RecoverTask reattaches by pid (:261).

Config keys (same vocabulary):
  image_path         VM image (required; must live under the task's
                     alloc dir or an operator-allowed path)
  accelerator        "tcg" (default) | "kvm"
  graceful_shutdown  bool — use the monitor socket for powerdown
  args               passthrough qemu arguments
  port_map           {label: guest_port} → hostfwd via user netdev

The qemu binary itself is operator config (constructor), never jobspec
config — a job-settable binary would be arbitrary host execution.
"""

from __future__ import annotations

import os
import shutil
import signal as _signal
import socket
import subprocess
import threading
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
    HEALTH_STATE_HEALTHY,
    HEALTH_STATE_UNDETECTED,
)

QEMU_BINARY = "qemu-system-x86_64"
MONITOR_SOCKET_NAME = "qemu-monitor.sock"
# unix socket paths truncate at 108 bytes (reference :69)
MAX_SOCKET_PATH = 108


class _QemuTask:
    def __init__(self, cfg: TaskConfig, proc: subprocess.Popen,
                 monitor_path: str = "") -> None:
        self.cfg = cfg
        self.proc = proc
        self.monitor_path = monitor_path
        self.started_at = now_ns()
        self.completed_at = 0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self._waiter = threading.Thread(
            target=self._wait, name="qemu-waiter", daemon=True
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


class QemuDriver(Driver):
    name = "qemu"

    def __init__(self, image_paths: Optional[list[str]] = None,
                 qemu_binary: Optional[str] = None) -> None:
        # operator-allowed image dirs beyond the alloc dir (reference
        # config image_paths) + optional binary override (tests stub it)
        self.image_paths = image_paths or []
        self.qemu_binary = qemu_binary
        self.tasks: dict[str, _QemuTask] = {}
        self._lock = threading.Lock()

    # -- fingerprint ---------------------------------------------------

    def fingerprint(self) -> Fingerprint:
        path = shutil.which(QEMU_BINARY)
        if path is None:
            return Fingerprint(
                attributes={},
                health=HEALTH_STATE_UNDETECTED,
                health_description="qemu-system binary not found",
            )
        try:
            out = subprocess.run(
                [path, "--version"], capture_output=True, text=True,
                timeout=10,
            ).stdout
            # "QEMU emulator version 8.2.0 ..." (reference :226)
            version = ""
            for tok in out.split():
                if tok and tok[0].isdigit():
                    version = tok
                    break
        except (OSError, subprocess.TimeoutExpired) as e:
            return Fingerprint(
                attributes={},
                health=HEALTH_STATE_UNDETECTED,
                health_description=f"qemu version probe failed: {e}",
            )
        return Fingerprint(
            attributes={
                "driver.qemu": "1",
                "driver.qemu.version": version,
            },
            health=HEALTH_STATE_HEALTHY,
        )

    # -- lifecycle ------------------------------------------------------

    def _allowed_image(self, task_dir: str, image: str) -> bool:
        """image must live under the alloc dir or an allowed path
        (reference isAllowedImagePath)."""
        image = os.path.realpath(image)
        alloc_dir = os.path.dirname(os.path.realpath(task_dir)) if task_dir else ""
        roots = [r for r in ([alloc_dir] + self.image_paths) if r]
        return any(
            image == r or image.startswith(os.path.realpath(r) + os.sep)
            for r in roots
        )

    def _monitor_path(self, task_dir: str) -> str:
        path = os.path.join(task_dir, MONITOR_SOCKET_NAME)
        if len(path.encode()) > MAX_SOCKET_PATH:
            raise DriverError(
                f"monitor socket path exceeds {MAX_SOCKET_PATH} bytes: "
                f"{path}"
            )
        return path

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        from .configspec import QEMU_SPEC

        conf = QEMU_SPEC.validate(cfg.config, "qemu")
        image = conf["image_path"]
        if not os.path.isabs(image):
            image = os.path.join(cfg.task_dir, image)
        if not self._allowed_image(cfg.task_dir, image):
            raise DriverError("qemu: image_path is not in the allowed paths")
        # binary override is OPERATOR config (constructor), never
        # jobspec config — a job-settable binary would be arbitrary
        # host execution, defeating the image allowlist
        binary = self.qemu_binary or shutil.which(QEMU_BINARY)
        if not binary:
            raise DriverError(f"qemu: {QEMU_BINARY} not found")
        accelerator = conf.get("accelerator", "tcg")
        mem_mb = int(cfg.resources_memory_mb or 0)
        if mem_mb < 128 or mem_mb > 4_000_000:
            raise DriverError("qemu: memory assignment out of bounds")
        vm_id = os.path.basename(image)
        args = [
            binary,
            "-machine", f"type=pc,accel={accelerator}",
            "-name", vm_id,
            "-m", f"{mem_mb}M",
            "-drive", f"file={image}",
            "-nographic",
        ]
        monitor_path = ""
        if conf.get("graceful_shutdown"):
            monitor_path = self._monitor_path(cfg.task_dir)
            args += ["-monitor", f"unix:{monitor_path},server,nowait"]
        args += [str(a) for a in conf.get("args", [])]
        # port_map {label: guest} → user-mode netdev hostfwd rules
        # (reference :441-466); host ports come from NOMAD_HOST_PORT_*
        port_map = conf.get("port_map") or {}
        fwd = []
        for label, guest in port_map.items():
            host = cfg.env.get(f"NOMAD_HOST_PORT_{label}") or cfg.env.get(
                f"NOMAD_PORT_{label}"
            )
            if not host:
                raise DriverError(f"qemu: unknown port label {label!r}")
            try:
                guest_port = int(guest)
            except (TypeError, ValueError):
                raise DriverError(
                    f"qemu: port_map[{label!r}] must be an integer guest "
                    f"port, got {guest!r}"
                ) from None
            for proto in ("udp", "tcp"):
                fwd.append(f"hostfwd={proto}::{host}-:{guest_port}")
        if fwd:
            args += [
                "-netdev", "user,id=user.0," + ",".join(fwd),
                "-device", "virtio-net,netdev=user.0",
            ]
        if accelerator == "kvm":
            args += ["-enable-kvm", "-cpu", "host"]

        stdout = (
            open(cfg.stdout_path, "ab")
            if cfg.stdout_path
            else subprocess.DEVNULL
        )
        stderr = (
            open(cfg.stderr_path, "ab")
            if cfg.stderr_path
            else subprocess.DEVNULL
        )
        try:
            proc = subprocess.Popen(
                args,
                stdout=stdout,
                stderr=stderr,
                cwd=cfg.task_dir or None,
                env={**os.environ, **cfg.env},
                start_new_session=True,
            )
        except OSError as e:
            raise DriverError(f"qemu: failed to start: {e}") from e
        finally:
            for f in (stdout, stderr):
                if hasattr(f, "close"):
                    f.close()
        task = _QemuTask(cfg, proc, monitor_path)
        with self._lock:
            self.tasks[cfg.id] = task
        return TaskHandle(
            cfg.id, self.name,
            {"pid": proc.pid, "monitor_path": monitor_path},
        )

    # -- graceful shutdown ---------------------------------------------

    def _send_powerdown(self, task: _QemuTask) -> bool:
        """system_powerdown over the monitor socket (reference
        sendQemuShutdown)."""
        if not task.monitor_path:
            return False
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(2.0)
                s.connect(task.monitor_path)
                s.sendall(b"system_powerdown\n")
            return True
        except OSError:
            return False

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        task = self._get(task_id)
        if task.done.is_set():
            return
        if self._send_powerdown(task):
            if task.done.wait(timeout_s):
                return
        else:
            sig = (
                getattr(_signal, signal, _signal.SIGTERM)
                if signal
                else _signal.SIGTERM
            )
            try:
                os.killpg(os.getpgid(task.proc.pid), sig)
            except ProcessLookupError:
                return
            if task.done.wait(timeout_s):
                return
        try:
            os.killpg(os.getpgid(task.proc.pid), _signal.SIGKILL)
        except ProcessLookupError:
            pass
        task.done.wait(5)

    # -- the rest of the Driver contract -------------------------------

    def wait_task(
        self, task_id: str, timeout_s: Optional[float] = None
    ) -> Optional[ExitResult]:
        task = self._get(task_id)
        if not task.done.wait(timeout_s):
            return None
        return task.exit_result

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            return
        if not task.done.is_set():
            if not force:
                raise DriverError("qemu task still running")
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

    def task_stats(self, task_id: str) -> dict[str, Any]:
        task = self._get(task_id)
        try:
            with open(f"/proc/{task.proc.pid}/statm") as f:
                pages = int(f.read().split()[1])
            rss = pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            rss = 0
        return {"memory_rss_bytes": rss, "pid": task.proc.pid}

    def signal_task(self, task_id: str, signal: str) -> None:
        task = self._get(task_id)
        sig = getattr(_signal, signal, None)
        if sig is None:
            raise DriverError(f"unknown signal {signal!r}")
        try:
            os.kill(task.proc.pid, sig)
        except ProcessLookupError:
            raise DriverError("process gone") from None

    def exec_task(
        self, task_id: str, cmd: list[str], timeout_s: float = 30.0
    ) -> tuple[bytes, int]:
        raise DriverError("qemu driver does not support exec")

    def recover_task(self, handle: TaskHandle) -> None:
        """Reattach to a live VM by pid (reference RecoverTask :261)."""
        if handle.task_id in self.tasks:
            return
        pid = handle.state.get("pid")
        if not pid:
            raise DriverError("no pid in qemu handle")
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            raise DriverError(f"qemu pid {pid} is gone") from None
        from .rawexec import _AdoptedProcess

        proc = _AdoptedProcess(pid)
        task = _QemuTask(
            TaskConfig(id=handle.task_id),
            proc,  # type: ignore[arg-type]
            handle.state.get("monitor_path", ""),
        )
        with self._lock:
            self.tasks[handle.task_id] = task

    def _get(self, task_id: str) -> _QemuTask:
        with self._lock:
            task = self.tasks.get(task_id)
        if task is None:
            raise DriverError(f"unknown qemu task {task_id}")
        return task
