"""Task driver plugin interface.

Port of ``nomad_tpu/drivers/base.py``.

Reference: plugins/drivers/driver.go:47-64 DriverPlugin — Fingerprint,
StartTask, WaitTask, StopTask, DestroyTask, InspectTask, TaskStats,
ExecTask, SignalTask, RecoverTask. The reference runs drivers out-of-process
over gRPC (hashicorp/go-plugin); round-1 drivers run in-process behind this
same interface so the gRPC boundary can be added underneath without
touching the task runner.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

HEALTH_STATE_HEALTHY = "healthy"
HEALTH_STATE_UNHEALTHY = "unhealthy"
HEALTH_STATE_UNDETECTED = "undetected"

TASK_STATE_RUNNING = "running"
TASK_STATE_EXITED = "exited"
TASK_STATE_UNKNOWN = "unknown"


@dataclass
class Fingerprint:
    attributes: dict[str, str] = field(default_factory=dict)
    health: str = HEALTH_STATE_HEALTHY
    health_description: str = ""


@dataclass
class TaskConfig:
    """What a driver needs to start a task (reference: drivers.TaskConfig)."""

    id: str = ""  # alloc_id/task_name
    name: str = ""
    alloc_id: str = ""
    env: dict[str, str] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)  # driver-specific
    resources_cpu: int = 0
    resources_memory_mb: int = 0
    # oversubscription hard cap (0 = cap at the reserve)
    resources_memory_max_mb: int = 0
    # dedicated core ids (reference LinuxResources.CpusetCpus): pinning
    # drivers restrict the task's cpu affinity to exactly these
    reserved_cores: list = field(default_factory=list)
    task_dir: str = ""
    stdout_path: str = ""
    stderr_path: str = ""
    user: str = ""
    # bridge mode: the alloc's network namespace path — drivers run the
    # task inside it (reference drivers' NetworkIsolationSpec)
    network_ns: str = ""
    # volume mounts: [{"host_path", "task_path", "read_only"}] —
    # bind-mounting drivers (docker) consume these; filesystem drivers
    # get a symlink placed by the task runner (reference: TaskConfig.Mounts)
    mounts: list = field(default_factory=list)


@dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: Optional[str] = None

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and self.err is None


@dataclass
class TaskStatus:
    id: str = ""
    name: str = ""
    state: str = TASK_STATE_UNKNOWN
    started_at_ns: int = 0
    completed_at_ns: int = 0
    exit_result: Optional[ExitResult] = None


class TaskHandle:
    """Opaque driver-side handle; serializable so a restarted client can
    reattach (reference: drivers.TaskHandle + RecoverTask)."""

    def __init__(self, task_id: str, driver: str, state: dict[str, Any]):
        self.task_id = task_id
        self.driver = driver
        self.state = state

    def to_dict(self) -> dict[str, Any]:
        return {"task_id": self.task_id, "driver": self.driver, "state": self.state}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TaskHandle":
        return cls(d["task_id"], d["driver"], d.get("state", {}))


class DriverError(Exception):
    pass


class Driver:
    """Base driver; subclasses implement the lifecycle verbs."""

    name = "base"

    def fingerprint(self) -> Fingerprint:
        raise NotImplementedError

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        raise NotImplementedError

    def wait_task(self, task_id: str, timeout_s: Optional[float] = None) -> Optional[ExitResult]:
        """Block until the task exits; None on timeout."""
        raise NotImplementedError

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        raise NotImplementedError

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        raise NotImplementedError

    def inspect_task(self, task_id: str) -> TaskStatus:
        raise NotImplementedError

    def task_stats(self, task_id: str) -> dict[str, Any]:
        return {}

    def signal_task(self, task_id: str, signal: str) -> None:
        raise NotImplementedError

    def exec_task(self, task_id: str, cmd: list[str], timeout_s: float = 30.0) -> tuple[bytes, int]:
        raise DriverError(f"driver {self.name} does not support exec")

    def exec_task_streaming(self, task_id: str, cmd: list[str], tty: bool = False):
        """Interactive exec: returns a connected socket bridging the
        exec'd process's stdio (reference ExecTaskStreaming,
        plugins/drivers/execstreaming.go)."""
        raise DriverError(f"driver {self.name} does not support exec")

    def recover_task(self, handle: TaskHandle) -> None:
        raise DriverError(f"driver {self.name} cannot recover tasks")
