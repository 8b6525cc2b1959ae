"""Out-of-process driver plugins.

Port of ``nomad_tpu/drivers/plugin.py``.

Reference: plugins/ — hashicorp/go-plugin launches the plugin binary,
reads a handshake line on stdout, then talks gRPC
(plugins/drivers/proto/driver.proto; client/server wrappers in
plugins/drivers/{client,server}.go). TPU-native equivalent: the plugin
process hosts its driver on the framed-msgpack RPC fabric and prints

    NOMAD_TPU_PLUGIN|1|127.0.0.1:<port>

The parent connects via ConnPool and forwards the Driver verbs. The
plugin exits when its stdin closes (parent-death detection, exactly
go-plugin's behavior), so orphaned plugins never outlive the agent.

Run a plugin process with:
    python -m nomad_tpu_torch.drivers.plugin my_module:MyDriverClass
"""

from __future__ import annotations

import sys
from typing import Any, Optional

from ..rpc import RPCServer
from .base import (
    Driver,
    DriverError,
    ExitResult,
    Fingerprint,
    TaskConfig,
    TaskHandle,
    TaskStatus,
)

HANDSHAKE_PREFIX = "NOMAD_TPU_PLUGIN|1|"


class DriverEndpoint:
    """RPC surface wrapping a concrete Driver (plugin side)."""

    def __init__(self, driver: Driver) -> None:
        self.driver = driver

    def fingerprint(self, args):
        return self.driver.fingerprint()

    def start_task(self, args):
        handle = self.driver.start_task(args["cfg"])
        return handle.to_dict()

    def wait_task(self, args):
        return self.driver.wait_task(args["task_id"], args.get("timeout_s"))

    def stop_task(self, args):
        self.driver.stop_task(
            args["task_id"], args["timeout_s"], args.get("signal", "")
        )

    def destroy_task(self, args):
        self.driver.destroy_task(args["task_id"], args.get("force", False))

    def inspect_task(self, args):
        return self.driver.inspect_task(args["task_id"])

    def task_stats(self, args):
        return self.driver.task_stats(args["task_id"])

    def signal_task(self, args):
        self.driver.signal_task(args["task_id"], args["signal"])

    def exec_task(self, args):
        out, code = self.driver.exec_task(
            args["task_id"], args["cmd"], args.get("timeout_s", 30.0)
        )
        return {"output": out, "code": code}

    def recover_task(self, args):
        self.driver.recover_task(TaskHandle.from_dict(args["handle"]))


def serve_plugin(driver: Driver) -> None:
    """Plugin-process main: host the driver, handshake, die with parent."""
    server = RPCServer(host="127.0.0.1", port=0)
    server.register("Driver", DriverEndpoint(driver))
    server.start()
    host, port = server.addr
    sys.stdout.write(f"{HANDSHAKE_PREFIX}{host}:{port}\n")
    sys.stdout.flush()
    # Block until the parent goes away (stdin EOF), then exit.
    try:
        while sys.stdin.readline():
            pass
    except (KeyboardInterrupt, OSError):
        pass
    server.shutdown()


class ExternalDriver(Driver):
    """Parent-side proxy speaking to a plugin process.

    `factory_ref` is "module.path:ClassName" resolved in the plugin
    process (reference: the plugin catalog's launcher config).
    """

    def __init__(self, name: str, factory_ref: str) -> None:
        from ..plugins.launcher import PluginProcess

        self.name = name
        self.factory_ref = factory_ref
        self._proc = PluginProcess(
            [sys.executable, "-m", "nomad_tpu_torch.drivers.plugin", factory_ref],
            HANDSHAKE_PREFIX,
            DriverError,
        )

    # -- process lifecycle ---------------------------------------------

    def shutdown_plugin(self) -> None:
        self._proc.shutdown()

    def _call(self, method: str, args=None, timeout_s: float = 30.0):
        return self._proc.call(method, args, timeout_s=timeout_s)

    # -- Driver verbs --------------------------------------------------

    def fingerprint(self) -> Fingerprint:
        return self._call("Driver.fingerprint")

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        return TaskHandle.from_dict(self._call("Driver.start_task", {"cfg": cfg}))

    def wait_task(
        self, task_id: str, timeout_s: Optional[float] = None
    ) -> Optional[ExitResult]:
        rpc_timeout = (timeout_s + 10.0) if timeout_s is not None else 3600.0
        return self._call(
            "Driver.wait_task",
            {"task_id": task_id, "timeout_s": timeout_s},
            timeout_s=rpc_timeout,
        )

    def stop_task(self, task_id: str, timeout_s: float, signal: str = "") -> None:
        self._call(
            "Driver.stop_task",
            {"task_id": task_id, "timeout_s": timeout_s, "signal": signal},
            timeout_s=timeout_s + 15.0,
        )

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        self._call("Driver.destroy_task", {"task_id": task_id, "force": force})

    def inspect_task(self, task_id: str) -> TaskStatus:
        return self._call("Driver.inspect_task", {"task_id": task_id})

    def task_stats(self, task_id: str) -> dict[str, Any]:
        return self._call("Driver.task_stats", {"task_id": task_id})

    def signal_task(self, task_id: str, signal: str) -> None:
        self._call("Driver.signal_task", {"task_id": task_id, "signal": signal})

    def exec_task(
        self, task_id: str, cmd: list[str], timeout_s: float = 30.0
    ) -> tuple[bytes, int]:
        out = self._call(
            "Driver.exec_task",
            {"task_id": task_id, "cmd": cmd, "timeout_s": timeout_s},
            timeout_s=timeout_s + 10.0,
        )
        return out["output"], out["code"]

    def recover_task(self, handle: TaskHandle) -> None:
        self._call("Driver.recover_task", {"handle": handle.to_dict()})


def _main() -> None:
    import importlib

    if len(sys.argv) != 2 or ":" not in sys.argv[1]:
        sys.stderr.write("usage: python -m nomad_tpu_torch.drivers.plugin module:Class\n")
        sys.exit(2)
    mod_name, _, cls_name = sys.argv[1].partition(":")
    mod = importlib.import_module(mod_name)
    driver_cls = getattr(mod, cls_name)
    serve_plugin(driver_cls())


if __name__ == "__main__":
    _main()
