"""Out-of-process device plugins over the plugin fabric.

Port of ``nomad_tpu/devices/plugin.py``.

Reference: plugins/device/ — go-plugin serves the DevicePlugin gRPC API
(Fingerprint/Reserve/Stats) from a separate binary; the client's device
manager launches and proxies it. Same transport as the task-driver
plugins (drivers/plugin.py): handshake line on stdout, framed-msgpack
RPC, die-with-parent on stdin EOF.

Run a plugin process with:
    python -m nomad_tpu_torch.devices.plugin my_module:MyDeviceClass ['{json config}']
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from ..rpc import RPCServer

HANDSHAKE_PREFIX = "NOMAD_TPU_DEVICE_PLUGIN|1|"


class DevicePluginError(Exception):
    pass


class DeviceEndpoint:
    """RPC surface wrapping a concrete device plugin (plugin side)."""

    def __init__(self, plugin) -> None:
        self.plugin = plugin

    def fingerprint(self, args):
        return self.plugin.fingerprint()

    def reserve(self, args):
        return self.plugin.reserve(args["instance_ids"])

    def stats(self, args):
        return self.plugin.stats()


def serve_device_plugin(plugin) -> None:
    """Plugin-process main: host the device API, handshake, die with
    parent (mirrors drivers/plugin.py serve_plugin)."""
    server = RPCServer(host="127.0.0.1", port=0)
    server.register("Device", DeviceEndpoint(plugin))
    server.start()
    host, port = server.addr
    sys.stdout.write(f"{HANDSHAKE_PREFIX}{host}:{port}\n")
    sys.stdout.flush()
    try:
        while sys.stdin.readline():
            pass
    except (KeyboardInterrupt, OSError):
        pass
    server.shutdown()


class ExternalDevicePlugin:
    """Client-side proxy: launches the plugin process on first use and
    forwards the device verbs (the DeviceManager treats it like any
    in-process DevicePlugin)."""

    def __init__(
        self, name: str, factory_ref: str, config: Optional[dict] = None
    ) -> None:
        from ..plugins.launcher import PluginProcess

        self.name = name
        self.factory_ref = factory_ref
        self.config = config or {}
        argv = [
            sys.executable, "-m", "nomad_tpu_torch.devices.plugin", factory_ref,
        ]
        if self.config:
            argv.append(json.dumps(self.config))
        self._proc = PluginProcess(argv, HANDSHAKE_PREFIX, DevicePluginError)

    def shutdown_plugin(self) -> None:
        self._proc.shutdown()

    # -- DevicePlugin surface ------------------------------------------

    def fingerprint(self):
        return self._proc.call("Device.fingerprint")

    def reserve(self, instance_ids: list[str]) -> dict:
        return self._proc.call("Device.reserve", {"instance_ids": instance_ids})

    def stats(self) -> dict:
        return self._proc.call("Device.stats")

    def env_var(self) -> str:  # fallback when reserve() is unavailable
        return f"NOMAD_DEVICE_{self.name.upper()}"


def _main() -> None:
    if len(sys.argv) < 2 or ":" not in sys.argv[1]:
        sys.stderr.write(
            "usage: python -m nomad_tpu_torch.devices.plugin module:Class [json]\n"
        )
        sys.exit(2)
    mod_name, _, cls_name = sys.argv[1].partition(":")
    import importlib

    from ..plugins.launcher import instantiate_plugin

    cls = getattr(importlib.import_module(mod_name), cls_name)
    config = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    serve_device_plugin(instantiate_plugin(cls, config))


if __name__ == "__main__":
    _main()
