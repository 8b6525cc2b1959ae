"""Client-side device plugin framework.

Port of ``nomad_tpu/client/devicemanager.py``.

Reference: client/devicemanager/ + plugins/device/ — device plugins
fingerprint accelerator groups onto the node so the scheduler's
DeviceAllocator (scheduler/device.py) has real instances to assign, and
the task runner turns assigned instance ids into the visibility env vars
the workload expects.

Builtin plugins:
  * tpu    — detects TPU chips by their /dev/accel* (or /dev/vfio) device
             files, the tpu-native analog of the reference's nvidia plugin
  * nvidia — nvidia-smi when present (reference drivers/../nvidia)

The interface is the same Fingerprint/Reserve split as the reference's
device plugin API; out-of-process plugins can slot in behind it later.
"""

from __future__ import annotations

import glob
import logging
import os
import subprocess
from typing import Optional

from ..structs.structs import NodeDeviceInstance, NodeDeviceResource

logger = logging.getLogger("nomad_tpu_torch.devicemanager")


class DevicePlugin:
    """One device family's detector (reference plugins/device/device.go)."""

    name = "base"

    def fingerprint(self) -> list[NodeDeviceResource]:
        raise NotImplementedError

    def env_var(self) -> str:
        """The visibility variable workloads read for this device type."""
        return f"NOMAD_DEVICE_{self.name.upper()}"

    def reserve(self, instance_ids: list[str]) -> dict:
        """Reservation response for granted instances (reference
        plugins/device Reserve → ContainerReservation): {"env": {...}}."""
        return {"env": {self.env_var(): ",".join(instance_ids)}}

    def stats(self) -> dict:
        """instance id -> {stat: value} (reference Stats stream)."""
        return {}


class TPUDevicePlugin(DevicePlugin):
    """TPU chips appear as /dev/accel<N> (PCI) or /dev/vfio devices."""

    name = "tpu"

    def __init__(self, dev_glob: str = "/dev/accel*") -> None:
        self.dev_glob = dev_glob

    def fingerprint(self) -> list[NodeDeviceResource]:
        paths = sorted(glob.glob(self.dev_glob))
        if not paths:
            return []
        instances = [
            NodeDeviceInstance(id=os.path.basename(p), healthy=True)
            for p in paths
        ]
        return [
            NodeDeviceResource(
                vendor="google",
                type="tpu",
                name="tpu",
                instances=instances,
                attributes={"count": len(instances)},
            )
        ]

    def env_var(self) -> str:
        return "TPU_VISIBLE_DEVICES"


class NvidiaDevicePlugin(DevicePlugin):
    name = "nvidia"

    def fingerprint(self) -> list[NodeDeviceResource]:
        try:
            out = subprocess.run(
                [
                    "nvidia-smi",
                    "--query-gpu=uuid,name",
                    "--format=csv,noheader",
                ],
                capture_output=True,
                timeout=10,
            )
        except (OSError, subprocess.TimeoutExpired):
            return []
        if out.returncode != 0:
            return []
        by_model: dict[str, list[NodeDeviceInstance]] = {}
        for line in out.stdout.decode(errors="replace").splitlines():
            parts = [p.strip() for p in line.split(",", 1)]
            if len(parts) != 2 or not parts[0]:
                continue
            by_model.setdefault(parts[1], []).append(
                NodeDeviceInstance(id=parts[0], healthy=True)
            )
        return [
            NodeDeviceResource(
                vendor="nvidia", type="gpu", name=model, instances=insts
            )
            for model, insts in by_model.items()
        ]

    def env_var(self) -> str:
        return "CUDA_VISIBLE_DEVICES"


class DeviceManager:
    """Aggregates plugins for node fingerprinting, task env wiring, and
    stats collection (reference client/devicemanager/manager.go).

    external: name -> "module:Class" factory refs (or
    {"factory": ref, "config": {...}} dicts) launched out-of-process
    over the device-plugin fabric (devices/plugin.py) — the
    reference's go-plugin device catalog."""

    def __init__(
        self,
        plugins: Optional[list[DevicePlugin]] = None,
        external: Optional[dict] = None,
    ) -> None:
        self.plugins = (
            plugins
            if plugins is not None
            else [TPUDevicePlugin(), NvidiaDevicePlugin()]
        )
        self._external = []
        for name, spec in (external or {}).items():
            from ..devices.plugin import ExternalDevicePlugin

            if isinstance(spec, dict):
                ref, config = spec.get("factory", ""), spec.get("config")
            else:
                ref, config = str(spec), None
            if ref:
                ext = ExternalDevicePlugin(name, ref, config)
                # an external plugin REPLACES a same-named builtin (the
                # driver-plugin catalog overlays builtins the same way)
                self.plugins = [p for p in self.plugins if p.name != name]
                self.plugins.append(ext)
                self._external.append(ext)

    def shutdown(self) -> None:
        for ext in self._external:
            try:
                ext.shutdown_plugin()
            except Exception:
                logger.exception("device plugin %s shutdown failed", ext.name)

    def fingerprint(self) -> list[NodeDeviceResource]:
        out: list[NodeDeviceResource] = []
        for plugin in self.plugins:
            try:
                out.extend(plugin.fingerprint())
            except Exception:
                logger.exception("device plugin %s failed", plugin.name)
        return out

    def stats(self) -> dict[str, dict]:
        """plugin name -> {instance id -> {stat: value}}."""
        out: dict[str, dict] = {}
        for plugin in self.plugins:
            try:
                s = plugin.stats()
            except Exception:
                logger.exception("device plugin %s stats failed", plugin.name)
                continue
            if s:
                out[plugin.name] = s
        return out

    def task_env(self, task_resources) -> dict[str, str]:
        """Visibility env vars for a task's ASSIGNED device instances
        (the scheduler's DeviceAllocator picked the ids; reference:
        the nvidia plugin's Reserve returns CUDA_VISIBLE_DEVICES)."""
        env: dict[str, str] = {}
        if task_resources is None:
            return env
        by_type: dict[str, list[str]] = {}
        for dev in getattr(task_resources, "devices", []) or []:
            dev_id = dev.get("id", "")  # vendor/type/name
            parts = dev_id.split("/")
            dtype = parts[1] if len(parts) > 1 else dev_id
            by_type.setdefault(dtype, []).extend(dev.get("device_ids", []))
        for dtype, ids in by_type.items():
            plugin = next(
                (
                    p
                    for p in self.plugins
                    if dtype in (p.name, getattr(p, "type", None))
                    or (dtype == "gpu" and p.name == "nvidia")
                ),
                None,
            )
            if plugin is not None:
                try:
                    env.update(plugin.reserve(ids).get("env", {}))
                    continue
                except Exception:
                    logger.exception(
                        "device plugin %s reserve failed", plugin.name
                    )
            env[f"NOMAD_DEVICE_{dtype.upper()}"] = ",".join(ids)
        return env
