"""CSI plugin client interface.

Port of ``nomad_tpu/plugins/csi.py``.

Reference: plugins/csi/ — Nomad talks the CSI spec's gRPC services
(Identity/Controller/Node) to external storage plugins and ships a fake
client for tests (plugins/csi/fake/). The TPU-native build keeps the same
three-service verb set but carries it over the repo's framed-msgpack RPC
fabric instead of gRPC (see drivers/plugin.py for the matching
driver-plugin transport): an external CSI plugin process hosts a
``CSIPlugin`` implementation and prints the same
``NOMAD_TPU_PLUGIN|1|host:port`` handshake.

The verb set mirrors the CSI spec methods Nomad actually calls
(plugins/csi/client.go):

  identity:   plugin_info, probe
  controller: controller_publish, controller_unpublish, validate_volume
  node:       node_get_info, node_stage, node_unstage,
              node_publish, node_unpublish

Staging/publishing are filesystem operations under the client's data dir;
on hosts where bind mounts need privileges the fake (and any in-process
plugin) uses symlinks — the lifecycle contract, refcounts and claim
interaction are what parity requires, not mount(2).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class CSIError(Exception):
    pass


@dataclass
class CSIPluginInfo:
    name: str = ""
    version: str = "0.0.0"
    # which services this instance provides (a plugin job may run
    # controller-only and node-only instances; reference: TaskCSIPluginConfig)
    controller: bool = True
    node: bool = True


@dataclass
class StageContext:
    """Everything a node-stage/publish call needs (reference:
    plugins/csi/client.go NodeStageVolume params)."""

    volume_id: str = ""
    external_id: str = ""
    staging_path: str = ""
    target_path: str = ""
    read_only: bool = False
    access_mode: str = ""
    attachment_mode: str = "file-system"
    context: dict[str, str] = field(default_factory=dict)


class CSIPlugin:
    """One CSI plugin (in-process base class; external plugins subclass
    this in their own process behind ``serve_csi_plugin``)."""

    def plugin_info(self) -> CSIPluginInfo:
        raise NotImplementedError

    def probe(self) -> bool:
        """Health check (CSI Identity.Probe)."""
        return True

    # -- controller service -------------------------------------------

    def controller_publish(
        self, volume_id: str, external_id: str, node_id: str, read_only: bool
    ) -> dict[str, str]:
        """Attach the volume to the node; returns publish context the node
        verbs receive (CSI ControllerPublishVolume)."""
        return {}

    def controller_unpublish(
        self, volume_id: str, external_id: str, node_id: str
    ) -> None:
        """CSI ControllerUnpublishVolume."""

    def validate_volume(
        self, volume_id: str, external_id: str, access_mode: str,
        attachment_mode: str,
    ) -> None:
        """Raise CSIError if the volume can't satisfy the requested modes
        (CSI ValidateVolumeCapabilities)."""

    def create_volume(self, name: str, params: dict) -> dict:
        """Provision storage; returns {"external_id": ..., "context":
        {...}} (CSI CreateVolume)."""
        raise CSIError("plugin does not support volume creation")

    def delete_volume(self, external_id: str) -> None:
        """CSI DeleteVolume."""
        raise CSIError("plugin does not support volume deletion")

    def create_snapshot(
        self, external_id: str, name: str, params: dict
    ) -> dict:
        """Point-in-time copy of a volume; returns {"snapshot_id",
        "source_external_id", "size_mb", "create_time_ns", "ready"}
        (CSI CreateSnapshot)."""
        raise CSIError("plugin does not support snapshots")

    def delete_snapshot(self, snapshot_id: str) -> None:
        """CSI DeleteSnapshot."""
        raise CSIError("plugin does not support snapshots")

    def list_snapshots(self) -> list[dict]:
        """CSI ListSnapshots — every snapshot this plugin holds."""
        raise CSIError("plugin does not support snapshots")

    # -- node service --------------------------------------------------

    def node_get_info(self) -> dict[str, str]:
        """CSI NodeGetInfo — the storage provider's id for this host."""
        return {"node_id": ""}

    def node_stage(self, ctx: StageContext) -> None:
        """Make the volume available at ctx.staging_path (once per volume
        per node; CSI NodeStageVolume)."""
        raise NotImplementedError

    def node_unstage(self, volume_id: str, staging_path: str) -> None:
        raise NotImplementedError

    def node_publish(self, ctx: StageContext) -> None:
        """Expose the staged volume at ctx.target_path (once per alloc;
        CSI NodePublishVolume)."""
        raise NotImplementedError

    def node_unpublish(self, volume_id: str, target_path: str) -> None:
        raise NotImplementedError


class FakeCSIPlugin(CSIPlugin):
    """Directory-backed plugin (reference: plugins/csi/fake/client.go).

    The "storage cloud" is ``backing_dir``: each external volume id is a
    subdirectory; stage links it into the staging path and publish links
    the staging path to the per-alloc target. Tests and the builtin
    ``hostpath`` catalog entry both use it.
    """

    def __init__(self, name: str = "hostpath", backing_dir: str = "",
                 controller: bool = True) -> None:
        self.name = name
        self.backing_dir = backing_dir or os.path.join(
            os.path.expanduser("~"), ".nomad-tpu-csi", name
        )
        self._controller = controller
        self._lock = threading.Lock()
        self.published: dict[str, str] = {}  # target_path -> volume_id
        self.staged: dict[str, str] = {}  # staging_path -> volume_id
        self.attached: dict[str, set[str]] = {}  # external_id -> node ids
        self.healthy = True

    def plugin_info(self) -> CSIPluginInfo:
        return CSIPluginInfo(
            name=self.name, version="1.0.0",
            controller=self._controller, node=True,
        )

    def probe(self) -> bool:
        return self.healthy

    def _backing(self, external_id: str) -> str:
        path = os.path.join(self.backing_dir, external_id or "default")
        os.makedirs(path, exist_ok=True)
        return path

    def controller_publish(self, volume_id, external_id, node_id, read_only):
        with self._lock:
            self.attached.setdefault(external_id, set()).add(node_id)
        return {"attached_on": node_id}

    def controller_unpublish(self, volume_id, external_id, node_id):
        with self._lock:
            self.attached.get(external_id, set()).discard(node_id)

    def validate_volume(self, volume_id, external_id, access_mode,
                        attachment_mode):
        if attachment_mode not in ("", "file-system"):
            raise CSIError(
                f"fake plugin only supports file-system attachment, "
                f"got {attachment_mode!r}"
            )

    def create_volume(self, name: str, params: dict) -> dict:
        external_id = f"vol-{name}"
        os.makedirs(os.path.join(self.backing_dir, external_id),
                    exist_ok=True)
        return {"external_id": external_id, "context": dict(params or {})}

    def delete_volume(self, external_id: str) -> None:
        path = os.path.join(self.backing_dir, external_id)
        if os.path.isdir(path):
            shutil.rmtree(path)

    def _snap_dir(self) -> str:
        path = os.path.join(self.backing_dir, "_snapshots")
        os.makedirs(path, exist_ok=True)
        return path

    @staticmethod
    def _safe_component(value: str, what: str) -> str:
        """Snapshot ids/names become filesystem path components: reject
        anything that could escape the snapshot directory (these arrive
        straight off the HTTP query string)."""
        if (
            not value
            or value != os.path.basename(value)
            or value in (".", "..")
            or "/" in value
            or "\\" in value
        ):
            raise CSIError(f"invalid {what} {value!r}")
        return value

    def create_snapshot(self, external_id: str, name: str,
                        params: dict) -> dict:
        self._safe_component(external_id, "volume id")
        if name:
            self._safe_component(name, "snapshot name")
        src = os.path.join(self.backing_dir, external_id)
        if not os.path.isdir(src):
            raise CSIError(f"volume {external_id!r} not found")
        snap_id = f"snap-{name or external_id}-{int(time.time_ns())}"
        dst = os.path.join(self._snap_dir(), snap_id)
        shutil.copytree(src, dst)
        meta = {
            "snapshot_id": snap_id,
            "source_external_id": external_id,
            "size_mb": sum(
                os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(dst)
                for f in fs
            ) // (1024 * 1024),
            "create_time_ns": time.time_ns(),
            "ready": True,
        }
        # metadata rides BESIDE the copy, never inside it — the snapshot
        # must stay a faithful point-in-time image of the volume
        with open(os.path.join(self._snap_dir(),
                               f"{snap_id}.meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    def delete_snapshot(self, snapshot_id: str) -> None:
        self._safe_component(snapshot_id, "snapshot id")
        path = os.path.join(self._snap_dir(), snapshot_id)
        if not os.path.isdir(path):
            raise CSIError(f"snapshot {snapshot_id!r} not found")
        shutil.rmtree(path)
        meta = os.path.join(self._snap_dir(), f"{snapshot_id}.meta.json")
        if os.path.exists(meta):
            os.unlink(meta)

    def list_snapshots(self) -> list[dict]:
        out = []
        snap_root = self._snap_dir()
        for snap_id in sorted(os.listdir(snap_root)):
            if not os.path.isdir(os.path.join(snap_root, snap_id)):
                continue  # sibling .meta.json files
            try:
                with open(os.path.join(
                    snap_root, f"{snap_id}.meta.json"
                )) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                # missing/corrupt metadata must not break listing the
                # rest; the snapshot itself is still intact
                out.append({"snapshot_id": snap_id, "ready": True})
        return out

    def node_get_info(self):
        return {"node_id": f"fake-{os.uname().nodename}"}

    def node_stage(self, ctx: StageContext) -> None:
        backing = self._backing(ctx.external_id or ctx.volume_id)
        os.makedirs(os.path.dirname(ctx.staging_path), exist_ok=True)
        with self._lock:
            if not os.path.lexists(ctx.staging_path):
                os.symlink(backing, ctx.staging_path)
            self.staged[ctx.staging_path] = ctx.volume_id

    def node_unstage(self, volume_id: str, staging_path: str) -> None:
        with self._lock:
            if os.path.islink(staging_path):
                os.unlink(staging_path)
            self.staged.pop(staging_path, None)

    def node_publish(self, ctx: StageContext) -> None:
        if ctx.staging_path not in self.staged:
            raise CSIError(f"volume {ctx.volume_id} not staged")
        os.makedirs(os.path.dirname(ctx.target_path), exist_ok=True)
        with self._lock:
            if not os.path.lexists(ctx.target_path):
                os.symlink(os.path.realpath(ctx.staging_path), ctx.target_path)
            self.published[ctx.target_path] = ctx.volume_id

    def node_unpublish(self, volume_id: str, target_path: str) -> None:
        with self._lock:
            if os.path.islink(target_path):
                os.unlink(target_path)
            elif os.path.isdir(target_path):
                shutil.rmtree(target_path, ignore_errors=True)
            self.published.pop(target_path, None)


# -- external plugin transport (mirrors drivers/plugin.py) -------------

HANDSHAKE_PREFIX = "NOMAD_TPU_PLUGIN|1|"


class _CSIEndpoint:
    """RPC surface wrapping a concrete CSIPlugin (plugin side)."""

    def __init__(self, plugin: CSIPlugin) -> None:
        self.plugin = plugin

    def plugin_info(self, args):
        info = self.plugin.plugin_info()
        return {
            "name": info.name, "version": info.version,
            "controller": info.controller, "node": info.node,
        }

    def probe(self, args):
        return self.plugin.probe()

    def controller_publish(self, args):
        return self.plugin.controller_publish(
            args["volume_id"], args["external_id"], args["node_id"],
            args["read_only"],
        )

    def controller_unpublish(self, args):
        self.plugin.controller_unpublish(
            args["volume_id"], args["external_id"], args["node_id"]
        )

    def validate_volume(self, args):
        self.plugin.validate_volume(
            args["volume_id"], args["external_id"], args["access_mode"],
            args["attachment_mode"],
        )

    def node_get_info(self, args):
        return self.plugin.node_get_info()

    def create_volume(self, args):
        return self.plugin.create_volume(args["name"], args.get("params") or {})

    def delete_volume(self, args):
        self.plugin.delete_volume(args["external_id"])

    def create_snapshot(self, args):
        return self.plugin.create_snapshot(
            args["external_id"], args.get("name", ""),
            args.get("params") or {},
        )

    def delete_snapshot(self, args):
        self.plugin.delete_snapshot(args["snapshot_id"])

    def list_snapshots(self, args):
        return self.plugin.list_snapshots()

    def _ctx(self, args) -> StageContext:
        return StageContext(**args["ctx"])

    def node_stage(self, args):
        self.plugin.node_stage(self._ctx(args))

    def node_unstage(self, args):
        self.plugin.node_unstage(args["volume_id"], args["staging_path"])

    def node_publish(self, args):
        self.plugin.node_publish(self._ctx(args))

    def node_unpublish(self, args):
        self.plugin.node_unpublish(args["volume_id"], args["target_path"])


def serve_csi_plugin(plugin: CSIPlugin) -> None:
    """CSI-plugin-process main (same contract as drivers.plugin.serve_plugin:
    handshake on stdout, die on stdin EOF)."""
    from ..rpc import RPCServer

    server = RPCServer(host="127.0.0.1", port=0)
    server.register("CSI", _CSIEndpoint(plugin))
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


class ExternalCSIPlugin(CSIPlugin):
    """Parent-side proxy to a CSI plugin process (reference:
    plugins/csi/client.go over gRPC; here the repo's RPC fabric)."""

    def __init__(self, name: str, factory_ref: str) -> None:
        from ..rpc import ConnPool

        self.name = name
        self.factory_ref = factory_ref
        self._proc: Optional[subprocess.Popen] = None
        self._addr: Optional[tuple[str, int]] = None
        self._pool = ConnPool()
        self._lock = threading.Lock()

    def _ensure_running(self) -> tuple[str, int]:
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return self._addr  # type: ignore[return-value]
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "nomad_tpu_torch.plugins.csi",
                 self.factory_ref],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                text=True,
            )
            line = self._proc.stdout.readline().strip()  # type: ignore[union-attr]
            if not line.startswith(HANDSHAKE_PREFIX):
                raise CSIError(f"bad CSI plugin handshake: {line!r}")
            host, _, port = line[len(HANDSHAKE_PREFIX):].partition(":")
            self._addr = (host, int(port))
            return self._addr

    def shutdown_plugin(self) -> None:
        with self._lock:
            if self._proc is not None:
                try:
                    self._proc.stdin.close()  # type: ignore[union-attr]
                    self._proc.wait(timeout=5)
                except Exception:
                    self._proc.kill()
                self._proc = None

    def _call(self, method: str, args=None, timeout_s: float = 30.0):
        from ..rpc import RPCError

        addr = self._ensure_running()
        try:
            return self._pool.call(addr, method, args, timeout_s=timeout_s)
        except RPCError as e:
            raise CSIError(str(e)) from None

    def plugin_info(self) -> CSIPluginInfo:
        d = self._call("CSI.plugin_info")
        return CSIPluginInfo(**d)

    def probe(self) -> bool:
        try:
            return bool(self._call("CSI.probe", timeout_s=5.0))
        except CSIError:
            return False

    def controller_publish(self, volume_id, external_id, node_id, read_only):
        return self._call("CSI.controller_publish", {
            "volume_id": volume_id, "external_id": external_id,
            "node_id": node_id, "read_only": read_only,
        })

    def controller_unpublish(self, volume_id, external_id, node_id):
        self._call("CSI.controller_unpublish", {
            "volume_id": volume_id, "external_id": external_id,
            "node_id": node_id,
        })

    def validate_volume(self, volume_id, external_id, access_mode,
                        attachment_mode):
        self._call("CSI.validate_volume", {
            "volume_id": volume_id, "external_id": external_id,
            "access_mode": access_mode, "attachment_mode": attachment_mode,
        })

    def node_get_info(self):
        return self._call("CSI.node_get_info")

    def create_volume(self, name, params):
        return self._call(
            "CSI.create_volume", {"name": name, "params": params}
        )

    def delete_volume(self, external_id):
        self._call("CSI.delete_volume", {"external_id": external_id})

    def create_snapshot(self, external_id, name, params):
        return self._call("CSI.create_snapshot", {
            "external_id": external_id, "name": name, "params": params,
        })

    def delete_snapshot(self, snapshot_id):
        self._call("CSI.delete_snapshot", {"snapshot_id": snapshot_id})

    def list_snapshots(self):
        return self._call("CSI.list_snapshots")

    def _wire_ctx(self, ctx: StageContext) -> dict:
        return {"ctx": {
            "volume_id": ctx.volume_id, "external_id": ctx.external_id,
            "staging_path": ctx.staging_path, "target_path": ctx.target_path,
            "read_only": ctx.read_only, "access_mode": ctx.access_mode,
            "attachment_mode": ctx.attachment_mode, "context": ctx.context,
        }}

    def node_stage(self, ctx: StageContext) -> None:
        self._call("CSI.node_stage", self._wire_ctx(ctx))

    def node_unstage(self, volume_id: str, staging_path: str) -> None:
        self._call("CSI.node_unstage", {
            "volume_id": volume_id, "staging_path": staging_path,
        })

    def node_publish(self, ctx: StageContext) -> None:
        self._call("CSI.node_publish", self._wire_ctx(ctx))

    def node_unpublish(self, volume_id: str, target_path: str) -> None:
        self._call("CSI.node_unpublish", {
            "volume_id": volume_id, "target_path": target_path,
        })


def _main() -> None:
    import importlib

    if len(sys.argv) != 2 or ":" not in sys.argv[1]:
        sys.stderr.write(
            "usage: python -m nomad_tpu_torch.plugins.csi module:Class\n"
        )
        sys.exit(2)
    mod_name, _, cls_name = sys.argv[1].partition(":")
    mod = importlib.import_module(mod_name)
    serve_csi_plugin(getattr(mod, cls_name)())


if __name__ == "__main__":
    _main()
