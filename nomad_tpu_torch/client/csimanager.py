"""Client-side CSI volume manager.

Port of ``nomad_tpu/client/csimanager.py``.

Reference: client/pluginmanager/csimanager/ — tracks the CSI plugins
available on this node, fingerprints them onto the Node struct
(Node.CSINodePlugins; volume_manager.go owns the stage/publish refcounts,
instance manager the per-plugin health loop). One manager per client:

  * plugins are registered from client config (builtin catalog name or
    ``module:Class`` factory ref for external plugin processes);
  * ``fingerprint()`` yields the node's csi_plugins map the heartbeat
    carries to the servers (feeds scheduler feasibility and the server's
    /v1/plugins aggregation);
  * ``mount_volume`` runs controller-publish → node-stage (refcounted,
    once per volume per node) → node-publish (once per alloc) and returns
    the host path task volume_mounts bind to;
  * ``unmount_alloc`` unwinds publishes and unstages volumes whose last
    alloc left (volume_manager.go UnmountVolume → usage tracker).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..plugins.csi import CSIError, CSIPlugin, ExternalCSIPlugin, StageContext

logger = logging.getLogger("nomad_tpu_torch.csimanager")


def _builtin(name: str) -> Optional[CSIPlugin]:
    if name == "hostpath":
        from ..plugins.csi import FakeCSIPlugin

        return FakeCSIPlugin(name="hostpath")
    return None


class CSIManager:
    def __init__(self, data_dir: str, node_id: str = "") -> None:
        self.data_dir = data_dir
        self.node_id = node_id
        self.plugins: dict[str, CSIPlugin] = {}
        self._lock = threading.Lock()
        # volume_id -> set of alloc ids publishing it (stage refcount)
        self._stage_users: dict[str, set[str]] = {}
        # alloc_id -> list of (plugin_id, volume, target_path)
        self._alloc_mounts: dict[str, list[tuple[str, object, str]]] = {}

    # -- plugin registry ----------------------------------------------

    def register(self, plugin_id: str, plugin: CSIPlugin) -> None:
        with self._lock:
            self.plugins[plugin_id] = plugin

    def register_from_config(self, cfg: dict[str, str]) -> None:
        """cfg: plugin_id -> builtin name | "module:Class" factory ref."""
        for plugin_id, ref in (cfg or {}).items():
            if ":" in ref:
                self.register(plugin_id, ExternalCSIPlugin(plugin_id, ref))
            else:
                p = _builtin(ref)
                if p is None:
                    logger.warning("unknown builtin CSI plugin %r", ref)
                else:
                    self.register(plugin_id, p)

    def shutdown(self) -> None:
        for p in self.plugins.values():
            if isinstance(p, ExternalCSIPlugin):
                p.shutdown_plugin()

    # -- fingerprint ---------------------------------------------------

    def fingerprint(self) -> dict[str, dict]:
        """The node's csi_plugins map (reference: instance manager
        fingerprint loop updating Node.CSINodePlugins)."""
        out: dict[str, dict] = {}
        for plugin_id, plugin in list(self.plugins.items()):
            try:
                info = plugin.plugin_info()
                healthy = plugin.probe()
                provider_id = plugin.node_get_info().get("node_id", "")
            except Exception:
                logger.exception("CSI plugin %s fingerprint failed", plugin_id)
                out[plugin_id] = {"healthy": False}
                continue
            out[plugin_id] = {
                "version": info.version,
                "healthy": healthy,
                "controller": info.controller,
                "node": info.node,
                "provider_node_id": provider_id,
            }
        return out

    # -- mount lifecycle ----------------------------------------------

    def _staging_path(self, plugin_id: str, volume_id: str) -> str:
        return os.path.join(
            self.data_dir, "csi", plugin_id, "staging", volume_id
        )

    def _target_path(self, plugin_id: str, volume_id: str,
                     alloc_id: str) -> str:
        return os.path.join(
            self.data_dir, "csi", plugin_id, "per-alloc", alloc_id, volume_id
        )

    def mount_volume(self, vol, alloc_id: str, read_only: bool) -> str:
        """Full attach for one alloc; returns the published host path.

        ``vol`` is a structs.Volume with type == "csi". Raises CSIError
        when the plugin is absent or any CSI verb fails (the alloc then
        fails setup, matching csi_hook.go's behavior).
        """
        plugin = self.plugins.get(vol.plugin_id)
        if plugin is None:
            raise CSIError(
                f"volume {vol.id}: CSI plugin {vol.plugin_id!r} "
                f"not present on this node"
            )
        plugin.validate_volume(
            vol.id, vol.external_id, vol.access_mode, vol.attachment_mode
        )
        publish_ctx = plugin.controller_publish(
            vol.id, vol.external_id, self.node_id, read_only
        )
        staging = self._staging_path(vol.plugin_id, vol.id)
        target = self._target_path(vol.plugin_id, vol.id, alloc_id)
        ctx = StageContext(
            volume_id=vol.id,
            external_id=vol.external_id,
            staging_path=staging,
            target_path=target,
            read_only=read_only,
            access_mode=vol.access_mode,
            attachment_mode=vol.attachment_mode,
            context={**vol.context, **(publish_ctx or {})},
        )
        with self._lock:
            users = self._stage_users.setdefault(vol.id, set())
            first = not users
            users.add(alloc_id)
        try:
            if first:
                plugin.node_stage(ctx)
            plugin.node_publish(ctx)
        except Exception:
            with self._lock:
                self._stage_users.get(vol.id, set()).discard(alloc_id)
            raise
        with self._lock:
            self._alloc_mounts.setdefault(alloc_id, []).append(
                (vol.plugin_id, vol, target)
            )
        return target

    def unmount_alloc(self, alloc_id: str) -> None:
        """Unpublish this alloc's volumes; unstage + controller-unpublish
        any volume it was the last user of."""
        with self._lock:
            mounts = self._alloc_mounts.pop(alloc_id, [])
        for plugin_id, vol, target in mounts:
            plugin = self.plugins.get(plugin_id)
            if plugin is None:
                continue
            try:
                plugin.node_unpublish(vol.id, target)
            except Exception:
                logger.exception("node_unpublish %s failed", vol.id)
            with self._lock:
                users = self._stage_users.get(vol.id, set())
                users.discard(alloc_id)
                last = not users
            if last:
                try:
                    plugin.node_unstage(
                        vol.id, self._staging_path(plugin_id, vol.id)
                    )
                except Exception:
                    logger.exception("node_unstage %s failed", vol.id)
                try:
                    plugin.controller_unpublish(
                        vol.id, vol.external_id, self.node_id
                    )
                except Exception:
                    logger.exception(
                        "controller_unpublish %s failed", vol.id
                    )
