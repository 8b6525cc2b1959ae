"""The node agent.

Port of ``nomad_tpu/client/client.py``.

Reference: client/client.go (3,085 LoC) — NewClient :325, registration +
heartbeat :1554, watchAllocations :2003 (blocking query), runAllocs :2233
(diff desired vs running), batched status sync allocSync :1936.

The server connection is the `rpc` object — in-process round 1, the
msgpack-RPC fabric in Phase 2. The client only uses five verbs, mirroring
the reference's Node.* RPCs: register, heartbeat, get_client_allocs,
update_allocs, deregister.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Optional

from ..drivers import BUILTIN_DRIVERS, Driver
from ..drivers.base import HEALTH_STATE_HEALTHY, HEALTH_STATE_UNDETECTED
from ..structs import Allocation, Node
from ..structs.structs import ALLOC_DESIRED_STATUS_RUN, DriverInfo, now_ns
from .allocrunner import AllocRunner
from .fingerprint import dynamic_attributes, fingerprint_node

logger = logging.getLogger("nomad_tpu_torch.client")

ALLOC_SYNC_INTERVAL_S = 0.2  # reference: allocSyncIntv 200ms


class ServerRPC:
    """In-process stand-in for the client<->server RPC fabric."""

    def __init__(self, server) -> None:
        self.server = server

    def register(self, node: Node) -> float:
        return self.server.node_register(node)

    def heartbeat(self, node_id: str) -> float:
        return self.server.node_heartbeat(node_id)

    def get_client_allocs(self, node_id: str, min_index: int, timeout_s: float):
        return self.server.get_client_allocs(node_id, min_index, timeout_s)

    def update_allocs(self, allocs: list[Allocation]) -> None:
        self.server.update_allocs_from_client(allocs)

    def volumes_for_alloc(self, alloc_id: str) -> list:
        return self.server.state.volumes_for_alloc(alloc_id)

    def services_register(self, regs: list) -> None:
        self.server.services_register(regs)

    def services_deregister_alloc(self, alloc_id: str) -> None:
        self.server.services_deregister_alloc(alloc_id)

    def service_lookup(self, namespace: str, name: str) -> list:
        return self.server.state.service_registrations(namespace, name)

    def secret_read(self, namespace: str, path: str, token: str = ""):
        # in-process dev shim: no ACL enforcement (the fabric endpoint
        # enforces read-secret when the cluster runs with ACLs on)
        return self.server.state.secret_by_path(namespace, path)

    def derive_token(self, alloc_id: str, task_name: str) -> dict:
        return self.server.derive_task_token(alloc_id, task_name)

    def renew_token(self, accessor_id: str) -> float:
        return self.server.renew_task_token(accessor_id)

    def revoke_token(self, accessor_id: str) -> None:
        self.server.acl_token_delete([accessor_id])

    def alloc_client_addr(self, alloc_id: str):
        """(alloc, 'host:port' of its node's client fabric) or (None, None)
        — the prev-alloc migrator's cross-node lookup."""
        alloc = self.server.state.alloc_by_id(alloc_id)
        if alloc is None:
            return None, None
        node = self.server.state.node_by_id(alloc.node_id)
        addr = node.attributes.get("unique.client.rpc") if node else None
        return alloc, addr


def default_data_dir() -> str:
    """The port's own data dir under the temp dir, apart from
    nomad_tpu's ``/tmp/nomad_tpu``."""
    return os.path.join(tempfile.gettempdir(), "nomad_tpu_torch")


class Client:
    def __init__(
        self,
        rpc,
        data_dir: Optional[str] = None,
        datacenter: str = "dc1",
        node_class: str = "",
        node: Optional[Node] = None,
        drivers: Optional[dict[str, Driver]] = None,
        rpc_secret="",  # str | rpc.keyring.Keyring (shared by the agent)
        advertise_host: str = "127.0.0.1",
        csi_plugins: Optional[dict] = None,
        driver_plugins: Optional[dict] = None,  # name -> "module:Class"
        device_plugins: Optional[dict] = None,  # name -> "module:Class"
        chroot_env: Optional[dict] = None,  # exec driver's chroot map
        host_volumes: Optional[dict] = None,  # name -> {path, read_only}
        node_meta: Optional[dict] = None,  # static node metadata
        reserved: Optional[dict] = None,  # {cpu, memory, disk} carve-out
        tls=None,  # (server_ctx, client_ctx) — fabric TLS, rpc/tls.py
    ) -> None:
        self.rpc = rpc
        self.tls = tls
        data_dir = data_dir or default_data_dir()
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        # Fingerprint against the REAL data dir: the periodic loop
        # recomputes storage attributes from it, and a mismatched initial
        # value would force a spurious re-register on the first tick.
        self.node = node or fingerprint_node(
            datacenter=datacenter, node_class=node_class, data_dir=data_dir
        )
        # Streaming fs/logs/exec listener; its address is advertised as a
        # node attribute so servers can dial back (client/endpoints.py).
        # advertise_host must be reachable FROM the servers (the agent
        # passes its bind_addr; loopback only works single-host).
        from .endpoints import ClientEndpoints
        from ..rpc.keyring import ensure_keyring

        # One keyring for the streaming listener and every dialer this
        # client spawns (reverse-dial, prev-alloc migration): a live
        # rpc_secret rotation moves them all together (rpc/keyring.py).
        self.keyring = ensure_keyring(rpc_secret)
        self.endpoints = ClientEndpoints(
            self, host=advertise_host, secret=self.keyring,
            tls_context=tls[0] if tls else None,
        )
        host, port = self.endpoints.addr
        self.node.attributes["unique.client.rpc"] = f"{host}:{port}"
        if drivers is not None:
            self.drivers = dict(drivers)
        else:
            self.drivers = {
                name: cls() for name, cls in BUILTIN_DRIVERS.items()
            }
            if chroot_env:
                from ..drivers.exec import ExecDriver

                self.drivers["exec"] = ExecDriver(chroot_env=chroot_env)
        # external driver plugins overlay the builtins (reference:
        # go-plugin catalog); Client owns the merge so builtins are
        # instantiated in exactly one place
        if driver_plugins:
            from ..drivers.plugin import ExternalDriver

            for name, ref in driver_plugins.items():
                self.drivers[name] = ExternalDriver(name, ref)
        # Device plugins: accelerators fingerprint onto the node so the
        # scheduler's DeviceAllocator has real instances to assign.
        from .devicemanager import DeviceManager

        self.device_manager = DeviceManager(external=device_plugins)
        # Bridge networking state (lazy: nothing touches the host until
        # the first bridge-mode alloc lands)
        from .network import BridgeNetwork

        self.bridge_network = BridgeNetwork()
        # CSI plugins (reference: client/pluginmanager/csimanager) — config
        # maps plugin_id -> builtin catalog name | "module:Class" ref.
        from .csimanager import CSIManager

        # operator meta + reserved capacity land on the node BEFORE the
        # class hash (reference: client config meta/reserved stanzas)
        if node_meta:
            self.node.meta.update(
                {str(k): str(v) for k, v in node_meta.items()}
            )
        if reserved:
            self.node.reserved.cpu = int(reserved.get("cpu", 0))
            self.node.reserved.memory_mb = int(reserved.get("memory", 0))
            self.node.reserved.disk_mb = int(reserved.get("disk", 0))
        # operator host volumes land on the node BEFORE the class hash
        # (reference: client config host_volume → Node.HostVolumes)
        if host_volumes:
            from ..structs.structs import HostVolumeConfig

            for name, hv in host_volumes.items():
                self.node.host_volumes[name] = HostVolumeConfig(
                    name=name,
                    path=str(hv.get("path", "")),
                    read_only=bool(hv.get("read_only", False)),
                )
        self.csi_manager = CSIManager(data_dir, node_id=self.node.id)
        self.csi_manager.register_from_config(csi_plugins or {})
        # Task secrets-token derivation + renewal (reference
        # client/vaultclient; the server mints TTL'd cluster tokens).
        from .vaultclient import VaultClient

        self.vault_client = VaultClient(rpc)
        self._fingerprint_drivers()
        self._fingerprint_devices()
        self._fingerprint_csi()
        from ..structs.node_class import compute_node_class

        self.node.computed_class = compute_node_class(self.node)

        # Local persistence: allocs, task state, driver handles — so a
        # restarted agent reattaches to live tasks (reference
        # client/state/state_database.go; restore path client.go:325).
        from .state_db import StateDB

        self.state_db = StateDB(data_dir)
        prev_node_id = self.state_db.get_meta("node_id")
        if node is None and prev_node_id:
            # keep our identity across restarts (reference: node ID file)
            self.node.id = prev_node_id
        self.state_db.put_meta("node_id", self.node.id)

        self.alloc_runners: dict[str, AllocRunner] = {}
        self._pending_updates: dict[str, Allocation] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._registered = threading.Event()
        self._threads: list[threading.Thread] = []
        self.heartbeat_ttl = 10.0
        # Periodic re-fingerprint cadence (reference fingerprint.go:31
        # runs each fingerprinter on its own period; one loop suffices
        # here). Tests shrink it to exercise the update path.
        self.fingerprint_interval_s = 30.0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self.endpoints.start()
        self.vault_client.start()
        # Reverse-dial fallback (reference client_rpc.go): park sessions
        # on the servers so they can reach us even when forward-dial to
        # our advertised address fails (NAT/firewall). Enabled whenever
        # the rpc shim can name server fabric addresses.
        addrs_fn = getattr(self.rpc, "reverse_addrs", None)
        if addrs_fn is not None and addrs_fn():
            from .endpoints import ReverseDialer

            self._reverse = ReverseDialer(
                self, self.endpoints, addrs_fn,
                secret=self.keyring,
                tls_context=self.tls[1] if self.tls else None,
            )
            self._reverse.start()
        self._restore()
        # Registration happens ON the heartbeat thread with retries
        # (reference registerAndHeartbeat runs in a goroutine): agent boot
        # must not block on servers that are still electing a leader.
        for target, name in (
            (self._heartbeat_loop, "client-heartbeat"),
            (self._watch_allocs, "client-watch"),
            (self._alloc_sync, "client-allocsync"),
            (self._fingerprint_loop, "client-fingerprint"),
        ):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def shutdown(self, kill_allocs: bool = True) -> None:
        """kill_allocs=False = agent restart semantics: leave tasks
        running under their executors and keep local state for the next
        incarnation's restore (the reference's default — tasks outlive
        the agent process)."""
        self._shutdown.set()
        if getattr(self, "_reverse", None) is not None:
            self._reverse.stop()
        self.endpoints.stop()
        if kill_allocs:
            runners = list(self.alloc_runners.values())
            for ar in runners:
                ar.destroy()
            # destroy() only SIGNALS the task threads; wait for the
            # kill→destroy path to actually run or the process exits
            # with supervisors still alive (daemonized executors would
            # linger forever after their tasks die). ONE shared deadline
            # — a per-runner bound would multiply by the task count.
            deadline = time.monotonic() + 10.0
            for ar in runners:
                ar.wait(timeout_s=max(0.0, deadline - time.monotonic()))
        self.vault_client.stop()
        self.csi_manager.shutdown()
        self.device_manager.shutdown()
        # kill_allocs=False leaves tasks running in their namespaces;
        # only the in-process port relays stop (the next incarnation
        # adopts the netns and restarts them)
        self.bridge_network.shutdown(keep_namespaces=not kill_allocs)
        # out-of-process driver plugins die with us, not as orphans
        for driver in self.drivers.values():
            stop = getattr(driver, "shutdown_plugin", None)
            if stop is not None:
                try:
                    stop()
                except Exception:
                    logger.exception("driver plugin shutdown failed")
        self.state_db.close()

    # -- loops ---------------------------------------------------------

    def wait_registered(self, timeout_s: float = 15.0) -> bool:
        return self._registered.wait(timeout_s)

    def update_node_meta(self, meta: dict) -> None:
        """Agent-reload path (reference client.Reload → UpdateConfig):
        replace the operator-set static metadata and push the node so
        schedulers see the new constraint/spread targets immediately."""
        from ..structs.node_class import compute_node_class

        self.node.meta = {str(k): str(v) for k, v in meta.items()}
        self.node.computed_class = compute_node_class(self.node)
        if self._registered.is_set():
            try:
                self.rpc.register(self.node)
            except Exception:
                logger.exception("node update after meta reload failed")

    def _fingerprint_drivers(self) -> bool:
        """Run every driver's fingerprint and fold the results into the
        node. Honors each driver's verdict — an undetected driver (e.g.
        docker with no daemon) must not advertise as schedulable or the
        feasibility mask places jobs this node cannot run. Returns True
        when anything observable changed."""
        changed = False
        for name, driver in self.drivers.items():
            try:
                fp = driver.fingerprint()
            except Exception:
                logger.exception("fingerprint of driver %s failed", name)
                continue
            info = DriverInfo(
                attributes=fp.attributes,
                detected=fp.health != HEALTH_STATE_UNDETECTED,
                healthy=fp.health == HEALTH_STATE_HEALTHY,
                health_description=fp.health_description,
                update_time_ns=now_ns(),
            )
            prev = self.node.drivers.get(name)
            if (
                prev is None
                or prev.detected != info.detected
                or prev.healthy != info.healthy
                or prev.attributes != info.attributes
            ):
                changed = True
                self.node.drivers[name] = info
                # drop attributes a now-undetected driver used to claim
                if prev is not None:
                    for k in prev.attributes:
                        if k not in fp.attributes:
                            self.node.attributes.pop(k, None)
            self.node.attributes.update(fp.attributes)
        return changed

    def _fingerprint_devices(self) -> bool:
        """Refresh node.resources.devices from the device plugins;
        True when the device set changed."""
        devices = self.device_manager.fingerprint()
        prev = {
            d.id_string(): [i.id for i in d.instances]
            for d in self.node.resources.devices
        }
        cur = {d.id_string(): [i.id for i in d.instances] for d in devices}
        if prev == cur:
            return False
        self.node.resources.devices = devices
        return True

    def _fingerprint_csi(self) -> bool:
        """Refresh node.csi_plugins from the CSI manager; True on change."""
        cur = self.csi_manager.fingerprint()
        if cur == self.node.csi_plugins:
            return False
        self.node.csi_plugins = cur
        return True

    def _fingerprint_loop(self) -> None:
        """Periodic re-fingerprint (reference fingerprint.go:31-48 —
        periodic fingerprinters push node updates): drivers can appear
        (dockerd started after the agent) or die; dynamic host attributes
        (free disk) drift. On change, re-register so the schedulers see
        the new truth."""
        while not self._shutdown.is_set():
            self._shutdown.wait(self.fingerprint_interval_s)
            if self._shutdown.is_set():
                return
            changed = self._fingerprint_drivers()
            changed = self._fingerprint_devices() or changed
            changed = self._fingerprint_csi() or changed
            dyn = dynamic_attributes(self.data_dir)
            for k, v in dyn.items():
                if self.node.attributes.get(k) != v:
                    self.node.attributes[k] = v
                    changed = True
            # a periodic attribute that STOPPED being reported must be
            # dropped (e.g. cgroups unmounted) — but only after TWO
            # consecutive misses, so a transient sample failure doesn't
            # strip attributes and churn re-registration cluster-wide
            misses = getattr(self, "_dyn_miss_counts", {})
            known = getattr(self, "_dyn_known_keys", set()) | set(dyn)
            for k in list(known):
                if k in dyn:
                    misses.pop(k, None)
                    continue
                misses[k] = misses.get(k, 0) + 1
                if misses[k] >= 2:
                    known.discard(k)
                    misses.pop(k, None)
                    if self.node.attributes.pop(k, None) is not None:
                        changed = True
            self._dyn_miss_counts = misses
            self._dyn_known_keys = known
            if not changed or not self._registered.is_set():
                continue
            from ..structs.node_class import compute_node_class

            self.node.computed_class = compute_node_class(self.node)
            try:
                self.rpc.register(self.node)
            except Exception:
                logger.exception("node update after re-fingerprint failed")

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set() and not self._registered.is_set():
            try:
                self.heartbeat_ttl = self.rpc.register(self.node)
                # Fingerprinting is already done, so promote to ready NOW
                # (reference: updateNodeStatus(ready) right after the
                # batched fingerprint completes) instead of letting the
                # node sit `initializing` until the first TTL/2 beat.
                self.heartbeat_ttl = self.rpc.heartbeat(self.node.id)
                self._registered.set()
            except Exception as e:
                # Honor the node door's Retry-After pacing (429-class,
                # server/cluster.py node_limiter): during a reconnect
                # storm the server admits at a fixed rate and each
                # rejected client backs off exactly as told — with
                # jitter, so a cohort throttled together doesn't return
                # together.
                import random

                from ..ratelimit import retry_after_from_text

                hint = retry_after_from_text(str(e))
                if hint:
                    delay = hint + random.uniform(0, hint / 2)
                    logger.debug(
                        "registration throttled; retrying in %.2fs", delay
                    )
                else:
                    delay = 0.2
                    logger.debug("registration failed; retrying")
                self._shutdown.wait(delay)
        while not self._shutdown.is_set():
            # heartbeat at half the granted TTL (reference client.go:1606)
            self._shutdown.wait(max(self.heartbeat_ttl / 2, 0.5))
            if self._shutdown.is_set():
                return
            try:
                self.heartbeat_ttl = self.rpc.heartbeat(self.node.id)
            except Exception:
                logger.exception("heartbeat failed")

    def _watch_allocs(self) -> None:
        """Blocking-query loop on our alloc set (reference :2003).

        The 10s hold matters at fleet scale: the server wakes this
        query through its per-node watch hub the moment OUR alloc set
        changes, so a long hold costs nothing in reaction latency and
        divides the idle re-poll RPC rate by ten versus the old 1s
        spin (10k clients at 1s = 10k RPCs/s of pure no-change churn)."""
        index = 0
        while not self._shutdown.is_set():
            try:
                allocs, index = self.rpc.get_client_allocs(
                    self.node.id, index + 1, timeout_s=10.0
                )
            except Exception:
                if self._shutdown.is_set():
                    return
                logger.exception("alloc watch failed")
                self._shutdown.wait(1)
                continue
            self._run_allocs(allocs)

    def _run_allocs(self, server_allocs: list[Allocation]) -> None:
        """Diff desired vs running (reference runAllocs :2233)."""
        desired = {a.id: a for a in server_allocs}
        with self._lock:
            existing = dict(self.alloc_runners)
        # removals (server GC'd the alloc entirely)
        for alloc_id, runner in existing.items():
            if alloc_id not in desired:
                runner.destroy()
                with self._lock:
                    self.alloc_runners.pop(alloc_id, None)
        for alloc_id, alloc in desired.items():
            runner = existing.get(alloc_id)
            if runner is None:
                if (
                    alloc.desired_status == ALLOC_DESIRED_STATUS_RUN
                    and not alloc.client_terminal_status()
                ):
                    self.state_db.put_alloc(alloc)
                    runner = AllocRunner(
                        alloc,
                        self.drivers,
                        self.data_dir,
                        self._alloc_updated,
                        node=self.node,
                        state_db=self.state_db,
                        client=self,
                    )
                    with self._lock:
                        self.alloc_runners[alloc_id] = runner
                    runner.run()
            else:
                if alloc.modify_index > runner.alloc.modify_index:
                    self.state_db.put_alloc(alloc)
                    runner.update(alloc)

    def _restore(self) -> None:
        """Recreate runners for persisted allocs, reattaching to live
        tasks (reference client.go restore → allocRunner.Restore)."""
        for alloc in self.state_db.get_allocs():
            if alloc.client_terminal_status():
                continue
            runner = AllocRunner(
                alloc,
                self.drivers,
                self.data_dir,
                self._alloc_updated,
                node=self.node,
                state_db=self.state_db,
                restore=True,
                client=self,
            )
            with self._lock:
                self.alloc_runners[alloc.id] = runner
            runner.run()
            logger.info("restored alloc %s", alloc.id[:8])

    def _alloc_updated(self, alloc: Allocation) -> None:
        """AllocRunner reported a state change; queue for batched sync."""
        with self._lock:
            stub = alloc.copy(keep_job=False)
            self._pending_updates[alloc.id] = stub

    def _alloc_sync(self) -> None:
        """Batched status push (reference allocSync :1936)."""
        while not self._shutdown.is_set():
            self._shutdown.wait(ALLOC_SYNC_INTERVAL_S)
            with self._lock:
                updates = list(self._pending_updates.values())
                self._pending_updates.clear()
            if not updates:
                continue
            try:
                self.rpc.update_allocs(updates)
            except Exception:
                logger.exception("alloc sync failed")
                with self._lock:
                    for u in updates:
                        self._pending_updates.setdefault(u.id, u)

    # -- introspection -------------------------------------------------

    def num_allocs(self) -> int:
        with self._lock:
            return len(self.alloc_runners)
