"""Alloc runner: one allocation's lifecycle on a node.

Port of ``nomad_tpu/client/allocrunner.py``.

Reference: client/allocrunner/alloc_runner.go — Run :292, task-state fan-in
handleTaskStateUpdates :479, Update :802, Destroy :956; the hook pipeline
(alloc dir, networking, …) is a fixed inline sequence in round 1.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

from ..drivers import Driver
from ..structs import Allocation, TaskState
from ..structs.structs import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_RUN,
    JOB_TYPE_BATCH,
    JOB_TYPE_SYSBATCH,
)
from .allocdir import AllocDir
from .allochealth import HealthTracker, new_deployment_status
from .taskrunner import TaskRunner

logger = logging.getLogger("nomad_tpu_torch.allocrunner")


class AllocRunner:
    def __init__(
        self,
        alloc: Allocation,
        drivers: dict[str, Driver],
        data_dir: str,
        on_update: Callable[[Allocation], None],
        node=None,
        state_db=None,
        restore: bool = False,
        client=None,  # the owning Client: prev-alloc lookups + rpc
    ) -> None:
        self._client = client
        self.alloc = alloc.copy()
        self.drivers = drivers
        self.allocdir = AllocDir(data_dir, alloc.id)
        self.alloc_dir = self.allocdir.alloc_dir
        self.on_update = on_update
        self.node = node
        self.state_db = state_db  # persists task handles for reattach
        self.restore = restore
        self.task_runners: dict[str, TaskRunner] = {}
        self._lock = threading.Lock()
        self._destroyed = False
        self._health: Optional[HealthTracker] = None
        self._services = None
        self._network = None  # AllocNetwork when bridge mode

    # ------------------------------------------------------------------

    def _on_handle(self, task_name: str, handle: dict) -> None:
        if self.state_db is not None:
            self.state_db.put_task_handle(self.alloc.id, task_name, handle)

    def _fail_all(self, tg, reason: str) -> None:
        logger.error("alloc %s: %s", self.alloc.id, reason)
        self.alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
        for task in tg.tasks:
            self.alloc.task_states[task.name] = TaskState(
                state="dead", failed=True
            )
        self.on_update(self.alloc)

    def _port_mappings(self) -> list[tuple[int, int]]:
        """(host port, container port) pairs this alloc was granted —
        ports with a `to` mapping forward; unmapped ports relay to the
        same number inside the namespace."""
        out: list[tuple[int, int]] = []
        res = self.alloc.resources
        if res is None:
            return out
        nets = list(res.shared_networks)
        for tr in res.tasks.values():
            nets.extend(tr.networks)
        for net in nets:
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                if p.value:
                    out.append((p.value, p.to or p.value))
        return out

    def run(self) -> None:
        self.allocdir.build()
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        if tg is None:
            logger.error("alloc %s: unknown task group", self.alloc.id)
            self.alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
            self.on_update(self.alloc)
            return
        # Volume hook (reference alloc_runner_hooks.go csi_hook/volume_hook):
        # resolve group volume asks to host paths — host volumes from the
        # node fingerprint, CSI volumes via claim fetch + plugin mount —
        # before any task starts. Failure fails the alloc, not the node.
        try:
            volume_paths = self._resolve_volumes(tg)
        except Exception as e:
            self._fail_all(tg, f"volume setup failed: {e}")
            return
        # Bridge networking (reference alloc_runner_hooks.go
        # network_hook → networking_bridge_linux.go): a netns per alloc,
        # veth onto the shared bridge, and host→container port relays
        # for every granted port with a `to` mapping.
        if (
            tg.networks
            and tg.networks[0].mode == "bridge"
            and self._client is not None
        ):
            from .network import BridgeNetwork, NetworkError, PortProxy

            if not BridgeNetwork.available():
                self._fail_all(tg, "bridge networking unavailable on host")
                return
            try:
                net = self._client.bridge_network.create(self.alloc.id)
                for host_port, to_port in self._port_mappings():
                    net.proxies.append(
                        PortProxy(host_port, net.ip, to_port)
                    )
                self._network = net
            except (NetworkError, OSError) as e:
                self._client.bridge_network.destroy(self.alloc.id)
                self._fail_all(tg, f"network setup failed: {e}")
                return
        # Sticky/migrate ephemeral disk: inherit the previous alloc's
        # shared data before any task starts (reference allocwatcher;
        # restored allocs already own their dir).
        if (
            not self.restore
            and self.alloc.previous_allocation
            and self._client is not None
            and (tg.ephemeral_disk.sticky or tg.ephemeral_disk.migrate)
        ):
            from .allocwatcher import PrevAllocMigrator

            PrevAllocMigrator(
                self.alloc,
                tg,
                self.allocdir,
                lambda aid: self._client.alloc_runners.get(aid),
                rpc=self._client.rpc,
                secret=self._client.endpoints.rpc.keyring,
                tls_context=(
                    self._client.tls[1] if self._client.tls else None
                ),
            ).run()
        batch = job.type in (JOB_TYPE_BATCH, JOB_TYPE_SYSBATCH)
        restored_states = (
            self.state_db.get_task_states(self.alloc.id)
            if (self.restore and self.state_db is not None)
            else {}
        )
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                self.alloc.client_status = ALLOC_CLIENT_STATUS_FAILED
                self.alloc.task_states[task.name] = TaskState(
                    state="dead", failed=True
                )
                self.on_update(self.alloc)
                return
            restore_handle = None
            if self.restore and self.state_db is not None:
                restore_handle = self.state_db.get_task_handle(
                    self.alloc.id, task.name
                )
            tr = TaskRunner(
                self.alloc,
                task,
                driver,
                self.allocdir,
                self._task_state_updated,
                batch=batch,
                node=self.node,
                on_handle=self._on_handle,
                restore_handle=restore_handle,
                restore_state=restored_states.get(task.name),
                device_manager=(
                    self._client.device_manager
                    if self._client is not None
                    else None
                ),
                volume_paths=volume_paths,
                service_fn=(
                    (
                        lambda name: self._client.rpc.service_lookup(
                            self.alloc.namespace, name
                        )
                    )
                    if self._client is not None
                    else None
                ),
                secret_fn=(
                    (
                        lambda path, token="": self._client.rpc.secret_read(
                            self.alloc.namespace, path, token
                        )
                    )
                    if self._client is not None
                    else None
                ),
                vault_client=(
                    self._client.vault_client
                    if self._client is not None
                    else None
                ),
                network_ns=(
                    self._network.ns_path if self._network is not None else ""
                ),
            )
            self.task_runners[task.name] = tr
        for tr in self.task_runners.values():
            tr.start()
        # Service registration + checks (reference: the group/task
        # services hook via client/serviceregistration; catalog rows ride
        # raft into the cluster's own services table)
        if self._client is not None:
            from .serviceregistration import ServiceWatcher

            self._services = ServiceWatcher(
                self.alloc, self.node, self._client.rpc,
                exec_fn=self._check_exec,
                restart_fn=self._check_restart,
                started_fn=self._task_started_stamp,
            )
            self._services.start()
        # Deployment allocs get a health watcher (reference
        # alloc_runner_hooks.go: allocHealthWatcherHook → client/allochealth).
        # Canaries arrive with a deployment_status already attached
        # (canary=True, healthy=None) — "not yet judged" is healthy=None,
        # not status=None.
        ds = self.alloc.deployment_status
        if self.alloc.deployment_id and (ds is None or ds.healthy is None):
            self._health = HealthTracker(
                self.alloc, self._task_states, self._set_health
            )
            self._health.start()
        self._task_state_updated()

    def _resolve_volumes(self, tg) -> dict[str, tuple[str, bool]]:
        """Group volume name -> (host path, read_only).

        Host volumes come straight from the node fingerprint; CSI volumes
        are fetched by claim (Volume.for_alloc) and mounted through the
        node's CSI plugin. An unsatisfiable CSI ask raises — feasibility
        screened nodes, so this means the plugin died since placement."""
        paths: dict[str, tuple[str, bool]] = {}
        mounted = {vm.volume for t in tg.tasks for vm in t.volume_mounts}
        csi_vols = None
        for name, req in tg.volumes.items():
            if req.type in ("", "host"):
                hv = self.node.host_volumes.get(req.source) if self.node else None
                if hv is not None and hv.path:
                    paths[name] = (hv.path, hv.read_only or req.read_only)
                elif name in mounted:
                    # Feasibility placed us here because the fingerprint
                    # advertised the volume; if it's gone (or pathless)
                    # by run time, a task mount can't be satisfied —
                    # fail the alloc, not a per-task restart loop.
                    raise RuntimeError(
                        f"volume {name}: host volume {req.source!r} "
                        f"not present on this node"
                    )
            elif req.type == "csi":
                if self._client is None:
                    raise RuntimeError(
                        f"volume {name}: CSI mounts need a client context"
                    )
                if csi_vols is None:
                    csi_vols = self._client.rpc.volumes_for_alloc(self.alloc.id)
                match = next(
                    (
                        v
                        for v in csi_vols
                        if v.name == req.source and v.type == "csi"
                    ),
                    None,
                )
                if match is None:
                    raise RuntimeError(
                        f"volume {name}: no claimed CSI volume for source "
                        f"{req.source!r}"
                    )
                target = self._client.csi_manager.mount_volume(
                    match, self.alloc.id, req.read_only
                )
                paths[name] = (target, req.read_only)
        return paths

    def _task_states(self) -> dict:
        with self._lock:
            return {name: tr.state for name, tr in self.task_runners.items()}

    def _set_health(self, healthy: bool) -> None:
        with self._lock:
            status = new_deployment_status(healthy)
            # the canary marker rides the same struct — never clobber it
            prev = self.alloc.deployment_status
            if prev is not None:
                status.canary = prev.canary
            self.alloc.deployment_status = status
        self.on_update(self.alloc)

    def _task_state_updated(self) -> None:
        """Fan task states into the alloc's client status
        (reference alloc_runner.go:479)."""
        with self._lock:
            states = {name: tr.state for name, tr in self.task_runners.items()}
            self.alloc.task_states = {k: v.copy() for k, v in states.items()}
            if self.state_db is not None:
                for name, st in states.items():
                    self.state_db.put_task_state(self.alloc.id, name, st)
            failed = any(s.failed for s in states.values())
            all_dead = all(s.state == "dead" for s in states.values()) and states
            any_running = any(s.state == "running" for s in states.values())
            leader = next(
                (
                    name
                    for name, tr in self.task_runners.items()
                    if tr.task.leader
                ),
                None,
            )
            if failed:
                status = ALLOC_CLIENT_STATUS_FAILED
            elif all_dead:
                status = ALLOC_CLIENT_STATUS_COMPLETE
            elif any_running:
                status = ALLOC_CLIENT_STATUS_RUNNING
            else:
                status = ALLOC_CLIENT_STATUS_PENDING
            self.alloc.client_status = status
            # leader death kills followers (reference task_hook_coordinator)
            if leader and states.get(leader, TaskState()).state == "dead":
                for name, tr in self.task_runners.items():
                    if name != leader:
                        tr.kill()
            # tasks exited on their own (batch completion, failure):
            # deregister services and stop the check loop — the catalog
            # must not advertise a dead instance
            services = None
            teardown_net = False
            if status in (
                ALLOC_CLIENT_STATUS_COMPLETE, ALLOC_CLIENT_STATUS_FAILED
            ):
                services, self._services = self._services, None
                teardown_net = self._network is not None
        if services is not None:
            services.stop()
        if teardown_net:
            self._teardown_network()
        # Always sync: task_states changed even when status didn't, and the
        # client's alloc-sync loop batches/dedups by alloc id anyway.
        self.on_update(self.alloc)

    # ------------------------------------------------------------------

    def _lifecycle_targets(self, task_name: str):
        """Runners an operator lifecycle verb applies to: the named task
        (must exist), or every RUNNING task — a dead prestart task must
        not fail a whole-alloc restart (reference alloc restart only
        errors for an explicitly named non-running task)."""
        with self._lock:
            runners = dict(self.task_runners)
        if task_name:
            tr = runners.get(task_name)
            if tr is None:
                raise KeyError(f"task {task_name!r} not in alloc")
            return [tr]
        running = [
            tr for tr in runners.values() if tr.state.state == "running"
        ]
        if not running:
            raise RuntimeError("no running tasks in allocation")
        return running

    def restart(self, task_name: str = "") -> None:
        """Restart one task or every running task (reference
        alloc_endpoint.go Restart → task runner restart without budget)."""
        for tr in self._lifecycle_targets(task_name):
            tr.trigger_restart()

    # -- health-check hooks (serviceregistration.ServiceWatcher) -------

    def _check_exec(self, task_name: str, cmd: list, timeout_s: float):
        """Script checks run INSIDE the task's context via the driver
        (reference command/agent/consul/check_watcher.go execs through
        the driver's ExecTask). Non-zero on any failure to exec."""
        from ..drivers.base import DriverError

        tr = self.task_runners.get(task_name)
        if tr is None or tr.state.state != "running":
            return 1
        try:
            _out, code = tr.driver.exec_task(
                tr.task_id, cmd, timeout_s=max(timeout_s, 0.1)
            )
            return code
        except (DriverError, OSError):
            return 1

    def _task_started_stamp(self, task_name: str):
        """Start stamp for check_restart grace re-arming: changes on
        every (re)start of the task. Group services ("" task) re-arm on
        ANY task's restart — a group trip bounces every task."""
        if not task_name:
            return max(
                (tr.state.started_at_ns
                 for tr in self.task_runners.values()),
                default=0,
            )
        tr = self.task_runners.get(task_name)
        return tr.state.started_at_ns if tr is not None else 0

    def _check_restart(self, task_name: str, reason: str) -> None:
        """check_restart tripped: bounce the owning task (group service
        → every task, matching the reference's group-level semantics),
        consuming restart-policy budget. A NAMED task that doesn't
        exist is a config error — restarting the whole healthy group
        for it would burn every task's budget."""
        if task_name and task_name not in self.task_runners:
            logger.error(
                "alloc %s: check_restart names unknown task %r — ignoring",
                self.alloc.id[:8], task_name,
            )
            return
        targets = (
            [self.task_runners[task_name]]
            if task_name
            else list(self.task_runners.values())
        )
        for tr in targets:
            tr.trigger_failure_restart(reason)

    def signal(self, sig: str, task_name: str = "") -> None:
        for tr in self._lifecycle_targets(task_name):
            tr.signal(sig)

    def update(self, updated: Allocation) -> None:
        """Server pushed a new version of this alloc (reference Update :802)."""
        with self._lock:
            self.alloc.desired_status = updated.desired_status
            self.alloc.desired_description = updated.desired_description
            self.alloc.modify_index = updated.modify_index
        if updated.desired_status != ALLOC_DESIRED_STATUS_RUN:
            self.stop()

    def stop(self) -> None:
        # A server-initiated stop must not race the health tracker into
        # reporting a killed (dead, not failed) alloc as healthy.
        if self._health is not None:
            self._health.stop()
        if self._services is not None:
            self._services.stop()
            self._services = None
        for tr in self.task_runners.values():
            tr.kill()

    def _teardown_network(self) -> None:
        """Release the netns and its host-port relays (reference:
        network_hook Postrun)."""
        net, self._network = self._network, None
        if net is not None and self._client is not None:
            try:
                self._client.bridge_network.destroy(self.alloc.id)
            except Exception:
                logger.exception(
                    "alloc %s: network teardown failed", self.alloc.id
                )

    def destroy(self) -> None:
        self._destroyed = True
        self.stop()
        self._teardown_network()
        if self._client is not None:
            # unwind CSI publishes (reference: csi_hook Postrun)
            try:
                self._client.csi_manager.unmount_alloc(self.alloc.id)
            except Exception:
                logger.exception(
                    "alloc %s: CSI unmount failed", self.alloc.id
                )
        if self.state_db is not None:
            self.state_db.delete_alloc(self.alloc.id)

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return all(tr.wait(timeout_s) for tr in self.task_runners.values())

    def is_terminal(self) -> bool:
        with self._lock:
            return self.alloc.client_terminal_status()
