"""Client-side service registration + health checking.

Port of ``nomad_tpu/client/serviceregistration.py``.

Reference: client/serviceregistration/ (the workload-services hook,
nsd/ provider) and command/agent/consul/check_watcher.go — the consul
sync's check scheduling, rebuilt against the cluster's OWN catalog (the
native-service-discovery design): registrations ride raft into the
services table, and this watcher pushes aggregate check status updates
the same way the consul agent would flip a check to critical.

One ServiceWatcher per alloc covers group services and every task's
services. Checks supported: ``http`` (2xx = passing), ``tcp``
(connect = passing) and ``script`` (command exec'd INSIDE the task via
the driver, exit 0 = passing — reference structs.go ServiceCheck
Command); intervals honor the check's ``interval``/``timeout``
(defaults 10s/2s, floors 1s/0.1s). A ``check_restart`` stanza
(reference command/agent/consul/check_watcher.go) restarts the task
after ``limit`` consecutive failures once ``grace`` has elapsed from
watch start; the restart consumes the task's restart-policy budget, so
a permanently sick task eventually fails instead of flapping forever.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import urllib.request
from typing import Optional

from ..structs.structs import ServiceRegistration

logger = logging.getLogger("nomad_tpu_torch.services")


def _parse_secs(v, default: float) -> float:
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    from ..jobspec.hcl import parse_duration

    try:
        return parse_duration(str(v))
    except Exception:
        return default


def build_registrations(alloc, node, with_services: bool = False):
    """Materialize the alloc's service stanzas into catalog rows.

    Address selection (reference serviceregistration.GetAddress): the
    node's advertised IP; port from the alloc's allocated network ports
    by label, falling back to a literal numeric port_label.

    with_services=True also returns the source Service stanza per row
    (parallel list) so callers can pair checks without re-deriving the
    mapping."""
    job = alloc.job
    tg = job.lookup_task_group(alloc.task_group) if job else None
    if tg is None:
        return ([], []) if with_services else []
    address = ""
    if node is not None:
        address = node.attributes.get("unique.network.ip-address", "")
        if not address and node.http_addr:
            address = node.http_addr.rsplit(":", 1)[0]

    # label -> allocated HOST port value across task network asks AND
    # the group's shared networks (bridge-mode ports live there)
    ports: dict[str, int] = {}
    if alloc.resources is not None:
        nets = list(alloc.resources.shared_networks)
        for tr in alloc.resources.tasks.values():
            nets.extend(tr.networks)
        for net in nets:
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                ports[p.label] = p.value

    def port_for(label: str) -> int:
        if label in ports:
            return ports[label]
        try:
            return int(label)
        except (TypeError, ValueError):
            return 0

    regs: list[ServiceRegistration] = []
    sources: list = []

    def add(svc, task_name: str) -> None:
        sources.append(svc)
        regs.append(
            ServiceRegistration(
                id=(
                    f"_nomad-{alloc.id[:8]}-{task_name or 'group'}-"
                    f"{svc.name}-{svc.port_label}"
                ),
                service_name=svc.name,
                namespace=alloc.namespace,
                node_id=node.id if node is not None else "",
                datacenter=node.datacenter if node is not None else "",
                job_id=alloc.job_id,
                alloc_id=alloc.id,
                task_name=task_name,
                tags=list(svc.tags),
                address=address,
                port=port_for(svc.port_label),
            )
        )

    for svc in tg.services:
        if svc.name:
            add(svc, "")
    for task in tg.tasks:
        for svc in task.services:
            if svc.name:
                add(svc, task.name)
    return (regs, sources) if with_services else regs


class ServiceWatcher:
    """Registers an alloc's services, keeps their check status fresh,
    deregisters on stop."""

    def __init__(self, alloc, node, rpc,
                 poll_interval_s: Optional[float] = None,
                 exec_fn=None, restart_fn=None, started_fn=None) -> None:
        import os

        self.alloc = alloc
        self.node = node
        self.rpc = rpc
        # exec_fn(task_name, cmd: list, timeout_s) -> exit_code — script
        # checks; restart_fn(task_name, reason) — check_restart trips;
        # started_fn(task_name) -> start stamp (any monotone value that
        # CHANGES on restart) so grace re-arms per instance
        self.exec_fn = exec_fn
        self.restart_fn = restart_fn
        self.started_fn = started_fn
        self._started_at = time.monotonic()
        # (reg.id, check idx) -> consecutive failures since last pass
        self._fail_counts: dict[tuple[str, int], int] = {}
        # task -> last seen start stamp (re-arms counters on change)
        self._grace_base: dict[str, int] = {}
        self.regs, sources = build_registrations(
            alloc, node, with_services=True
        )
        # reg.id -> its source stanza's check dicts, paired by
        # construction (a name registered on two ports keeps its own
        # checks; a key-based lookup couldn't tell them apart)
        self._checks = {
            reg.id: list(svc.checks)
            for reg, svc in zip(self.regs, sources)
        }
        self.poll_interval_s = (
            poll_interval_s
            if poll_interval_s is not None
            else float(os.environ.get("NOMAD_CHECK_POLL_INTERVAL", "10.0"))
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if not self.regs:
            return
        self._register(initial=True)
        if any(self._checks.values()):
            self._thread = threading.Thread(
                target=self._check_loop, daemon=True,
                name=f"svc-checks-{self.alloc.id[:8]}",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.regs:
            try:
                self.rpc.services_deregister_alloc(self.alloc.id)
            except Exception:
                logger.exception(
                    "service deregister for alloc %s failed", self.alloc.id
                )

    # -- internals -----------------------------------------------------

    def _register(self, initial: bool = False) -> None:
        try:
            self.rpc.services_register(self.regs)
        except Exception:
            if initial:
                logger.exception(
                    "service register for alloc %s failed", self.alloc.id
                )

    def _run_check(self, reg: ServiceRegistration, check: dict) -> bool:
        ctype = check.get("type", "tcp")
        # the parser stores seconds under timeout_s; accept the raw
        # jobspec key too for hand-built check dicts
        timeout = _parse_secs(
            check.get("timeout_s", check.get("timeout")), 2.0
        )
        timeout = max(timeout, 0.1)
        addr = check.get("address") or reg.address or "127.0.0.1"
        port = reg.port
        if check.get("port"):
            try:
                port = int(check["port"])
            except (TypeError, ValueError):
                pass
        try:
            if ctype == "script":
                # group-service checks name their exec task via the
                # check's `task` field (reference ServiceCheck.TaskName)
                task = check.get("task") or reg.task_name
                if self.exec_fn is None or not task:
                    logger.warning(
                        "script check on %s has no exec context: critical",
                        reg.service_name,
                    )
                    return False
                cmd = [check.get("command", "")] + list(
                    check.get("args") or []
                )
                return self.exec_fn(task, cmd, timeout) == 0
            if ctype == "http":
                path = check.get("path", "/")
                proto = check.get("protocol", "http")
                url = f"{proto}://{addr}:{port}{path}"
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    return 200 <= resp.status < 300
            if ctype == "tcp":
                with socket.create_connection((addr, port), timeout=timeout):
                    return True
        except Exception:
            return False
        logger.warning("unsupported check type %r: marking critical", ctype)
        return False

    def _check_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            changed = False
            for reg in self.regs:
                checks = self._checks.get(reg.id) or []
                if not checks:
                    continue
                passing = True
                for i, c in enumerate(checks):
                    ok = self._run_check(reg, c)
                    passing = passing and ok
                    self._track_restart(reg, i, c, ok)
                status = "passing" if passing else "critical"
                if reg.status != status:
                    reg.status = status
                    changed = True
            if changed and not self._stop.is_set():
                self._register()

    def _track_restart(self, reg, idx: int, check: dict, ok: bool) -> None:
        """check_restart accounting: `limit` consecutive failures after
        `grace` from watch start trip a task restart (reference
        check_watcher.go checkRestart.apply)."""
        cr = check.get("check_restart") or {}
        limit = int(cr.get("limit", 0))
        if limit <= 0 or self.restart_fn is None:
            return
        key = (reg.id, idx)
        if ok:
            self._fail_counts[key] = 0
            return
        # grace counts from the task's LAST start, not watcher birth:
        # a restarted instance gets its full startup window again and
        # the previous instance's failures don't carry over (reference
        # check_watcher.go re-arms on task restart)
        target = check.get("task") or reg.task_name
        grace = float(cr.get("grace_s", 1.0))
        stamp = (
            self.started_fn(target)
            if self.started_fn is not None
            else 0
        )
        if stamp:
            prev = self._grace_base.get(target)
            if prev != stamp:
                # new instance observed: EVERY check that RESOLVES to
                # this task sheds the previous instance's failures —
                # including group-service checks naming it via `task`
                self._grace_base[target] = stamp
                for r in self.regs:
                    for i, c in enumerate(self._checks.get(r.id) or []):
                        if (c.get("task") or r.task_name) == target:
                            self._fail_counts[(r.id, i)] = 0
            # grace runs from the task's REAL start, so a long-running
            # instance's first failure counts immediately (reference
            # check_watcher: grace shields startup, not steady state)
            if (time.time_ns() - stamp) / 1e9 < grace:
                return
        elif time.monotonic() - self._started_at < grace:
            return
        n = self._fail_counts.get(key, 0) + 1
        self._fail_counts[key] = n
        if n < limit:
            return
        self._fail_counts[key] = 0
        reason = (
            f"check {check.get('name') or check.get('type')!r} "
            f"unhealthy {n}x"
        )
        logger.warning(
            "alloc %s task %s: %s — restarting",
            self.alloc.id[:8], target or "(group)", reason,
        )
        try:
            self.restart_fn(target, reason)
        except Exception:
            logger.exception("check_restart restart failed")
