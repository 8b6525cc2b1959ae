"""In-memory MVCC state store with watch support.

Reference: nomad/state/state_store.go (6,445 LoC, go-memdb immutable radix)
and nomad/state/schema.go:39-60 for the table set. The TPU-native redesign
keeps the same contract the schedulers and plan applier rely on:

  * copy-on-write discipline — structs are immutable once stored; writers
    insert fresh copies, never mutate in place;
  * O(1) snapshots — `snapshot()` marks tables shared and the next write to
    a shared table forks the dict (table-granular COW instead of the
    reference's radix-node-granular COW);
  * every write stamps a monotonically increasing index, and blocking reads
    (`wait_for_index`, the analog of memdb watch channels +
    SnapshotMinIndex, reference nomad/state/state_store.go SnapshotMinIndex)
    park on a condition variable.

The schedulers only read snapshots; the plan applier and FSM write through
the live store.
"""

from __future__ import annotations

import dataclasses
import threading

from ..gctune import paused_gc
from typing import Callable, Iterable, Optional

from ..structs import (
    Allocation,
    Deployment,
    Evaluation,
    Job,
    Node,
    PlanResult,
)
from ..structs.placement_batch import AllocRow, PlacementBatch
from ..structs.structs import (
    ALLOC_CLIENT_STATUS_COMPLETE,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_LOST,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_EVICT,
    ALLOC_DESIRED_STATUS_STOP,
    DEPLOYMENT_STATUS_CANCELLED,
    DEPLOYMENT_STATUS_SUCCESSFUL,
    DEPLOYMENT_STATUSES_TERMINAL,
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_PENDING,
    JOB_STATUS_DEAD,
    JOB_STATUS_PENDING,
    JOB_STATUS_RUNNING,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    NODE_SCHEDULING_ELIGIBLE,
    NODE_SCHEDULING_INELIGIBLE,
    NODE_STATUS_DOWN,
    DrainStrategy,
    now_ns,
)

# Table names (reference: nomad/state/schema.go:39-60)
TABLE_NODES = "nodes"
TABLE_JOBS = "jobs"
TABLE_JOB_VERSIONS = "job_version"
TABLE_JOB_SUMMARIES = "job_summary"
TABLE_EVALS = "evals"
TABLE_ALLOCS = "allocs"
TABLE_DEPLOYMENTS = "deployment"
TABLE_ACL_POLICIES = "acl_policy"
TABLE_ACL_TOKENS = "acl_token"
TABLE_VOLUMES = "volumes"
TABLE_NAMESPACES = "namespaces"
TABLE_SERVICES = "services"
TABLE_SECRETS = "secrets"
TABLE_OPERATOR = "operator_config"
TABLE_SCALING_POLICIES = "scaling_policy"
# (ns, job_id) -> {group: [event dicts]} — bounded scale-event journal
# (reference state_store.go UpsertScalingEvent, JOB_TRACKED_SCALING_EVENTS)
TABLE_SCALING_EVENTS = "scaling_event"
ALL_TABLES = (
    TABLE_NODES,
    TABLE_JOBS,
    TABLE_JOB_VERSIONS,
    TABLE_JOB_SUMMARIES,
    TABLE_EVALS,
    TABLE_ALLOCS,
    TABLE_DEPLOYMENTS,
    TABLE_ACL_POLICIES,
    TABLE_ACL_TOKENS,
    TABLE_VOLUMES,
    TABLE_NAMESPACES,
    TABLE_SERVICES,
    TABLE_SECRETS,
    TABLE_OPERATOR,
    TABLE_SCALING_POLICIES,
    TABLE_SCALING_EVENTS,
)

# Secondary indexes: key -> {alloc_id: Allocation}. Kept under the same
# table-granular COW regime so snapshots see consistent index views.
IDX_ALLOCS_NODE = "_idx_allocs_node"
IDX_ALLOCS_JOB = "_idx_allocs_job"
IDX_ALLOCS_EVAL = "_idx_allocs_eval"
# node_id -> (cpu, memory_mb, disk_mb, complex_count): committed
# non-terminal resource usage per node, maintained incrementally on every
# alloc write. This is what lets the plan applier verify a plan's node set
# with one vectorized compare instead of re-summing each node's allocs
# (reference parallelizes the re-sum over a pool, plan_apply_pool.go:18;
# here the sum is pre-maintained and the compare is numpy). complex_count
# counts non-terminal allocs whose fit cannot be expressed as a 3-vector
# compare (reserved cores, port/network asks) — those nodes take the exact
# per-node path. Values are immutable tuples, replaced wholesale, so the
# table obeys the same COW discipline as every other table.
IDX_NODE_USED = "_idx_node_used"
# priority -> count of non-terminal allocs at that job priority. A few
# integers that let the batch solver prove "no preemptible tier exists
# below this batch's priorities" in O(1) and take the aggregate-usage
# lowering path (O(nodes)) instead of walking every live alloc to build
# tier tensors it would never use.
IDX_PRIO_COUNT = "_idx_prio_count"
INDEX_TABLES = (
    IDX_ALLOCS_NODE, IDX_ALLOCS_JOB, IDX_ALLOCS_EVAL, IDX_NODE_USED,
    IDX_PRIO_COUNT,
)


def usage_contribution(alloc) -> "Optional[tuple[int, int, int, int]]":
    """What this alloc adds to its node's committed usage: (cpu, memory_mb,
    disk_mb, complex) — None for terminal allocs (they hold nothing, the
    same rule allocs_fit applies). complex=1 when the alloc carries
    reserved cores or network/port reservations."""
    if alloc.terminal_status():
        return None
    r = alloc.comparable_resources()
    cx = 0
    ar = alloc.resources
    if ar is not None:
        if ar.shared_networks:
            cx = 1
        else:
            for tr in ar.tasks.values():
                if tr.reserved_cores or tr.networks:
                    cx = 1
                    break
    return (r.cpu, r.memory_mb, r.disk_mb, cx)


def _usage_add(ut: dict, node_id: str, c) -> None:
    if c is None or not node_id:
        return
    cur = ut.get(node_id)
    if cur is None:
        ut[node_id] = c
    else:
        ut[node_id] = (cur[0] + c[0], cur[1] + c[1], cur[2] + c[2], cur[3] + c[3])


def _usage_sub(ut: dict, node_id: str, c) -> None:
    if c is None or not node_id:
        return
    cur = ut.get(node_id)
    if cur is None:
        return
    nxt = (cur[0] - c[0], cur[1] - c[1], cur[2] - c[2], cur[3] - c[3])
    if nxt == (0, 0, 0, 0):
        del ut[node_id]
    else:
        ut[node_id] = nxt


def rebuild_node_usage(allocs: dict) -> dict:
    """Recompute the per-node usage table from scratch (restore path, and
    the test invariant that the incremental table never drifts)."""
    ut: dict[str, tuple[int, int, int, int]] = {}
    for alloc in allocs.values():
        _usage_add(ut, alloc.node_id, usage_contribution(alloc))
    return ut


def _alloc_priority(alloc) -> int:
    return alloc.job.priority if alloc.job is not None else 50


def _prio_add(pt: dict, alloc, c) -> None:
    """Count a non-terminal alloc (c = its usage contribution; None
    means terminal and uncounted — the same rule the usage table uses)."""
    if c is None:
        return
    p = _alloc_priority(alloc)
    pt[p] = pt.get(p, 0) + 1


def _prio_sub(pt: dict, alloc, c) -> None:
    if c is None:
        return
    p = _alloc_priority(alloc)
    cur = pt.get(p, 0) - 1
    if cur <= 0:
        pt.pop(p, None)
    else:
        pt[p] = cur


def rebuild_prio_counts(allocs: dict) -> dict:
    pt: dict[int, int] = {}
    for alloc in allocs.values():
        _prio_add(pt, alloc, usage_contribution(alloc))
    return pt

JOB_TRACKED_VERSIONS = 6


class JobSummary:
    """Queued/running counts per task group (reference structs.go JobSummary)."""

    def __init__(self, job_id: str, namespace: str) -> None:
        self.job_id = job_id
        self.namespace = namespace
        # group -> {queued, complete, failed, running, starting, lost}
        self.summary: dict[str, dict[str, int]] = {}
        self.children_pending = 0
        self.children_running = 0
        self.children_dead = 0
        self.create_index = 0
        self.modify_index = 0

    def copy(self) -> "JobSummary":
        c = JobSummary(self.job_id, self.namespace)
        c.summary = {g: dict(v) for g, v in self.summary.items()}
        c.children_pending = self.children_pending
        c.children_running = self.children_running
        c.children_dead = self.children_dead
        c.create_index = self.create_index
        c.modify_index = self.modify_index
        return c


class StateSnapshot:
    """A consistent read-only view at one index."""

    def __init__(self, tables: dict[str, dict], indexes: dict[str, int], index: int):
        self._tables = tables
        self._indexes = indexes
        self.index = index

    # -- reads shared with the live store (mixin below) --


def _locked_on_live(fn):
    """Guard for readers that ITERATE a table with a Python-level
    predicate: on the LIVE store (which has a _lock) they must hold it,
    because unshared tables and owned inner index dicts mutate in place —
    a concurrent bulk plan apply would raise 'dict changed size during
    iteration' mid-loop. Snapshots have no _lock and read lock-free (their
    tables are frozen). C-atomic reads (dict.get, list(d.values())) don't
    need this. Apply it to any NEW iterating reader added to the mixin."""

    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        lock = getattr(self, "_lock", None)
        if lock is None:
            return fn(self, *args, **kwargs)
        with lock:
            return fn(self, *args, **kwargs)

    return wrapper


class _ReadMixin:
    _tables: dict[str, dict]

    # nodes ------------------------------------------------------------
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._tables[TABLE_NODES].get(node_id)

    def nodes(self) -> list[Node]:
        return list(self._tables[TABLE_NODES].values())

    def nodes_table_index(self) -> int:
        """Raft index of the last nodes-table write — the O(1)
        invalidation key for node-universe caches (the solver's warm
        ready-node lists): node register/update/drain writes move it,
        alloc and usage writes do not."""
        return self._indexes.get(TABLE_NODES, 0)

    @_locked_on_live
    def nodes_by_prefix(self, prefix: str) -> list[Node]:
        return [n for i, n in self._tables[TABLE_NODES].items() if i.startswith(prefix)]

    # jobs -------------------------------------------------------------
    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._tables[TABLE_JOBS].get((namespace, job_id))

    @_locked_on_live
    def jobs(self, namespace: Optional[str] = None) -> list[Job]:
        if namespace is None:
            return list(self._tables[TABLE_JOBS].values())
        return [j for (ns, _), j in self._tables[TABLE_JOBS].items() if ns == namespace]

    @_locked_on_live
    def jobs_by_prefix(self, namespace: str, prefix: str) -> list[Job]:
        return [
            j
            for (ns, jid), j in self._tables[TABLE_JOBS].items()
            if ns == namespace and jid.startswith(prefix)
        ]

    def job_version(self, namespace: str, job_id: str, version: int) -> Optional[Job]:
        return self._tables[TABLE_JOB_VERSIONS].get((namespace, job_id, version))

    @_locked_on_live
    def job_versions(self, namespace: str, job_id: str) -> list[Job]:
        out = [
            j
            for (ns, jid, _), j in self._tables[TABLE_JOB_VERSIONS].items()
            if ns == namespace and jid == job_id
        ]
        out.sort(key=lambda j: j.version, reverse=True)
        return out

    @_locked_on_live
    def jobs_by_periodic(self) -> list[Job]:
        return [j for j in self._tables[TABLE_JOBS].values() if j.is_periodic()]

    @_locked_on_live
    def jobs_by_parent(self, namespace: str, parent_id: str) -> list[Job]:
        return [
            j
            for (ns, _), j in self._tables[TABLE_JOBS].items()
            if ns == namespace and j.parent_id == parent_id
        ]

    def job_summary_by_id(self, namespace: str, job_id: str) -> Optional[JobSummary]:
        return self._tables[TABLE_JOB_SUMMARIES].get((namespace, job_id))

    # evals ------------------------------------------------------------
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._tables[TABLE_EVALS].get(eval_id)

    def evals(self) -> list[Evaluation]:
        return list(self._tables[TABLE_EVALS].values())

    @_locked_on_live
    def evals_by_job(self, namespace: str, job_id: str) -> list[Evaluation]:
        return [
            e
            for e in self._tables[TABLE_EVALS].values()
            if e.namespace == namespace and e.job_id == job_id
        ]

    # allocs -----------------------------------------------------------
    #
    # Alloc tables may hold lazy AllocRow handles (SoA placements,
    # structs/placement_batch.py): the read mixin is THE materialization
    # boundary — readers always receive Allocation objects, minted on
    # first access and cached in the owning batch, so repeated reads
    # don't re-pay. Handles never escape the store/event layer.

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        a = self._tables[TABLE_ALLOCS].get(alloc_id)
        return a.get() if a.__class__ is AllocRow else a

    def allocs(self) -> list[Allocation]:
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in list(self._tables[TABLE_ALLOCS].values())
        ]

    def allocs_by_node(self, node_id: str) -> list[Allocation]:
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in list(
                self._tables[IDX_ALLOCS_NODE].get(node_id, {}).values()
            )
        ]

    def node_usage(self, node_id: str) -> tuple[int, int, int, int]:
        """Committed non-terminal usage on one node: (cpu, memory_mb,
        disk_mb, complex_count). Maintained incrementally on every alloc
        write; the plan applier's vectorized verifier reads this instead of
        re-summing the node's allocs. (No lock needed: a single dict.get
        of an immutable tuple.)"""
        return self._tables[IDX_NODE_USED].get(node_id, (0, 0, 0, 0))

    def alloc_priority_tiers(self) -> list[int]:
        """Ascending job priorities that have at least one committed
        non-terminal alloc — the O(1) preemption-possibility signal the
        batch solver gates its aggregate lowering path on."""
        return sorted(self._tables[IDX_PRIO_COUNT])

    @_locked_on_live
    def allocs_by_node_terminal(
        self, node_id: str, terminal: bool
    ) -> list[Allocation]:
        # the terminal predicate answers from the handle's columns (a
        # fresh SoA row is non-terminal by construction); only returned
        # rows materialize
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in self._tables[IDX_ALLOCS_NODE].get(node_id, {}).values()
            if a.terminal_status() == terminal
        ]

    def allocs_by_job(self, namespace: str, job_id: str) -> list[Allocation]:
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in list(
                self._tables[IDX_ALLOCS_JOB]
                .get((namespace, job_id), {})
                .values()
            )
        ]

    def allocs_by_eval(self, eval_id: str) -> list[Allocation]:
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in list(
                self._tables[IDX_ALLOCS_EVAL].get(eval_id, {}).values()
            )
        ]

    @_locked_on_live
    def allocs_by_deployment(self, deployment_id: str) -> list[Allocation]:
        return [
            a.get() if a.__class__ is AllocRow else a
            for a in self._tables[TABLE_ALLOCS].values()
            if a.deployment_id == deployment_id
        ]

    # namespaces -------------------------------------------------------
    def namespace_by_name(self, name: str):
        return self._tables[TABLE_NAMESPACES].get(name)

    def namespaces(self) -> list:
        return list(self._tables[TABLE_NAMESPACES].values())

    # volumes ----------------------------------------------------------
    def volume_by_id(self, namespace: str, vol_id: str):
        return self._tables[TABLE_VOLUMES].get((namespace, vol_id))

    @_locked_on_live
    def volumes(self, namespace: Optional[str] = None) -> list:
        if namespace is None:
            return list(self._tables[TABLE_VOLUMES].values())
        return [
            v
            for (ns, _), v in self._tables[TABLE_VOLUMES].items()
            if ns == namespace
        ]

    @_locked_on_live
    def volumes_by_name(self, namespace: str, name: str) -> list:
        """Volumes satisfying a group volume.source ask."""
        return [
            v
            for (ns, _), v in self._tables[TABLE_VOLUMES].items()
            if ns == namespace and v.name == name
        ]

    # services ---------------------------------------------------------
    @_locked_on_live
    def service_names(self, namespace: Optional[str] = None) -> list[dict]:
        """Catalog summary: one row per service name (reference:
        ServiceRegistrationsByNamespace)."""
        agg: dict[tuple[str, str], dict] = {}
        for reg in self._tables[TABLE_SERVICES].values():
            if namespace is not None and reg.namespace != namespace:
                continue
            row = agg.setdefault(
                (reg.namespace, reg.service_name),
                {
                    "namespace": reg.namespace,
                    "service_name": reg.service_name,
                    "tags": set(),
                    "instances": 0,
                },
            )
            row["tags"].update(reg.tags)
            row["instances"] += 1
        out = [
            {**r, "tags": sorted(r["tags"])}
            for r in agg.values()
        ]
        out.sort(key=lambda r: (r["namespace"], r["service_name"]))
        return out

    @_locked_on_live
    def service_registrations(self, namespace: str, name: str) -> list:
        out = [
            r
            for r in self._tables[TABLE_SERVICES].values()
            if r.namespace == namespace and r.service_name == name
        ]
        out.sort(key=lambda r: r.id)
        return out

    def service_registration_by_id(self, reg_id: str):
        return self._tables[TABLE_SERVICES].get(reg_id)

    # scaling policies -------------------------------------------------
    def scaling_policies(self, namespace: Optional[str] = None) -> list:
        out = [
            p
            for p in self._tables[TABLE_SCALING_POLICIES].values()
            if namespace is None or p.namespace == namespace
        ]
        out.sort(key=lambda p: (p.namespace, p.job_id, p.group))
        return out

    def scaling_policy_by_id(self, policy_id: str):
        return self._tables[TABLE_SCALING_POLICIES].get(policy_id)

    def scaling_events(self, namespace: str, job_id: str) -> dict:
        """group -> [events], newest first (reference JobScalingEvents)."""
        return self._tables[TABLE_SCALING_EVENTS].get(
            (namespace, job_id), {}
        )

    def scaling_policies_by_job(self, namespace: str, job_id: str) -> list:
        return [
            p
            for p in self._tables[TABLE_SCALING_POLICIES].values()
            if p.namespace == namespace and p.job_id == job_id
        ]

    # operator config --------------------------------------------------
    def operator_config(self, key: str):
        return self._tables[TABLE_OPERATOR].get(key)

    # secrets ----------------------------------------------------------
    def secret_by_path(self, namespace: str, path: str):
        return self._tables[TABLE_SECRETS].get((namespace, path))

    @_locked_on_live
    def secrets(self, namespace: Optional[str] = None) -> list:
        if namespace is None:
            return list(self._tables[TABLE_SECRETS].values())
        return [
            e
            for (ns, _), e in self._tables[TABLE_SECRETS].items()
            if ns == namespace
        ]

    @_locked_on_live
    def expired_acl_tokens(self, now_ns_: int) -> list:
        """Tokens past their expiration (the token-gc sweep's read;
        reference: 1.4 ExpiredACLTokenGC)."""
        return [
            t
            for t in self._tables[TABLE_ACL_TOKENS].values()
            if t.expiration_time_ns and t.expiration_time_ns < now_ns_
        ]

    @_locked_on_live
    def services_by_alloc(self, alloc_id: str) -> list:
        return [
            r
            for r in self._tables[TABLE_SERVICES].values()
            if r.alloc_id == alloc_id
        ]

    @_locked_on_live
    def volumes_for_alloc(self, alloc_id: str) -> list:
        """Volumes holding a claim by this alloc (the client's mount hook
        fetches these; reference: CSIVolume.Get per claimed volume)."""
        return [
            v
            for v in self._tables[TABLE_VOLUMES].values()
            if alloc_id in v.claims
        ]

    @_locked_on_live
    def csi_plugins(self) -> dict[str, dict]:
        """Aggregate CSI plugin health across nodes (reference: the
        CSIPlugin table nomad/state/state_store.go maintains on node
        updates; here computed at read time from the nodes table)."""
        out: dict[str, dict] = {}
        for node in self._tables[TABLE_NODES].values():
            for plugin_id, info in node.csi_plugins.items():
                agg = out.setdefault(plugin_id, {
                    "id": plugin_id,
                    "version": info.get("version", ""),
                    "controllers_healthy": 0,
                    "controllers_expected": 0,
                    "nodes_healthy": 0,
                    "nodes_expected": 0,
                })
                healthy = bool(info.get("healthy"))
                if info.get("controller"):
                    agg["controllers_expected"] += 1
                    agg["controllers_healthy"] += int(healthy)
                if info.get("node", True):
                    agg["nodes_expected"] += 1
                    agg["nodes_healthy"] += int(healthy)
                if info.get("version"):
                    agg["version"] = info["version"]
        return out

    # deployments ------------------------------------------------------
    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self._tables[TABLE_DEPLOYMENTS].get(deployment_id)

    def deployments(self) -> list[Deployment]:
        return list(self._tables[TABLE_DEPLOYMENTS].values())

    @_locked_on_live
    def deployments_by_job(self, namespace: str, job_id: str) -> list[Deployment]:
        return [
            d
            for d in self._tables[TABLE_DEPLOYMENTS].values()
            if d.namespace == namespace and d.job_id == job_id
        ]

    @_locked_on_live
    def latest_deployment_by_job(
        self, namespace: str, job_id: str
    ) -> Optional[Deployment]:
        best = None
        for d in self._tables[TABLE_DEPLOYMENTS].values():
            if d.namespace == namespace and d.job_id == job_id:
                if best is None or d.create_index > best.create_index:
                    best = d
        return best


class StateSnapshotImpl(StateSnapshot, _ReadMixin):
    pass


class StateStore(_ReadMixin):
    def __init__(self) -> None:
        self._tables: dict[str, dict] = {t: {} for t in ALL_TABLES + INDEX_TABLES}
        self._indexes: dict[str, int] = {t: 0 for t in ALL_TABLES}
        self._latest_index = 0
        self._shared: set[str] = set()
        # Inner-index COW ownership: (table, key) pairs whose inner
        # {alloc_id: Allocation} dict is exclusively owned by the live
        # store (no snapshot shares it) and may be mutated in place.
        # Cleared whenever a snapshot is taken. Without this, every index
        # insert copies the inner dict — O(n²) across a bulk plan apply.
        self._idx_owned: set[tuple[str, object]] = set()
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        # Event hooks: called under lock with
        # (index, table, list-of-objects, event-type). The event type mirrors
        # the reference's raft-message-derived stream event types
        # (nomad/state/events.go eventFromChange).
        self._subscribers: list[Callable[[int, str, list, str], None]] = []
        # Restore hooks: called under lock AFTER a snapshot restore (or
        # index rebase) replaces the tables, with (index, alloc node-ids).
        # Separate from _subscribers so internal watch routers can
        # re-prime without emitting synthetic stream events — external
        # stream consumers re-subscribe after a restore, as in the
        # reference.
        self._restore_subs: list[Callable[[int, set], None]] = []

    # -- snapshot / watch ----------------------------------------------

    def snapshot(self) -> StateSnapshotImpl:
        with self._lock:
            self._shared.update(ALL_TABLES + INDEX_TABLES)
            self._idx_owned.clear()
            return StateSnapshotImpl(
                dict(self._tables), dict(self._indexes), self._latest_index
            )

    def latest_index(self) -> int:
        with self._lock:
            return self._latest_index

    def table_index(self, *tables: str) -> int:
        with self._lock:
            return max(self._indexes[t] for t in tables)

    def snapshot_min_index(
        self, index: int, timeout_s: float = 5.0
    ) -> StateSnapshotImpl:
        """Block until the store has applied `index`, then snapshot.

        Reference: nomad/worker.go:228 snapshotMinIndex /
        state_store.go SnapshotMinIndex.
        """
        deadline = now_ns() + int(timeout_s * 1e9)
        with self._cv:
            while self._latest_index < index:
                remaining = (deadline - now_ns()) / 1e9
                if remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for index {index} (at {self._latest_index})"
                    )
                self._cv.wait(remaining)
        return self.snapshot()

    def wait_for_index(
        self, tables: Iterable[str], min_index: int, timeout_s: float = 30.0
    ) -> int:
        """Block until any of `tables` reaches min_index (blocking query)."""
        tables = list(tables)
        deadline = now_ns() + int(timeout_s * 1e9)
        with self._cv:
            while True:
                cur = max(self._indexes[t] for t in tables)
                if cur >= min_index:
                    return cur
                remaining = (deadline - now_ns()) / 1e9
                if remaining <= 0:
                    return cur
                self._cv.wait(remaining)

    def subscribe(self, fn: Callable[[int, str, list, str], None]) -> None:
        self._subscribers.append(fn)

    def subscribe_restore(self, fn: Callable[[int, set], None]) -> None:
        self._restore_subs.append(fn)

    def _notify_restore(self) -> None:
        """Caller holds the lock: hand restore hooks the rebased index
        plus every node that owns allocs in the restored world."""
        if not self._restore_subs:
            return
        node_ids = {
            getattr(a, "node_id", "")
            for a in self._tables[TABLE_ALLOCS].values()
        }
        node_ids.discard("")
        for fn in self._restore_subs:
            fn(self._latest_index, node_ids)

    # -- ACL -----------------------------------------------------------

    def upsert_acl_policies(self, index: int, policies: list) -> None:
        with self._lock:
            t = self._wtable(TABLE_ACL_POLICIES)
            for pol in policies:
                pol = pol.copy()
                existing = t.get(pol.name)
                pol.create_index = existing.create_index if existing else index
                pol.modify_index = index
                t[pol.name] = pol
            self._stamp(index, TABLE_ACL_POLICIES)

    def delete_acl_policies(self, index: int, names: list[str]) -> None:
        with self._lock:
            t = self._wtable(TABLE_ACL_POLICIES)
            for name in names:
                t.pop(name, None)
            self._stamp(index, TABLE_ACL_POLICIES)

    def acl_policy_by_name(self, name: str):
        return self._tables[TABLE_ACL_POLICIES].get(name)

    def acl_policies(self) -> list:
        return list(self._tables[TABLE_ACL_POLICIES].values())

    def upsert_acl_tokens(self, index: int, tokens: list) -> None:
        with self._lock:
            t = self._wtable(TABLE_ACL_TOKENS)
            for tok in tokens:
                tok = tok.copy()
                existing = t.get(tok.accessor_id)
                tok.create_index = existing.create_index if existing else index
                tok.modify_index = index
                t[tok.accessor_id] = tok
            self._stamp(index, TABLE_ACL_TOKENS)

    def delete_acl_tokens(self, index: int, accessor_ids: list[str]) -> None:
        with self._lock:
            t = self._wtable(TABLE_ACL_TOKENS)
            for aid in accessor_ids:
                t.pop(aid, None)
            self._stamp(index, TABLE_ACL_TOKENS)

    def acl_token_by_accessor(self, accessor_id: str):
        return self._tables[TABLE_ACL_TOKENS].get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        # Locked: iterates a live table with a Python predicate (see the
        # _locked_reader note at the bottom of this module).
        with self._lock:
            for tok in self._tables[TABLE_ACL_TOKENS].values():
                if tok.secret_id == secret_id:
                    return tok
            return None

    def acl_tokens(self) -> list:
        return list(self._tables[TABLE_ACL_TOKENS].values())

    def acl_has_management_token(self) -> bool:
        with self._lock:
            return any(
                t.type == "management"
                for t in self._tables[TABLE_ACL_TOKENS].values()
            )

    # -- snapshot persistence ------------------------------------------

    def serialize(self) -> bytes:
        """Full-state snapshot bytes (reference fsm.go:1860 Persist streams
        every table; here one codec blob — tables, indexes, latest)."""
        from .. import codec

        with self._lock:
            self._materialize_rows_locked()
            return codec.pack(
                {
                    "tables": self._tables,
                    "indexes": self._indexes,
                    "latest": self._latest_index,
                }
            )

    def _materialize_rows_locked(self) -> None:
        """Swap any lazy AllocRow handles for their materialized rows in
        place, so the native encoder sees only registered structs. A
        handle and its cached row are the same logical value (snapshot
        readers holding either see identical state), so the in-place
        swap is COW-safe — it is a representation change, not a write."""
        t = self._tables[TABLE_ALLOCS]
        lazy = [
            (k, v) for k, v in t.items() if v.__class__ is AllocRow
        ]
        if not lazy:
            return
        for k, v in lazy:
            t[k] = v.get()
        for table in (IDX_ALLOCS_NODE, IDX_ALLOCS_JOB, IDX_ALLOCS_EVAL):
            for inner in self._tables[table].values():
                for k in list(inner):
                    v = inner[k]
                    if v.__class__ is AllocRow:
                        inner[k] = v.get()

    def restore_from(self, raw: bytes) -> None:
        """Replace all state from snapshot bytes (reference fsm.go:1381
        Restore). Watchers are woken; subscribers are NOT replayed — stream
        consumers must re-subscribe after a restore, as in the reference."""
        from .. import codec

        data = codec.unpack(raw)
        # Forward compatibility: snapshots from before a table existed
        # restore with that table empty instead of KeyError-ing later.
        for t in ALL_TABLES + INDEX_TABLES:
            data["tables"].setdefault(t, {})
        for t in ALL_TABLES:
            data["indexes"].setdefault(t, 0)
        # The usage table's tuple values round-trip as lists through the
        # codec; rebuild from the allocs table rather than trusting them.
        data["tables"][IDX_NODE_USED] = rebuild_node_usage(
            data["tables"][TABLE_ALLOCS]
        )
        data["tables"][IDX_PRIO_COUNT] = rebuild_prio_counts(
            data["tables"][TABLE_ALLOCS]
        )
        with self._cv:
            self._tables = data["tables"]
            self._indexes = data["indexes"]
            self._latest_index = data["latest"]
            self._shared = set()
            self._idx_owned.clear()
            self._notify_restore()
            self._cv.notify_all()

    def rebase_indexes(self, index: int) -> None:
        """Re-stamp every table index to `index` after an operator
        snapshot restore.

        The snapshot carries the indexes of the CLUSTER IT WAS SAVED
        FROM; the restoring cluster's raft log continues from its own
        position. Without rebasing, a snapshot saved at index 5000
        restored into a cluster at index 4 leaves _latest_index=5000
        while new writes stamp 5,6,... — wait_for_index goes stale and
        blocking queries hang (the reference avoids this by resetting
        raft itself to a post-snapshot index in helper/snapshot)."""
        with self._cv:
            for t in self._indexes:
                self._indexes[t] = index
            self._latest_index = index
            self._notify_restore()
            self._cv.notify_all()

    # -- write plumbing ------------------------------------------------

    def _wtable(self, table: str) -> dict:
        """Copy-on-write fork of a table that a live snapshot may share."""
        if table in self._shared:
            self._tables[table] = dict(self._tables[table])
            self._shared.discard(table)
        return self._tables[table]

    def _stamp(self, index: int, *tables: str) -> None:
        for t in tables:
            self._indexes[t] = index
        if index > self._latest_index:
            self._latest_index = index
        self._cv.notify_all()

    def _publish(
        self, index: int, table: str, objs: list, etype: str = ""
    ) -> None:
        for fn in self._subscribers:
            fn(index, table, objs, etype)

    def _idx_put(self, table: str, key, alloc: Allocation) -> None:
        t = self._wtable(table)
        inner = t.get(key)
        if inner is not None and (table, key) in self._idx_owned:
            inner[alloc.id] = alloc
            return
        inner = dict(inner) if inner is not None else {}
        inner[alloc.id] = alloc
        t[key] = inner
        self._idx_owned.add((table, key))

    def _idx_del(self, table: str, key, alloc_id: str) -> None:
        t = self._wtable(table)
        inner = t.get(key)
        if inner and alloc_id in inner:
            if (table, key) not in self._idx_owned:
                inner = dict(inner)
                self._idx_owned.add((table, key))
            del inner[alloc_id]
            if inner:
                t[key] = inner
            else:
                del t[key]
                self._idx_owned.discard((table, key))

    def _put_alloc(self, alloc: Allocation, existing: Optional[Allocation]) -> None:
        """Insert an alloc into the main table and every secondary index."""
        self._wtable(TABLE_ALLOCS)[alloc.id] = alloc
        ut = self._wtable(IDX_NODE_USED)
        pt = self._wtable(IDX_PRIO_COUNT)
        if existing is not None:
            ce = usage_contribution(existing)
            _usage_sub(ut, existing.node_id, ce)
            _prio_sub(pt, existing, ce)
        ca = usage_contribution(alloc)
        _usage_add(ut, alloc.node_id, ca)
        _prio_add(pt, alloc, ca)
        if existing is not None:
            if existing.node_id != alloc.node_id:
                self._idx_del(IDX_ALLOCS_NODE, existing.node_id, alloc.id)
            if (existing.namespace, existing.job_id) != (alloc.namespace, alloc.job_id):
                self._idx_del(
                    IDX_ALLOCS_JOB, (existing.namespace, existing.job_id), alloc.id
                )
            if existing.eval_id != alloc.eval_id:
                self._idx_del(IDX_ALLOCS_EVAL, existing.eval_id, alloc.id)
        self._idx_put(IDX_ALLOCS_NODE, alloc.node_id, alloc)
        self._idx_put(IDX_ALLOCS_JOB, (alloc.namespace, alloc.job_id), alloc)
        self._idx_put(IDX_ALLOCS_EVAL, alloc.eval_id, alloc)

    def _del_alloc(self, alloc_id: str) -> None:
        t = self._wtable(TABLE_ALLOCS)
        alloc = t.pop(alloc_id, None)
        if alloc is not None:
            c = usage_contribution(alloc)
            _usage_sub(self._wtable(IDX_NODE_USED), alloc.node_id, c)
            _prio_sub(self._wtable(IDX_PRIO_COUNT), alloc, c)
            self._idx_del(IDX_ALLOCS_NODE, alloc.node_id, alloc_id)
            self._idx_del(IDX_ALLOCS_JOB, (alloc.namespace, alloc.job_id), alloc_id)
            self._idx_del(IDX_ALLOCS_EVAL, alloc.eval_id, alloc_id)

    # -- nodes ---------------------------------------------------------

    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            t = self._wtable(TABLE_NODES)
            existing = t.get(node.id)
            node = node.copy()
            if existing is not None:
                node.create_index = existing.create_index
                # Server-owned lifecycle state survives client
                # re-registration (reference state_store.go UpsertNode:
                # "Retain node events... transfer the drain/eligibility"):
                # a periodic re-fingerprint must not erase an operator's
                # drain or flip a ready node back to initializing.
                node.drain_strategy = existing.drain_strategy
                node.scheduling_eligibility = existing.scheduling_eligibility
                if existing.status:
                    node.status = existing.status
                    node.status_updated_at = existing.status_updated_at
            else:
                node.create_index = index
            node.modify_index = index
            node.canonicalize()
            t[node.id] = node
            self._stamp(index, TABLE_NODES)
            self._publish(index, TABLE_NODES, [node], "NodeRegistration")

    def upsert_nodes(self, index: int, nodes: list) -> None:
        """Bulk ``upsert_node``: one lock hold, one index stamp, one
        published event block for the whole batch — the store half of
        the batched node-register raft entry (a 10k-node reconnect
        storm commits as a bounded number of entries, each landing
        here once)."""
        with self._lock:
            t = self._wtable(TABLE_NODES)
            upserted = []
            for node in nodes:
                existing = t.get(node.id)
                node = node.copy()
                if existing is not None:
                    node.create_index = existing.create_index
                    node.drain_strategy = existing.drain_strategy
                    node.scheduling_eligibility = (
                        existing.scheduling_eligibility
                    )
                    if existing.status:
                        node.status = existing.status
                        node.status_updated_at = existing.status_updated_at
                else:
                    node.create_index = index
                node.modify_index = index
                node.canonicalize()
                t[node.id] = node
                upserted.append(node)
            self._stamp(index, TABLE_NODES)
            self._publish(index, TABLE_NODES, upserted, "NodeRegistration")

    def update_node_statuses(
        self, index: int, node_ids: list, status: str
    ) -> None:
        """Bulk ``update_node_status``: the store half of the batched
        down-mark raft entry a heartbeat-wheel expiry storm commits.
        Unknown ids are skipped (a node purged between expiry and
        apply), not an error — the batch must land for the rest."""
        with self._lock:
            t = self._wtable(TABLE_NODES)
            updated = []
            stamp = now_ns()
            for node_id in node_ids:
                existing = t.get(node_id)
                if existing is None:
                    continue
                node = existing.copy()
                node.status = status
                node.status_updated_at = stamp
                node.modify_index = index
                t[node_id] = node
                updated.append(node)
            if updated:
                self._stamp(index, TABLE_NODES)
                self._publish(
                    index, TABLE_NODES, updated, "NodeStatusUpdate"
                )

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            t = self._wtable(TABLE_NODES)
            node = t.get(node_id)
            if node is not None:
                del t[node_id]
                self._stamp(index, TABLE_NODES)
                self._publish(index, TABLE_NODES, [node], "NodeDeregistration")

    def update_node_status(self, index: int, node_id: str, status: str) -> None:
        with self._lock:
            t = self._wtable(TABLE_NODES)
            existing = t.get(node_id)
            if existing is None:
                raise KeyError(f"node {node_id} not found")
            node = existing.copy()
            node.status = status
            node.status_updated_at = now_ns()
            node.modify_index = index
            t[node_id] = node
            self._stamp(index, TABLE_NODES)
            self._publish(index, TABLE_NODES, [node], "NodeStatusUpdate")

    def update_node_drain(
        self,
        index: int,
        node_id: str,
        drain: Optional[DrainStrategy],
        mark_eligible: bool = False,
    ) -> None:
        with self._lock:
            t = self._wtable(TABLE_NODES)
            existing = t.get(node_id)
            if existing is None:
                raise KeyError(f"node {node_id} not found")
            node = existing.copy()
            node.drain_strategy = drain.copy() if drain is not None else None
            if drain is not None:
                # Stamp the wall-clock force deadline once, at drain time
                # (reference structs.go DrainStrategy.DeadlineTime).
                if drain.deadline_s > 0 and not node.drain_strategy.force_deadline_ns:
                    node.drain_strategy.force_deadline_ns = now_ns() + int(
                        drain.deadline_s * 1e9
                    )
                node.scheduling_eligibility = NODE_SCHEDULING_INELIGIBLE
            elif mark_eligible:
                node.scheduling_eligibility = NODE_SCHEDULING_ELIGIBLE
            node.modify_index = index
            t[node_id] = node
            self._stamp(index, TABLE_NODES)
            self._publish(index, TABLE_NODES, [node], "NodeDrain")

    def update_node_eligibility(
        self, index: int, node_id: str, eligibility: str
    ) -> None:
        with self._lock:
            t = self._wtable(TABLE_NODES)
            existing = t.get(node_id)
            if existing is None:
                raise KeyError(f"node {node_id} not found")
            if existing.drain_strategy is not None and (
                eligibility == NODE_SCHEDULING_ELIGIBLE
            ):
                raise ValueError("can't make draining node eligible")
            node = existing.copy()
            node.scheduling_eligibility = eligibility
            node.modify_index = index
            t[node_id] = node
            self._stamp(index, TABLE_NODES)
            self._publish(index, TABLE_NODES, [node], "NodeEligibilityUpdate")

    # -- jobs ----------------------------------------------------------

    def upsert_job(self, index: int, job: Job, keep_version: bool = False) -> None:
        with self._lock:
            self._upsert_job_txn(index, job, keep_version)
            self._sync_scaling_policies_txn(index, job)
            self._stamp(index, TABLE_JOBS, TABLE_JOB_VERSIONS, TABLE_JOB_SUMMARIES)
            self._publish(
                index,
                TABLE_JOBS,
                [self._tables[TABLE_JOBS][job.ns_id()]],
                "JobRegistered",
            )

    def _upsert_job_txn(self, index: int, job: Job, keep_version: bool = False) -> None:
        t = self._wtable(TABLE_JOBS)
        job = job.copy()
        existing = t.get(job.ns_id())
        if existing is not None:
            job.create_index = existing.create_index
            job.job_modify_index = index
            if keep_version:
                job.version = existing.version
            elif job.specification_changed(existing):
                job.version = existing.version + 1
            else:
                job.version = existing.version
        else:
            job.create_index = index
            job.job_modify_index = index
            job.version = 0
        job.modify_index = index
        if job.status not in (JOB_STATUS_PENDING, JOB_STATUS_RUNNING, JOB_STATUS_DEAD):
            job.status = JOB_STATUS_PENDING
        if job.stop:
            job.status = JOB_STATUS_DEAD
        t[job.ns_id()] = job
        # version history
        vt = self._wtable(TABLE_JOB_VERSIONS)
        vt[(job.namespace, job.id, job.version)] = job
        versions = sorted(
            (k for k in vt if k[0] == job.namespace and k[1] == job.id),
            key=lambda k: k[2],
            reverse=True,
        )
        for stale in versions[JOB_TRACKED_VERSIONS:]:
            del vt[stale]
        # summary
        st = self._wtable(TABLE_JOB_SUMMARIES)
        summary = st.get(job.ns_id())
        summary = summary.copy() if summary else JobSummary(job.id, job.namespace)
        if summary.create_index == 0:
            summary.create_index = index
        for tg in job.task_groups:
            summary.summary.setdefault(
                tg.name,
                {
                    "queued": 0,
                    "complete": 0,
                    "failed": 0,
                    "running": 0,
                    "starting": 0,
                    "lost": 0,
                },
            )
        summary.modify_index = index
        st[job.ns_id()] = summary

    def _sync_scaling_policies_txn(self, index: int, job) -> None:
        """Keep the scaling-policy table in lockstep with the job's
        scaling stanzas (reference: UpsertJob upserts/deletes policies
        for the job's groups, state_store.go updateJobScalingPolicies).
        Deterministic ids (ns/job/group) so re-registration updates in
        place."""
        t = self._wtable(TABLE_SCALING_POLICIES)
        wanted: dict[str, object] = {}
        for tg in job.task_groups:
            if tg.scaling is None:
                continue
            pol = tg.scaling.copy()
            pol.id = f"{job.namespace}/{job.id}/{tg.name}"
            pol.namespace = job.namespace
            pol.job_id = job.id
            pol.group = tg.name
            existing = t.get(pol.id)
            pol.create_index = existing.create_index if existing else index
            pol.modify_index = index
            wanted[pol.id] = pol
        stale = [
            pid
            for pid, p in t.items()
            if p.namespace == job.namespace
            and p.job_id == job.id
            and pid not in wanted
        ]
        changed = bool(wanted) or bool(stale)
        for pid in stale:
            del t[pid]
        t.update(wanted)
        if changed:
            self._stamp(index, TABLE_SCALING_POLICIES)

    def reconcile_job_summaries(self, index: int) -> int:
        """Rebuild every job summary from the alloc table (reference
        state_store.go ReconcileJobSummaries — `system reconcile
        summaries` repairs drifted counters). Returns jobs recomputed."""
        with self._lock:
            st = self._wtable(TABLE_JOB_SUMMARIES)
            jobs = dict(self._tables[TABLE_JOBS])
            per_job: dict[tuple, dict[str, dict[str, int]]] = {}
            for alloc in self._tables[TABLE_ALLOCS].values():
                key = (alloc.namespace, alloc.job_id)
                if key not in jobs:
                    continue
                groups = per_job.setdefault(key, {})
                c = groups.setdefault(
                    alloc.task_group,
                    {
                        "queued": 0,
                        "complete": 0,
                        "failed": 0,
                        "running": 0,
                        "starting": 0,
                        "lost": 0,
                    },
                )
                status = alloc.client_status
                if alloc.server_terminal_status() and status not in (
                    ALLOC_CLIENT_STATUS_COMPLETE,
                    ALLOC_CLIENT_STATUS_FAILED,
                    ALLOC_CLIENT_STATUS_LOST,
                ):
                    continue  # stopping: counted nowhere, like fresh GC
                if status == ALLOC_CLIENT_STATUS_RUNNING:
                    c["running"] += 1
                elif status == ALLOC_CLIENT_STATUS_COMPLETE:
                    c["complete"] += 1
                elif status == ALLOC_CLIENT_STATUS_FAILED:
                    c["failed"] += 1
                elif status == ALLOC_CLIENT_STATUS_LOST:
                    c["lost"] += 1
                else:
                    c["starting"] += 1
            for key, job in jobs.items():
                old = st.get(key)
                summary = JobSummary(job.id, job.namespace)
                summary.create_index = old.create_index if old else index
                summary.modify_index = index
                summary.summary = per_job.get(key, {})
                for tg in job.task_groups:
                    summary.summary.setdefault(
                        tg.name,
                        {
                            "queued": 0,
                            "complete": 0,
                            "failed": 0,
                            "running": 0,
                            "starting": 0,
                            "lost": 0,
                        },
                    )
                if old is not None:
                    summary.children_pending = old.children_pending
                    summary.children_running = old.children_running
                    summary.children_dead = old.children_dead
                st[key] = summary
            self._stamp(index, TABLE_JOB_SUMMARIES)
            return len(jobs)

    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            t = self._wtable(TABLE_JOBS)
            job = t.get((namespace, job_id))
            if job is not None:
                del t[(namespace, job_id)]
            vt = self._wtable(TABLE_JOB_VERSIONS)
            for k in [k for k in vt if k[0] == namespace and k[1] == job_id]:
                del vt[k]
            st = self._wtable(TABLE_JOB_SUMMARIES)
            st.pop((namespace, job_id), None)
            sp = self._wtable(TABLE_SCALING_POLICIES)
            for pid in [
                pid
                for pid, p in sp.items()
                if p.namespace == namespace and p.job_id == job_id
            ]:
                del sp[pid]
            self._wtable(TABLE_SCALING_EVENTS).pop(
                (namespace, job_id), None
            )
            self._stamp(
                index, TABLE_JOBS, TABLE_JOB_VERSIONS,
                TABLE_JOB_SUMMARIES, TABLE_SCALING_POLICIES,
                TABLE_SCALING_EVENTS,
            )
            if job is not None:
                self._publish(index, TABLE_JOBS, [job], "JobDeregistered")

    # -- evals ---------------------------------------------------------

    def upsert_evals(self, index: int, evals: list[Evaluation]) -> None:
        with self._lock:
            stored = self._upsert_evals_txn(index, evals)
            self._stamp(index, TABLE_EVALS)
            self._publish(index, TABLE_EVALS, stored, "EvaluationUpdated")

    def _upsert_evals_txn(self, index: int, evals: list[Evaluation]) -> list[Evaluation]:
        t = self._wtable(TABLE_EVALS)
        jobs_touched: set[tuple[str, str]] = set()
        stored: list[Evaluation] = []
        for ev in evals:
            ev = ev.copy()
            existing = t.get(ev.id)
            ev.create_index = existing.create_index if existing else index
            ev.modify_index = index
            t[ev.id] = ev
            stored.append(ev)
            jobs_touched.add((ev.namespace, ev.job_id))
            # Blocked-eval dedup: cancel older blocked evals for the same job.
            if ev.status == EVAL_STATUS_BLOCKED:
                for other in list(t.values()):
                    if (
                        other.id != ev.id
                        and other.job_id == ev.job_id
                        and other.namespace == ev.namespace
                        and other.status == EVAL_STATUS_BLOCKED
                        and other.modify_index < index
                    ):
                        c = other.copy()
                        c.status = "canceled"
                        c.status_description = (
                            f"evaluation {ev.id} successfully blocked"
                        )
                        c.modify_index = index
                        t[other.id] = c
                        stored.append(c)
        for ns, job_id in jobs_touched:
            self._update_job_status_txn(index, ns, job_id)
        return stored

    # reference structs.go JobTrackedScalingEvents = 20
    SCALING_EVENTS_TRACKED = 20

    def upsert_scaling_event(
        self, index: int, namespace: str, job_id: str, group: str,
        event: dict,
    ) -> None:
        """Append one scale event, bounded per group (reference
        state_store.go UpsertScalingEvent keeps the newest
        JobTrackedScalingEvents = 20)."""
        with self._lock:
            t = self._wtable(TABLE_SCALING_EVENTS)
            key = (namespace, job_id)
            cur = t.get(key) or {}
            fresh = {g: list(evs) for g, evs in cur.items()}
            evs = fresh.setdefault(group, [])
            evs.insert(0, dict(event))
            del evs[self.SCALING_EVENTS_TRACKED:]
            t[key] = fresh
            self._stamp(index, TABLE_SCALING_EVENTS)

    def delete_evals(self, index: int, eval_ids: list[str], alloc_ids: list[str]) -> None:
        with self._lock:
            t = self._wtable(TABLE_EVALS)
            gone_evals = [t.pop(eid) for eid in eval_ids if eid in t]
            gone_allocs = [
                a
                for aid in alloc_ids
                if (a := self._tables[TABLE_ALLOCS].get(aid)) is not None
            ]
            for aid in alloc_ids:
                self._del_alloc(aid)
            self._stamp(index, TABLE_EVALS, TABLE_ALLOCS)
            if gone_evals:
                self._publish(index, TABLE_EVALS, gone_evals, "EvaluationDeleted")
            if gone_allocs:
                self._publish(index, TABLE_ALLOCS, gone_allocs, "AllocationDeleted")

    # -- allocs --------------------------------------------------------

    def upsert_allocs(self, index: int, allocs: list[Allocation]) -> None:
        with self._lock:
            stored = self._upsert_allocs_txn(index, allocs)
            self._stamp(index, TABLE_ALLOCS, TABLE_JOB_SUMMARIES)
            self._publish(index, TABLE_ALLOCS, stored, "AllocationUpdated")

    def _upsert_allocs_txn(
        self,
        index: int,
        allocs: list[Allocation],
        owned: bool = False,
        default_job: Optional[Job] = None,
        default_jobs: Optional[dict] = None,
    ) -> list[Allocation]:
        """owned=True transfers ownership of the alloc objects to the store:
        no defensive copy is made and index/time fields are stamped in
        place. Only valid for allocs the caller minted for this write and
        will not mutate afterwards (the plan-apply path: every alloc in a
        submitted Plan is a plan-owned copy or freshly minted — see
        Plan.append_fresh_alloc). At c2m scale the per-alloc copy is the
        single largest cost of applying a plan (VERDICT r2 weak #2).

        Even when owned, allocs matching an EXISTING row are copied before
        the client-state merge below: with leader-direct raft apply the
        submitted objects are concurrently visible to the plan applier's
        OverlaySnapshot, and while index stamps and job re-attachment are
        invisible to its verification math (it reads statuses and
        resources only), the existing-row merge rewrites client_status /
        task_states — those must never mutate under a concurrent reader.
        Fresh inserts (the ~10^5-alloc bulk of a c2m plan) stay
        zero-copy.

        default_jobs — the merged-plan form of default_job: a
        {(namespace, job_id): Job} map when one bulk upsert carries
        allocs scheduled against SEVERAL plans' job versions (the
        batched plan apply commits N same-snapshot plans in one
        transaction)."""
        t = self._wtable(TABLE_ALLOCS)
        jobs_touched: set[tuple[str, str]] = set()
        # (ns, job) -> {task_group: fresh insert count}: jobs whose touched
        # allocs were ALL fresh non-terminal inserts take an O(1) summary
        # increment instead of the full per-alloc rescan.
        fresh_counts: dict[tuple[str, str], dict[str, int]] = {}
        full_jobs: set[tuple[str, str]] = set()
        stored: list[Allocation] = []
        now = now_ns()
        # Per-txn cache of owned inner index dicts: one ownership check per
        # distinct key instead of three per alloc (bulk plans insert ~10³-10⁵
        # allocs that share one job/eval key and a few thousand node keys).
        # The COW/ownership protocol itself lives in _owned_inner — ONE
        # implementation shared with the batch txn.
        inner_cache: dict[tuple[str, object], dict] = {}

        def _inner(table: str, key) -> dict:
            ck = (table, key)
            inner = inner_cache.get(ck)
            if inner is None:
                inner = inner_cache[ck] = self._owned_inner(table, key)
            return inner

        ut = self._wtable(IDX_NODE_USED)
        pt = self._wtable(IDX_PRIO_COUNT)
        if default_jobs is None:
            default_jobs = (
                {(default_job.namespace, default_job.id): default_job}
                if default_job is not None
                else {}
            )
        # Usage-contribution memo: the batch solver's fast-mint path shares
        # ONE AllocatedResources object across a whole group's fresh allocs
        # (solver._materialize_compact), so the contribution walk runs once
        # per distinct (resources, status) instead of once per alloc.
        contrib_cache: dict[tuple, Optional[tuple]] = {}
        for alloc in allocs:
            existing = t.get(alloc.id)
            if not owned or existing is not None:
                alloc = alloc.copy()
            # Plan payloads are denormalized: allocs scheduled against the
            # plan's job version carry job=None and re-attach to it here —
            # BEFORE the existing-alloc fallback, which holds the OLD
            # version and would revert in-place updates.
            if alloc.job is None and default_jobs:
                alloc.job = default_jobs.get(
                    (alloc.namespace, alloc.job_id)
                )
            if existing is not None:
                alloc.create_index = existing.create_index
                alloc.create_time = existing.create_time
                if alloc.job is None:
                    alloc.job = existing.job
                # Client-reported state survives server-side updates.
                if not alloc.task_states and existing.task_states:
                    alloc.task_states = {
                        k: v.copy() for k, v in existing.task_states.items()
                    }
                if alloc.client_status == "pending" and existing.client_status not in (
                    "",
                    "pending",
                ):
                    alloc.client_status = existing.client_status
                    alloc.client_description = existing.client_description
            else:
                alloc.create_index = index
                if not alloc.create_time:
                    alloc.create_time = now
            alloc.modify_index = index
            alloc.modify_time = now
            if alloc.job is None:
                alloc.job = self._tables[TABLE_JOBS].get(
                    (alloc.namespace, alloc.job_id)
                )
            if existing is not None:
                if existing.node_id != alloc.node_id:
                    self._idx_del(IDX_ALLOCS_NODE, existing.node_id, alloc.id)
                    inner_cache.pop((IDX_ALLOCS_NODE, existing.node_id), None)
                old_key = (existing.namespace, existing.job_id)
                if old_key != (alloc.namespace, alloc.job_id):
                    self._idx_del(IDX_ALLOCS_JOB, old_key, alloc.id)
                    inner_cache.pop((IDX_ALLOCS_JOB, old_key), None)
                if existing.eval_id != alloc.eval_id:
                    self._idx_del(IDX_ALLOCS_EVAL, existing.eval_id, alloc.id)
                    inner_cache.pop((IDX_ALLOCS_EVAL, existing.eval_id), None)
            if existing is not None:
                ce = usage_contribution(existing)
                _usage_sub(ut, existing.node_id, ce)
                _prio_sub(pt, existing, ce)
            ar = alloc.resources
            if ar is not None:
                ck2 = (id(ar), alloc.desired_status, alloc.client_status)
                c = contrib_cache.get(ck2)
                if c is None and ck2 not in contrib_cache:
                    c = contrib_cache[ck2] = usage_contribution(alloc)
            else:
                c = usage_contribution(alloc)
            _usage_add(ut, alloc.node_id, c)
            _prio_add(pt, alloc, c)
            t[alloc.id] = alloc
            _inner(IDX_ALLOCS_NODE, alloc.node_id)[alloc.id] = alloc
            key = (alloc.namespace, alloc.job_id)
            _inner(IDX_ALLOCS_JOB, key)[alloc.id] = alloc
            _inner(IDX_ALLOCS_EVAL, alloc.eval_id)[alloc.id] = alloc
            stored.append(alloc)
            jobs_touched.add(key)
            # inlined: with client_status "pending" (non-terminal),
            # terminal_status() reduces to the desired-status check
            if (
                existing is None
                and alloc.client_status == "pending"
                and alloc.desired_status != ALLOC_DESIRED_STATUS_STOP
                and alloc.desired_status != ALLOC_DESIRED_STATUS_EVICT
            ):
                groups = fresh_counts.setdefault(key, {})
                groups[alloc.task_group] = groups.get(alloc.task_group, 0) + 1
            else:
                full_jobs.add(key)
        self._reconcile_summaries_txn(index, full_jobs)
        inc_jobs = [k for k in fresh_counts if k not in full_jobs]
        if inc_jobs:
            st = self._wtable(TABLE_JOB_SUMMARIES)
            for key in inc_jobs:
                ns, jid = key
                summary = st.get(key)
                summary = summary.copy() if summary else JobSummary(jid, ns)
                for g, delta in fresh_counts[key].items():
                    c = summary.summary.setdefault(
                        g,
                        {
                            "queued": 0,
                            "complete": 0,
                            "failed": 0,
                            "running": 0,
                            "starting": 0,
                            "lost": 0,
                        },
                    )
                    c["starting"] += delta
                summary.modify_index = index
                st[key] = summary
        for ns, job_id in jobs_touched:
            self._update_job_status_txn(index, ns, job_id)
        return stored

    @staticmethod
    def _store_rows_py(
        ids: list,
        handles: list,
        idx_list: list,
        main_t: dict,
        job_inner: dict,
        eval_inner: dict,
        node_inners: dict,
    ) -> None:
        """Pure-Python fallback for fastpack.store_rows: group rows per
        node, preserving row order within a node and first-touch node
        order — the exact insertion sequence the eager txn produces
        from a node_allocation dict, so the two paths build
        byte-identical tables (the identity battery serializes and
        compares)."""
        per_node: dict[int, list] = {}
        for uid, h, ti in zip(ids, handles, idx_list):
            bucket = per_node.get(ti)
            if bucket is None:
                bucket = per_node[ti] = []
            bucket.append((uid, h))
        for ti, bucket in per_node.items():
            node_inner = node_inners[ti]
            for uid, h in bucket:
                main_t[uid] = h
                job_inner[uid] = h
                eval_inner[uid] = h
                node_inner[uid] = h

    def _owned_inner(self, table: str, key) -> dict:
        """Writable (ownership-checked) inner index dict — the method
        form of _upsert_allocs_txn's per-txn _inner resolver."""
        tbl = self._wtable(table)
        inner = tbl.get(key)
        if inner is None:
            inner = {}
            tbl[key] = inner
            self._idx_owned.add((table, key))
        elif (table, key) not in self._idx_owned:
            inner = dict(inner)
            tbl[key] = inner
            self._idx_owned.add((table, key))
        return inner

    def _upsert_batches_txn(
        self,
        index: int,
        batches: list[PlacementBatch],
        default_jobs: Optional[dict] = None,
    ) -> list:
        """Insert SoA placement batches: lazy AllocRow handles into the
        main/secondary tables, per-NODE (not per-row) usage-aggregate
        updates from the columns, one priority-count bump and one
        summary increment per batch. Per-row work is exactly the four
        table inserts the id-keyed indexes require — everything the
        eager path did per row beyond that (defensive copy, stamps,
        contribution walk, terminal checks) happens once per batch.

        Rows are all fresh by construction (new uuids; the applier's
        verification preserved that), so the existing-row merge paths
        never apply."""
        from .. import codec

        # native_module never compiles (codec.warm_native is the one
        # sanctioned build point, outside any lock — NV-lock-blocking),
        # so resolving it under the store lock is a cached attribute
        # read, not a C build.
        fp = codec.native_module()
        t = self._wtable(TABLE_ALLOCS)
        ut = self._wtable(IDX_NODE_USED)
        pt = self._wtable(IDX_PRIO_COUNT)
        st = None
        now = now_ns()
        stored: list = []
        jobs_touched: set[tuple[str, str]] = set()
        for b in batches:
            if not len(b):
                continue
            if b.job is None:
                if default_jobs:
                    b.job = default_jobs.get((b.namespace, b.job_id))
                if b.job is None:
                    b.job = self._tables[TABLE_JOBS].get(
                        (b.namespace, b.job_id)
                    )
            b.stamp(index, now)
            key = (b.namespace, b.job_id)
            job_inner = self._owned_inner(IDX_ALLOCS_JOB, key)
            eval_inner = self._owned_inner(IDX_ALLOCS_EVAL, b.eval_id)
            node_inners: dict[int, dict] = {}
            touched = b.touched_nodes()
            for nid, ti, _cnt in touched:
                node_inners[ti] = self._owned_inner(IDX_ALLOCS_NODE, nid)
            # the four dict inserts per row, node-grouped (first-touch
            # node order, row order within a node): one C call per
            # batch when the extension is live, the identical Python
            # loop when it isn't
            hs = b.handles()
            if fp is not None:
                fp.store_rows(
                    b.ids, hs, b.node_idx_raw,
                    t, job_inner, eval_inner, node_inners,
                )
            else:
                self._store_rows_py(
                    b.ids, hs, b.node_idx.tolist(),
                    t, job_inner, eval_inner, node_inners,
                )
            # aggregates: one update per touched node / one per batch
            c = b.row_contribution()
            for nid, _ti, cnt in touched:
                _usage_add(ut, nid, (c[0] * cnt, c[1] * cnt, c[2] * cnt, 0))
            prio = b.job.priority if b.job is not None else 50
            pt[prio] = pt.get(prio, 0) + len(b)
            # summaries: every row is a fresh non-terminal insert, so the
            # O(1) starting-count increment always applies (the eager
            # txn's fresh-counts fast path)
            if st is None:
                st = self._wtable(TABLE_JOB_SUMMARIES)
            summary = st.get(key)
            summary = summary.copy() if summary else JobSummary(key[1], key[0])
            counts = summary.summary.setdefault(
                b.task_group,
                {
                    "queued": 0,
                    "complete": 0,
                    "failed": 0,
                    "running": 0,
                    "starting": 0,
                    "lost": 0,
                },
            )
            counts["starting"] += len(b)
            summary.modify_index = index
            st[key] = summary
            jobs_touched.add(key)
            stored.extend(hs)
        for ns, job_id in jobs_touched:
            self._update_job_status_txn(index, ns, job_id)
        return stored

    def update_allocs_from_client(self, index: int, allocs: list[Allocation]) -> None:
        """Merge client-reported status into stored allocs.

        Reference: state_store.go UpdateAllocsFromClient / nested
        updateClientAllocUpdateIndex.
        """
        with self._lock:
            t = self._wtable(TABLE_ALLOCS)
            jobs_touched: set[tuple[str, str]] = set()
            stored: list[Allocation] = []
            for update in allocs:
                existing = t.get(update.id)
                if existing is None:
                    continue
                alloc = existing.copy()
                alloc.client_status = update.client_status
                alloc.client_description = update.client_description
                alloc.task_states = {
                    k: v.copy() for k, v in update.task_states.items()
                }
                if update.deployment_status is not None:
                    alloc.deployment_status = update.deployment_status.copy()
                if update.network_status is not None:
                    alloc.network_status = dataclasses.replace(update.network_status)
                    alloc.network_status.dns = dict(update.network_status.dns)
                alloc.modify_index = index
                alloc.modify_time = now_ns()
                self._put_alloc(alloc, existing)
                stored.append(alloc)
                jobs_touched.add((alloc.namespace, alloc.job_id))
            self._reconcile_summaries_txn(index, jobs_touched)
            for ns, job_id in jobs_touched:
                self._update_job_status_txn(index, ns, job_id)
            self._stamp(index, TABLE_ALLOCS, TABLE_JOB_SUMMARIES)
            self._publish(
                index, TABLE_ALLOCS, stored, "AllocationUpdatedFromClient"
            )

    def update_alloc_desired_transition(
        self, index: int, transitions: dict[str, "DesiredTransition"], evals: list[Evaluation]
    ) -> None:
        from ..structs.structs import DesiredTransition  # local to avoid cycle

        with self._lock:
            t = self._wtable(TABLE_ALLOCS)
            changed: list[Allocation] = []
            for alloc_id, transition in transitions.items():
                existing = t.get(alloc_id)
                if existing is None:
                    continue
                alloc = existing.copy()
                dt = alloc.desired_transition
                if transition.migrate is not None:
                    dt.migrate = transition.migrate
                if transition.reschedule is not None:
                    dt.reschedule = transition.reschedule
                if transition.force_reschedule is not None:
                    dt.force_reschedule = transition.force_reschedule
                alloc.modify_index = index
                self._put_alloc(alloc, existing)
                changed.append(alloc)
            if evals:
                stored_evals = self._upsert_evals_txn(index, evals)
                self._stamp(index, TABLE_EVALS)
            self._stamp(index, TABLE_ALLOCS)
            if changed:
                self._publish(
                    index, TABLE_ALLOCS, changed, "AllocationUpdateDesiredStatus"
                )
            if evals:
                self._publish(index, TABLE_EVALS, stored_evals, "EvaluationUpdated")

    # -- namespaces ----------------------------------------------------

    def upsert_namespace(self, index: int, ns) -> None:
        with self._lock:
            t = self._wtable(TABLE_NAMESPACES)
            existing = t.get(ns.name)
            ns = ns.copy()
            ns.create_index = existing.create_index if existing else index
            ns.modify_index = index
            t[ns.name] = ns
            self._stamp(index, TABLE_NAMESPACES)
            self._publish(index, TABLE_NAMESPACES, [ns], "NamespaceUpserted")

    def delete_namespace(self, index: int, name: str) -> None:
        """Refuses while the namespace holds jobs or volumes (reference
        namespace_endpoint.go DeleteNamespaces nonTerminal check)."""
        if name == "default":
            raise ValueError("the default namespace cannot be deleted")
        with self._lock:
            t = self._wtable(TABLE_NAMESPACES)
            ns = t.get(name)
            if ns is None:
                raise KeyError(f"namespace {name} not found")
            # Only NON-TERMINAL jobs block deletion (reference
            # namespace_endpoint.go nonTerminal check): dead jobs pending
            # GC should not wedge the namespace for minutes.
            in_use = sum(
                1
                for (jns, _), j in self._tables[TABLE_JOBS].items()
                if jns == name and not (j.stop or j.status == JOB_STATUS_DEAD)
            ) + sum(
                1 for (vns, _) in self._tables[TABLE_VOLUMES] if vns == name
            )
            if in_use:
                raise ValueError(
                    f"namespace {name} has {in_use} jobs/volumes"
                )
            del t[name]
            self._stamp(index, TABLE_NAMESPACES)
            self._publish(index, TABLE_NAMESPACES, [ns], "NamespaceDeleted")

    # -- volumes -------------------------------------------------------

    def upsert_volume(self, index: int, vol) -> None:
        """Register/update a volume. Claims survive re-registration
        (reference: CSIVolumeRegister keeps claim state)."""
        with self._lock:
            t = self._wtable(TABLE_VOLUMES)
            key = (vol.namespace, vol.id)
            existing = t.get(key)
            vol = vol.copy()
            if existing is not None:
                vol.create_index = existing.create_index
                vol.claims = {
                    k: c for k, c in existing.claims.items()
                }
            else:
                vol.create_index = index
            vol.modify_index = index
            t[key] = vol
            self._stamp(index, TABLE_VOLUMES)
            self._publish(index, TABLE_VOLUMES, [vol], "VolumeRegistered")

    def delete_volume(self, index: int, namespace: str, vol_id: str) -> None:
        with self._lock:
            t = self._wtable(TABLE_VOLUMES)
            vol = t.get((namespace, vol_id))
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if vol.claims:
                raise ValueError(
                    f"volume {vol_id} has {len(vol.claims)} active claims"
                )
            del t[(namespace, vol_id)]
            self._stamp(index, TABLE_VOLUMES)
            self._publish(index, TABLE_VOLUMES, [vol], "VolumeDeregistered")

    def claim_volume(
        self,
        index: int,
        namespace: str,
        vol_id: str,
        alloc_id: str,
        node_id: str,
        read_only: bool,
    ) -> None:
        """Attach an alloc's claim; raises on access-mode conflict
        (reference: CSIVolumeClaim)."""
        from ..structs.structs import VolumeClaim

        with self._lock:
            t = self._wtable(TABLE_VOLUMES)
            vol = t.get((namespace, vol_id))
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if alloc_id in vol.claims:
                return
            ok, why = vol.claimable(read_only)
            if not ok:
                raise ValueError(f"volume {vol_id}: {why}")
            vol = vol.copy()
            vol.claims[alloc_id] = VolumeClaim(
                alloc_id=alloc_id,
                node_id=node_id,
                read_only=read_only,
                create_index=index,
            )
            vol.modify_index = index
            t[(namespace, vol_id)] = vol
            self._stamp(index, TABLE_VOLUMES)
            self._publish(index, TABLE_VOLUMES, [vol], "VolumeClaimed")

    def _claim_volumes_txn(self, index: int, allocs: list[Allocation]) -> None:
        """Best-effort claims for freshly placed allocs whose group asks
        for volumes that are REGISTERED (unregistered host volumes keep
        the config-only semantics). Conflicts are logged, not fatal —
        feasibility screened them; a race loses gracefully."""
        vt = self._tables[TABLE_VOLUMES]
        if not vt:
            return
        import logging

        log = logging.getLogger("nomad_tpu_torch.state")
        for alloc in allocs:
            if alloc.terminal_status() or alloc.job is None:
                continue
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg is None or not tg.volumes:
                continue
            for req in tg.volumes.values():
                # A node-pinned volume only serves allocs on its node;
                # prefer the pinned match over an unpinned (any-node) one.
                matches = [
                    vol
                    for vol in vt.values()
                    if vol.namespace == alloc.namespace
                    and vol.name == req.source
                    and vol.node_id in ("", alloc.node_id)
                ]
                matches.sort(key=lambda v: v.node_id == "", )
                if not matches:
                    continue
                vol = matches[0]
                try:
                    self.claim_volume(
                        index,
                        vol.namespace,
                        vol.id,
                        alloc.id,
                        alloc.node_id,
                        req.read_only,
                    )
                except (KeyError, ValueError) as e:
                    log.warning(
                        "volume claim for alloc %s: %s", alloc.id, e
                    )

    # -- operator config -----------------------------------------------

    def upsert_operator_config(self, index: int, key: str, value: dict) -> None:
        """Raft-replicated operator knobs (reference: autopilot config
        lives in raft state, operator_endpoint.go)."""
        with self._lock:
            t = self._wtable(TABLE_OPERATOR)
            t[key] = dict(value)
            self._stamp(index, TABLE_OPERATOR)

    # -- secrets -------------------------------------------------------

    def upsert_secret(self, index: int, entry) -> None:
        with self._lock:
            t = self._wtable(TABLE_SECRETS)
            key = (entry.namespace, entry.path)
            entry = entry.copy()
            existing = t.get(key)
            entry.create_index = existing.create_index if existing else index
            entry.modify_index = index
            t[key] = entry
            self._stamp(index, TABLE_SECRETS)
            # event subscribers must never see secret VALUES — publish a
            # redacted row (path/namespace only)
            self._publish(
                index,
                TABLE_SECRETS,
                [dataclasses.replace(entry, items={})],
                "SecretUpserted",
            )

    def delete_secret(self, index: int, namespace: str, path: str) -> None:
        with self._lock:
            t = self._wtable(TABLE_SECRETS)
            entry = t.pop((namespace, path), None)
            if entry is None:
                raise KeyError(f"secret {path} not found")
            self._stamp(index, TABLE_SECRETS)
            self._publish(
                index,
                TABLE_SECRETS,
                [dataclasses.replace(entry, items={})],
                "SecretDeleted",
            )

    # -- services ------------------------------------------------------

    def upsert_service_registrations(self, index: int, regs: list) -> None:
        """Register/update service instances (reference:
        state_store_service_registration.go UpsertServiceRegistrations)."""
        with self._lock:
            t = self._wtable(TABLE_SERVICES)
            stored = []
            for reg in regs:
                reg = reg.copy()
                existing = t.get(reg.id)
                reg.create_index = (
                    existing.create_index if existing else index
                )
                reg.modify_index = index
                t[reg.id] = reg
                stored.append(reg)
            if stored:
                self._stamp(index, TABLE_SERVICES)
                self._publish(
                    index, TABLE_SERVICES, stored, "ServiceRegistration"
                )

    def delete_service_registrations(self, index: int, ids: list[str]) -> int:
        with self._lock:
            t = self._wtable(TABLE_SERVICES)
            gone = [t.pop(i) for i in ids if i in t]
            if gone:
                self._stamp(index, TABLE_SERVICES)
                self._publish(
                    index, TABLE_SERVICES, gone, "ServiceDeregistration"
                )
            return len(gone)

    def delete_services_by_alloc(self, index: int, alloc_ids) -> int:
        """Drop every registration owned by the given allocs (client
        deregister on task stop + the GC sweep for lost clients)."""
        drop = set(alloc_ids)
        with self._lock:
            t = self._wtable(TABLE_SERVICES)
            gone = [r for r in t.values() if r.alloc_id in drop]
            for r in gone:
                del t[r.id]
            if gone:
                self._stamp(index, TABLE_SERVICES)
                self._publish(
                    index, TABLE_SERVICES, gone, "ServiceDeregistration"
                )
            return len(gone)

    def release_volume_claims_scoped(
        self, index: int, namespace: str, vol_id: str,
        alloc_ids: list[str],
    ) -> int:
        """Drop the given allocs' claims on ONE volume (the detach
        escape hatch — releasing them everywhere would free claims the
        same allocs legitimately hold on other volumes)."""
        drop = set(alloc_ids)
        released = 0
        with self._lock:
            t = self._wtable(TABLE_VOLUMES)
            vol = t.get((namespace, vol_id))
            if vol is None:
                return 0
            hits = drop & vol.claims.keys()
            if not hits:
                return 0
            vol = vol.copy()
            for aid in hits:
                del vol.claims[aid]
                released += 1
            vol.modify_index = index
            t[(namespace, vol_id)] = vol
            self._stamp(index, TABLE_VOLUMES)
            self._publish(
                index, TABLE_VOLUMES, [vol], "VolumeClaimReleased"
            )
        return released

    def release_volume_claims(self, index: int, alloc_ids: list[str]) -> int:
        """Drop the given allocs' claims everywhere; returns how many
        claims were released (the volume watcher's write)."""
        drop = set(alloc_ids)
        released = 0
        with self._lock:
            t = self._wtable(TABLE_VOLUMES)
            changed: list = []
            for key, vol in list(t.items()):
                hits = drop & vol.claims.keys()
                if not hits:
                    continue
                vol = vol.copy()
                for aid in hits:
                    del vol.claims[aid]
                    released += 1
                vol.modify_index = index
                t[key] = vol
                changed.append(vol)
            if changed:
                self._stamp(index, TABLE_VOLUMES)
                self._publish(
                    index, TABLE_VOLUMES, changed, "VolumeClaimReleased"
                )
        return released

    # -- plan results (the serialization point) ------------------------

    def upsert_plan_results(self, index: int, result: PlanResult) -> None:
        """Apply a committed plan atomically (reference state_store.go:318)."""
        self.upsert_plan_results_batch(index, [result])

    def upsert_plan_results_batch(
        self, index: int, results: list[PlanResult]
    ) -> None:
        """Apply N verified plan results as ONE store transaction.

        The batched plan applier commits a whole TPU batch's worth of
        same-snapshot, node-disjoint plans in a single raft entry; here
        they land under one lock acquisition with one bulk alloc upsert
        (one COW table fork, one summaries/status pass, one publish)
        instead of N serial upsert_plan_results calls. Semantics per
        result are identical to the single-plan form — the differential
        state-identity test (tests/test_plan_apply_batch.py) pins that.
        """
        with self._lock, paused_gc():
            allocs_to_upsert: list[Allocation] = []
            batches: list[PlacementBatch] = []
            stopped: list[Allocation] = []
            preempted: list[Allocation] = []
            deployment_events: list = []
            default_jobs: dict[tuple[str, str], Job] = {}
            preemption_evals: list[Evaluation] = []
            for result in results:
                for allocs in result.node_allocation.values():
                    allocs_to_upsert.extend(allocs)
                batches.extend(result.alloc_batches)
                for allocs in result.node_update.values():
                    stopped.extend(allocs)
                for allocs in result.node_preemptions.values():
                    preempted.extend(allocs)
                if result.job is not None:
                    default_jobs[
                        (result.job.namespace, result.job.id)
                    ] = result.job
                if result.deployment is not None:
                    self._upsert_deployment_txn(index, result.deployment)
                    deployment_events.append(
                        self._tables[TABLE_DEPLOYMENTS][result.deployment.id]
                    )
                for du in result.deployment_updates:
                    self._update_deployment_status_txn(index, du)
                    d = self._tables[TABLE_DEPLOYMENTS].get(du.deployment_id)
                    if d is not None:
                        deployment_events.append(d)
                preemption_evals.extend(result.preemption_evals)
            any_deployment = any(
                r.deployment is not None or r.deployment_updates
                for r in results
            )

            t = self._wtable(TABLE_ALLOCS)
            # Stops and preemptions merge desired-status changes onto the
            # existing alloc rather than replacing client state.
            committed: list[Allocation] = []
            for alloc in stopped + preempted:
                existing = t.get(alloc.id)
                merged = alloc.copy()
                if existing is not None:
                    merged = existing.copy()
                    merged.desired_status = alloc.desired_status
                    merged.desired_description = alloc.desired_description
                    merged.preempted_by_allocation = alloc.preempted_by_allocation
                    if alloc.client_status:
                        merged.client_status = alloc.client_status
                else:
                    # Plan raced a GC: recreate a fully-stamped tombstone row.
                    merged.create_index = index
                    merged.job = self._tables[TABLE_JOBS].get(
                        (merged.namespace, merged.job_id)
                    )
                merged.modify_index = index
                merged.modify_time = now_ns()
                self._put_alloc(merged, existing)
                committed.append(merged)
            # Ownership transfer: every alloc in a committed plan is either
            # freshly minted by the scheduler or a plan-owned copy (Plan's
            # append_* methods copy), so the store takes them without the
            # per-alloc defensive copy. The fresh-alloc scan only exists
            # for volume claims — skip it (and its 10^5 membership probes)
            # when no volumes are registered at all.
            fresh_allocs = (
                [a for a in allocs_to_upsert if a.id not in t]
                if self._tables[TABLE_VOLUMES]
                else []
            )
            committed.extend(
                self._upsert_allocs_txn(
                    index, allocs_to_upsert, owned=True,
                    default_jobs=default_jobs,
                )
            )
            # SoA batches: one bulk column transaction per batch — lazy
            # row handles into the tables, vectorized aggregate updates,
            # incremental summaries. The store takes ownership (stamps
            # the batch in place), the same owned-payload contract the
            # eager path has.
            if batches:
                committed.extend(
                    self._upsert_batches_txn(index, batches, default_jobs)
                )
                # volume-bearing batches materialize for the claim walk
                # (rare: volumes gate the plan onto the serial path)
                if self._tables[TABLE_VOLUMES]:
                    for b in batches:
                        job = b.job
                        tg = (
                            job.lookup_task_group(b.task_group)
                            if job is not None
                            else None
                        )
                        if tg is not None and tg.volumes:
                            fresh_allocs.extend(b.materialize())
            # Volume claims attach atomically with the placements that
            # need them (reference: the CSI claim RPC; here the plan
            # apply IS the claim point for registered volumes).
            if fresh_allocs:
                self._claim_volumes_txn(index, fresh_allocs)
            # Record placed canaries on their deployment's group state
            # (reference state_store.go:4888 "Ensure PlacedCanaries
            # accurately reflects the alloc canary status"): the
            # reconciler and promotion read dstate.placed_canaries.
            # Canary markers only exist on deployment-bearing plans, so
            # the per-alloc scan is gated on that.
            canary_by_deploy: dict[str, list[Allocation]] = {}
            if any_deployment or self._tables[TABLE_DEPLOYMENTS]:
                for a in allocs_to_upsert:
                    if (
                        a.deployment_id
                        and a.deployment_status is not None
                        and a.deployment_status.canary
                    ):
                        canary_by_deploy.setdefault(a.deployment_id, []).append(a)
            if canary_by_deploy:
                dt = self._wtable(TABLE_DEPLOYMENTS)
                for dep_id, callocs in canary_by_deploy.items():
                    existing_d = dt.get(dep_id)
                    if existing_d is None:
                        continue
                    d = existing_d.copy()
                    for a in callocs:
                        ds = d.task_groups.get(a.task_group)
                        if ds is not None and a.id not in ds.placed_canaries:
                            ds.placed_canaries.append(a.id)
                    d.modify_index = index
                    dt[dep_id] = d
                    deployment_events.append(d)
            if preemption_evals:
                self._upsert_evals_txn(index, preemption_evals)
                self._stamp(index, TABLE_EVALS)
            tables = [TABLE_ALLOCS, TABLE_JOB_SUMMARIES]
            if any_deployment or canary_by_deploy:
                tables.append(TABLE_DEPLOYMENTS)
            self._stamp(index, *tables)
            jobs_touched = {
                (a.namespace, a.job_id) for a in stopped + preempted
            }
            self._reconcile_summaries_txn(index, jobs_touched)
            for ns, job_id in jobs_touched:
                self._update_job_status_txn(index, ns, job_id)
            self._publish(index, TABLE_ALLOCS, committed, "PlanResult")
            if deployment_events:
                self._publish(
                    index,
                    TABLE_DEPLOYMENTS,
                    deployment_events,
                    "DeploymentStatusUpdate",
                )

    # -- deployments ---------------------------------------------------

    def upsert_deployment(self, index: int, deployment: Deployment) -> None:
        with self._lock:
            self._upsert_deployment_txn(index, deployment)
            self._stamp(index, TABLE_DEPLOYMENTS)
            self._publish(
                index, TABLE_DEPLOYMENTS, [deployment], "DeploymentStatusUpdate"
            )

    def _upsert_deployment_txn(self, index: int, deployment: Deployment) -> None:
        t = self._wtable(TABLE_DEPLOYMENTS)
        deployment = deployment.copy()
        existing = t.get(deployment.id)
        deployment.create_index = existing.create_index if existing else index
        deployment.modify_index = index
        deployment.modify_time = now_ns()
        t[deployment.id] = deployment

    def _update_deployment_status_txn(self, index: int, update) -> None:
        t = self._wtable(TABLE_DEPLOYMENTS)
        existing = t.get(update.deployment_id)
        if existing is None:
            return
        d = existing.copy()
        d.status = update.status
        d.status_description = update.status_description
        d.modify_index = index
        d.modify_time = now_ns()
        t[d.id] = d

    def update_deployment_status(self, index: int, update) -> None:
        with self._lock:
            self._update_deployment_status_txn(index, update)
            self._stamp(index, TABLE_DEPLOYMENTS)
            d = self._tables[TABLE_DEPLOYMENTS].get(update.deployment_id)
            if d is not None:
                self._publish(
                    index, TABLE_DEPLOYMENTS, [d], "DeploymentStatusUpdate"
                )

    def delete_deployment(self, index: int, deployment_ids: list[str]) -> None:
        with self._lock:
            t = self._wtable(TABLE_DEPLOYMENTS)
            gone = [t.pop(did) for did in deployment_ids if did in t]
            self._stamp(index, TABLE_DEPLOYMENTS)
            if gone:
                self._publish(
                    index, TABLE_DEPLOYMENTS, gone, "DeploymentDeleted"
                )

    def update_deployment_promotion(
        self,
        index: int,
        deployment_id: str,
        groups: Optional[list[str]] = None,
        eval_obj: Optional[Evaluation] = None,
    ) -> None:
        """Promote canaries (reference state_store.go UpdateDeploymentPromotion).

        Marks the given groups (all canary groups when None) promoted and
        flips the promoted allocs' canary flag off. Raises when a group has
        fewer healthy canaries than desired.
        """
        with self._lock:
            t = self._wtable(TABLE_DEPLOYMENTS)
            existing = t.get(deployment_id)
            if existing is None:
                raise KeyError(f"unknown deployment {deployment_id}")
            d = existing.copy()
            targets = groups if groups else [
                g for g, s in d.task_groups.items() if s.desired_canaries > 0
            ]
            canary_ids: set[str] = set()
            # Validation (healthy canary counts) happens in the endpoint
            # BEFORE the raft commit (check_promotion_ready) — an FSM apply
            # must never raise, or replay of the log would poison followers.
            for g in targets:
                dstate = d.task_groups.get(g)
                if dstate is None:
                    continue
                dstate.promoted = True
                canary_ids.update(dstate.placed_canaries)
            if not any(
                s.desired_canaries > 0 and not s.promoted
                for s in d.task_groups.values()
            ):
                d.status_description = "Deployment is running"
            d.modify_index = index
            d.modify_time = now_ns()
            t[d.id] = d
            # clear the canary flag on promoted allocs
            at = self._wtable(TABLE_ALLOCS)
            for cid in canary_ids:
                a = at.get(cid)
                if a is None or a.deployment_status is None:
                    continue
                na = a.copy()
                na.deployment_status.canary = False
                na.modify_index = index
                na.modify_time = now_ns()
                self._put_alloc(na, a)
            if eval_obj is not None:
                self._upsert_evals_txn(index, [eval_obj])
                self._stamp(index, TABLE_EVALS)
            self._stamp(index, TABLE_DEPLOYMENTS, TABLE_ALLOCS)
            self._publish(
                index, TABLE_DEPLOYMENTS, [d], "DeploymentPromotion"
            )

    def update_alloc_deployment_health(
        self,
        index: int,
        deployment_id: str,
        healthy_ids: list[str],
        unhealthy_ids: list[str],
        status_update=None,
        eval_obj: Optional[Evaluation] = None,
        revert_job: Optional[Job] = None,
    ) -> None:
        """Set alloc deployment health and resync the deployment's
        healthy/unhealthy counters (reference state_store.go
        UpdateDeploymentAllocHealth / upsertDeploymentUpdate). The optional
        revert_job is upserted atomically (auto-revert)."""
        with self._lock:
            at = self._wtable(TABLE_ALLOCS)
            ts = now_ns()
            for aid, healthy in [(i, True) for i in healthy_ids] + [
                (i, False) for i in unhealthy_ids
            ]:
                a = at.get(aid)
                if a is None:
                    continue
                na = a.copy()
                if na.deployment_status is None:
                    from ..structs.structs import AllocDeploymentStatus

                    na.deployment_status = AllocDeploymentStatus()
                na.deployment_status.healthy = healthy
                na.deployment_status.timestamp_ns = ts
                na.modify_index = index
                na.modify_time = ts
                self._put_alloc(na, a)
            # resync counters from the alloc table (single source of truth)
            dt = self._wtable(TABLE_DEPLOYMENTS)
            existing = dt.get(deployment_id)
            if existing is not None:
                d = existing.copy()
                counts: dict[str, list[int]] = {g: [0, 0] for g in d.task_groups}
                for a in self.allocs_by_deployment(deployment_id):
                    if (
                        a.deployment_status is None
                        or a.task_group not in counts
                        or a.terminal_status()
                    ):
                        continue
                    if a.deployment_status.is_healthy():
                        counts[a.task_group][0] += 1
                    elif a.deployment_status.is_unhealthy():
                        counts[a.task_group][1] += 1
                for g, (h, u) in counts.items():
                    d.task_groups[g].healthy_allocs = h
                    d.task_groups[g].unhealthy_allocs = u
                d.modify_index = index
                d.modify_time = now_ns()
                dt[d.id] = d
            if status_update is not None:
                self._update_deployment_status_txn(index, status_update)
            if revert_job is not None:
                self._upsert_job_txn(index, revert_job)
                self._stamp(index, TABLE_JOBS)
            if eval_obj is not None:
                self._upsert_evals_txn(index, [eval_obj])
                self._stamp(index, TABLE_EVALS)
            self._stamp(index, TABLE_DEPLOYMENTS, TABLE_ALLOCS)
            d2 = self._tables[TABLE_DEPLOYMENTS].get(deployment_id)
            if d2 is not None:
                self._publish(
                    index, TABLE_DEPLOYMENTS, [d2], "DeploymentAllocHealth"
                )

    # -- derived state -------------------------------------------------

    def _reconcile_summaries_txn(
        self, index: int, jobs_touched: set[tuple[str, str]]
    ) -> None:
        if not jobs_touched:
            return
        st = self._wtable(TABLE_JOB_SUMMARIES)
        for ns, job_id in jobs_touched:
            job = self._tables[TABLE_JOBS].get((ns, job_id))
            summary = st.get((ns, job_id))
            summary = summary.copy() if summary else JobSummary(job_id, ns)
            groups = (
                {tg.name for tg in job.task_groups}
                if job
                else set(summary.summary.keys())
            )
            counts = {
                g: {
                    "queued": summary.summary.get(g, {}).get("queued", 0),
                    "complete": 0,
                    "failed": 0,
                    "running": 0,
                    "starting": 0,
                    "lost": 0,
                }
                for g in groups
            }
            for a in self.allocs_by_job(ns, job_id):
                c = counts.setdefault(
                    a.task_group,
                    {
                        "queued": 0,
                        "complete": 0,
                        "failed": 0,
                        "running": 0,
                        "starting": 0,
                        "lost": 0,
                    },
                )
                if a.client_status == ALLOC_CLIENT_STATUS_RUNNING:
                    c["running"] += 1
                elif a.client_status == ALLOC_CLIENT_STATUS_COMPLETE:
                    c["complete"] += 1
                elif a.client_status == ALLOC_CLIENT_STATUS_FAILED:
                    c["failed"] += 1
                elif a.client_status == ALLOC_CLIENT_STATUS_LOST:
                    c["lost"] += 1
                elif not a.terminal_status():
                    c["starting"] += 1
            summary.summary = counts
            summary.modify_index = index
            st[(ns, job_id)] = summary

    def update_job_queued_allocs(
        self, index: int, namespace: str, job_id: str, queued: dict[str, int]
    ) -> None:
        with self._lock:
            st = self._wtable(TABLE_JOB_SUMMARIES)
            summary = st.get((namespace, job_id))
            if summary is None:
                return
            summary = summary.copy()
            for group, count in queued.items():
                summary.summary.setdefault(
                    group,
                    {
                        "queued": 0,
                        "complete": 0,
                        "failed": 0,
                        "running": 0,
                        "starting": 0,
                        "lost": 0,
                    },
                )["queued"] = count
            summary.modify_index = index
            st[(namespace, job_id)] = summary
            self._stamp(index, TABLE_JOB_SUMMARIES)

    def _update_job_status_txn(self, index: int, namespace: str, job_id: str) -> None:
        """Derive job status from its allocs and evals (reference
        state_store.go getJobStatus/setJobStatus)."""
        jt = self._tables[TABLE_JOBS]
        job = jt.get((namespace, job_id))
        if job is None:
            return
        if job.stop:
            new_status = JOB_STATUS_DEAD
        else:
            # raw index rows, not the materializing reader: the only
            # question is "any live alloc?", which lazy AllocRow handles
            # answer straight from their batch columns
            job_allocs = self._tables[IDX_ALLOCS_JOB].get(
                (namespace, job_id), {}
            )
            has_live_alloc = any(
                not a.terminal_status() for a in job_allocs.values()
            )
            has_open_eval = False
            for e in self._tables[TABLE_EVALS].values():
                if (
                    e.namespace == namespace
                    and e.job_id == job_id
                    and e.status in (EVAL_STATUS_PENDING, EVAL_STATUS_BLOCKED)
                ):
                    has_open_eval = True
                    break
            if has_live_alloc or has_open_eval:
                new_status = JOB_STATUS_RUNNING if has_live_alloc else JOB_STATUS_PENDING
            else:
                # Periodic/parameterized parents idle at running.
                if job.is_periodic() or job.is_parameterized():
                    new_status = JOB_STATUS_RUNNING
                elif job.type in (JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM):
                    # Service/system jobs with no allocs yet are pending.
                    new_status = (
                        JOB_STATUS_PENDING if job.status == JOB_STATUS_PENDING else JOB_STATUS_DEAD
                    )
                else:
                    new_status = JOB_STATUS_DEAD if job_allocs else job.status
        if new_status != job.status:
            jt2 = self._wtable(TABLE_JOBS)
            # shallow clone: only status/modify_index change, so the
            # nested spec (task_groups, constraints, meta) is SHARED
            # with the replaced row — safe under the store's
            # copy-on-write discipline (every writer that mutates spec
            # internals goes through Job.copy first, which deep-copies
            # them; the same sub-object sharing the solver's fast-mint
            # templates rely on). The deep copy here was the single
            # largest cost of committing a fresh job's first placement
            # (~0.2ms of a ~1ms interactive eval).
            import copy as _copy

            j = _copy.copy(job)
            j.status = new_status
            j.modify_index = index
            jt2[(namespace, job_id)] = j
            self._stamp(index, TABLE_JOBS)


