"""Struct-of-arrays placements: the array-native data plane's core type.

A ``PlacementBatch`` is K fresh placements of ONE lowered group (same
eval, job version, task group, resource ask) kept as dense columns —
ids, names, and a node-index array into a shared node table — instead
of K ``Allocation`` objects. The batch flows unchanged from kernel
readback (solver fast-mint) through plan assembly (``Plan.alloc_batches``),
and the store's bulk transaction (``_upsert_batch_txn``), where the
table rows are lazy ``AllocRow`` handles.

``Allocation`` objects are materialized lazily, only at API/client/
event-stream boundaries, with a cached-on-first-access view (``row(i)``)
so repeated reads don't re-pay the construction. A materialized row is
field-for-field identical to what the eager path would have minted and
stored — the differential identity battery
(tests/test_plan_apply_batch.py) pins that, byte-for-byte, across the
merged-plan-apply matrix.

Only the fast-mint shape rides a batch: no per-row ports, devices,
dedicated cores, canary status, or previous-alloc rewiring — exactly
the rows that share one AllocatedResources/AllocMetric today. Everything
else keeps the eager per-row path.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Optional

import numpy as np

from .structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    Allocation,
    AllocMetric,
    AllocatedResources,
    DEFAULT_NAMESPACE,
    Job,
)

_ALLOC_FIELDS = tuple(f.name for f in dataclass_fields(Allocation))


@dataclass(eq=False)
class PlacementBatch:
    """Dense columns for K same-group placements.

    node_idx_raw is the int32 node-index column as raw bytes (numpy
    ``tobytes``) so the wire codec ships it as one msgpack bin instead
    of K ints; ``node_idx`` exposes the array view. node_ids/node_names
    are indexed BY that column (they may be the whole solve's node
    table — shared references, not copies).
    """

    # shared scalars (identical across every row)
    namespace: str = DEFAULT_NAMESPACE
    eval_id: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Optional[AllocatedResources] = None
    metrics: Optional[AllocMetric] = None
    deployment_id: str = ""
    # stamped by the store transaction (one value for the whole batch —
    # the eager txn stamps every row with the same index/now anyway)
    create_index: int = 0
    modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0
    # per-row columns
    ids: list[str] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    node_idx_raw: bytes = b""
    node_ids: list[str] = field(default_factory=list)
    node_names: list[str] = field(default_factory=list)

    # -- column views ---------------------------------------------------

    @property
    def node_idx(self) -> np.ndarray:
        arr = getattr(self, "_idx_arr", None)
        if arr is None:
            arr = np.frombuffer(self.node_idx_raw, dtype=np.int32)
            self._idx_arr = arr
        return arr

    @property
    def count(self) -> int:
        return len(self.ids)

    def __len__(self) -> int:
        return len(self.ids)

    # -- per-node aggregation (the vectorized-verify inputs) ------------

    def touched_nodes(self) -> list[tuple[str, int, int]]:
        """(node_id, table_idx, row_count) per distinct node, in
        FIRST-APPEARANCE order — the same order the eager per-row loop
        would first touch each node, so downstream dict insertion order
        (usage aggregates, node_allocation folds) is byte-identical.
        Cached: the columns are immutable once built (take() returns a
        NEW batch), and the partition key, verifier, codec fold, and
        store txn all read this."""
        cached = getattr(self, "_touched", None)
        if cached is not None:
            return cached
        # plain dict walk, not np.unique: dict insertion order IS
        # first-appearance order, and numpy's per-call overhead loses to
        # the interpreter below ~10^4 rows (the common batch size)
        counts: dict[int, int] = {}
        for ti in self.node_idx.tolist():
            counts[ti] = counts.get(ti, 0) + 1
        nid = self.node_ids
        self._touched = [(nid[ti], ti, c) for ti, c in counts.items()]
        return self._touched

    def row_contribution(self) -> tuple[int, int, int, int]:
        """One row's usage contribution (cpu, mem, disk, complex=0) —
        fast-mint rows never carry ports/cores, so complex is 0 by
        construction (the property the store's vectorized aggregate
        update rides on)."""
        r = self.resources.comparable() if self.resources else None
        if r is None:
            return (0, 0, 0, 0)
        return (r.cpu, r.memory_mb, r.disk_mb, 0)

    # -- masking (plan-apply per-node rejection) ------------------------

    def take(self, keep: np.ndarray) -> "PlacementBatch":
        """Sub-batch of the rows where ``keep`` is True (plan apply
        drops a rejected node's rows). Shares the node tables and the
        shared scalars; never copies the survivors' strings."""
        sel = np.nonzero(keep)[0]
        return PlacementBatch(
            namespace=self.namespace,
            eval_id=self.eval_id,
            job_id=self.job_id,
            job=self.job,
            task_group=self.task_group,
            resources=self.resources,
            metrics=self.metrics,
            deployment_id=self.deployment_id,
            create_index=self.create_index,
            modify_index=self.modify_index,
            create_time=self.create_time,
            modify_time=self.modify_time,
            ids=[self.ids[i] for i in sel],
            names=[self.names[i] for i in sel],
            node_idx_raw=np.ascontiguousarray(
                self.node_idx[keep]
            ).tobytes(),
            node_ids=self.node_ids,
            node_names=self.node_names,
        )

    # -- store stamping -------------------------------------------------

    def stamp(self, index: int, now: int) -> None:
        """Store-commit stamp (the eager txn's per-row index/time writes,
        once per batch). Drops any cached materializations: a row
        materialized before the stamp (e.g. the codec's wire template)
        would otherwise serve stale index fields to store readers."""
        self.create_index = index
        self.modify_index = index
        if not self.create_time:
            self.create_time = now
        self.modify_time = now
        if getattr(self, "_rows", None) is not None:
            self._rows = None

    # -- lazy materialization -------------------------------------------

    def _row_cache(self) -> list:
        rows = getattr(self, "_rows", None)
        if rows is None:
            rows = self._rows = [None] * len(self.ids)
        return rows

    def _proto_items(self) -> list:
        """Per-batch default field values: fresh default-factory
        containers minted ONCE per batch and shared across its rows —
        the exact sharing the eager _MintTemplate prototype had (the
        store's copy-on-write discipline makes stored sub-object
        sharing safe; sharing is per-batch, never process-global)."""
        items = getattr(self, "_proto", None)
        if items is None:
            proto = Allocation()
            items = self._proto = [
                (n, getattr(proto, n)) for n in _ALLOC_FIELDS
            ]
        return items

    def _mint(self, i: int) -> Allocation:
        """Construct row i — field-identical to the eager fast-mint."""
        a = Allocation.__new__(Allocation)
        ni = int(self.node_idx[i])
        for name, v in self._proto_items():
            setattr(a, name, v)
        a.id = self.ids[i]
        a.namespace = self.namespace
        a.eval_id = self.eval_id
        a.name = self.names[i]
        a.node_id = self.node_ids[ni]
        a.node_name = self.node_names[ni]
        a.job_id = self.job_id
        a.job = self.job
        a.task_group = self.task_group
        a.resources = self.resources
        a.metrics = self.metrics
        a.deployment_id = self.deployment_id
        a.create_index = self.create_index
        a.modify_index = self.modify_index
        a.create_time = self.create_time
        a.modify_time = self.modify_time
        return a

    def row(self, i: int) -> Allocation:
        """Materialize row i, cached on first access."""
        rows = self._row_cache()
        a = rows[i]
        if a is None:
            a = rows[i] = self._mint(i)
        return a

    def materialize(self) -> list[Allocation]:
        """All rows, cached (the API/client boundary view)."""
        return [self.row(i) for i in range(len(self.ids))]

    def extend_wire_rows(self, out: dict) -> None:
        """Append this batch's rows to a node_allocation WIRE map
        (node_id -> [row maps]), exactly as the eager encoder would:
        per-node lists in first-touch order, rows in placement order.

        Rows share one template wire dict (the to_wire(_elide) form of a
        transient row 0) with the four per-row fields re-set per row;
        shared nested values (resources/metrics wire maps) are aliased,
        not copied — the byte encoder re-encodes them per row,
        reproducing the eager bytes."""
        if not self.ids:
            return
        from .. import codec

        template = codec.to_wire(self._mint(0), _elide=True)
        idx = self.node_idx
        nid_of = self.node_ids
        node_col = [nid_of[int(i)] for i in idx]
        rows = _wire_rows(
            template, self.ids, self.names, node_col,
            [self.node_names[int(i)] for i in idx],
        )
        for nid, row in zip(node_col, rows):
            bucket = out.get(nid)
            if bucket is None:
                bucket = out[nid] = []
            bucket.append(row)

    def handles(self) -> list["AllocRow"]:
        """One lazy store-table handle per row. Cached: the columns are
        immutable once built, and both the plan applier and the store
        txn ask for the same handle list."""
        cached = getattr(self, "_handles", None)
        if cached is not None:
            return cached
        out = [AllocRow(self, i) for i in range(len(self.ids))]
        self._handles = out
        return out


def _wire_rows_py(template, ids, names, node_ids, node_names):
    out = []
    ap = out.append
    for uid, name, nid, nname in zip(ids, names, node_ids, node_names):
        d = dict(template)
        d["id"] = uid
        d["name"] = name
        d["node_id"] = nid
        d["node_name"] = nname
        ap(d)
    return out


def _wire_rows(template, ids, names, node_ids, node_names):
    """The rows from fastpack's ``wire_rows`` when the extension is
    resolved (this module never builds it: codec.warm_native does), else
    from the Python twin; both give equal dicts with equal key order."""
    from .. import codec

    fp = codec.native_module()
    if fp is not None:
        return fp.wire_rows(template, ids, names, node_ids, node_names)
    return _wire_rows_py(template, ids, names, node_ids, node_names)


class AllocRow:
    """Lazy store-table handle for one batch row.

    The hot fields the store's own bookkeeping reads (ids, statuses,
    job/node keys, the terminal predicate) answer straight from the
    batch columns without materializing; anything else falls through to
    the cached materialized row. Store READERS materialize at the mixin
    boundary — handles never escape the store/event layer."""

    __slots__ = ("b", "i")

    def __init__(self, b: PlacementBatch, i: int) -> None:
        self.b = b
        self.i = i

    # cheap column-backed fields ---------------------------------------
    @property
    def id(self) -> str:
        return self.b.ids[self.i]

    @property
    def name(self) -> str:
        return self.b.names[self.i]

    @property
    def node_id(self) -> str:
        return self.b.node_ids[int(self.b.node_idx[self.i])]

    @property
    def node_name(self) -> str:
        return self.b.node_names[int(self.b.node_idx[self.i])]

    @property
    def namespace(self) -> str:
        return self.b.namespace

    @property
    def eval_id(self) -> str:
        return self.b.eval_id

    @property
    def job_id(self) -> str:
        return self.b.job_id

    @property
    def job(self):
        return self.b.job

    @property
    def task_group(self) -> str:
        return self.b.task_group

    @property
    def resources(self):
        return self.b.resources

    @property
    def deployment_id(self) -> str:
        return self.b.deployment_id

    @property
    def desired_status(self) -> str:
        return ALLOC_DESIRED_STATUS_RUN

    @property
    def client_status(self) -> str:
        return ALLOC_CLIENT_STATUS_PENDING

    @property
    def create_index(self) -> int:
        return self.b.create_index

    @property
    def modify_index(self) -> int:
        return self.b.modify_index

    def terminal_status(self) -> bool:
        return False  # fresh run/pending by construction

    def client_terminal_status(self) -> bool:
        return False

    def server_terminal_status(self) -> bool:
        return False

    def get(self) -> Allocation:
        """The materialized row (cached in the batch)."""
        return self.b.row(self.i)

    def __getattr__(self, name):
        # safety net: any field not column-backed materializes
        return getattr(self.b.row(self.i), name)


# The store's read mixin inlines the materialization expression
# (`a.get() if a.__class__ is AllocRow else a`) at each reader — a
# helper call per row would be the hot paths' dominant remaining cost.
