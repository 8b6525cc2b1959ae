"""State-store change → stream event conversion.

Reference: nomad/state/events.go (eventFromChange maps memdb change objects
+ raft message type to typed stream events). Here the store's publish hook
hands us (index, table, objs, etype); we map tables to topics and objects
to keys/filter-keys, then hand blocks to the EventBroker. Port of
``nomad_tpu/state/events.py``. Each block goes to the broker unbuilt
(``EventBroker.publish_lazy``): its events are made when a subscription
first reads it. Each hand-off is timed as the trace stage
``events.publish`` when tracing is on, so the stream's share of a store
write can be split.
"""

from __future__ import annotations

import time

from .. import trace
from ..stream.event_broker import (
    TOPIC_ALLOC,
    TOPIC_DEPLOYMENT,
    TOPIC_EVAL,
    TOPIC_JOB,
    TOPIC_NODE,
    TOPIC_SERVICE,
    TOPIC_VOLUME,
    Event,
    EventBroker,
)
from .store import (
    TABLE_ALLOCS,
    TABLE_DEPLOYMENTS,
    TABLE_EVALS,
    TABLE_JOBS,
    TABLE_NODES,
    TABLE_SERVICES,
    TABLE_VOLUMES,
    StateStore,
)

_TABLE_TOPICS = {
    TABLE_NODES: TOPIC_NODE,
    TABLE_JOBS: TOPIC_JOB,
    TABLE_EVALS: TOPIC_EVAL,
    TABLE_ALLOCS: TOPIC_ALLOC,
    TABLE_DEPLOYMENTS: TOPIC_DEPLOYMENT,
    TABLE_SERVICES: TOPIC_SERVICE,
    TABLE_VOLUMES: TOPIC_VOLUME,
}

_DEFAULT_TYPES = {
    TABLE_NODES: "NodeEvent",
    TABLE_JOBS: "JobEvent",
    TABLE_EVALS: "EvaluationUpdated",
    TABLE_ALLOCS: "AllocationUpdated",
    TABLE_DEPLOYMENTS: "DeploymentStatusUpdate",
    TABLE_SERVICES: "ServiceRegistration",
    TABLE_VOLUMES: "VolumeEvent",
}


def _event_for(index: int, table: str, obj, etype: str) -> Event:
    topic = _TABLE_TOPICS[table]
    etype = etype or _DEFAULT_TYPES[table]
    namespace = getattr(obj, "namespace", "") or ""
    filter_keys: tuple = ()
    if table == TABLE_NODES:
        key = obj.id
    elif table == TABLE_JOBS:
        key = obj.id
    elif table == TABLE_EVALS:
        key = obj.id
        filter_keys = (obj.job_id,)
    elif table == TABLE_ALLOCS:
        key = obj.id
        # Filterable by job and node (reference events.go AllocationEvent
        # FilterKeys: JobID, DeploymentID).
        filter_keys = tuple(
            k for k in (obj.job_id, obj.node_id, obj.deployment_id) if k
        )
    elif table == TABLE_SERVICES:
        key = obj.service_name
        filter_keys = tuple(
            k for k in (obj.job_id, obj.alloc_id, obj.node_id) if k
        )
    elif table == TABLE_VOLUMES:
        key = obj.id
        filter_keys = (obj.plugin_id,) if obj.plugin_id else ()
    else:
        key = obj.id
        filter_keys = (obj.job_id,)
    return Event(
        topic=topic,
        type=etype,
        key=key,
        index=index,
        payload=obj,
        namespace=namespace,
        filter_keys=filter_keys,
    )


def wire_events(store: StateStore, broker: EventBroker) -> None:
    """Subscribe the broker to every state-store write."""

    def on_change(index: int, table: str, objs: list, etype: str) -> None:
        if table not in _TABLE_TOPICS or not objs:
            return
        t0 = time.monotonic_ns() if trace.enabled() else 0
        broker.publish_lazy(
            index, lambda: [_event_for(index, table, o, etype) for o in objs]
        )
        if t0:
            trace.stage("events.publish", time.monotonic_ns() - t0)

    store.subscribe(on_change)
