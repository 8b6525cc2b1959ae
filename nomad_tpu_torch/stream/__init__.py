"""Event streaming (reference: nomad/stream/; port of ``nomad_tpu/stream``)."""

from .event_broker import (
    Event,
    EventBroker,
    Subscription,
    SubscriptionClosedError,
    TOPIC_ALL,
)

__all__ = [
    "Event",
    "EventBroker",
    "Subscription",
    "SubscriptionClosedError",
    "TOPIC_ALL",
]
