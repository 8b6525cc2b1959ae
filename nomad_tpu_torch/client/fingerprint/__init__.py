"""Host fingerprinting: what does this machine offer?

Port of ``nomad_tpu/client/fingerprint/__init__.py``.

Reference: client/fingerprint/ (30+ files) — a registry of
fingerprinters (fingerprint.go:31-48 builtinFingerprintMap), each
contributing attributes/resources to the Node; periodic ones re-run on
a cadence and push node updates. The same shape here: one module per
fingerprinter, a registry, and two entry points the client uses —
``fingerprint_node`` (full pass at boot) and ``dynamic_attributes``
(periodic re-sample, consumed by the client's re-fingerprint loop).
"""

from __future__ import annotations

import logging
import socket
import uuid

logger = logging.getLogger("nomad_tpu_torch.fingerprint")

from ...structs import Node, NodeResources
from ...structs.node_class import compute_node_class
from .base import Fingerprinter, FingerprintResponse
from .cgroup import CgroupFingerprint
from .cpu import CPUFingerprint
from .env_cloud import (
    EnvAWSFingerprint,
    EnvAzureFingerprint,
    EnvGCEFingerprint,
)
from .host import HostFingerprint
from .memory import MemoryFingerprint
from .network import NetworkFingerprint
from .nomad import NomadFingerprint
from .storage import StorageFingerprint

# registration order matters only for attribute collisions (last wins),
# mirroring the reference's map ordering by name
BUILTIN_FINGERPRINTERS: list[Fingerprinter] = [
    HostFingerprint(),
    CPUFingerprint(),
    MemoryFingerprint(),
    StorageFingerprint(),
    NetworkFingerprint(),
    CgroupFingerprint(),
    NomadFingerprint(),
    EnvAWSFingerprint(),
    EnvGCEFingerprint(),
    EnvAzureFingerprint(),
]


def fingerprint_node(
    node_id: str = "",
    datacenter: str = "dc1",
    node_class: str = "",
    data_dir: str = "/tmp",
) -> Node:
    """Run every fingerprinter and assemble the Node."""
    attributes: dict[str, str] = {}
    # Start from ZERO capacity, not the struct defaults: a failed
    # resource fingerprinter must leave the node advertising nothing in
    # that dimension (under-advertising wastes capacity; the defaults
    # would OVER-advertise and place allocs that fail at runtime).
    resources = NodeResources(cpu=0, memory_mb=0, disk_mb=0, networks=[])
    for fp in BUILTIN_FINGERPRINTERS:
        try:
            resp = fp.fingerprint(data_dir)
        except Exception:
            # one broken fingerprinter must not sink the node, but it
            # must be VISIBLE — silence here cost real capacity
            logger.exception("fingerprinter %s failed", fp.name)
            continue
        if not resp.detected:
            continue
        attributes.update(resp.attributes)
        if "cpu" in resp.resources:
            resources.cpu = resp.resources["cpu"]
        if "total_cores" in resp.resources:
            resources.total_cores = resp.resources["total_cores"]
        if "memory_mb" in resp.resources:
            resources.memory_mb = resp.resources["memory_mb"]
        if "disk_mb" in resp.resources:
            resources.disk_mb = resp.resources["disk_mb"]
        if "networks" in resp.resources:
            resources.networks = resp.resources["networks"]
    node = Node(
        id=node_id or str(uuid.uuid4()),
        name=socket.gethostname(),
        datacenter=datacenter,
        node_class=node_class,
        attributes=attributes,
        resources=resources,
    )
    node.computed_class = compute_node_class(node)
    return node


def dynamic_attributes(data_dir: str = "/tmp") -> dict[str, str]:
    """Re-run the PERIODIC fingerprinters (reference: each periodic
    fingerprinter pushes node updates on its cadence; the client's one
    re-fingerprint loop consumes this)."""
    out: dict[str, str] = {}
    for fp in BUILTIN_FINGERPRINTERS:
        if not fp.periodic:
            continue
        try:
            resp = fp.fingerprint(data_dir)
        except Exception:
            logger.exception("periodic fingerprinter %s failed", fp.name)
            continue
        if resp.detected:
            out.update(resp.attributes)
    return out
