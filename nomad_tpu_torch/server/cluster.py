"""Clustered server: Raft-replicated control plane over the RPC fabric.

Port of ``nomad_tpu/server/cluster.py``. Reference: nomad/server.go
(server wiring: RPC at :1073, Raft at :1210), nomad/rpc.go `forward`
(any server forwards writes to the leader), nomad/leader.go leadership
transitions driving leader-only subsystems, and client/servers manager
(clients fail over between servers).

One ClusterServer = one `nomad agent -server` process-equivalent:
  * a core `Server` (state store, FSM, brokers, schedulers, watchers);
  * a `RaftNode` replicating every state mutation;
  * an `RPCServer` exposing Raft.* plus the public endpoints
    (Job/Node/Eval/Alloc/Deployment/Status and the rest);
  * leadership changes from raft enable/disable the leader-only
    subsystems, exactly like establishLeadership/revokeLeadership.

Writes land on any server and are forwarded to the leader; reads are
served from the local replica (the reference's default-consistent reads
forward too — our forwarding helper takes `local_ok` to choose).

Scheduler workers run only on the leader — a deliberate departure from
the reference (which runs workers on every server, submitting plans to
the leader over Plan.Submit): the batch solver wants all pending evals
in one dense batch on the card, so spreading workers across followers
would shrink batches and add a network hop per plan.

``scheduler_config`` is handed to the core `Server`: it names the card
the leader's batch worker solves on (``SchedulerConfig(device="cuda:0")``)
or asks for the CPU (``SchedulerConfig(device="cpu")``, as the tests do).
The reference's `Server` takes the same argument; its ClusterServer does
not pass one.

The per-member telemetry federation (``peer_telemetry``,
``cluster_health`` and ``Status.peer_telemetry``) reads the host
profiler (hostobs.py) and feeds the agent's
``/v1/operator/cluster/health``. The reverse-dial
sessions, the exec-stream splice and ``csi_controller_roundtrip`` are
reached only by a client agent.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

from .. import blackbox, clusterobs, metrics
from ..retry import FORWARD_POLICY, call_with_retry
from ..rpc import ConnPool, RPCError, RPCServer
from .. import faultplane
from ..structs import Allocation, Node
from .membership import Membership
from .raft_replication import LeadershipLostError, NotLeaderError, RaftNode
from .server import Server

logger = logging.getLogger("nomad_tpu_torch.cluster")


def _is_leaderless_error(e: BaseException) -> bool:
    """Errors that mean 'the cluster is between leaders' — safe to retry
    because they are raised BEFORE the write reaches the log (a local
    NotLeaderError, or the remote's NotLeaderError/no-leader travelling
    back as an RPCError string). A dial to a dead leader's address
    (connection refused — the crash-failover case) and an injected
    chaos drop are likewise pre-delivery. A generic ConnectionError
    ('connection closed' mid-flight) is NOT retried: the request may
    already have been applied and the response lost. LeadershipLostError
    (deposed AFTER the entry was replicating — outcome unknown) is the
    explicit do-not-retry variant, locally and as its RPC string."""
    if isinstance(e, LeadershipLostError):
        return False
    if isinstance(e, RPCError) and "LeadershipLostError" in str(e):
        return False
    if isinstance(e, (NotLeaderError, ConnectionRefusedError)):
        return True
    if isinstance(e, faultplane.InjectedRPCError):
        return True
    if isinstance(e, RPCError):
        msg = str(e)
        return "NotLeaderError" in msg or "no cluster leader" in msg
    return False


class _Forwarder:
    """Endpoint helper: run locally on the leader, else forward the same
    RPC to the leader (reference nomad/rpc.go forward). Leaderless
    windows (elections, leadership transfer) retry under the shared
    RetryPolicy instead of failing the caller: each attempt re-resolves
    the leader hint, so a request that lands mid-election sticks around
    just long enough to follow the new leader."""

    def __init__(self, cs: "ClusterServer") -> None:
        self.cs = cs

    def _forward(self, method: str, args, local_fn, local_ok: bool = False):
        cs = self.cs

        def attempt():
            if local_ok or cs.raft.is_leader():
                return local_fn(args)
            addr = cs.raft.leader_addr()
            # A stale self-hint would loop the RPC back into our own
            # worker pool until it deadlocks — treat it as leaderless.
            if addr is None or addr == cs.rpc.addr:
                raise RPCError("no cluster leader")
            return cs.pool.call(addr, method, args, timeout_s=30.0)

        return call_with_retry(
            attempt,
            policy=cs.forward_retry,
            retry_if=_is_leaderless_error,
            label=method,
        )


class OperatorEndpoint(_Forwarder):
    """Reference: nomad/operator_endpoint.go + helper/snapshot — state
    snapshot save/restore and raft introspection for operators."""

    def snapshot_save(self, args):
        # any server can serve its own (possibly slightly stale) state
        return {"snapshot": self.cs.server.state.serialize()}

    def snapshot_restore(self, args):
        return self._forward(
            "Operator.snapshot_restore",
            args,
            lambda a: self.cs.server.raft_apply("snapshot_restore", a["data"]),
        )

    def force_gc(self, args):
        return self._forward(
            "Operator.force_gc",
            args,
            lambda a: self.cs.server.force_gc(),
        )

    def autopilot_get_config(self, args):
        """Reference operator_endpoint.go AutopilotGetConfiguration
        (the OSS-relevant knob: dead-server cleanup). Raft-replicated:
        every replica reads its own consistent copy and the setting
        survives failover."""
        return self.cs.autopilot_config()

    def autopilot_set_config(self, args):
        def apply(a):
            cfg = a.get("config") or {}
            cur = self.cs.autopilot_config()
            if "CleanupDeadServers" in cfg:
                cur["CleanupDeadServers"] = bool(
                    cfg["CleanupDeadServers"]
                )
            self.cs.server.raft_apply("operator_config_upsert",
                                      ("autopilot", cur))
            return {"Updated": True}

        return self._forward(
            "Operator.autopilot_set_config", args, apply
        )

    def force_leave(self, args):
        return self.cs.force_leave(args["member_id"])

    def scheduler_get_config(self, args):
        def local(a):
            return self._scheduler_config_payload()

        return self._forward("Operator.scheduler_get_config", args, local)

    def _scheduler_config_payload(self):
        c = self.cs.server.scheduler_config
        return {
            "SchedulerAlgorithm": c.algorithm,
            "PreemptionConfig": {
                "ServiceSchedulerEnabled": c.preemption_service,
                "BatchSchedulerEnabled": c.preemption_batch,
                "SystemSchedulerEnabled": c.preemption_system,
                "SysBatchSchedulerEnabled": c.preemption_sysbatch,
            },
            "MemoryOversubscriptionEnabled": c.memory_oversubscription,
            "Backend": c.backend,
        }

    def scheduler_set_config(self, args):
        """Mutate the live scheduler knobs (reference
        operator_endpoint.go SchedulerSetConfiguration; the reference
        raft-replicates the config — here it is leader-local operator
        state, re-set after failover)."""

        def apply(a):
            cfg = a.get("config") or {}
            c = self.cs.server.scheduler_config
            if "SchedulerAlgorithm" in cfg:
                algo = cfg["SchedulerAlgorithm"]
                if algo not in ("binpack", "spread"):
                    raise ValueError(f"unknown algorithm {algo!r}")
                c.algorithm = algo
            pre = cfg.get("PreemptionConfig") or {}
            for key, attr in (
                ("ServiceSchedulerEnabled", "preemption_service"),
                ("BatchSchedulerEnabled", "preemption_batch"),
                ("SystemSchedulerEnabled", "preemption_system"),
                ("SysBatchSchedulerEnabled", "preemption_sysbatch"),
            ):
                if key in pre:
                    setattr(c, attr, bool(pre[key]))
            if "MemoryOversubscriptionEnabled" in cfg:
                c.memory_oversubscription = bool(
                    cfg["MemoryOversubscriptionEnabled"]
                )
            return {"Updated": True}

        return self._forward("Operator.scheduler_set_config", args, apply)

    def raft_remove_peer(self, args):
        """Force-remove a raft peer (reference operator_endpoint.go
        RaftRemovePeerByID — recovering a cluster whose dead member
        can't leave gracefully)."""
        return self._forward(
            "Operator.raft_remove_peer",
            args,
            lambda a: self.cs.raft.remove_peer(a["peer_id"]),
        )

    def raft_configuration(self, args):
        out = [
            {
                "id": self.cs.node_id,
                "address": list(self.cs.rpc.addr),
                "leader": self.cs.raft.is_leader(),
            }
        ]
        with self.cs.raft._lock:
            peers = dict(self.cs.raft.peers)
        leader = self.cs.raft.leader_id
        for pid, addr in peers.items():
            out.append(
                {"id": pid, "address": list(addr), "leader": pid == leader}
            )
        return out


class JobEndpoint(_Forwarder):
    def register(self, args):
        return self._forward(
            "Job.register", args, lambda a: self.cs.server.job_register(a["job"])
        )

    def deregister(self, args):
        return self._forward(
            "Job.deregister",
            args,
            lambda a: self.cs.server.job_deregister(
                a["namespace"], a["job_id"], a.get("purge", False)
            ),
        )

    def get(self, args):
        return self.cs.server.state.job_by_id(args["namespace"], args["job_id"])

    def list(self, args):
        return self.cs.server.state.jobs(args.get("namespace"))

    def allocs(self, args):
        return self.cs.server.state.allocs_by_job(
            args["namespace"], args["job_id"]
        )

    def summary(self, args):
        return self.cs.server.state.job_summary_by_id(
            args["namespace"], args["job_id"]
        )

    def evals(self, args):
        return self.cs.server.state.evals_by_job(
            args["namespace"], args["job_id"]
        )

    def versions(self, args):
        return self.cs.server.state.job_versions(
            args["namespace"], args["job_id"]
        )

    def revert(self, args):
        return self._forward(
            "Job.revert",
            args,
            lambda a: self.cs.server.job_revert(
                a["namespace"], a["job_id"], a["version"]
            ),
        )

    def dispatch(self, args):
        return self._forward(
            "Job.dispatch",
            args,
            lambda a: self.cs.server.job_dispatch(
                a["namespace"],
                a["job_id"],
                payload=a.get("payload") or b"",
                meta=a.get("meta") or {},
            ),
        )

    def periodic_force(self, args):
        def local(a):
            # front-door admission: force_launch mints a child job +
            # eval directly (not via job_register, whose own guard
            # covers register/scale/revert) — the periodic dispatcher's
            # internal timer path stays unguarded on purpose
            self.cs.server.check_eval_admission(a["namespace"])
            return self.cs.server.periodic.force_launch(
                a["namespace"], a["job_id"]
            )

        return self._forward("Job.periodic_force", args, local)

    def scale_status(self, args):
        """Group-level desired/placed/running counts (reference
        Job.ScaleStatus)."""
        st = self.cs.server.state
        job = st.job_by_id(args["namespace"], args["job_id"])
        if job is None:
            return None
        allocs = st.allocs_by_job(args["namespace"], args["job_id"])
        policies = {
            p.group: p
            for p in st.scaling_policies_by_job(
                args["namespace"], args["job_id"]
            )
        }
        groups = {}
        for tg in job.task_groups:
            live = [
                a
                for a in allocs
                if a.task_group == tg.name and not a.terminal_status()
            ]
            entry = {
                "Desired": tg.count,
                "Running": sum(
                    1 for a in live if a.client_status == "running"
                ),
                "Placed": len(live),
            }
            pol = policies.get(tg.name)
            if pol is not None:
                entry["ScalingPolicy"] = {
                    "ID": pol.id, "Min": pol.min, "Max": pol.max,
                    "Enabled": pol.enabled,
                }
            groups[tg.name] = entry
        return {
            "JobID": job.id,
            "JobStopped": job.stop,
            "TaskGroups": groups,
            # newest-first scale-event journal per group (reference
            # JobScaleStatus — `nomad job scaling-events` reads this)
            "ScalingEvents": st.scaling_events(
                args["namespace"], args["job_id"]
            ),
        }

    def evaluate(self, args):
        return self._forward(
            "Job.evaluate",
            args,
            lambda a: self.cs.server.job_force_evaluate(
                a["namespace"], a["job_id"]
            ),
        )

    def deployments(self, args):
        return self.cs.server.state.deployments_by_job(
            args["namespace"], args["job_id"]
        )

    def scale(self, args):
        return self._forward(
            "Job.scale",
            args,
            lambda a: self.cs.server.job_scale(
                a["namespace"], a["job_id"], a["group"], a["count"],
                a.get("message", ""),
            ),
        )

    def plan(self, args):
        # Dry-run: leader-forwarded so the plan sees the freshest state,
        # but nothing is committed (reference job_endpoint.go:521).
        return self._forward(
            "Job.plan",
            args,
            lambda a: self.cs.server.job_plan(
                a["job"], diff=a.get("diff", True)
            ),
        )


class SearchEndpoint(_Forwarder):
    """Reference: nomad/search_endpoint.go."""

    def prefix(self, args):
        from .search import prefix_search

        return prefix_search(
            self.cs.server.state,
            args.get("prefix", ""),
            args.get("context", "all"),
            args.get("namespace", "default"),
        )

    def fuzzy(self, args):
        from .search import fuzzy_search

        return fuzzy_search(
            self.cs.server.state,
            args.get("text", ""),
            args.get("context", "all"),
            args.get("namespace", "default"),
        )


class NamespaceEndpoint(_Forwarder):
    """Reference: nomad/namespace_endpoint.go."""

    def upsert(self, args):
        return self._forward(
            "Namespace.upsert",
            args,
            lambda a: self.cs.server.namespace_upsert(a["namespace"]),
        )

    def delete(self, args):
        return self._forward(
            "Namespace.delete",
            args,
            lambda a: self.cs.server.namespace_delete(a["name"]),
        )

    def get(self, args):
        return self.cs.server.state.namespace_by_name(args["name"])

    def list(self, args):
        return sorted(
            self.cs.server.state.namespaces(), key=lambda n: n.name
        )


class VolumeEndpoint(_Forwarder):
    """Reference: nomad/csi_endpoint.go reshaped for host volumes."""

    def register(self, args):
        return self._forward(
            "Volume.register",
            args,
            lambda a: self.cs.server.volume_register(a["volume"]),
        )

    def deregister(self, args):
        return self._forward(
            "Volume.deregister",
            args,
            lambda a: self.cs.server.volume_deregister(
                a["namespace"], a["volume_id"]
            ),
        )

    def get(self, args):
        return self.cs.server.state.volume_by_id(
            args["namespace"], args["volume_id"]
        )

    def list(self, args):
        return self.cs.server.state.volumes(args.get("namespace"))

    def for_alloc(self, args):
        return self.cs.server.state.volumes_for_alloc(args["alloc_id"])

    def create(self, args):
        """Provision through a controller plugin then register
        (reference csi_endpoint.go Create → ClientCSI controller RPC on
        a plugin-bearing node)."""

        def local(a):
            vol = a["volume"]
            # validate BEFORE provisioning: a rejected register after
            # the controller call would orphan the external storage
            self.cs.server.validate_volume(vol)
            if vol.plugin_id == "":
                raise ValueError("csi volume requires plugin_id")
            existing = self.cs.server.state.volume_by_id(
                vol.namespace, vol.id
            )
            if existing is not None:
                raise ValueError(
                    f"volume {vol.id} already exists (external id "
                    f"{existing.external_id!r}); delete it first"
                )
            out = self.cs.csi_controller_roundtrip(
                vol.plugin_id,
                "CSI.create",
                {"name": vol.name or vol.id,
                 "params": dict(vol.context or {})},
            )
            vol = vol.copy()
            vol.type = "csi"
            vol.external_id = out.get("external_id", "")
            ctx = out.get("context") or {}
            vol.context = {**(vol.context or {}), **ctx}
            self.cs.server.volume_register(vol)
            return self.cs.server.state.volume_by_id(
                vol.namespace, vol.id
            )

        return self._forward("Volume.create", args, local)

    def delete(self, args):
        """Deregister then deprovision via the controller plugin
        (reference csi_endpoint.go Delete)."""

        def local(a):
            ns, vol_id = a["namespace"], a["volume_id"]
            vol = self.cs.server.state.volume_by_id(ns, vol_id)
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if vol.claims:
                raise ValueError(
                    f"volume {vol_id} has {len(vol.claims)} active claims"
                )
            # Deprovision BEFORE dropping the record: a controller
            # failure here leaves the record in place so the operator
            # can retry — the reverse order would orphan the external
            # storage forever (the record with its external_id is the
            # only handle we have on it).
            if vol.plugin_id and vol.external_id:
                self.cs.csi_controller_roundtrip(
                    vol.plugin_id,
                    "CSI.delete",
                    {"external_id": vol.external_id},
                )
            self.cs.server.volume_deregister(ns, vol_id)
            return None

        return self._forward("Volume.delete", args, local)

    def plugins(self, args):
        return self.cs.server.state.csi_plugins()

    def detach(self, args):
        """Operator escape hatch for a wedged attachment (reference
        csi_endpoint.go Unpublish / `nomad volume detach`): release the
        volume's claims held by allocs on one node and tell the
        controller plugin to unpublish it there."""

        def local(a):
            ns, vol_id, node_id = (
                a["namespace"], a["volume_id"], a["node_id"]
            )
            vol = self.cs.server.state.volume_by_id(ns, vol_id)
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            alloc_ids = [
                c.alloc_id
                for c in vol.claims.values()
                if c.node_id == node_id
            ]
            if alloc_ids:
                # scoped: these allocs may hold legitimate claims on
                # OTHER volumes — only this volume's claims release
                self.cs.server.raft_apply(
                    "volume_claim_release",
                    {
                        "namespace": ns,
                        "volume_id": vol_id,
                        "alloc_ids": alloc_ids,
                    },
                )
            if vol.plugin_id and vol.external_id:
                self.cs.csi_controller_roundtrip(
                    vol.plugin_id,
                    "CSI.controller_unpublish",
                    {
                        "volume_id": vol.id,
                        "external_id": vol.external_id,
                        "node_id": node_id,
                    },
                )
            return {"released_claims": len(alloc_ids)}

        return self._forward("Volume.detach", args, local)

    def snapshot_create(self, args):
        """Point-in-time snapshot of a registered CSI volume (reference
        csi_endpoint.go CreateSnapshot → controller RPC)."""

        def local(a):
            ns, vol_id = a["namespace"], a["volume_id"]
            vol = self.cs.server.state.volume_by_id(ns, vol_id)
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if not vol.plugin_id or not vol.external_id:
                raise ValueError(
                    f"volume {vol_id} is not a provisioned CSI volume"
                )
            out = self.cs.csi_controller_roundtrip(
                vol.plugin_id,
                "CSI.create_snapshot",
                {
                    "external_id": vol.external_id,
                    "name": a.get("name") or vol_id,
                    "params": dict(vol.context or {}),
                },
            )
            # documented shape only — the roundtrip's transport "ok"
            # key must not become accidental API contract
            return {
                k: out.get(k)
                for k in (
                    "snapshot_id", "source_external_id", "size_mb",
                    "create_time_ns", "ready",
                )
            }

        return self._forward("Volume.snapshot_create", args, local)

    def snapshot_delete(self, args):
        def local(a):
            self.cs.csi_controller_roundtrip(
                a["plugin_id"],
                "CSI.delete_snapshot",
                {"snapshot_id": a["snapshot_id"]},
            )
            return None

        return self._forward("Volume.snapshot_delete", args, local)

    def snapshot_list(self, args):
        def local(a):
            out = self.cs.csi_controller_roundtrip(
                a["plugin_id"], "CSI.list_snapshots", {}
            )
            return out.get("snapshots", [])

        return self._forward("Volume.snapshot_list", args, local)


class SecretsEndpoint(_Forwarder):
    """Embedded secrets store + task-token derivation (the Vault-analog
    server side; reference nomad/vault.go + client/vaultclient)."""

    def upsert(self, args):
        return self._forward(
            "Secrets.upsert",
            args,
            lambda a: self.cs.server.secret_upsert(a["entry"]),
        )

    def delete(self, args):
        return self._forward(
            "Secrets.delete",
            args,
            lambda a: self.cs.server.secret_delete(
                a["namespace"], a["path"]
            ),
        )

    def read(self, args):
        ns = args.get("namespace", "default")
        # Task template reads authenticate with the task's DERIVED token
        # (the consul-template-with-vault-token model): when enforcement
        # is on, the token's policies must grant read-secret in the
        # namespace — a task without a vault stanza has no token and
        # reads nothing.
        if self.cs.acl_enforce:
            try:
                acl = self.cs.server.resolve_token(args.get("token", ""))
            except PermissionError as e:
                raise PermissionError(f"secret read: {e}") from None
            if acl is None:
                raise PermissionError("secret read: missing token")
            if not acl.is_management() and not acl.allow_namespace_op(
                ns, "read-secret"
            ):
                raise PermissionError(
                    "secret read: missing 'read-secret' capability"
                )
        return self.cs.server.state.secret_by_path(ns, args["path"])

    def list(self, args):
        # redact values in listings — only `read` of a named path
        # returns items
        out = []
        for e in self.cs.server.state.secrets(args.get("namespace")):
            out.append({
                "path": e.path,
                "namespace": e.namespace,
                "keys": sorted(e.items),
                "modify_index": e.modify_index,
            })
        return out

    def derive_token(self, args):
        return self._forward(
            "Secrets.derive_token",
            args,
            lambda a: self.cs.server.derive_task_token(
                a["alloc_id"], a["task_name"]
            ),
        )

    def renew_token(self, args):
        return self._forward(
            "Secrets.renew_token",
            args,
            lambda a: self.cs.server.renew_task_token(a["accessor_id"]),
        )

    def revoke_token(self, args):
        return self._forward(
            "Secrets.revoke_token",
            args,
            lambda a: self.cs.server.acl_token_delete([a["accessor_id"]]),
        )


class ServiceEndpoint(_Forwarder):
    """Native service discovery (reference:
    nomad/service_registration_endpoint.go)."""

    def register(self, args):
        return self._forward(
            "Service.register",
            args,
            lambda a: self.cs.server.services_register(a["regs"]),
        )

    def deregister_alloc(self, args):
        return self._forward(
            "Service.deregister_alloc",
            args,
            lambda a: self.cs.server.services_deregister_alloc(a["alloc_id"]),
        )

    def deregister(self, args):
        return self._forward(
            "Service.deregister",
            args,
            lambda a: self.cs.server.services_deregister(a["ids"]),
        )

    def list(self, args):
        return self.cs.server.state.service_names(args.get("namespace"))

    def get(self, args):
        return self.cs.server.state.service_registrations(
            args.get("namespace", "default"), args["name"]
        )


class NodeEndpoint(_Forwarder):
    def register(self, args):
        return self._forward(
            "Node.register", args, lambda a: self.cs.server.node_register(a["node"])
        )

    def heartbeat(self, args):
        return self._forward(
            "Node.heartbeat",
            args,
            lambda a: self.cs.server.node_heartbeat(a["node_id"]),
        )

    def update_status(self, args):
        return self._forward(
            "Node.update_status",
            args,
            lambda a: self.cs.server.node_update_status(a["node_id"], a["status"]),
        )

    def update_drain(self, args):
        return self._forward(
            "Node.update_drain",
            args,
            lambda a: self.cs.server.node_update_drain(
                a["node_id"], a.get("drain"), a.get("mark_eligible", False)
            ),
        )

    def update_eligibility(self, args):
        return self._forward(
            "Node.update_eligibility",
            args,
            lambda a: self.cs.server.node_update_eligibility(
                a["node_id"], a["eligibility"]
            ),
        )

    def get_client_allocs(self, args):
        # Blocking query served from the local replica: alloc writes reach
        # followers via raft, waking the same watch channels.
        allocs, index = self.cs.server.get_client_allocs(
            args["node_id"],
            args.get("min_index", 0),
            args.get("timeout_s", 5.0),
        )
        return {"allocs": allocs, "index": index}

    def update_allocs(self, args):
        return self._forward(
            "Node.update_allocs",
            args,
            lambda a: self.cs.server.update_allocs_from_client(a["allocs"]),
        )

    def get(self, args):
        return self.cs.server.state.node_by_id(args["node_id"])

    def list(self, args):
        return self.cs.server.state.nodes()

    def purge(self, args):
        return self._forward(
            "Node.purge",
            args,
            lambda a: self.cs.server.raft_apply("node_deregister", a["node_id"]),
        )


class EvalEndpoint(_Forwarder):
    def get(self, args):
        return self.cs.server.state.eval_by_id(args["eval_id"])

    def delete(self, args):
        """Delete terminal evals (reference eval_endpoint.go Delete —
        1.4's operator eval cleanup). The terminal check lives HERE, on
        the leader, immediately before the apply — an HTTP-layer-only
        check would let any fabric caller (or a check-then-apply race)
        drop a pending eval from the broker."""

        def local(a):
            for eid in a["eval_ids"]:
                ev = self.cs.server.state.eval_by_id(eid)
                if ev is None:
                    raise KeyError(f"eval {eid} not found")
                if not ev.terminal_status():
                    raise ValueError(
                        f"eval {eid} is {ev.status}; only terminal "
                        f"evaluations can be deleted"
                    )
            return self.cs.server.raft_apply(
                "eval_delete", (a["eval_ids"], [])
            )

        return self._forward("Eval.delete", args, local)

    def allocs(self, args):
        return self.cs.server.state.allocs_by_eval(args["eval_id"])

    def list(self, args):
        return self.cs.server.state.evals()


class AllocEndpoint(_Forwarder):
    def get(self, args):
        return self.cs.server.state.alloc_by_id(args["alloc_id"])

    def list(self, args):
        return self.cs.server.state.allocs()

    def stop(self, args):
        def local(a):
            try:
                alloc = self.cs.find_alloc(a["alloc_id"])
            except LookupError as e:
                raise KeyError(str(e)) from None
            return self.cs.server.alloc_stop(alloc.id)

        return self._forward("Alloc.stop", args, local)

    def list_by_node(self, args):
        return self.cs.server.state.allocs_by_node(args["node_id"])

    def client_addr(self, args):
        """(alloc, 'host:port' of its node's client fabric) — the
        prev-alloc migrator's cross-node lookup."""
        st = self.cs.server.state
        alloc = st.alloc_by_id(args["alloc_id"])
        if alloc is None:
            return None, None
        node = st.node_by_id(alloc.node_id)
        addr = node.attributes.get("unique.client.rpc") if node else None
        return alloc, addr


class DeploymentEndpoint(_Forwarder):
    def get(self, args):
        return self.cs.server.state.deployment_by_id(args["deployment_id"])

    def list(self, args):
        return self.cs.server.state.deployments()

    def promote(self, args):
        return self._forward(
            "Deployment.promote",
            args,
            lambda a: self.cs.server.deployment_promote(
                a["deployment_id"], a.get("groups")
            ),
        )

    def pause(self, args):
        return self._forward(
            "Deployment.pause",
            args,
            lambda a: self.cs.server.deployment_pause(
                a["deployment_id"], a["pause"]
            ),
        )

    def fail(self, args):
        return self._forward(
            "Deployment.fail",
            args,
            lambda a: self.cs.server.deployment_fail(a["deployment_id"]),
        )


class ACLEndpoint(_Forwarder):
    def _forward_authoritative(self, method: str, args):
        """Replicated ACL state (policies, global tokens) is writable
        ONLY in the authoritative region — a write landed here would be
        reverted by the next replication poll. Forward it (reference
        acl_endpoint.go rewrites args.Region to AuthoritativeRegion).
        Returns None when THIS region is authoritative (or federation
        is unconfigured) and the caller should apply locally."""
        cs = self.cs
        if not cs.authoritative_region or cs.region == cs.authoritative_region:
            return None
        addr = cs.region_server(cs.authoritative_region)
        if addr is None:
            raise RPCError(
                f"authoritative region {cs.authoritative_region!r} "
                f"unreachable for replicated ACL write"
            )
        return lambda: cs.pool.call(addr, method, args, timeout_s=10.0)

    def bootstrap(self, args):
        return self._forward(
            "ACL.bootstrap", args, lambda a: self.cs.server.acl_bootstrap()
        )

    def policy_upsert(self, args):
        fwd = self._forward_authoritative("ACL.policy_upsert", args)
        if fwd is not None:
            return fwd()
        return self._forward(
            "ACL.policy_upsert",
            args,
            lambda a: self.cs.server.acl_policy_upsert(a["policies"]),
        )

    def policy_delete(self, args):
        fwd = self._forward_authoritative("ACL.policy_delete", args)
        if fwd is not None:
            return fwd()
        return self._forward(
            "ACL.policy_delete",
            args,
            lambda a: self.cs.server.acl_policy_delete(a["names"]),
        )

    def policy_get(self, args):
        return self.cs.server.state.acl_policy_by_name(args["name"])

    def policy_list(self, args):
        return self.cs.server.state.acl_policies()

    def token_create(self, args):
        # Global tokens are minted in the authoritative region and
        # replicate outward (reference acl_endpoint.go UpsertTokens
        # forwards globals to AuthoritativeRegion; leader.go:1423 pulls
        # them back). Local tokens stay region-local.
        token = args.get("token")
        stored_global = False
        if token is not None and token.accessor_id:
            stored = self.cs.server.state.acl_token_by_accessor(
                token.accessor_id
            )
            stored_global = stored is not None and stored.global_
        # forward when the token IS global or WAS global (a demotion to
        # local must land authoritatively too, or replication re-promotes
        # it here within one poll)
        if token is not None and (
            getattr(token, "global_", False) or stored_global
        ):
            fwd = self._forward_authoritative("ACL.token_create", args)
            if fwd is not None:
                return fwd()
        return self._forward(
            "ACL.token_create",
            args,
            lambda a: self.cs.server.acl_token_create(a["token"]),
        )

    def token_delete(self, args):
        # Global-token deletes must land in the authoritative region or
        # the replication poll resurrects the revoked secret here within
        # one interval. Split the batch: globals forward, locals apply.
        state = self.cs.server.state
        accessors = list(args.get("accessor_ids", []))
        global_ids = [
            aid
            for aid in accessors
            if (t := state.acl_token_by_accessor(aid)) is not None
            and t.global_
        ]
        if global_ids:
            fwd = self._forward_authoritative(
                "ACL.token_delete", {**args, "accessor_ids": global_ids}
            )
            if fwd is not None:
                fwd()
                accessors = [a for a in accessors if a not in global_ids]
                if not accessors:
                    return None
                args = {**args, "accessor_ids": accessors}
        return self._forward(
            "ACL.token_delete",
            args,
            lambda a: self.cs.server.acl_token_delete(a["accessor_ids"]),
        )

    def token_get(self, args):
        return self.cs.server.state.acl_token_by_accessor(args["accessor_id"])

    def replicate(self, args):
        """Server-to-server replication feed (reference ACL.ListPolicies /
        ACL.ListTokens driven by leader.go:1282,1423): full policy set +
        GLOBAL tokens WITH secrets, plus the acl table index so pollers
        no-op cheaply. Rides the server fabric only — the fabric's shared
        rpc secret/mTLS is the authorization boundary (the reference uses
        a replication token; external clients never see this surface
        because token_list redacts secrets)."""
        from ..state.store import TABLE_ACL_POLICIES, TABLE_ACL_TOKENS

        state = self.cs.server.state
        idx = state.table_index(TABLE_ACL_POLICIES, TABLE_ACL_TOKENS)
        if args.get("min_index") and idx <= args["min_index"]:
            return {"index": idx, "unchanged": True}
        return {
            "index": idx,
            "policies": state.acl_policies(),
            "tokens": [t for t in state.acl_tokens() if t.global_],
        }

    def token_list(self, args):
        # Secrets are never listed (reference redacts SecretID on list).
        out = []
        for t in self.cs.server.state.acl_tokens():
            c = t.copy()
            c.secret_id = ""
            out.append(c)
        return out


class ScalingEndpoint(_Forwarder):
    """Reference: nomad/scaling_endpoint.go."""

    def list_policies(self, args):
        return self.cs.server.state.scaling_policies(
            args.get("namespace")
        )

    def get_policy(self, args):
        return self.cs.server.state.scaling_policy_by_id(
            args["policy_id"]
        )


class SystemEndpoint(_Forwarder):
    """Reference: nomad/system_endpoint.go."""

    def reconcile_summaries(self, args):
        return self._forward(
            "System.reconcile_summaries",
            args,
            lambda a: self.cs.server.reconcile_job_summaries(),
        )


class StatusEndpoint(_Forwarder):
    def leader(self, args):
        addr = self.cs.raft.leader_addr()
        return {"leader": list(addr) if addr else None}

    def regions(self, args):
        """Distinct regions known via gossip (reference
        nomad/regions_endpoint.go — federation membership rides serf)."""
        regions = {self.cs.region}
        for m in self.cs.serf.members():
            r = (m.tags or {}).get("region")
            if r:
                regions.add(r)
        return sorted(regions)

    def peers(self, args):
        out = [
            {"id": self.cs.node_id, "addr": list(self.cs.rpc.addr)}
        ]
        with self.cs.raft._lock:  # applies mutate the dict in place
            peers = dict(self.cs.raft.peers)
        for pid, addr in peers.items():
            out.append({"id": pid, "addr": list(addr)})
        return out

    def ping(self, args):
        return "pong"

    def members(self, args):
        return [m.to_wire() for m in self.cs.serf.members()]

    def peer_telemetry(self, args):
        """One member's health/telemetry summary, answered LOCALLY
        (never forwarded — the caller is federating, and a forward
        would report the leader's numbers as ours). The leader-side
        aggregation in ClusterServer.cluster_health pulls this from
        every member with a bounded per-peer deadline."""
        top = int((args or {}).get("top", 5))
        return self.cs.peer_telemetry(top=top)


class ClusterServer:
    def __init__(
        self,
        node_id: str,
        peers: Optional[dict[str, tuple[str, int]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        num_workers: int = 2,
        use_tpu_batch_worker: bool = False,
        enabled_schedulers=None,
        region: str = "global",
        bootstrap_expect: Optional[int] = None,
        rpc_secret="",  # str | rpc.keyring.Keyring (shared by the agent)
        data_dir: Optional[str] = None,
        acl_enforce: bool = False,
        authoritative_region: Optional[str] = None,
        acl_replication_interval_s: float = 0.5,
        tls=None,  # (server_ctx, client_ctx) from rpc.tls.fabric_contexts
        solver_pool_role: str = "",
        solver_pool_members=(),
        solver_pool_sync_interval_s: float = 2.0,
        blackbox_enabled: bool = True,
        incident_dir: Optional[str] = None,
        incident_max: int = 16,
        scheduler_config=None,  # scheduler.context.SchedulerConfig
        **raft_kw,
    ) -> None:
        self.node_id = node_id
        self.region = region
        self.acl_enforce = acl_enforce
        # Federated ACL replication (reference leader.go:1282,1423): a
        # region naming an authoritative region other than itself pulls
        # that region's policies + global tokens on its leader.
        self.authoritative_region = authoritative_region
        self.acl_replication_interval_s = acl_replication_interval_s
        self._acl_repl_stop: Optional[threading.Event] = None
        self.tls = tls
        # One keyring for this server's listener AND dialer (rpc/
        # keyring.py): a live rpc_secret rotation (Agent.reload /
        # ChaosCluster.rotate_secret) moves both sides together. The
        # agent passes its process-shared Keyring; a plain string gets
        # a private one.
        from ..rpc.keyring import ensure_keyring

        self.keyring = ensure_keyring(rpc_secret)
        self.rpc = RPCServer(
            host=host, port=port, secret=self.keyring,
            tls_context=tls[0] if tls else None,
        )
        self.pool = ConnPool(
            secret=self.keyring, tls_context=tls[1] if tls else None
        )
        # Fault-plane identity (faultplane.py): injected partitions
        # and response drops match on these labels. No-ops in production.
        self.pool.owner = node_id
        self.rpc.chaos_label = node_id
        # Per-source cost ledger (clusterobs.py): THIS server's own
        # instance — an in-process test cluster attributes per member,
        # and Status.peer_telemetry reports each member's own ledger.
        # Both dispatch paths feed it: the fabric socket
        # (RPCServer._dispatch) and in-process rpc_self below. The
        # bounded provider gauges ride the registry; per-source detail
        # stays in the ledger (cardinality stays fixed).
        self.source_ledger = clusterobs.SourceLedger()
        self.rpc.source_ledger = self.source_ledger
        self._source_provider = metrics.register_provider(
            "nomad.rpc.source", self.source_ledger.stats
        )
        self._started_monotonic = time.monotonic()
        # Leaderless-window retry budget for _Forwarder (retry.py) —
        # overridable per deployment (tests shrink it).
        self.forward_retry = FORWARD_POLICY
        # Per-namespace token buckets on the RPC front door (ratelimit
        # .py; disabled until limits{} config sets a rate). Charged in
        # _rpc_precheck for the eval-minting write verbs only — raft,
        # serf, heartbeats, and reads must never be throttled (a
        # throttled heartbeat marks live nodes down, amplifying the
        # overload this exists to contain). A follower charges its own
        # bucket before forwarding, the leader charges again on arrival:
        # per-server budgets, conservative under forwarding.
        from ..ratelimit import KeyedRateLimiter

        self.rpc_limiter = KeyedRateLimiter()
        # The node door (fleet-scale survival): Node.register is the ONE
        # node-originated verb that gets admission control. A reconnect
        # storm (partition heals, mass agent restart) is survivable if
        # registrations are paced — clients back off on 429/Retry-After
        # and re-register within their TTL — whereas an unpaced storm
        # stacks raft writes behind every live heartbeat. Heartbeats
        # themselves stay unthrottled (throttling them manufactures the
        # very down-marks the door exists to prevent).
        self.node_limiter = KeyedRateLimiter()
        self.server = Server(
            num_workers=num_workers,
            scheduler_config=scheduler_config,
            use_tpu_batch_worker=use_tpu_batch_worker,
            enabled_schedulers=enabled_schedulers,
        )
        # Wider timers than the raw RaftNode defaults: a full server stacks
        # scheduler workers, watchers, and client traffic onto the same
        # process, so heartbeat delivery jitter is much higher than in a
        # bare raft cluster (GIL contention).
        raft_kw.setdefault("heartbeat_ms", 100)
        raft_kw.setdefault("election_ms", 1000)
        # Static peer wiring (tests, fixed configs) bootstraps immediately;
        # gossip-discovered clusters wait for bootstrap_expect members
        # (reference server config bootstrap_expect + serf discovery).
        if bootstrap_expect is None:
            bootstrap_expect = len(peers) + 1 if peers else 1
        raft_kw.setdefault("bootstrap_expect", bootstrap_expect)
        self._bootstrap_expect = bootstrap_expect
        self._bootstrapped = bool(peers) or bootstrap_expect <= 1
        # Durable raft storage (reference: raft-boltdb + FSM snapshots,
        # nomad/server.go:1210): with a data_dir, term/vote/log/snapshot
        # survive a full-cluster restart.
        self.raft_store = None
        if data_dir:
            import os

            from .raft_store import RaftLogStore

            self.raft_store = RaftLogStore(
                os.path.join(data_dir, "server", "raft.db")
            )
            self.raft_store.chaos_label = node_id
        self.raft = RaftNode(
            node_id,
            self.server.fsm,
            self.pool,
            self.rpc.addr,
            peers or {},
            snapshot_fn=self.server.state.serialize,
            restore_fn=self.server.state.restore_from,
            on_leader_change=self._on_leader_change,
            store=self.raft_store,
            **raft_kw,
        )
        self.server.set_raft_applier(self._raft_apply, self._raft_apply_async)
        # Replay barrier for establish_leadership (server.py): broker
        # state must be rebuilt only from a store that has applied this
        # leader's own barrier entry — i.e. the full committed log, not
        # a mid-replay prefix (the duplicate-alloc window after a
        # full-cluster restart with leadership churn).
        self.server.replay_barrier = self._replay_barrier
        self.rpc.precheck = self._rpc_precheck
        self.rpc.register("Raft", self.raft.endpoint)
        for name, ep in (
            ("Job", JobEndpoint(self)),
            ("Node", NodeEndpoint(self)),
            ("Eval", EvalEndpoint(self)),
            ("Alloc", AllocEndpoint(self)),
            ("Volume", VolumeEndpoint(self)),
            ("Service", ServiceEndpoint(self)),
            ("Secrets", SecretsEndpoint(self)),
            ("Namespace", NamespaceEndpoint(self)),
            ("Search", SearchEndpoint(self)),
            ("Deployment", DeploymentEndpoint(self)),
            ("ACL", ACLEndpoint(self)),
            ("Status", StatusEndpoint(self)),
            ("System", SystemEndpoint(self)),
            ("Scaling", ScalingEndpoint(self)),
            ("Operator", OperatorEndpoint(self)),
        ):
            self.rpc.register(name, ep)
        # Streaming exec splice: API consumer ↔ this server ↔ the
        # alloc's client agent ↔ driver pty (reference streaming path,
        # SURVEY §3.5 — 4 process boundaries).
        self.rpc.register_stream("ClientExec.exec", self._handle_exec_stream)
        # Reverse-dial registry: NAT'd clients park connections here that
        # the server can open streams over when forward-dial fails
        # (reference nomad/client_rpc.go yamux session reuse).
        self._reverse_lock = threading.Lock()
        self._reverse: dict[str, list[tuple]] = {}
        self.rpc.register_stream(
            "ClientReverse.register", self._handle_reverse_register
        )
        # Gossip membership (reference setupSerf): server-role tagged,
        # events drive leader-side raft peer reconciliation.
        self.serf = Membership(
            node_id,
            self.rpc.addr,
            pool=self.pool,
            tags={"role": "server", "region": region},
            on_event=self._on_member_event,
        )
        self.rpc.register("Serf", self.serf.endpoint)
        # Solver-pool tier (server/solver_pool.py): membership hangs off
        # the serf ring above (tag solver=1); the endpoint serves warm
        # remote solves; the leader's batch worker dispatches through the
        # tracker. Constructed AFTER serf so role="solver" can advertise
        # on the local member record before gossip starts.
        from .solver_pool import SolverPool

        self.solver_pool = SolverPool(
            self,
            role=solver_pool_role,
            members=solver_pool_members,
            sync_interval_s=solver_pool_sync_interval_s,
        )
        self.rpc.register("SolverPool", self.solver_pool.endpoint)
        if getattr(self.server, "tpu_worker", None) is not None:
            self.server.tpu_worker.solver_pool = self.solver_pool
        # Blackbox flight recorder (blackbox.py + blackbox_wire.py):
        # always-on journal pump + anomaly triggers + incident capture.
        # Owned here (not by the Agent) so bare ClusterServers — chaos
        # clusters included — are self-forensic. Incident bundles land
        # under data_dir/incidents unless a dir is configured; with
        # neither (dev mode), captures stay in the in-memory ledger.
        from .blackbox_wire import BlackboxWiring

        if incident_dir is None and data_dir:
            import os

            incident_dir = os.path.join(data_dir, "incidents")
        self.blackbox = BlackboxWiring(
            self,
            incident_dir=incident_dir or "",
            incident_max=incident_max,
            enabled=blackbox_enabled,
        )
        # Member events are handled on a dedicated reconciler thread:
        # add_peer/remove_peer block on raft commit (up to 10s with no
        # quorum), which must never stall the gossip probe loop.
        self._reconcile_q: "queue.Queue" = queue.Queue()
        self._reconciler = threading.Thread(
            target=self._reconcile_loop,
            name=f"reconcile-{node_id}",
            daemon=True,
        )
        self._reconciler.start()

    # -- cluster-scope observability (clusterobs.py) -------------------

    def peer_telemetry(self, top: int = 5) -> dict:
        """THIS member's health/telemetry summary — the per-server row
        of ``/v1/operator/cluster/health`` (autopilot-health-shaped:
        raft indices, broker/plan-queue depths, host CPU/RSS, and the
        per-source cost top-K). Reads live structures only; cheap
        enough for a poll loop."""
        raft = self.raft
        srv = self.server
        from .. import hostobs

        host = clusterobs.host_summary()
        prof = hostobs.profiler()
        host["profiler_running"] = prof.running()
        host["busy_seconds"] = round(prof.busy_ns / 1e9, 3)
        return {
            "id": self.node_id,
            "region": self.region,
            "addr": list(self.rpc.addr),
            "leader": self.is_leader(),
            "leader_id": raft.leader_id,
            "uptime_s": round(
                time.monotonic() - self._started_monotonic, 1
            ),
            "raft": {
                "state": raft.state,
                "term": raft.current_term,
                "commit_index": raft.commit_index,
                "applied_index": raft.last_applied,
                "last_index": raft.last_index,
            },
            "broker": srv.eval_broker.stats_snapshot(),
            "plan_queue_depth": srv.plan_queue.depth(),
            "host": host,
            "sources": self.source_ledger.snapshot(top=top),
        }

    def cluster_health(
        self, per_peer_timeout_s: float = 2.0, top: int = 5
    ) -> dict:
        """Leader-side telemetry federation: pull every known member's
        ``Status.peer_telemetry`` over the existing fabric, each under
        a bounded per-peer deadline, in parallel. A member that cannot
        answer in time is reported ``degraded`` with the error — the
        response NEVER hangs on a partitioned or dead peer, and healthy
        members are still aggregated (the autopilot-health shape). Any
        server may serve this; it needs no leadership."""
        t0 = time.perf_counter()
        per_peer_timeout_s = max(0.1, min(float(per_peer_timeout_s), 30.0))
        top = max(1, min(int(top), 50))
        with self.raft._lock:  # applies mutate the dict in place
            peers = {
                pid: tuple(a) for pid, a in self.raft.peers.items()
            }
        for m in self.serf.members():
            if m.id != self.node_id and (m.tags or {}).get(
                "role"
            ) == "server":
                peers.setdefault(m.id, tuple(m.addr))
        peers.pop(self.node_id, None)
        results: dict[str, dict] = {}
        local = self.peer_telemetry(top=top)
        local["status"] = "ok"
        results[self.node_id] = local

        def query(pid: str, addr: tuple) -> None:
            try:
                out = self.pool.call(
                    addr,
                    "Status.peer_telemetry",
                    {"top": top},
                    timeout_s=per_peer_timeout_s,
                    retries=0,
                )
                out["status"] = "ok"
                results[pid] = out  # GIL-atomic store
            except Exception as e:
                # never overwrite a success a racing attempt landed
                results.setdefault(
                    pid,
                    {
                        "id": pid,
                        "addr": list(addr),
                        "status": "degraded",
                        "error": f"{type(e).__name__}: {e}",
                    },
                )

        threads = []
        for pid, addr in peers.items():
            t = threading.Thread(
                target=query,
                args=(pid, addr),
                name=f"cluster-health-{pid}",
                daemon=True,
            )
            t.start()
            threads.append(t)
        # one shared deadline: peers are queried in PARALLEL, so the
        # whole federation costs one per-peer budget (+ slack), not N.
        # Stragglers are left to their daemon threads and reported
        # degraded — a hung peer must never hang the response.
        deadline = time.monotonic() + per_peer_timeout_s + 0.25
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        servers = []
        degraded = []
        fleet = {
            "broker_ready": 0,
            "broker_unacked": 0,
            "plan_queue_depth": 0,
            "cpu_seconds": 0.0,
            "rss_bytes": 0,
        }
        source_rows: list[dict] = []
        for pid in sorted(set(peers) | {self.node_id}):
            ent = results.get(pid)
            if ent is None:
                ent = {
                    "id": pid,
                    "addr": list(peers.get(pid, ())),
                    "status": "degraded",
                    "error": "peer deadline exceeded",
                }
            if ent.get("status") == "ok":
                broker = ent.get("broker") or {}
                fleet["broker_ready"] += int(
                    broker.get("total_ready", 0)
                )
                fleet["broker_unacked"] += int(
                    broker.get("total_unacked", 0)
                )
                fleet["plan_queue_depth"] += int(
                    ent.get("plan_queue_depth", 0)
                )
                host = ent.get("host") or {}
                fleet["cpu_seconds"] = round(
                    fleet["cpu_seconds"]
                    + float(host.get("cpu_seconds", 0.0)),
                    3,
                )
                fleet["rss_bytes"] += int(host.get("rss_bytes", 0))
                source_rows.extend(
                    (ent.get("sources") or {}).get("top", [])
                )
            else:
                degraded.append(pid)
            servers.append(ent)
        fleet["sources_top"] = clusterobs.merge_top_sources(
            source_rows, top=top
        )
        leader_id = next(
            (s["id"] for s in servers if s.get("leader")), None
        )
        out = {
            "region": self.region,
            "queried_by": self.node_id,
            "leader": leader_id,
            "per_peer_timeout_s": per_peer_timeout_s,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "healthy": len(servers) - len(degraded),
            "degraded": degraded,
            "servers": servers,
            "fleet": fleet,
        }
        metrics.observe(
            "nomad.cluster.health_seconds", time.perf_counter() - t0
        )
        metrics.set_gauge("nomad.cluster.members", float(len(servers)))
        metrics.set_gauge(
            "nomad.cluster.degraded", float(len(degraded))
        )
        if degraded:
            metrics.incr("nomad.cluster.peer_degraded", len(degraded))
        return out

    # -- wiring --------------------------------------------------------

    def autopilot_config(self) -> dict:
        cfg = self.server.state.operator_config("autopilot")
        return dict(cfg) if cfg else {"CleanupDeadServers": True}

    def force_leave(self, member_id: str) -> int:
        """Force a (presumed-dead) member out of gossip everywhere
        (reference `server force-leave` / serf RemoveFailedNode).
        Returns how many peers acknowledged."""
        target = next(
            (m for m in self.serf.members() if m.id == member_id), None
        )
        # Unknown locally ⇒ peers may hold it at any incarnation: use an
        # operator-override incarnation that outranks organic ones (a
        # force-left member is declared dead; it does not refute).
        inc = (target.incarnation + 1) if target else (1 << 30)
        self.serf.endpoint.leave(
            {"id": member_id, "incarnation": inc}
        )
        acked = 0
        for m in self.serf.members():
            if m.id in (member_id, self.node_id):
                continue
            try:
                accepted = self.pool.call(
                    tuple(m.addr), "Serf.leave",
                    {"id": member_id, "incarnation": inc},
                    timeout_s=3.0,
                )
            except Exception:
                continue
            if accepted:
                acked += 1
        return acked

    def csi_controller_roundtrip(
        self, plugin_id: str, verb: str, header: dict
    ) -> dict:
        """Run one controller verb on SOME node carrying a healthy
        controller-capable instance of the plugin (reference: the server
        routes controller RPCs to a random plugin-bearing client)."""
        candidates = []
        for node in self.server.state.nodes():
            info = node.csi_plugins.get(plugin_id)
            addr_s = node.attributes.get("unique.client.rpc", "")
            if (
                info
                and info.get("healthy")
                and info.get("controller")
                and addr_s
            ):
                host, _, port = addr_s.rpartition(":")
                candidates.append((host, int(port)))
        if not candidates:
            raise RPCError(
                f"no healthy controller for CSI plugin {plugin_id!r}"
            )
        import random

        last: Exception = RPCError("unreachable")
        for addr in random.sample(candidates, len(candidates)):
            try:
                session = self.pool.stream(
                    addr, verb, {"plugin_id": plugin_id, **header}
                )
            except (ConnectionError, OSError) as e:
                last = e
                continue
            try:
                msg = session.recv(timeout_s=30)
            finally:
                session.close()
            if msg.get("error"):
                raise RPCError(msg["error"])
            return msg
        raise RPCError(f"controller unreachable: {last}")

    def find_alloc(self, alloc_id: str):
        """Resolve an alloc by exact id or unique prefix — the single
        source of truth for id resolution (state only; raises
        LookupError with a human message)."""
        state = self.server.state
        alloc = state.alloc_by_id(alloc_id)
        if alloc is None:
            matches = [a for a in state.allocs() if a.id.startswith(alloc_id)]
            if len(matches) > 1:
                raise LookupError(f"alloc id prefix {alloc_id!r} ambiguous")
            alloc = matches[0] if matches else None
        if alloc is None:
            raise LookupError(f"allocation {alloc_id!r} not found")
        return alloc

    def find_alloc_client(self, alloc_id: str):
        """find_alloc plus the client agent's advertised streaming
        address (the HTTP fs handlers and the fabric exec splice)."""
        state = self.server.state
        alloc = self.find_alloc(alloc_id)
        node = state.node_by_id(alloc.node_id)
        addr_s = (node.attributes.get("unique.client.rpc", "") if node else "")
        if not addr_s:
            raise LookupError(
                "allocation's node does not advertise a client endpoint"
            )
        host, _, port = addr_s.rpartition(":")
        return alloc, (host, int(port))

    def _handle_reverse_register(self, session, header: dict) -> None:
        """Park a client-initiated connection until a relay consumes it.

        The dispatch thread owns the socket and closes it on return, so
        while parked it polls the socket for liveness: a readable socket
        before the entry is CLAIMED means the client hung up (it sends
        nothing while parked) — prune the entry instead of leaking a
        thread + fd per reconnect of a flapping client. Once claimed, the
        handler waits for the relay's close (done)."""
        import select as _select
        import threading as _t

        node_id = header.get("node_id", "")
        if not node_id:
            session.send({"error": "node_id required"})
            return
        entry = {
            "session": session,
            "claimed": _t.Event(),
            "done": _t.Event(),
        }
        with self._reverse_lock:
            self._reverse.setdefault(node_id, []).append(entry)
        sock = session._sock
        while not entry["claimed"].is_set():
            try:
                readable, _, _ = _select.select([sock], [], [], 0.5)
            except (OSError, ValueError):
                readable = [sock]
            if entry["claimed"].is_set():
                break  # readable bytes belong to the consumer's exchange
            if readable:
                # EOF (or protocol violation) while parked: dead client
                with self._reverse_lock:
                    stack = self._reverse.get(node_id)
                    if stack and entry in stack:
                        stack.remove(entry)
                        if not stack:
                            del self._reverse[node_id]
                    elif entry["claimed"].is_set():
                        break  # consumer raced us; let it run
                session.close()
                return
        entry["done"].wait()

    def take_reverse_session(self, node_id: str, method: str, header: dict):
        """Open a stream over a connection the client dialed (the NAT
        fallback). Returns a ready session or None when the node has no
        parked connections on THIS server. Dead parked sessions (client
        went away) are skimmed off until one answers."""
        while True:
            with self._reverse_lock:
                stack = self._reverse.get(node_id)
                if not stack:
                    return None
                entry = stack.pop()
                if not stack:
                    del self._reverse[node_id]
                # claim under the lock: the parker's liveness poll must
                # not mistake the upcoming ack bytes for a dead client
                entry["claimed"].set()
            session, done = entry["session"], entry["done"]
            hdr = dict(header)
            hdr["method"] = method
            try:
                session.send(hdr)
                ack = session.recv(timeout_s=10)
            except (ConnectionError, OSError, TimeoutError):
                done.set()
                session.close()
                continue
            if not ack.get("ok"):
                done.set()
                session.close()
                if ack.get("error"):
                    raise RPCError(ack["error"])
                continue
            orig_close = session.close

            def tracked_close(done=done, orig_close=orig_close):
                done.set()
                orig_close()

            session.close = tracked_close
            return session

    def _close_reverse_sessions(self) -> None:
        with self._reverse_lock:
            parked = [
                entry for stack in self._reverse.values() for entry in stack
            ]
            self._reverse.clear()
        for entry in parked:
            entry["claimed"].set()
            entry["done"].set()
            entry["session"].close()

    def _handle_exec_stream(self, session, header: dict) -> None:
        """Splice an exec session through to the alloc's client agent."""
        down = None
        try:
            try:
                alloc, addr = self.find_alloc_client(header.get("alloc_id", ""))
            except LookupError as e:
                session.send({"error": str(e)})
                return
            # ACL: exec grants a shell inside the task — when enforcement
            # is on, require alloc-exec on the alloc's namespace
            # (reference nomad/client_alloc_endpoint.go exec).
            if self.acl_enforce:
                try:
                    acl = self.server.resolve_token(header.get("token", ""))
                except PermissionError:
                    session.send({"error": "ACL token not found"})
                    return
                if acl is None:
                    session.send({"error": "missing ACL token"})
                    return
                if not acl.is_management() and not acl.allow_namespace_op(
                    alloc.namespace, "alloc-exec"
                ):
                    session.send(
                        {"error": "missing 'alloc-exec' capability"}
                    )
                    return
            hdr = dict(header)
            hdr.pop("token", None)
            hdr["alloc_id"] = alloc.id
            try:
                down = self.pool.stream(addr, "Exec.exec", hdr)
            except (ConnectionError, OSError) as e:
                # same NAT fallback as the fs/logs relay
                down = self.take_reverse_session(
                    alloc.node_id, "Exec.exec", hdr
                )
                if down is None:
                    session.send(
                        {"error": f"client agent unreachable: {e}"}
                    )
                    return

            done = threading.Event()

            def pump_down_to_up() -> None:
                try:
                    while True:
                        msg = down.recv(timeout_s=None)
                        session.send(msg)
                        if msg.get("eof") or msg.get("error"):
                            break
                except (ConnectionError, OSError):
                    pass
                finally:
                    done.set()

            t = threading.Thread(
                target=pump_down_to_up, name="exec-stream-down",
                daemon=True,
            )
            t.start()
            while not done.is_set():
                try:
                    msg = session.recv(timeout_s=0.5)
                except TimeoutError:
                    continue
                except (ConnectionError, OSError):
                    break
                try:
                    down.send(msg)
                except (ConnectionError, OSError):
                    break
                if msg.get("eof"):
                    break
            done.wait(timeout=5)
        except (ConnectionError, OSError):
            pass
        finally:
            if down is not None:
                down.close()
            session.close()

    def _replay_barrier(self) -> bool:
        """Wait for local replay of this leadership's barrier entry, as
        long as we HOLD the leadership (a slow replay under load keeps
        waiting; a depose aborts immediately so the queued revoke runs)."""
        while not self.raft.wait_for_replay(timeout_s=5.0):
            if not self.raft.is_leader() or self.raft._stop.is_set():
                return False
        return True

    def _raft_apply(self, msg_type: str, payload) -> int:
        return self.raft.apply(msg_type, payload)

    def _raft_apply_async(self, msg_type: str, payload):
        index, term = self.raft.apply_submit(msg_type, payload)
        return index, (lambda: self.raft.apply_wait(index, term))

    def _on_leader_change(self, is_leader: bool) -> None:
        # journal the edge BEFORE acting on it: a revoke that hangs in
        # establish/revoke teardown still leaves its flight-recorder
        # trace, and the leader-churn trigger counts these rows
        blackbox.record(
            blackbox.KIND_LEADERSHIP,
            f"node:{self.node_id}",
            transition="establish" if is_leader else "revoke",
            term=self.raft.current_term,
            rel=[f"node:{self.node_id}"],
        )
        if is_leader:
            logger.info("%s: establishing leadership", self.node_id)
            self.server.establish_leadership()
            if (
                self.authoritative_region
                and self.authoritative_region != self.region
                and self._acl_repl_stop is None
            ):
                self._acl_repl_stop = threading.Event()
                t = threading.Thread(
                    target=self._acl_replication_loop,
                    args=(self._acl_repl_stop,),
                    name=f"acl-repl-{self.node_id}",
                    daemon=True,
                )
                t.start()
        else:
            logger.info("%s: revoking leadership", self.node_id)
            if self._acl_repl_stop is not None:
                self._acl_repl_stop.set()
                self._acl_repl_stop = None
            # Abort in-flight pool dispatches BEFORE stopping the worker:
            # revoke_leadership joins the commit stage, whose finish()
            # may be blocked on a remote solve — the abort resolves it
            # promptly and the batch NACKS (redelivers on the new
            # leader) instead of dropping or stalling the revoke.
            self.solver_pool.abort_inflight()
            self.server.revoke_leadership()

    def _acl_replication_loop(self, stop: threading.Event) -> None:
        """Leader-only puller in a NON-authoritative region: mirror the
        authoritative region's policies and global tokens into this
        region's raft (reference replicateACLPolicies leader.go:1282 +
        replicateACLTokens leader.go:1423). Local (non-global) tokens in
        this region are never touched; policies converge to the
        authoritative set exactly."""
        last_index = 0
        while not stop.wait(self.acl_replication_interval_s):
            addr = self.region_server(self.authoritative_region)
            if addr is None:
                continue  # authoritative region not gossip-visible yet
            try:
                feed = self.pool.call(
                    addr, "ACL.replicate", {"min_index": last_index},
                    timeout_s=10.0,
                )
            except Exception:
                continue  # transient fabric failure: retry next tick
            if feed.get("unchanged"):
                continue
            try:
                self._acl_apply_feed(feed)
                last_index = feed["index"]
            except NotLeaderError:
                return  # deposed mid-apply; the new leader re-pulls
            except Exception:
                # a transient apply failure (raft commit timeout under
                # load) must not kill the daemon — replication would
                # silently stop until the next leadership change
                logger.exception(
                    "%s: acl replication apply failed; retrying",
                    self.node_id,
                )

    def _acl_apply_feed(self, feed: dict) -> None:
        state = self.server.state
        want_pols = {p.name: p for p in feed.get("policies", [])}
        have_pols = {p.name: p for p in state.acl_policies()}
        upserts = [
            p
            for name, p in want_pols.items()
            if name not in have_pols
            or have_pols[name].rules != p.rules
            or have_pols[name].description != p.description
        ]
        deletes = [n for n in have_pols if n not in want_pols]
        if upserts:
            self.server.raft_apply(
                "acl_policy_upsert", [p.copy() for p in upserts]
            )
        if deletes:
            self.server.raft_apply("acl_policy_delete", deletes)
        want_toks = {t.accessor_id: t for t in feed.get("tokens", [])}
        have_toks = {
            t.accessor_id: t for t in state.acl_tokens() if t.global_
        }
        tok_up = [
            t
            for aid, t in want_toks.items()
            if aid not in have_toks
            or have_toks[aid].secret_id != t.secret_id
            or have_toks[aid].policies != t.policies
            or have_toks[aid].type != t.type
            or have_toks[aid].expiration_time_ns != t.expiration_time_ns
        ]
        tok_del = [aid for aid in have_toks if aid not in want_toks]
        if tok_up:
            self.server.raft_apply(
                "acl_token_upsert", [t.copy() for t in tok_up]
            )
        if tok_del:
            self.server.raft_apply("acl_token_delete", tok_del)

    @property
    def addr(self) -> tuple[str, int]:
        return self.rpc.addr

    def rpc_self(self, method: str, args):
        """In-process RPC dispatch (no socket hop): runs the endpoint
        locally, which itself forwards to the leader when needed — the
        reference's server.RPC fast path. A request naming another
        REGION forwards to a server there first (nomad/rpc.go
        forwardRegion via serf WAN membership)."""
        region = args.get("region") if isinstance(args, dict) else None
        if region and region != self.region:
            addr = self.region_server(region)
            if addr is None:
                raise RPCError(f"no known servers in region {region!r}")
            return self.pool.call(addr, method, args, timeout_s=30.0)
        # Per-source attribution for the in-process door too (HTTP
        # routes, co-located client agents): same ledger + thread-source
        # registry as the fabric path in RPCServer._dispatch. The outer
        # source is saved/restored — a handler that internally re-enters
        # rpc_self must not lose its caller's attribution.
        sources = clusterobs.thread_sources()
        tid = threading.get_ident()
        prev = sources.get(tid)
        source = clusterobs.source_of("", args)
        sources[tid] = source
        t0 = time.perf_counter()
        try:
            return self.rpc.dispatch_local(method, args)
        finally:
            if prev is None:
                sources.pop(tid, None)
            else:
                sources[tid] = prev
            self.source_ledger.record(
                source, method, time.perf_counter() - t0
            )

    # The write verbs the per-namespace RPC rate limit covers: every
    # eval-minting mutation a client can drive in a loop. Deliberately
    # absent: deregister/stop (shedding a stop strands capacity),
    # node/heartbeat traffic, raft/serf internals, and all reads.
    _RATE_LIMITED_METHODS = frozenset({
        "Job.register",
        "Job.scale",
        "Job.evaluate",
        "Job.dispatch",
        "Job.revert",
        "Job.periodic_force",
    })

    def set_rate_limits(self, rpc_rate: float, rpc_burst: float = 0.0) -> None:
        """Configure (or SIGHUP-reconfigure) the per-namespace RPC
        front-door token buckets. rate <= 0 disables."""
        self.rpc_limiter.configure(rpc_rate, rpc_burst)

    def set_node_register_limit(
        self, rate: float, burst: float = 0.0
    ) -> None:
        """Configure (or SIGHUP-reconfigure) the Node.register admission
        door — one server-wide bucket, not per-namespace: a reconnect
        storm is a cluster-level event. rate <= 0 disables."""
        self.node_limiter.configure(rate, burst)

    @staticmethod
    def _args_namespace(args) -> str:
        if not isinstance(args, dict):
            return "default"
        ns = args.get("namespace")
        if not ns:
            job = args.get("job")
            ns = getattr(job, "namespace", None)
        return ns or "default"

    def _rpc_precheck(self, method: str, args) -> None:
        """Runs before EVERY dispatch (in-process and fabric-arriving):
        a federated request landing in its target region carries the
        caller's token — the sending region's HTTP-layer check used ITS
        acl state, so re-authorize against OURS (the reference resolves
        the forwarded token in the target region; non-replicated tokens
        are region-local, like non-global tokens there). The per-
        namespace rate limit also charges here: one choke point covers
        the fabric socket, in-process rpc_self, and HTTP-originated
        writes alike."""
        if self.node_limiter.enabled and method == "Node.register":
            from .. import metrics
            from ..ratelimit import RateLimitError

            wait = self.node_limiter.check("node")
            if wait > 0:
                metrics.incr("nomad.rpc.node_throttled")
                raise RateLimitError(
                    "node registration rate limit exceeded "
                    "(reconnect-storm admission door)",
                    retry_after_s=wait,
                )
        if (
            self.rpc_limiter.enabled
            and method in self._RATE_LIMITED_METHODS
        ):
            from .. import metrics
            from ..ratelimit import RateLimitError

            ns = self._args_namespace(args)
            wait = self.rpc_limiter.check(ns)
            if wait > 0:
                metrics.incr("nomad.rpc.throttled")
                raise RateLimitError(
                    f"rpc {method} rate limit exceeded for namespace "
                    f"{ns!r}",
                    retry_after_s=wait,
                )
        if (
            isinstance(args, dict)
            and args.get("__cross_region_token__") is not None
            and args.get("region") == self.region
        ):
            self._check_cross_region(method, args)

    # RPC method → (kind, capability) for federated re-authorization.
    # kind "ns": namespace capability against args' namespace;
    # kind "read": any valid token; everything unlisted needs management.
    _FEDERATED_CAPS = {
        "Job.register": ("ns", "submit-job"),
        "Job.deregister": ("ns", "submit-job"),
        "Job.revert": ("ns", "submit-job"),
        "Job.dispatch": ("ns", "dispatch-job"),
        "Job.plan": ("ns", "submit-job"),
        "Job.scale": ("ns_any", ("scale-job", "submit-job")),
        "Job.scale_status": ("ns", "read-job"),
        "Job.periodic_force": ("ns", "submit-job"),
        "Job.get": ("ns", "read-job"),
        "Job.list": ("read", None),
        "Job.allocs": ("ns", "read-job"),
        "Job.evals": ("ns", "read-job"),
        "Job.summary": ("ns", "read-job"),
        "Job.versions": ("ns", "read-job"),
        "Node.list": ("read", None),
        "Node.get": ("read", None),
        "Alloc.get": ("read", None),
        "Alloc.list": ("read", None),
        "Alloc.list_by_node": ("read", None),
        "Alloc.stop": ("alloc_ns", "alloc-lifecycle"),
        "Eval.get": ("read", None),
        "Eval.list": ("read", None),
        "Eval.allocs": ("read", None),
        "Deployment.get": ("read", None),
        "Deployment.list": ("read", None),
        "Service.list": ("read", None),
        "Service.get": ("read", None),
        "Volume.list": ("ns", "read-job"),
        "Volume.get": ("ns", "read-job"),
        "Volume.register": ("ns", "submit-job"),
        "Status.regions": ("read", None),
        "Status.leader": ("read", None),
        "Status.peers": ("read", None),
    }

    def _check_cross_region(self, method: str, args: dict) -> None:
        if not self.acl_enforce:
            return
        token = args.get("__cross_region_token__") or ""
        try:
            acl = self.server.resolve_token(token)
        except PermissionError as e:
            raise PermissionError(f"region {self.region!r}: {e}") from None
        if acl is None:
            raise PermissionError(
                f"region {self.region!r}: missing ACL token"
            )
        if acl.is_management():
            return
        rule = self._FEDERATED_CAPS.get(method)
        if rule is None:
            raise PermissionError(
                f"region {self.region!r}: {method} requires a management "
                f"token across regions"
            )
        kind, cap = rule
        if kind == "read":
            return  # any valid local token may read
        if kind == "ns_any":
            ns = args.get("namespace") or "default"
            if not any(
                acl.allow_namespace_op(ns, c) for c in cap
            ):
                raise PermissionError(
                    f"region {self.region!r}: missing any of {cap} on "
                    f"namespace {ns!r}"
                )
            return
        if kind == "alloc_ns":
            # resolve the TARGET object's namespace here — the sending
            # region's HTTP guard never saw this alloc
            try:
                alloc = self.find_alloc(args.get("alloc_id", ""))
            except LookupError:
                return  # the op itself will 404
            if not acl.allow_namespace_op(alloc.namespace, cap):
                raise PermissionError(
                    f"region {self.region!r}: missing {cap!r} on "
                    f"namespace {alloc.namespace!r}"
                )
            return
        ns = args.get("namespace") or getattr(
            args.get("job"), "namespace", None
        ) or getattr(args.get("volume"), "namespace", None) or "default"
        if not acl.allow_namespace_op(ns, cap):
            raise PermissionError(
                f"region {self.region!r}: missing {cap!r} on "
                f"namespace {ns!r}"
            )

    def region_server(self, region: str):
        """A live server's fabric addr in the named region, from gossip
        (reference nomad/server.go forwardRegion picks a random member)."""
        import random

        candidates = [
            tuple(m.addr)
            for m in self.serf.members()
            if m.tags.get("role") == "server"
            and m.status == "alive"
            and (m.tags.get("region") or "global") == region
        ]
        return random.choice(candidates) if candidates else None

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    def start(self) -> None:
        self.rpc.start()
        self.raft.start()
        self.serf.start()
        self.solver_pool.start()
        self.blackbox.start()

    def join(self, seeds: list[tuple[str, int]]) -> int:
        """Gossip-join an existing cluster (reference `nomad server join` /
        server_join config). Raft adoption follows via member events."""
        return self.serf.join(seeds)

    def _on_member_event(self, kind: str, member) -> None:
        if member.tags.get("role") != "server":
            return
        # Federation: one gossip ring can span regions (the reference's
        # WAN serf), but raft is PER-REGION — a server in another region
        # must never become a raft peer (nomad/serf.go keeps LAN serf
        # per region; regions meet only at RPC forwarding).
        if (member.tags.get("region") or "global") != self.region:
            return
        # Pool health rides the same gossip events: a confirmed-dead
        # solver member fails its in-flight dispatches immediately
        # (solver_pool.py) instead of waiting out the RPC timeout.
        self.solver_pool.on_member_event(kind, member)
        # Initial bootstrap: once bootstrap_expect servers see each other,
        # every one of them derives the SAME peer map from gossip and raft
        # elections begin (reference serf.go maybeBootstrap). Cheap — runs
        # inline on the probe thread.
        if not self._bootstrapped and kind == "member-join":
            servers = {
                m.id: tuple(m.addr)
                for m in self.serf.members()
                if m.tags.get("role") == "server"
                and m.status == "alive"
                and (m.tags.get("region") or "global") == self.region
            }
            servers[self.node_id] = self.rpc.addr
            if len(servers) >= self._bootstrap_expect:
                with self.raft._lock:
                    if not self.raft.peers:
                        self.raft.peers = {
                            p: a for p, a in servers.items() if p != self.node_id
                        }
                self._bootstrapped = True
                logger.info(
                    "%s: bootstrapped raft with %d servers",
                    self.node_id,
                    len(servers),
                )
            return
        self._reconcile_q.put((kind, member))

    def _reconcile_loop(self) -> None:
        """Leader-side raft config reconciliation off the gossip thread
        (reference leader.go reconcileMember)."""
        while True:
            item = self._reconcile_q.get()
            if item is None:
                return
            kind, member = item
            if not self.raft.is_leader():
                continue
            try:
                if kind in ("member-join", "member-alive"):
                    self.raft.add_peer(member.id, tuple(member.addr))
                elif kind in ("member-failed", "member-leave"):
                    if kind == "member-failed" and not self.autopilot_config().get(
                        "CleanupDeadServers", True
                    ):
                        continue  # operator opted out of auto-removal
                    self.raft.remove_peer(member.id)
            except (NotLeaderError, TimeoutError):
                pass
            except Exception:
                logger.exception("member reconciliation failed")

    def shutdown(self) -> None:
        was_leader = self.raft.is_leader()
        self._close_reverse_sessions()
        self.blackbox.stop()
        self.solver_pool.stop()
        self.serf.stop()
        self._reconcile_q.put(None)
        self.raft.stop()
        if was_leader:
            self.server.revoke_leadership()
        self.server.shutdown()
        metrics.unregister_provider(
            "nomad.rpc.source", self._source_provider
        )
        self.rpc.shutdown()
        self.pool.shutdown()
        if self.raft_store is not None:
            self.raft_store.close()


class ClusterRPC:
    """Client-side server connection over the fabric, with failover.

    Reference: client/servers manager — the client holds a ring of server
    addresses and rotates on RPC failure; any server forwards to the
    leader. Satisfies the same five-verb interface as the in-process
    ServerRPC shim (client/client.py).
    """

    def __init__(
        self,
        addrs: list[tuple[str, int]],
        pool: Optional[ConnPool] = None,
        rpc_secret="",  # str | rpc.keyring.Keyring (shared by the agent)
        tls_context=None,  # client-side ssl ctx (rpc.tls.fabric_contexts)
    ):
        self.addrs = [tuple(a) for a in addrs]
        if pool is not None and tls_context is not None:
            # silently dropping the context would dial a TLS fabric in
            # plaintext with no hint why registration fails
            raise ValueError("pass tls_context on the pool, not both")
        self.pool = pool or ConnPool(
            secret=rpc_secret, tls_context=tls_context
        )
        # The client's heartbeat and watch threads share this object;
        # rotation must be atomic or concurrent failures double-rotate
        # past live servers.
        self._lock = threading.Lock()

    def reverse_addrs(self) -> list:
        """Server fabric addrs the ReverseDialer parks sessions on."""
        with self._lock:
            return list(self.addrs)

    def _call(self, method: str, args, timeout_s: float = 30.0):
        last: Optional[Exception] = None
        with self._lock:
            candidates = list(self.addrs)
        for addr in candidates:
            try:
                return self.pool.call(addr, method, args, timeout_s=timeout_s)
            except (ConnectionError, OSError, TimeoutError, RPCError) as e:
                last = e
                # rotate the shared ring only if this addr is still at the
                # front (another thread may have rotated already)
                with self._lock:
                    if self.addrs and self.addrs[0] == addr:
                        self.addrs.append(self.addrs.pop(0))
        raise last  # type: ignore[misc]

    def register(self, node: Node) -> float:
        return self._call("Node.register", {"node": node})

    def heartbeat(self, node_id: str) -> float:
        return self._call("Node.heartbeat", {"node_id": node_id})

    def get_client_allocs(self, node_id: str, min_index: int, timeout_s: float):
        resp = self._call(
            "Node.get_client_allocs",
            {"node_id": node_id, "min_index": min_index, "timeout_s": timeout_s},
            timeout_s=timeout_s + 10.0,
        )
        return resp["allocs"], resp["index"]

    def update_allocs(self, allocs: list[Allocation]) -> None:
        self._call("Node.update_allocs", {"allocs": allocs})

    def alloc_client_addr(self, alloc_id: str):
        out = self._call("Alloc.client_addr", {"alloc_id": alloc_id})
        return tuple(out) if out else (None, None)

    def volumes_for_alloc(self, alloc_id: str) -> list:
        return self._call("Volume.for_alloc", {"alloc_id": alloc_id})

    def services_register(self, regs: list) -> None:
        self._call("Service.register", {"regs": regs})

    def services_deregister_alloc(self, alloc_id: str) -> None:
        self._call("Service.deregister_alloc", {"alloc_id": alloc_id})

    def service_lookup(self, namespace: str, name: str) -> list:
        return self._call(
            "Service.get", {"namespace": namespace, "name": name}
        )

    def secret_read(self, namespace: str, path: str, token: str = ""):
        return self._call(
            "Secrets.read",
            {"namespace": namespace, "path": path, "token": token},
        )

    def derive_token(self, alloc_id: str, task_name: str) -> dict:
        return self._call(
            "Secrets.derive_token",
            {"alloc_id": alloc_id, "task_name": task_name},
        )

    def renew_token(self, accessor_id: str) -> float:
        return self._call(
            "Secrets.renew_token", {"accessor_id": accessor_id}
        )

    def revoke_token(self, accessor_id: str) -> None:
        self._call("Secrets.revoke_token", {"accessor_id": accessor_id})
