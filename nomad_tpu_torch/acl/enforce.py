"""HTTP-route → ACL capability enforcement.

Port of ``nomad_tpu/acl/enforce.py``.

Reference: each endpoint in nomad/ resolves the token and checks the
specific capability (e.g. nomad/job_endpoint.go Register checks
NamespaceValidator(acl.NamespaceCapabilitySubmitJob)). Here the mapping
lives in one table keyed on route shape, applied by the HTTP layer
before dispatch.
"""

from __future__ import annotations

import re
from typing import Optional

from .acl import ACL
from .policy import (
    CAP_ALLOC_LIFECYCLE,
    CAP_DISPATCH_JOB,
    CAP_LIST_JOBS,
    CAP_READ_FS,
    CAP_READ_JOB,
    CAP_READ_LOGS,
    CAP_READ_SECRET,
    CAP_SUBMIT_JOB,
    CAP_WRITE_SECRET,
)


class AuthError(Exception):
    def __init__(self, status: int, message: str) -> None:
        self.status = status
        self.message = message
        super().__init__(message)


_NS_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/v1/jobs$"), CAP_LIST_JOBS),
    ("PUT", re.compile(r"^/v1/jobs$"), CAP_SUBMIT_JOB),
    ("POST", re.compile(r"^/v1/jobs$"), CAP_SUBMIT_JOB),
    ("GET", re.compile(r"^/v1/job/[^/]+(/.*)?$"), CAP_READ_JOB),
    ("DELETE", re.compile(r"^/v1/job/[^/]+$"), CAP_SUBMIT_JOB),
    ("PUT", re.compile(r"^/v1/job/[^/]+/dispatch$"), CAP_DISPATCH_JOB),
    ("POST", re.compile(r"^/v1/job/[^/]+/dispatch$"), CAP_DISPATCH_JOB),
    ("PUT", re.compile(r"^/v1/job/[^/]+/.*$"), CAP_SUBMIT_JOB),
    ("GET", re.compile(r"^/v1/allocations$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/allocation/.*$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/evaluations$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/evaluation/.*$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/deployments$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/deployment/.*$"), CAP_READ_JOB),
    ("PUT", re.compile(r"^/v1/deployment/.*$"), CAP_SUBMIT_JOB),
    ("GET", re.compile(r"^/v1/event/stream$"), CAP_READ_JOB),
    # streaming alloc surface (handlers re-check against the alloc's
    # own namespace via _ns_guard; exec rides the RPC fabric and is
    # checked in ClusterServer._handle_exec_stream with CAP_ALLOC_EXEC)
    ("GET", re.compile(r"^/v1/client/fs/logs/.*$"), CAP_READ_LOGS),
    # alloc lifecycle (handlers re-check against the alloc's own
    # namespace via _ns_guard)
    ("PUT", re.compile(r"^/v1/client/allocation/[^/]+/(restart|signal)$"),
     CAP_ALLOC_LIFECYCLE),
    ("POST", re.compile(r"^/v1/client/allocation/[^/]+/(restart|signal)$"),
     CAP_ALLOC_LIFECYCLE),
    ("PUT", re.compile(r"^/v1/allocation/[^/]+/stop$"), CAP_ALLOC_LIFECYCLE),
    ("POST", re.compile(r"^/v1/allocation/[^/]+/stop$"),
     CAP_ALLOC_LIFECYCLE),
    ("GET", re.compile(r"^/v1/client/fs/(ls|cat|stat)/.*$"), CAP_READ_FS),
    # volumes ride the job caps (the reference gates host volumes with
    # namespace host_volume policies; submit-job is this tree's write cap)
    ("GET", re.compile(r"^/v1/volumes$"), CAP_READ_JOB),
    ("PUT", re.compile(r"^/v1/volumes$"), CAP_SUBMIT_JOB),
    ("POST", re.compile(r"^/v1/volumes$"), CAP_SUBMIT_JOB),
    ("PUT", re.compile(r"^/v1/volumes/create$"), CAP_SUBMIT_JOB),
    ("POST", re.compile(r"^/v1/volumes/create$"), CAP_SUBMIT_JOB),
    ("PUT", re.compile(r"^/v1/volumes/snapshot$"), CAP_SUBMIT_JOB),
    ("POST", re.compile(r"^/v1/volumes/snapshot$"), CAP_SUBMIT_JOB),
    ("DELETE", re.compile(r"^/v1/volumes/snapshot$"), CAP_SUBMIT_JOB),
    ("GET", re.compile(r"^/v1/volumes/snapshot$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/volume/.*$"), CAP_READ_JOB),
    ("DELETE", re.compile(r"^/v1/volume/.*$"), CAP_SUBMIT_JOB),
    # CSI plugin health rides the volume read gate (reference
    # csi_endpoint.go: plugin list/read allowed with namespace read)
    ("GET", re.compile(r"^/v1/plugins$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/plugin/csi/.*$"), CAP_READ_JOB),
    # embedded secrets store: explicit capabilities, never implied by
    # namespace read (values are sensitive)
    ("GET", re.compile(r"^/v1/secrets$"), CAP_READ_SECRET),
    ("GET", re.compile(r"^/v1/secret/.*$"), CAP_READ_SECRET),
    ("PUT", re.compile(r"^/v1/secret/.*$"), CAP_WRITE_SECRET),
    ("POST", re.compile(r"^/v1/secret/.*$"), CAP_WRITE_SECRET),
    ("DELETE", re.compile(r"^/v1/secret/.*$"), CAP_WRITE_SECRET),
    # server-side job validation: read-level (nothing is committed;
    # reference agent ValidateJobRequest allows any submitter)
    ("PUT", re.compile(r"^/v1/validate/job$"), CAP_READ_JOB),
    ("POST", re.compile(r"^/v1/validate/job$"), CAP_READ_JOB),
    # HCL parse is pure computation (nothing committed) — read-level,
    # so the UI Run view works with a submit-job token
    ("PUT", re.compile(r"^/v1/jobs/parse$"), CAP_READ_JOB),
    ("POST", re.compile(r"^/v1/jobs/parse$"), CAP_READ_JOB),
    # scaling policies read with namespace read (reference
    # scaling_endpoint.go ListPolicies: read-job or list-scaling-policies)
    ("GET", re.compile(r"^/v1/scaling/policies$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/scaling/policy/.*$"), CAP_READ_JOB),
    # native service discovery (reference
    # service_registration_endpoint.go: read-job to list, submit-job to
    # delete a registration)
    ("GET", re.compile(r"^/v1/services$"), CAP_READ_JOB),
    ("GET", re.compile(r"^/v1/service/[^/]+$"), CAP_READ_JOB),
    ("DELETE", re.compile(r"^/v1/service/[^/]+/[^/]+$"), CAP_SUBMIT_JOB),
    # search reads cluster objects (reference search_endpoint ACL: the
    # per-context capability; read-job is the broadest gate here)
    ("PUT", re.compile(r"^/v1/search(/fuzzy)?$"), CAP_READ_JOB),
    ("POST", re.compile(r"^/v1/search(/fuzzy)?$"), CAP_READ_JOB),
]

_NODE_READ = [("GET", re.compile(r"^/v1/nodes$")), ("GET", re.compile(r"^/v1/node/.*$"))]
_NODE_WRITE = [("PUT", re.compile(r"^/v1/node/.*$")), ("POST", re.compile(r"^/v1/node/.*$"))]
# pprof dumps internal state and can occupy handler threads for seconds:
# agent:write, like the reference (command/agent/agent_endpoint.go
# AgentPprofRequest). Checked BEFORE the broader agent-read rule.
_AGENT_WRITE = [
    ("GET", re.compile(r"^/v1/agent/pprof/.*$")),
    # force-leave ejects a member from gossip (reference agent:write)
    ("PUT", re.compile(r"^/v1/agent/force-leave$")),
    ("POST", re.compile(r"^/v1/agent/force-leave$")),
    # gossip-join mutates membership (reference agent:write)
    ("PUT", re.compile(r"^/v1/agent/join$")),
    ("POST", re.compile(r"^/v1/agent/join$")),
    # keyring rotation swaps the fabric's live auth secret (reference
    # keyring management is agent:write); status stays agent:read via
    # the broader GET rule below
    ("PUT", re.compile(r"^/v1/agent/keyring/rotate$")),
    ("POST", re.compile(r"^/v1/agent/keyring/rotate$")),
]
_AGENT_READ = [
    ("GET", re.compile(r"^/v1/agent/.*$")),
    ("GET", re.compile(r"^/v1/metrics$")),
    # traces expose request-level internals (job/eval ids, stage
    # timings): same agent:read gate as /v1/metrics
    ("GET", re.compile(r"^/v1/traces(/.*)?$")),
    # solver observability snapshot (compile ledger / occupancy /
    # transfers / device memory): agent-local read surface like
    # /v1/metrics — read-only, so agent:read, not the pprof-style
    # agent:write
    ("GET", re.compile(r"^/v1/solver/status$")),
    # host profiler summary + collapsed stacks (hostobs.py): always-on
    # read surface like /v1/metrics and /v1/solver/status — the raw
    # on-demand pprof capture stays agent:write + enable_debug, but the
    # continuous profiler's bounded aggregate is agent:read
    ("GET", re.compile(r"^/v1/profile(/.*)?$")),
    # cluster health federation (cluster.py cluster_health): the
    # observability surface family's gate — agent:read like /v1/metrics
    # and /v1/profile, NOT operator:read (checked before the broader
    # operator rule below; the payload is telemetry, not raft control)
    ("GET", re.compile(r"^/v1/operator/cluster/health$")),
    # blackbox flight recorder (blackbox.py): status, incident index,
    # and causal timelines — the same always-on observability family as
    # /v1/metrics and /v1/profile (incident bundles carry the same
    # internals traces do, so the same agent:read gate)
    ("GET", re.compile(r"^/v1/blackbox(/.*)?$")),
    ("GET", re.compile(r"^/v1/incidents(/.*)?$")),
    ("GET", re.compile(r"^/v1/timeline(/.*)?$")),
]
# reference: raft list-peers / snapshot save need operator:read; snapshot
# restore needs operator:write (nomad/operator_endpoint.go)
_OPERATOR_READ = [("GET", re.compile(r"^/v1/operator/.*$"))]
# Any VALID token may read these (the reference filters the namespace
# list to ones the token can use; every token can at least resolve names).
_ANY_TOKEN_READ = [
    ("GET", re.compile(r"^/v1/namespaces$")),
    ("GET", re.compile(r"^/v1/namespace/.*$")),
]
_OPERATOR_WRITE = [
    ("PUT", re.compile(r"^/v1/operator/.*$")),
    ("DELETE", re.compile(r"^/v1/operator/.*$")),
    # system gc is an operator action (reference System.GarbageCollect
    # requires management)
    ("PUT", re.compile(r"^/v1/system/.*$")),
    ("POST", re.compile(r"^/v1/system/.*$")),
    ("POST", re.compile(r"^/v1/operator/.*$")),
    # namespace CRUD is an operator action (reference
    # namespace_endpoint.go requires management)
    ("PUT", re.compile(r"^/v1/namespaces$")),
    ("POST", re.compile(r"^/v1/namespaces$")),
    ("DELETE", re.compile(r"^/v1/namespace/.*$")),
]


def make_http_resolver(server, enabled: bool = True):
    """Returns resolver(method, path, token_secret, query) raising
    AuthError on deny. `server` is the core Server (owns state +
    resolve_token)."""

    def resolver(
        method: str, path: str, secret: str, query: dict, body: bytes = b""
    ) -> None:
        if not enabled:
            return
        # Status endpoints stay open (cluster plumbing, like the
        # reference's unauthenticated Status.Ping/Leader).
        if path.startswith("/v1/status/") or path == "/v1/regions":
            return
        # Bootstrap is the chicken-and-egg exception.
        if path == "/v1/acl/bootstrap":
            return
        try:
            acl: Optional[ACL] = server.resolve_token(secret)
        except PermissionError:
            raise AuthError(401, "ACL token not found")
        if path == "/v1/acl/token/self":
            if acl is None:
                raise AuthError(401, "missing ACL token")
            return
        if path.startswith("/v1/acl/"):
            if acl is None or not acl.is_management():
                raise AuthError(403, "management token required")
            return
        if acl is None:
            # anonymous: deny by default (no anonymous policy support yet)
            raise AuthError(401, "missing ACL token")
        if acl.is_management():
            return
        ns = query.get("namespace", ["default"])[0]
        # Job registration: the namespace that matters is the one in the
        # JOB BODY (that's what the handler registers into) — checking
        # only the query namespace would let a default-scoped token write
        # into any namespace.
        if path == "/v1/jobs" and method in ("PUT", "POST") and body:
            import json as _json

            try:
                job = _json.loads(body).get("Job") or {}
                ns = job.get("namespace") or ns
            except Exception:
                pass
        # Search: the body names the namespace being searched.
        if path.startswith("/v1/search") and method in ("PUT", "POST") and body:
            import json as _json

            try:
                ns = _json.loads(body).get("Namespace") or ns
            except Exception:
                pass
        # Volume registration/creation: same body-namespace rule as
        # job register.
        if (
            path in ("/v1/volumes", "/v1/volumes/create")
            and method in ("PUT", "POST")
            and body
        ):
            import json as _json

            try:
                vol = _json.loads(body).get("Volume") or {}
                ns = vol.get("namespace") or ns
            except Exception:
                pass
        if path == "/v1/event/stream":
            # "*" streams every namespace: management only.
            if ns == "*":
                raise AuthError(403, "all-namespace stream requires management")
        # job scale authorizes with EITHER scale-job or submit-job
        # (reference Job.Scale) — the table below is single-capability
        if method in ("PUT", "POST") and re.fullmatch(
            r"/v1/job/[^/]+/scale", path
        ):
            if not (
                acl.allow_namespace_op(ns, "scale-job")
                or acl.allow_namespace_op(ns, "submit-job")
            ):
                raise AuthError(
                    403, "missing namespace capability 'scale-job'"
                )
            return
        for m, pat, cap in _NS_ROUTES:
            if m == method and pat.match(path):
                if not acl.allow_namespace_op(ns, cap):
                    raise AuthError(
                        403, f"missing namespace capability {cap!r}"
                    )
                return
        for m, pat in _NODE_WRITE:
            if m == method and pat.match(path):
                if not acl.allow_node_write():
                    raise AuthError(403, "node write denied")
                return
        for m, pat in _NODE_READ:
            if m == method and pat.match(path):
                if not acl.allow_node_read():
                    raise AuthError(403, "node read denied")
                return
        for m, pat in _AGENT_WRITE:
            if m == method and pat.match(path):
                if not acl.allow_agent_write():
                    raise AuthError(403, "agent write denied")
                return
        for m, pat in _AGENT_READ:
            if m == method and pat.match(path):
                if not acl.allow_agent_read():
                    raise AuthError(403, "agent read denied")
                return
        for m, pat in _ANY_TOKEN_READ:
            if m == method and pat.match(path):
                return  # token already resolved as valid above
        for m, pat in _OPERATOR_WRITE:
            if m == method and pat.match(path):
                if not acl.allow_operator_write():
                    raise AuthError(403, "operator write denied")
                return
        for m, pat in _OPERATOR_READ:
            if m == method and pat.match(path):
                if not acl.allow_operator_read():
                    raise AuthError(403, "operator read denied")
                return
        # Unmapped route under enforcement: require management (safe
        # default — new routes must be classified to be non-management).
        raise AuthError(403, "permission denied")

    return resolver
