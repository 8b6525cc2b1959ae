"""Typed HTTP client.

Port of ``nomad_tpu/api/client.py``.

Reference: api/api.go (Client, QueryOptions/WriteOptions, blocking
queries), api/jobs.go, api/nodes.go, api/allocations.go,
api/evaluations.go, api/deployments.go, api/event_stream.go.

Decodes codec wire payloads back into the shared typed structs, so
`client.jobs.get("x")` returns a real Job dataclass, like the Go SDK's
typed structs.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator, Optional

from .. import codec


class APIError(Exception):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None) -> None:
        self.status = status
        # 429/503 backoff hint from the Retry-After header or the error
        # body's retry_after_s field (sub-second precision wins).
        # retry.py's call_with_retry honors the same attribute name as
        # a backoff floor.
        self.retry_after = retry_after
        self.retry_after_s = retry_after
        super().__init__(f"HTTP {status}: {message}")


class NomadClient:
    def __init__(
        self,
        address: str = "http://127.0.0.1:4646",
        token: str = "",
        namespace: str = "default",
        region: str = "",
        timeout_s: float = 35.0,
        ca_cert: str = "",  # PEM bundle verifying an https:// server
        tls_skip_verify: bool = False,
        retry_429: int = 0,  # max automatic retries of throttled requests
        retry_429_max_wait_s: float = 30.0,
    ) -> None:
        self.address = address.rstrip("/")
        self.token = token
        self.namespace = namespace
        self.region = region  # "" = the contacted server's own region
        self.timeout_s = timeout_s
        # With retry_429 > 0, a 429 whose Retry-After (header or JSON
        # retry_after_s) fits under retry_429_max_wait_s is slept out
        # and retried, up to retry_429 times — the client half of the
        # server's admission control (it TOLD us when to come back).
        self.retry_429 = retry_429
        self.retry_429_max_wait_s = retry_429_max_wait_s
        self._ssl_ctx = None
        if address.startswith("https://"):
            import ssl

            if tls_skip_verify:
                self._ssl_ctx = ssl._create_unverified_context()
            elif ca_cert:
                self._ssl_ctx = ssl.create_default_context(cafile=ca_cert)
            else:
                self._ssl_ctx = ssl.create_default_context()
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.agent = AgentAPI(self)
        self.status = Status(self)
        self.acl = ACLAPI(self)
        self.operator = Operator(self)
        self.volumes = Volumes(self)
        self.plugins = Plugins(self)
        self.services = Services(self)
        self.secrets = Secrets(self)
        self.namespaces = Namespaces(self)
        self.search = Search(self)
        self.system = SystemAPI(self)
        self.scaling = Scaling(self)
        self.traces = Traces(self)

    # -- plumbing ------------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        params: Optional[dict] = None,
        body=None,
        raw: bool = False,
        with_index: bool = False,
        timeout_s: Optional[float] = None,
    ):
        params = {k: v for k, v in (params or {}).items() if v not in (None, "")}
        if self.region and "region" not in params:
            params["region"] = self.region
        url = self.address + path
        if params:
            url += "?" + urllib.parse.urlencode(params, doseq=True)
        data = None
        if body is not None:
            data = json.dumps(body, default=codec.json_default).encode()
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        attempts_left = self.retry_429
        while True:
            try:
                resp = urllib.request.urlopen(
                    req,
                    timeout=timeout_s or self.timeout_s,
                    context=self._ssl_ctx,
                )
                break
            except urllib.error.HTTPError as e:
                retry_after = None
                hdr = e.headers.get("Retry-After") if e.headers else None
                if hdr:
                    try:
                        retry_after = float(hdr)
                    except ValueError:
                        pass
                try:
                    body = json.loads(e.read())
                    msg = body.get("error", str(e))
                    # sub-second precision beats the integral header
                    if body.get("retry_after_s") is not None:
                        retry_after = float(body["retry_after_s"])
                except Exception:
                    msg = str(e)
                if (
                    e.code == 429
                    and attempts_left > 0
                    and retry_after is not None
                    and retry_after <= self.retry_429_max_wait_s
                ):
                    attempts_left -= 1
                    import time as _time

                    _time.sleep(max(0.0, retry_after))
                    continue
                raise APIError(e.code, msg, retry_after=retry_after) from None
        if raw:
            return resp
        payload = json.loads(resp.read() or b"null")
        index = resp.headers.get("X-Nomad-Index")
        decoded = codec.from_wire(payload)
        if with_index:
            return decoded, int(index) if index is not None else 0
        return decoded

    def get(self, path, **kw):
        return self._request("GET", path, **kw)

    def get_with_index(self, path, **kw):
        """Blocking-query form: returns (decoded, X-Nomad-Index)."""
        return self._request("GET", path, with_index=True, **kw)

    def put(self, path, body=None, **kw):
        return self._request("PUT", path, body=body, **kw)

    def delete(self, path, **kw):
        return self._request("DELETE", path, **kw)


class _Resource:
    def __init__(self, c: NomadClient) -> None:
        self.c = c


class Jobs(_Resource):
    def list(self, prefix: str = "", namespace: Optional[str] = None):
        return self.c.get(
            "/v1/jobs",
            params={
                "prefix": prefix,
                "namespace": namespace or self.c.namespace,
            },
        )

    def register(self, job) -> str:
        """Returns the eval id (reference api/jobs.go Register)."""
        return self.c.put("/v1/jobs", body={"Job": codec.to_wire(job)})

    def plan(self, job, diff: bool = True):
        """Server-side dry-run: scheduler annotations + structural diff +
        placement failures, nothing committed (reference api/jobs.go Plan)."""
        return self.c.put(
            f"/v1/job/{job.id}/plan",
            body={"Job": codec.to_wire(job), "Diff": diff},
        )

    def get(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}",
            params={"namespace": namespace or self.c.namespace},
        )

    def deregister(
        self, job_id: str, purge: bool = False, namespace: Optional[str] = None
    ) -> str:
        return self.c.delete(
            f"/v1/job/{job_id}",
            params={
                "purge": "true" if purge else "false",
                "namespace": namespace or self.c.namespace,
            },
        )

    def allocations(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/allocations",
            params={"namespace": namespace or self.c.namespace},
        )

    def evaluations(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/evaluations",
            params={"namespace": namespace or self.c.namespace},
        )

    def summary(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/summary",
            params={"namespace": namespace or self.c.namespace},
        )

    def scale(self, job_id: str, group: str, count: int,
              message: str = "", namespace: Optional[str] = None):
        return self.c.put(
            f"/v1/job/{job_id}/scale",
            params={"namespace": namespace or self.c.namespace},
            body={
                "Target": {"Group": group},
                "Count": count,
                "Message": message,
            },
        )

    def validate(self, job):
        """Server-side validation; returns {Error, ValidationErrors,
        Warnings} (reference api/jobs.go Validate)."""
        return self.c.put(
            "/v1/validate/job", body={"Job": codec.to_wire(job)}
        )

    def evaluate(self, job_id: str, namespace: Optional[str] = None):
        """Force a new evaluation (reference api/jobs.go ForceEvaluate)."""
        return self.c.put(
            f"/v1/job/{job_id}/evaluate",
            params={"namespace": namespace or self.c.namespace},
        )

    def deployments(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/deployments",
            params={"namespace": namespace or self.c.namespace},
        )

    def scale_status(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/scale",
            params={"namespace": namespace or self.c.namespace},
        )

    def versions(self, job_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/job/{job_id}/versions",
            params={"namespace": namespace or self.c.namespace},
        )

    def revert(self, job_id: str, version: int, namespace: Optional[str] = None):
        return self.c.put(
            f"/v1/job/{job_id}/revert",
            body={
                "JobVersion": version,
                "Namespace": namespace or self.c.namespace,
            },
        )

    def dispatch(
        self,
        job_id: str,
        meta: Optional[dict] = None,
        payload: Optional[str] = None,
        namespace: Optional[str] = None,
    ):
        return self.c.put(
            f"/v1/job/{job_id}/dispatch",
            params={"namespace": namespace or self.c.namespace},
            body={"Meta": meta or {}, "Payload": payload},
        )

    def periodic_force(self, job_id: str, namespace: Optional[str] = None):
        return self.c.put(
            f"/v1/job/{job_id}/periodic/force",
            params={"namespace": namespace or self.c.namespace},
        )


class Nodes(_Resource):
    def list(self, prefix: str = ""):
        return self.c.get("/v1/nodes", params={"prefix": prefix})

    def get(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}")

    def allocations(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}/allocations")

    def drain(self, node_id: str, spec=None, mark_eligible: bool = False):
        return self.c.put(
            f"/v1/node/{node_id}/drain",
            body={
                "DrainSpec": codec.to_wire(spec) if spec is not None else None,
                "MarkEligible": mark_eligible,
            },
        )

    def eligibility(self, node_id: str, eligible: bool):
        return self.c.put(
            f"/v1/node/{node_id}/eligibility",
            body={"Eligibility": "eligible" if eligible else "ineligible"},
        )

    def purge(self, node_id: str):
        return self.c.put(f"/v1/node/{node_id}/purge")


class Allocations(_Resource):
    def restart(self, alloc_id: str, task: str = ""):
        return self.c.put(
            f"/v1/client/allocation/{alloc_id}/restart",
            body={"TaskName": task},
        )

    def signal(self, alloc_id: str, signal: str, task: str = ""):
        return self.c.put(
            f"/v1/client/allocation/{alloc_id}/signal",
            body={"Signal": signal, "TaskName": task},
        )

    def stop(self, alloc_id: str):
        return self.c.put(f"/v1/allocation/{alloc_id}/stop")

    def stats(self, alloc_id: str):
        """Live resource usage incl. device stats (reference:
        GET /v1/client/allocation/:id/stats)."""
        return self.c.get(f"/v1/client/allocation/{alloc_id}/stats")

    def list(self):
        return self.c.get("/v1/allocations")

    def get(self, alloc_id: str):
        return self.c.get(f"/v1/allocation/{alloc_id}")

    # -- streaming alloc surface (reference api/fs.go, allocations_exec) --

    def logs(
        self,
        alloc_id: str,
        task: str = "",
        log_type: str = "stdout",
        follow: bool = False,
        origin: str = "start",
        offset: int = 0,
    ):
        """Yields raw log chunks; with follow=True, blocks for more."""
        resp = self.c.get(
            f"/v1/client/fs/logs/{alloc_id}",
            params={
                "task": task,
                "type": log_type,
                "follow": "true" if follow else "false",
                "origin": origin,
                "offset": offset or None,
            },
            raw=True,
            timeout_s=None if follow else 30,
        )
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                return
            yield chunk

    def fs_ls(self, alloc_id: str, path: str = ""):
        return self.c.get(
            f"/v1/client/fs/ls/{alloc_id}", params={"path": path}
        )

    def fs_stat(self, alloc_id: str, path: str = ""):
        return self.c.get(
            f"/v1/client/fs/stat/{alloc_id}", params={"path": path}
        )

    def fs_cat(self, alloc_id: str, path: str) -> bytes:
        resp = self.c.get(
            f"/v1/client/fs/cat/{alloc_id}", params={"path": path}, raw=True
        )
        return resp.read()

    def exec_session(
        self,
        alloc_id: str,
        cmd: list,
        task: str = "",
        tty: bool = False,
        rpc_secret: str = "",
        tls=None,  # (cert_file, key_file, ca_file) when tls { rpc }
    ):
        """Open an interactive exec session over the RPC fabric.

        Returns an ExecSession: .recv() yields output frames, .send_stdin()
        writes input, .close() ends it. The fabric address comes from
        /v1/agent/self; a cluster rpc_secret must be supplied when the
        fabric requires one, and `tls` (cert/key/ca paths) when the
        fabric runs TLS (rpc/tls.py).
        """
        from ..rpc import ConnPool

        tls_ctx = None
        if tls:
            from ..rpc.tls import client_context

            cert, key, ca = tls
            tls_ctx = client_context(ca, cert, key)
        info = self.c.get("/v1/agent/self")
        host, port = info["rpc_addr"]
        pool = ConnPool(secret=rpc_secret, tls_context=tls_ctx)
        session = pool.stream(
            (host, int(port)),
            "ClientExec.exec",
            {
                "alloc_id": alloc_id,
                "task": task,
                "cmd": cmd,
                "tty": tty,
                "token": self.c.token,
            },
        )
        first = session.recv(timeout_s=30)
        if first.get("error"):
            session.close()
            pool.shutdown()
            raise APIError(500, first["error"])
        return ExecSession(session, pool)


class ExecSession:
    """Client half of an interactive exec (reference api/allocations_exec)."""

    def __init__(self, session, pool) -> None:
        self._session = session
        self._pool = pool

    def recv(self, timeout_s=None):
        """Next output frame: {'data': bytes} | {'eof': True} |
        {'error': str}; None on timeout."""
        try:
            return self._session.recv(timeout_s=timeout_s)
        except TimeoutError:
            return None

    def send_stdin(self, data: bytes) -> None:
        self._session.send({"stdin": data})

    def close(self) -> None:
        try:
            self._session.send({"eof": True})
        except (ConnectionError, OSError):
            pass
        self._session.close()
        self._pool.shutdown()


class Scaling(_Resource):
    """Reference: api/scaling.go."""

    def list_policies(self, namespace: Optional[str] = None):
        return self.c.get(
            "/v1/scaling/policies",
            params={"namespace": namespace or self.c.namespace},
        )

    def get_policy(self, policy_id: str):
        return self.c.get(f"/v1/scaling/policy/{policy_id}")


class Traces(_Resource):
    """The agent's eval-lifecycle tracing ring (/v1/traces, trace.py)."""

    def list(self, name: str = "", eval_id: str = "", job_id: str = "",
             limit: int = 50):
        return self.c.get(
            "/v1/traces",
            params={
                "name": name,
                "eval_id": eval_id,
                "job_id": job_id,
                "limit": limit,
            },
        )

    def get(self, trace_id: str):
        return self.c.get(f"/v1/traces/{trace_id}")


class SystemAPI(_Resource):
    def gc(self):
        return self.c.put("/v1/system/gc")

    def reconcile_summaries(self):
        return self.c.put("/v1/system/reconcile/summaries")


class Evaluations(_Resource):
    def list(self):
        return self.c.get("/v1/evaluations")

    def delete(self, eval_id: str):
        return self.c.delete(f"/v1/evaluation/{eval_id}")

    def get(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}")

    def allocations(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations")


class Deployments(_Resource):
    def list(self):
        return self.c.get("/v1/deployments")

    def get(self, deployment_id: str):
        return self.c.get(f"/v1/deployment/{deployment_id}")

    def allocations(self, deployment_id: str):
        return self.c.get(f"/v1/deployment/allocations/{deployment_id}")

    def promote(self, deployment_id: str, groups=None):
        return self.c.put(
            f"/v1/deployment/promote/{deployment_id}",
            body={"Groups": groups},
        )

    def pause(self, deployment_id: str, pause: bool = True):
        return self.c.put(
            f"/v1/deployment/pause/{deployment_id}", body={"Pause": pause}
        )

    def fail(self, deployment_id: str):
        return self.c.put(f"/v1/deployment/fail/{deployment_id}")


class Search(_Resource):
    def prefix(self, prefix: str, context: str = "all",
               namespace: Optional[str] = None):
        return self.c.put(
            "/v1/search",
            body={
                "Prefix": prefix,
                "Context": context,
                "Namespace": namespace or self.c.namespace,
            },
        )

    def fuzzy(self, text: str, context: str = "all",
              namespace: Optional[str] = None):
        return self.c.put(
            "/v1/search/fuzzy",
            body={
                "Text": text,
                "Context": context,
                "Namespace": namespace or self.c.namespace,
            },
        )


class Namespaces(_Resource):
    def list(self):
        return self.c.get("/v1/namespaces")

    def apply(self, namespace):
        return self.c.put(
            "/v1/namespaces", body={"Namespace": codec.to_wire(namespace)}
        )

    def get(self, name: str):
        return self.c.get(f"/v1/namespace/{name}")

    def delete(self, name: str):
        return self.c.delete(f"/v1/namespace/{name}")


class Volumes(_Resource):
    def list(self, namespace: Optional[str] = None):
        return self.c.get(
            "/v1/volumes",
            params={"namespace": namespace or self.c.namespace},
        )

    def register(self, volume):
        return self.c.put("/v1/volumes", body={"Volume": codec.to_wire(volume)})

    def get(self, vol_id: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/volume/{vol_id}",
            params={"namespace": namespace or self.c.namespace},
        )

    def deregister(self, vol_id: str, namespace: Optional[str] = None):
        return self.c.delete(
            f"/v1/volume/{vol_id}",
            params={"namespace": namespace or self.c.namespace},
        )

    def detach(self, volume_id: str, node_id: str,
               namespace: Optional[str] = None):
        """Release a node's claims + controller-unpublish (reference
        api/csi.go Detach)."""
        return self.c.delete(
            f"/v1/volume/{volume_id}/detach",
            params={
                "node": node_id,
                "namespace": namespace or self.c.namespace,
            },
        )

    def snapshot_create(self, volume_id: str, name: str = "",
                        namespace: Optional[str] = None):
        """Point-in-time snapshot via the CSI controller (reference
        api/csi.go CreateSnapshot)."""
        return self.c.put(
            "/v1/volumes/snapshot",
            body={
                "VolumeID": volume_id,
                "Name": name,
                "Namespace": namespace or self.c.namespace,
            },
        )

    def snapshot_delete(self, plugin_id: str, snapshot_id: str):
        return self.c.delete(
            "/v1/volumes/snapshot",
            params={"plugin_id": plugin_id, "snapshot_id": snapshot_id},
        )

    def snapshot_list(self, plugin_id: str):
        return self.c.get(
            "/v1/volumes/snapshot", params={"plugin_id": plugin_id}
        )

    def create(self, volume):
        """Provision through the CSI controller then register
        (reference api/csi.go Create)."""
        return self.c.put(
            "/v1/volumes/create", body={"Volume": codec.to_wire(volume)}
        )

    def delete(self, vol_id: str, namespace: Optional[str] = None):
        """Deregister + deprovision (reference api/csi.go Delete)."""
        return self.c.delete(
            f"/v1/volume/{vol_id}/delete",
            params={"namespace": namespace or self.c.namespace},
        )


class Secrets(_Resource):
    """Embedded secrets store (the Vault-analog surface)."""

    def list(self, namespace: Optional[str] = None):
        return self.c.get(
            "/v1/secrets",
            params={"namespace": namespace or self.c.namespace},
        )

    def get(self, path: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/secret/{path}",
            params={"namespace": namespace or self.c.namespace},
        )

    def put(self, path: str, items: dict, namespace: Optional[str] = None):
        return self.c.put(
            f"/v1/secret/{path}",
            params={"namespace": namespace or self.c.namespace},
            body={"Items": items},
        )

    def delete(self, path: str, namespace: Optional[str] = None):
        return self.c.delete(
            f"/v1/secret/{path}",
            params={"namespace": namespace or self.c.namespace},
        )


class Services(_Resource):
    """Native service discovery (reference: api/services.go)."""

    def list(self, namespace: Optional[str] = None):
        return self.c.get(
            "/v1/services",
            params={"namespace": namespace or self.c.namespace},
        )

    def get(self, name: str, namespace: Optional[str] = None):
        return self.c.get(
            f"/v1/service/{name}",
            params={"namespace": namespace or self.c.namespace},
        )

    def delete(self, name: str, reg_id: str):
        return self.c.delete(f"/v1/service/{name}/{reg_id}")


class Plugins(_Resource):
    """CSI plugin health aggregation (reference: api/csi.go CSIPlugins)."""

    def list(self):
        return self.c.get("/v1/plugins")

    def get(self, plugin_id: str):
        return self.c.get(f"/v1/plugin/csi/{plugin_id}")


class Operator(_Resource):
    def autopilot_configuration(self):
        return self.c.get("/v1/operator/autopilot/configuration")

    def autopilot_set_configuration(self, config: dict):
        return self.c.put(
            "/v1/operator/autopilot/configuration", body=config
        )

    def raft_remove_peer(self, peer_id: str):
        return self.c.delete(
            "/v1/operator/raft/peer", params={"id": peer_id}
        )

    def scheduler_configuration(self):
        return self.c.get("/v1/operator/scheduler/configuration")

    def scheduler_set_configuration(self, config: dict):
        return self.c.put(
            "/v1/operator/scheduler/configuration", body=config
        )

    def snapshot_save(self) -> bytes:
        import base64

        resp = self.c.get("/v1/operator/snapshot")
        return base64.b64decode(resp["Snapshot"])

    def snapshot_restore(self, data: bytes):
        import base64

        return self.c.put(
            "/v1/operator/snapshot",
            body={"Snapshot": base64.b64encode(data).decode()},
        )

    def raft_configuration(self):
        return self.c.get("/v1/operator/raft/configuration")

    def cluster_health(self, timeout_s=None, top=None):
        """Leader-side telemetry federation (GET
        /v1/operator/cluster/health): every member's raft indices,
        broker/plan-queue depths, host CPU/RSS, and per-source cost
        top-K; partitioned members flagged `degraded` under a bounded
        per-peer deadline."""
        params = {}
        if timeout_s is not None:
            params["timeout"] = str(timeout_s)
        if top is not None:
            params["top"] = str(top)
        return self.c.get(
            "/v1/operator/cluster/health", params=params or None
        )


class AgentAPI(_Resource):
    def force_leave(self, node: str):
        return self.c.put("/v1/agent/force-leave", params={"node": node})

    def members(self):
        return self.c.get("/v1/agent/members")

    def metrics(self):
        """Telemetry snapshot (reference api/operator_metrics.go):
        counters, gauges, and histogram samples with cumulative and
        last-window p50/p90/p95/p99 (metrics.py)."""
        return self.c.get("/v1/metrics")

    def metrics_prometheus(self) -> str:
        """The Prometheus text exposition (?format=prometheus) verbatim
        — what a scraper sees, histogram buckets included."""
        resp = self.c.get(
            "/v1/metrics", params={"format": "prometheus"}, raw=True
        )
        return resp.read().decode()

    def solver_status(self):
        """Solver observability snapshot (/v1/solver/status): compile
        ledger, batch occupancy/padding waste, host<->device transfer
        bytes, device memory (solverobs.py); rendered by
        `operator solver status|top`."""
        return self.c.get("/v1/solver/status")

    def solver_pool(self):
        """Solver-pool tier snapshot (/v1/solver/pool): membership +
        health, leader-side dispatch stats, and each member's own warm
        solver counters (server/solver_pool.py); rendered by
        `operator solver pool status`."""
        return self.c.get("/v1/solver/pool")

    def profile_status(self, top: int = 50):
        """Host profiler summary (/v1/profile/status): span-correlated
        CPU self-time sites, GC pause/collection telemetry, lock-wait
        ledger, runtime gauges (hostobs.py); rendered by
        `operator profile status|top`."""
        return self.c.get("/v1/profile/status", params={"top": top})

    def profile_collapsed(self, limit: int = 0) -> str:
        """Collapsed-stack flamegraph text (/v1/profile/collapsed)
        verbatim — feed to flamegraph.pl / speedscope."""
        resp = self.c.get(
            "/v1/profile/collapsed", params={"limit": limit}, raw=True
        )
        return resp.read().decode()

    def blackbox_status(self, journal: int = 0):
        """Flight-recorder summary (/v1/blackbox/status): journal
        occupancy and per-kind counts, the trigger catalogue with
        last-fired ages, and recent incidents (blackbox.py);
        journal=N appends the newest N journal rows. Rendered by
        `operator incidents list` and the `operator top` panel."""
        params = {"journal": journal} if journal else None
        return self.c.get("/v1/blackbox/status", params=params)

    def incidents(self):
        """Captured-incident index (/v1/incidents), newest first; each
        record's `path` is the on-disk bundle directory."""
        return self.c.get("/v1/incidents")

    def incident(self, incident_id: str):
        """One incident's record + its bundle file inventory."""
        return self.c.get(f"/v1/incidents/{incident_id}")

    def timeline(self, kind: str, obj_id: str):
        """Causal cross-object timeline (/v1/timeline/<kind>/<id>):
        journal rows + finished traces merged and expanded through
        their cross-object links (eval -> plan -> alloc -> node).
        Rendered by `operator timeline <kind> <id>`."""
        return self.c.get(f"/v1/timeline/{kind}/{obj_id}")

    def self(self):
        return self.c.get("/v1/agent/self")

    def keyring_status(self):
        """Fabric-auth keyring state (/v1/agent/keyring): generation,
        key age, dual-accept window — fingerprints only, never the
        secrets. Rendered by `operator keyring status`."""
        return self.c.get("/v1/agent/keyring")

    def keyring_rotate(self, secret: str, window_s=None):
        """Rotate this agent's fabric secret live (the API analog of
        editing rpc_secret + SIGHUP); old secret stays accepted for the
        dual-accept window."""
        body = {"Secret": secret}
        if window_s is not None:
            body["Window"] = window_s
        return self.c.put("/v1/agent/keyring/rotate", body)

    def health(self):
        return self.c.get("/v1/agent/health")

    def join(self, *addresses: str):
        return self.c.put(
            "/v1/agent/join", params={"address": list(addresses)}
        )


class Status(_Resource):
    def leader(self):
        return self.c.get("/v1/status/leader")

    def peers(self):
        return self.c.get("/v1/status/peers")

    def regions(self):
        return self.c.get("/v1/regions")


class ACLAPI(_Resource):
    def bootstrap(self):
        return self.c.put("/v1/acl/bootstrap")

    def policies(self):
        return self.c.get("/v1/acl/policies")

    def policy(self, name: str):
        return self.c.get(f"/v1/acl/policy/{name}")

    def policy_apply(self, name: str, rules: str, description: str = ""):
        return self.c.put(
            f"/v1/acl/policy/{name}",
            body={"Rules": rules, "Description": description},
        )

    def policy_delete(self, name: str):
        return self.c.delete(f"/v1/acl/policy/{name}")

    def tokens(self):
        return self.c.get("/v1/acl/tokens")

    def token(self, accessor_id: str):
        return self.c.get(f"/v1/acl/token/{accessor_id}")

    def token_self(self):
        return self.c.get("/v1/acl/token/self")

    def token_create(
        self, name: str = "", type: str = "client", policies=None,
        global_: bool = False,
    ):
        return self.c.put(
            "/v1/acl/token",
            body={
                "Name": name, "Type": type, "Policies": policies or [],
                "Global": global_,
            },
        )

    def token_update(self, accessor_id: str, **fields):
        """Update mutable fields of an existing token (reference
        acl token update): Name, Policies, Type, Global."""
        body = {"AccessorID": accessor_id}
        for k_api, k_py in (
            ("Name", "name"), ("Policies", "policies"),
            ("Type", "type"), ("Global", "global_"),
        ):
            if k_py in fields:
                body[k_api] = fields[k_py]
        return self.c.put("/v1/acl/token", body=body)

    def token_delete(self, accessor_id: str):
        return self.c.delete(f"/v1/acl/token/{accessor_id}")


def event_stream(
    client: NomadClient,
    topics: Optional[dict] = None,
    index: int = 0,
    namespace: str = "",
) -> Iterator[dict]:
    """Generator over /v1/event/stream NDJSON frames (reference
    api/event_stream.go). Yields {"Index": n, "Events": [...]} dicts with
    decoded payloads; skips heartbeats."""
    params: list[tuple[str, str]] = []
    for topic, keys in (topics or {}).items():
        for k in keys:
            params.append(("topic", f"{topic}:{k}"))
    if index:
        params.append(("index", str(index)))
    if namespace:
        params.append(("namespace", namespace))
    url = client.address + "/v1/event/stream"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url)
    if client.token:
        req.add_header("X-Nomad-Token", client.token)
    resp = urllib.request.urlopen(req, context=client._ssl_ctx)
    for line in resp:
        line = line.strip()
        if not line or line == b"{}":
            continue
        frame = json.loads(line)
        for ev in frame.get("Events", []):
            ev["Payload"] = codec.from_wire(ev["Payload"])
        yield frame
