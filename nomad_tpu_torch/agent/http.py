"""HTTP API server.

Port of ``nomad_tpu/agent/http.py``.

Reference: command/agent/http.go (~60 routes at :252-360, wrap() adds
region/blocking-query/auth handling), the per-resource endpoint files
(job_endpoint.go, node_endpoint.go, …), and the NDJSON event stream
endpoint (event_endpoint.go).

JSON convention: payloads are the codec wire form of the shared structs —
plain JSON with a `$t` type tag per struct, so the SDK decodes straight
back into typed dataclasses and third-party consumers still read ordinary
JSON. Blocking queries take `?index=N&wait=SECONDS` like the reference
and respond with the `X-Nomad-Index` header.
"""

from __future__ import annotations

import contextvars
import json
import logging
import re
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from .. import codec, metrics
from ..server.server import ConflictError
from ..state.store import (
    TABLE_ALLOCS,
    TABLE_DEPLOYMENTS,
    TABLE_EVALS,
    TABLE_JOBS,
    TABLE_NODES,
)
from ..stream import SubscriptionClosedError

logger = logging.getLogger("nomad_tpu_torch.http")

# per-request ?region= (reference: wrap() parses the region query param
# and every RPC carries it for cross-region forwarding)
_REQ_REGION = contextvars.ContextVar("nomad_http_region", default="")
_REQ_TOKEN = contextvars.ContextVar("nomad_http_token", default="")


class RawResponse:
    """A handler return that bypasses the JSON encode — raw bytes with an
    explicit content type (the Prometheus exposition endpoint)."""

    def __init__(self, data: bytes, content_type: str) -> None:
        self.data = data
        self.content_type = content_type


class HTTPError(Exception):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None) -> None:
        self.status = status
        self.message = message
        # 429/503 backoff hint: surfaced as the Retry-After header
        # (integer ceil per RFC 9110) AND a float `retry_after_s` field
        # in the JSON error body (sub-second precision for the SDK).
        self.retry_after = retry_after
        super().__init__(message)


_json_default = codec.json_default


class HTTPAgentServer:
    """Routes /v1/... onto a ClusterServer (and optionally a Client).

    Route handlers get (params, query, body, token) and return a
    JSON-able wire object (codec.to_wire applied to struct returns).
    """

    def __init__(
        self,
        cluster,  # ClusterServer
        client=None,  # optional co-located node agent
        host: str = "127.0.0.1",
        port: int = 0,
        acl_resolver=None,  # installed by the ACL layer (acl/enforce.py)
        enable_debug: bool = False,  # pprof off unless opted in (reference)
        tls_cert: str = "",  # PEM cert+key enable HTTPS (reference:
        tls_key: str = "",   # tls { http = true } agent stanza)
        on_keyring_rotate=None,  # fn(secret) — the Agent syncs its
                                 # in-memory config so a later SIGHUP
                                 # diff is computed against the LIVE
                                 # secret, not the boot-time one
    ) -> None:
        self.cluster = cluster
        self.client = client
        self.acl_resolver = acl_resolver
        self.enable_debug = enable_debug
        self.on_keyring_rotate = on_keyring_rotate
        # Per-namespace token buckets on the HTTP front door (disabled
        # until limits{} config sets a rate; SIGHUP-reconfigurable).
        from ..ratelimit import KeyedRateLimiter

        self.limiter = KeyedRateLimiter()
        self._relay_lock = threading.Lock()
        self._relay_active = 0
        # Cap concurrent client-relay sessions: each one ties up an HTTP
        # worker thread against a possibly-slow client agent; unbounded,
        # a burst of follow-streams starves every other route.
        self._relay_max = 64
        # Single-flight guard for /v1/agent/pprof/profile: a wall-clock
        # capture occupies its handler thread for `seconds`; overlapping
        # requests coalesce to 429 + Retry-After instead of each eating
        # a thread (satellite of the host-profiling layer).
        self._pprof_capture_lock = threading.Lock()
        self._pprof_busy_until = 0.0
        # /v1/agent/monitor level refcounting (see _serve_monitor)
        self._monitor_lock = threading.Lock()
        self._monitor_levels: list = []
        self._monitor_base_level = 0
        self._routes: list[tuple[str, re.Pattern, Callable]] = []
        self._register_routes()
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.tls = bool(tls_cert and tls_key)
        self._tls_ctx = None
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            # kept for SIGHUP cert rotation: new handshakes pick up
            # material re-loaded into the live context (Agent.reload)
            self._tls_ctx = ctx
            # handshake must NOT run in the accept loop: a client that
            # connects and sends nothing would block serve_forever and
            # freeze the whole API. Deferred, the handshake happens on
            # first read in the per-connection worker thread, bounded
            # by the handler's socket timeout.
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket,
                server_side=True,
                do_handshake_on_connect=False,
            )
            # plaintext probes (health checkers, LBs) fail the deferred
            # handshake inside the handler thread; socketserver would
            # print a full traceback per connection — log one line
            base_handle_error = self._httpd.handle_error

            def handle_error(request, client_address, _base=base_handle_error):
                import sys as _sys

                exc = _sys.exc_info()[1]
                if isinstance(exc, (ssl.SSLError, ConnectionError)):
                    logger.debug(
                        "https %s: %s", client_address, exc
                    )
                    return
                _base(request, client_address)

            self._httpd.handle_error = handle_error
        self.addr = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-agent", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        # socketserver.shutdown() blocks on an event that only
        # serve_forever() sets — on a constructed-but-never-started
        # agent it would wait forever; just close the listener.
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def set_rate_limits(self, http_rate: float, http_burst: float = 0.0) -> None:
        """Configure (or SIGHUP-reconfigure) the per-namespace HTTP
        front-door token buckets. rate <= 0 disables."""
        self.limiter.configure(http_rate, http_burst)

    # Routes exempt from the front-door rate limit: the observability
    # and control surfaces an operator needs DURING overload (reading
    # shed/throttle metrics, traces, health, reload/debug) — throttling
    # the dashboards that diagnose a throttling event would blind the
    # operator exactly when they need to see.
    _THROTTLE_EXEMPT = (
        "/v1/agent",
        "/v1/metrics",
        "/v1/status",
        "/v1/operator",
        "/v1/traces",
        "/v1/solver",
        "/v1/profile",
        "/v1/event/stream",
        "/v1/acl",
        "/v1/blackbox",
        "/v1/incidents",
        "/v1/timeline",
    )

    @staticmethod
    def _throttle_ns(query: dict, raw_body: bytes) -> str:
        """The namespace to charge: ?namespace= when present, else the
        payload's object namespace (job register/plan and volume
        register carry it in the body, not the query — charging
        'default' for those would let one tenant's register storm
        starve everyone else's default bucket). The JSON parse runs
        only for body-bearing requests with no query namespace."""
        ns = query.get("namespace", [""])[0]
        if ns:
            return ns
        if raw_body:
            try:
                body = json.loads(raw_body)
                if isinstance(body, dict):
                    for key in ("Job", "Volume"):
                        obj = body.get(key)
                        if isinstance(obj, dict) and obj.get("namespace"):
                            return str(obj["namespace"])
                    if body.get("Namespace"):
                        return str(body["Namespace"])
            except ValueError:
                pass
        return "default"

    def _throttle_check(self, path: str, query: dict,
                        raw_body: bytes = b"") -> None:
        """Charge the request against its namespace's bucket; raises
        HTTPError 429 with Retry-After when over."""
        if not self.limiter.enabled or not path.startswith("/v1/"):
            return
        if path.startswith(self._THROTTLE_EXEMPT):
            return
        ns = self._throttle_ns(query, raw_body)
        wait = self.limiter.check(ns)
        if wait > 0:
            metrics.incr("nomad.http.throttled")
            raise HTTPError(
                429,
                f"rate limit exceeded for namespace {ns!r}",
                retry_after=wait,
            )

    def reload_tls(self, cert_file: str, key_file: str) -> bool:
        """Rotate the HTTPS certificate without dropping the listener:
        loading new material into the live SSLContext makes every
        SUBSEQUENT handshake present it while established connections
        finish on the old session (reference Agent.Reload →
        http.Server TLS config swap). No-op (False) when HTTPS is off —
        enabling TLS on a plaintext listener needs a restart, as in the
        reference."""
        if self._tls_ctx is None:
            return False
        self._tls_ctx.load_cert_chain(cert_file, key_file)
        return True

    # -- ACL helpers (second-stage, object-namespace-aware) ------------

    def _acl_for(self, token: str):
        """None ⇒ enforcement off or management. Raises on bad token."""
        if self.acl_resolver is None:
            return None
        try:
            acl = self.cluster.server.resolve_token(token)
        except PermissionError:
            raise HTTPError(401, "ACL token not found")
        if acl is None:
            raise HTTPError(401, "missing ACL token")
        return None if acl.is_management() else acl

    def _ns_guard(self, token: str, namespace: str, cap: str) -> None:
        """Check a capability against an OBJECT's namespace — the route
        pre-check only sees the query namespace, which need not match the
        object the handler acts on (cross-namespace escalation)."""
        acl = self._acl_for(token)
        if acl is not None and not acl.allow_namespace_op(namespace, cap):
            raise HTTPError(403, f"missing {cap!r} on namespace {namespace!r}")

    def _ns_filter(self, token: str, objs: list, cap: str) -> list:
        """Drop objects in namespaces the token can't read."""
        acl = self._acl_for(token)
        if acl is None:
            return objs
        return [
            o
            for o in objs
            if acl.allow_namespace_op(getattr(o, "namespace", "default"), cap)
        ]

    def _map_throttle_error(self, e: Exception) -> Optional[HTTPError]:
        """Queue-full / rate-limited rejections -> 429 with Retry-After,
        whether raised locally (RateLimitError / BrokerSaturatedError
        from an in-process dispatch) or arriving as a leader-forwarded
        RPCError string. Centralized in the handler's generic exception
        path so EVERY route maps correctly — these used to surface as
        500s, teaching clients to back off never."""
        from ..ratelimit import (
            RateLimitError,
            is_throttle_text,
            retry_after_from_text,
        )

        if isinstance(e, RateLimitError):
            return HTTPError(429, str(e), retry_after=e.retry_after_s)
        from ..rpc.client import RPCError

        if isinstance(e, RPCError) and is_throttle_text(str(e)):
            return HTTPError(
                429,
                str(e),
                retry_after=retry_after_from_text(str(e)) or 1.0,
            )
        return None

    def _map_forward_error(self, e: Exception):
        """KeyError/ValueError raised on THIS server map directly; the
        same errors raised on the LEADER arrive as RPCError strings —
        map both so followers return 404/400 instead of 500."""
        if isinstance(e, KeyError):
            return HTTPError(404, str(e))
        if isinstance(e, ValueError):
            return HTTPError(400, str(e))
        msg = str(e)
        if "KeyError" in msg or "not found" in msg:
            return HTTPError(404, msg)
        if "ValueError" in msg or "CSIError: invalid" in msg:
            # CSIError's own "invalid <thing>" rejections are client
            # errors; a bare "invalid" substring must NOT match (ids may
            # contain the word while the fault is server-side)
            return HTTPError(400, msg)
        return None

    def rpc_region(self, method: str, args):
        """rpc_self with the request's ?region= attached, so any route
        can address a federated region (reference: Region rides every
        RPC's QueryOptions/WriteRequest). The caller's token rides along
        so the TARGET region re-authorizes against its own ACL state."""
        region = _REQ_REGION.get()
        if (
            region
            and region != self.cluster.region
            and isinstance(args, dict)
            and "region" not in args
        ):
            args = {
                **args,
                "region": region,
                "__cross_region_token__": _REQ_TOKEN.get(),
            }
        return self.cluster.rpc_self(method, args)

    # -- routing -------------------------------------------------------

    def _register_routes(self) -> None:
        srv = self.cluster.server

        def other_region():
            """The request's ?region= when it names a DIFFERENT region
            (local-state read handlers then forward over RPC instead)."""
            region = _REQ_REGION.get()
            return region if region and region != self.cluster.region else ""

        def route(method: str, pattern: str, fn: Callable) -> None:
            # per-route latency label precomputed at registration: the
            # PATTERN (with named groups collapsed to :name), never the
            # raw request path — ids in the path would make the metric
            # name set unbounded
            label = (
                "nomad.http.request_seconds." + method + "."
                + re.sub(r"\(\?P<(\w+)>[^)]*\)", r":\1", pattern)
            )
            self._routes.append(
                (method, re.compile(f"^{pattern}$"), fn, label)
            )

        def blocking(tables, query, reader):
            """Common blocking-query wrapper (reference http.go wrap +
            setMeta): ?index=N&wait=S parks on the state watch."""
            min_index = int(query.get("index", ["0"])[0])
            wait_s = _parse_wait(query.get("wait", ["0"])[0])
            if min_index > 0 and wait_s > 0:
                idx = srv.state.wait_for_index(tables, min_index + 1, wait_s)
            else:
                idx = srv.state.table_index(*tables)
            return reader(), idx

        # -- jobs ------------------------------------------------------
        def jobs_list(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                return self.rpc_region(
                    "Job.list", {"namespace": None if ns == "*" else ns}
                )
            data, idx = blocking(
                [TABLE_JOBS], q, lambda: srv.state.jobs(None if ns == "*" else ns)
            )
            prefix = q.get("prefix", [""])[0]
            if prefix:
                data = [j for j in data if j.id.startswith(prefix)]
            return data, idx

        def jobs_register(p, q, body, tok):
            job = codec.from_wire(body["Job"])
            return self.rpc_region("Job.register", {"job": job})

        def job_get(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                job = self.rpc_region(
                    "Job.get", {"namespace": ns, "job_id": p["id"]}
                )
            else:
                job = srv.state.job_by_id(ns, p["id"])
            if job is None:
                raise HTTPError(404, f"job {p['id']} not found")
            return job

        def job_delete(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            purge = q.get("purge", ["false"])[0] == "true"
            return self.rpc_region(
                "Job.deregister",
                {"namespace": ns, "job_id": p["id"], "purge": purge},
            )

        def job_allocs(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                return self.rpc_region(
                    "Job.allocs", {"namespace": ns, "job_id": p["id"]}
                )
            data, idx = blocking(
                [TABLE_ALLOCS], q, lambda: srv.state.allocs_by_job(ns, p["id"])
            )
            return data, idx

        def job_evals(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                return self.rpc_region(
                    "Job.evals", {"namespace": ns, "job_id": p["id"]}
                )
            return srv.state.evals_by_job(ns, p["id"])

        def job_summary(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                s = self.rpc_region(
                    "Job.summary", {"namespace": ns, "job_id": p["id"]}
                )
            else:
                s = srv.state.job_summary_by_id(ns, p["id"])
            if s is None:
                raise HTTPError(404, "no summary")
            return s

        def job_scale(p, q, body, tok):
            # ACL: the route resolver already enforces scale-job OR
            # submit-job on this namespace (acl/enforce.py)
            ns = q.get("namespace", ["default"])[0]
            target = (body or {}).get("Target") or {}
            group = target.get("Group", "")
            count = (body or {}).get("Count")
            if count is None or not group:
                raise HTTPError(400, "Target.Group and Count are required")
            try:
                count = int(count)
            except (TypeError, ValueError):
                raise HTTPError(400, f"Count must be an integer, got {count!r}")
            try:
                eval_id = self.rpc_region(
                "Job.scale",
                {
                    "namespace": ns,
                    "job_id": p["id"],
                    "group": group,
                    "count": count,
                    "message": (body or {}).get("Message", ""),
                })
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(400, str(e))
            return {"EvalID": eval_id}

        def job_scale_status(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            out = self.rpc_region(
                "Job.scale_status", {"namespace": ns, "job_id": p["id"]}
            )
            if out is None:
                raise HTTPError(404, f"job {p['id']} not found")
            return out

        def job_versions(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            if other_region():
                return self.rpc_region(
                    "Job.versions", {"namespace": ns, "job_id": p["id"]}
                )
            return srv.state.job_versions(ns, p["id"])

        def _search_ns(q, body) -> str:
            # MUST mirror the ACL resolver's derivation (body wins, then
            # query): authorizing one namespace and searching another
            # would leak ids.
            return (
                body.get("Namespace")
                or q.get("namespace", ["default"])[0]
            )

        def _filter_search(result, tok):
            """Cluster-scoped contexts need their own capabilities
            (reference search_endpoint.go sufficientSearchPerms): nodes
            require node:read; the namespaces list shrinks to ones the
            token holds any job capability on."""
            acl = self._acl_for(tok)
            if acl is None:  # enforcement off or management token
                return result
            matches = result.get("Matches") or {}
            if not acl.allow_node_read():
                matches.pop("nodes", None)
                result.get("Truncations", {}).pop("nodes", None)
            if "namespaces" in matches:
                def visible(name):
                    n = name["ID"] if isinstance(name, dict) else name
                    return acl.allow_namespace_op(
                        n, "list-jobs"
                    ) or acl.allow_namespace_op(n, "read-job")

                kept = [n for n in matches["namespaces"] if visible(n)]
                if kept:
                    matches["namespaces"] = kept
                else:
                    matches.pop("namespaces", None)
            return result

        def search(p, q, body, tok):
            return _filter_search(
                self.rpc_region(
                    "Search.prefix",
                    {
                        "prefix": body.get("Prefix", ""),
                        "context": body.get("Context", "all"),
                        "namespace": _search_ns(q, body),
                    },
                ),
                tok,
            )

        def search_fuzzy(p, q, body, tok):
            return _filter_search(
                self.rpc_region(
                    "Search.fuzzy",
                    {
                        "text": body.get("Text", ""),
                        "context": body.get("Context", "all"),
                        "namespace": _search_ns(q, body),
                    },
                ),
                tok,
            )

        def namespaces_list(p, q, body, tok):
            return self.rpc_region("Namespace.list", {})

        def namespace_upsert(p, q, body, tok):
            ns = codec.from_wire(body["Namespace"])
            return self.rpc_region(
                "Namespace.upsert", {"namespace": ns}
            )

        def namespace_get(p, q, body, tok):
            ns = self.rpc_region("Namespace.get", {"name": p["name"]})
            if ns is None:
                raise HTTPError(404, f"namespace {p['name']} not found")
            return ns

        def namespace_delete(p, q, body, tok):
            from ..rpc.client import RPCError

            try:
                return self.rpc_region(
                    "Namespace.delete", {"name": p["name"]}
                )
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(409, str(e))
            except RPCError as e:
                msg = str(e)
                if "not found" in msg:
                    raise HTTPError(404, msg)
                if "jobs/volumes" in msg or "cannot be deleted" in msg:
                    raise HTTPError(409, msg)
                raise

        def volumes_list(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region(
                "Volume.list",
                {"namespace": None if ns == "*" else ns},
            )

        def volume_register(p, q, body, tok):
            vol = codec.from_wire(body["Volume"])
            self._ns_guard(tok, vol.namespace, "submit-job")
            return self.rpc_region("Volume.register", {"volume": vol})

        def volume_get(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            vol = self.rpc_region(
                "Volume.get", {"namespace": ns, "volume_id": p["id"]}
            )
            if vol is None:
                raise HTTPError(404, f"volume {p['id']} not found")
            return vol

        def volume_delete(p, q, body, tok):
            from ..rpc.client import RPCError

            ns = q.get("namespace", ["default"])[0]
            self._ns_guard(tok, ns, "submit-job")
            try:
                return self.rpc_region(
                    "Volume.deregister",
                    {"namespace": ns, "volume_id": p["id"]},
                )
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(409, str(e))
            except RPCError as e:
                # leader-forwarded errors arrive as strings; keep the
                # status mapping callers rely on
                msg = str(e)
                if "not found" in msg:
                    raise HTTPError(404, msg)
                if "active claims" in msg:
                    raise HTTPError(409, msg)
                raise

        def job_plan(p, q, body, tok):
            job = codec.from_wire(body["Job"])
            self._ns_guard(tok, job.namespace, "submit-job")
            if job.id != p["id"]:
                raise HTTPError(400, "job id does not match URL")
            return self.rpc_region(
                "Job.plan",
                {"job": job, "diff": bool(body.get("Diff", True))},
            )

        def job_revert(p, q, body, tok):
            ns = body.get("Namespace", "default")
            self._ns_guard(tok, ns, "submit-job")
            return self.rpc_region(
                "Job.revert",
                {"namespace": ns, "job_id": p["id"], "version": body["JobVersion"]},
            )

        def job_dispatch(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            payload = codec.from_wire(body.get("Payload"))
            if isinstance(payload, str):
                payload = payload.encode()
            return self.rpc_region(
                "Job.dispatch",
                {
                    "namespace": ns,
                    "job_id": p["id"],
                    "meta": body.get("Meta") or {},
                    "payload": payload,
                },
            )

        def job_periodic_force(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region(
                "Job.periodic_force", {"namespace": ns, "job_id": p["id"]}
            )

        def jobs_parse(p, q, body, tok):
            # Server-side HCL parse (reference /v1/jobs/parse,
            # jobs_endpoint.go): the browser UI submits raw jobspec text
            # and gets the canonical job back for plan/register.
            from ..jobspec import parse_job

            src = body.get("JobHCL", "")
            if not src.strip():
                raise HTTPError(400, "JobHCL required")
            variables = body.get("Variables") or {}
            try:
                job = parse_job(src, variables=variables)
            except Exception as e:
                raise HTTPError(400, f"parse failed: {e}")
            # the Job dataclass rides the reply encoder once — returning
            # a pre-encoded dict here would double-encode into $map form
            return {"Job": job}

        route("GET", "/v1/jobs", jobs_list)
        route("PUT", "/v1/jobs", jobs_register)
        route("POST", "/v1/jobs", jobs_register)
        route("POST", "/v1/jobs/parse", jobs_parse)
        route("PUT", "/v1/jobs/parse", jobs_parse)
        route("GET", "/v1/job/(?P<id>[^/]+)", job_get)
        route("DELETE", "/v1/job/(?P<id>[^/]+)", job_delete)
        route("GET", "/v1/job/(?P<id>[^/]+)/allocations", job_allocs)
        route("GET", "/v1/job/(?P<id>[^/]+)/evaluations", job_evals)
        route("GET", "/v1/job/(?P<id>[^/]+)/summary", job_summary)
        route("GET", "/v1/job/(?P<id>[^/]+)/versions", job_versions)
        def job_evaluate(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            try:
                eval_id = self.rpc_region(
                    "Job.evaluate", {"namespace": ns, "job_id": p["id"]}
                )
            except Exception as e:
                mapped = self._map_forward_error(e)
                if mapped is None:
                    raise
                raise mapped
            return {"EvalID": eval_id}

        def job_deployments(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region(
                "Job.deployments", {"namespace": ns, "job_id": p["id"]}
            )

        def validate_job(p, q, body, tok):
            # reference command/agent/job_endpoint.go ValidateJobRequest:
            # canonicalize+validate server-side, report errors as data
            # (not an HTTP failure)
            if not (body or {}).get("Job"):
                raise HTTPError(400, "Job is required")
            try:
                srv.validate_job_submission(codec.from_wire(body["Job"]))
            except (ValueError, PermissionError) as e:
                return {
                    "Error": str(e),
                    "ValidationErrors": [str(e)],
                    "Warnings": "",
                }
            return {"Error": "", "ValidationErrors": [], "Warnings": ""}

        route("PUT", "/v1/validate/job", validate_job)
        route("POST", "/v1/validate/job", validate_job)
        route("PUT", "/v1/job/(?P<id>[^/]+)/evaluate", job_evaluate)
        route("POST", "/v1/job/(?P<id>[^/]+)/evaluate", job_evaluate)
        route("GET", "/v1/job/(?P<id>[^/]+)/deployments", job_deployments)
        route("POST", "/v1/job/(?P<id>[^/]+)/scale", job_scale)
        route("PUT", "/v1/job/(?P<id>[^/]+)/scale", job_scale)
        route("GET", "/v1/job/(?P<id>[^/]+)/scale", job_scale_status)
        route("PUT", "/v1/search", search)
        route("POST", "/v1/search", search)
        route("PUT", "/v1/search/fuzzy", search_fuzzy)
        route("POST", "/v1/search/fuzzy", search_fuzzy)
        route("GET", "/v1/namespaces", namespaces_list)
        route("PUT", "/v1/namespaces", namespace_upsert)
        route("POST", "/v1/namespaces", namespace_upsert)
        route("GET", "/v1/namespace/(?P<name>[^/]+)", namespace_get)
        route("DELETE", "/v1/namespace/(?P<name>[^/]+)", namespace_delete)
        def secrets_list(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region("Secrets.list", {"namespace": ns})

        def secret_get(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            entry = self.rpc_region(
                "Secrets.read",
                {"namespace": ns, "path": p["path"], "token": tok or ""},
            )
            if entry is None:
                raise HTTPError(404, f"secret {p['path']} not found")
            return entry

        def secret_put(p, q, body, tok):
            from ..structs.structs import SecretEntry

            ns = q.get("namespace", ["default"])[0]
            items = (body or {}).get("Items") or {}
            if not isinstance(items, dict):
                raise HTTPError(400, "Items must be an object")
            entry = SecretEntry(
                path=p["path"], namespace=ns,
                items={str(k): str(v) for k, v in items.items()},
            )
            return self.rpc_region("Secrets.upsert", {"entry": entry})

        def secret_delete(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            try:
                return self.rpc_region(
                    "Secrets.delete", {"namespace": ns, "path": p["path"]}
                )
            except KeyError as e:
                raise HTTPError(404, str(e))

        route("GET", "/v1/secrets", secrets_list)
        route("GET", "/v1/secret/(?P<path>.+)", secret_get)
        route("PUT", "/v1/secret/(?P<path>.+)", secret_put)
        route("POST", "/v1/secret/(?P<path>.+)", secret_put)
        route("DELETE", "/v1/secret/(?P<path>.+)", secret_delete)

        def services_list(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region(
                "Service.list",
                {"namespace": None if ns == "*" else ns},
            )

        def service_get(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            regs = self.rpc_region(
                "Service.get", {"namespace": ns, "name": p["name"]}
            )
            if not regs:
                raise HTTPError(404, f"service {p['name']} not found")
            return regs

        def service_delete(p, q, body, tok):
            # Scope the delete to the ACL-checked namespace + the named
            # service: ids are guessable, so an id-only delete would let
            # a default-namespace token deregister another namespace's
            # instances.
            ns = q.get("namespace", ["default"])[0]
            regs = self.rpc_region(
                "Service.get", {"namespace": ns, "name": p["name"]}
            )
            if not any(r.id == p["id"] for r in regs):
                raise HTTPError(
                    404,
                    f"registration {p['id']} not found for service "
                    f"{p['name']} in namespace {ns}",
                )
            n = self.rpc_region(
                "Service.deregister", {"ids": [p["id"]]}
            )
            return {"Deregistered": n}

        route("GET", "/v1/services", services_list)
        route("GET", "/v1/service/(?P<name>[^/]+)", service_get)
        route(
            "DELETE",
            "/v1/service/(?P<name>[^/]+)/(?P<id>[^/]+)",
            service_delete,
        )

        def scaling_policies(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            return self.rpc_region(
                "Scaling.list_policies",
                {"namespace": None if ns == "*" else ns},
            )

        def scaling_policy_get(p, q, body, tok):
            pol = self.rpc_region(
                "Scaling.get_policy", {"policy_id": p["id"]}
            )
            if pol is None:
                raise HTTPError(404, f"scaling policy {p['id']} not found")
            self._ns_guard(tok, pol.namespace, "read-job")
            return pol

        route("GET", "/v1/scaling/policies", scaling_policies)
        route("GET", "/v1/scaling/policy/(?P<id>.+)", scaling_policy_get)

        def plugins_list(p, q, body, tok):
            plugins = self.rpc_region("Volume.plugins", {})
            return sorted(plugins.values(), key=lambda x: x["id"])

        def plugin_get(p, q, body, tok):
            plugins = self.rpc_region("Volume.plugins", {})
            if p["id"] not in plugins:
                raise HTTPError(404, f"plugin {p['id']} not found")
            return plugins[p["id"]]

        route("GET", "/v1/plugins", plugins_list)
        route("GET", "/v1/plugin/csi/(?P<id>[^/]+)", plugin_get)
        def volume_create(p, q, body, tok):
            if not (body or {}).get("Volume"):
                raise HTTPError(400, "Volume is required")
            vol = codec.from_wire(body["Volume"])
            self._ns_guard(tok, vol.namespace, "submit-job")
            try:
                return self.rpc_region("Volume.create", {"volume": vol})
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(400, str(e))

        def volume_csi_delete(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            self._ns_guard(tok, ns, "submit-job")
            try:
                self.rpc_region(
                    "Volume.delete",
                    {"namespace": ns, "volume_id": p["id"]},
                )
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(409, str(e))
            return None

        def volume_snapshot_create(p, q, body, tok):
            ns = (body or {}).get("Namespace") or q.get(
                "namespace", ["default"]
            )[0]
            self._ns_guard(tok, ns, "submit-job")
            vol_id = (body or {}).get("VolumeID", "")
            if not vol_id:
                raise HTTPError(400, "VolumeID is required")
            try:
                return self.rpc_region(
                    "Volume.snapshot_create",
                    {
                        "namespace": ns,
                        "volume_id": vol_id,
                        "name": (body or {}).get("Name", ""),
                    },
                )
            except Exception as e:
                mapped = self._map_forward_error(e)
                if mapped is None:
                    raise
                raise mapped

        def volume_snapshot_delete(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            self._ns_guard(tok, ns, "submit-job")
            plugin_id = q.get("plugin_id", [""])[0]
            snap_id = q.get("snapshot_id", [""])[0]
            if not plugin_id or not snap_id:
                raise HTTPError(400, "plugin_id and snapshot_id required")
            try:
                self.rpc_region(
                    "Volume.snapshot_delete",
                    {"plugin_id": plugin_id, "snapshot_id": snap_id},
                )
            except Exception as e:
                mapped = self._map_forward_error(e)
                if mapped is None:
                    raise
                raise mapped
            return None

        def volume_snapshot_list(p, q, body, tok):
            plugin_id = q.get("plugin_id", [""])[0]
            if not plugin_id:
                raise HTTPError(400, "plugin_id required")
            try:
                return self.rpc_region(
                    "Volume.snapshot_list", {"plugin_id": plugin_id}
                )
            except Exception as e:
                mapped = self._map_forward_error(e)
                if mapped is None:
                    raise
                raise mapped

        route("PUT", "/v1/volumes/create", volume_create)
        route("POST", "/v1/volumes/create", volume_create)
        def volume_detach(p, q, body, tok):
            ns = q.get("namespace", ["default"])[0]
            self._ns_guard(tok, ns, "submit-job")
            node_id = q.get("node", [""])[0]
            if not node_id:
                raise HTTPError(400, "node required")
            try:
                return self.rpc_region(
                    "Volume.detach",
                    {
                        "namespace": ns,
                        "volume_id": p["id"],
                        "node_id": node_id,
                    },
                )
            except Exception as e:
                mapped = self._map_forward_error(e)
                if mapped is None:
                    raise
                raise mapped

        route(
            "DELETE", "/v1/volume/(?P<id>[^/]+)/detach", volume_detach
        )
        route("PUT", "/v1/volumes/snapshot", volume_snapshot_create)
        route("POST", "/v1/volumes/snapshot", volume_snapshot_create)
        route("DELETE", "/v1/volumes/snapshot", volume_snapshot_delete)
        route("GET", "/v1/volumes/snapshot", volume_snapshot_list)
        route(
            "DELETE", "/v1/volume/(?P<id>[^/]+)/delete", volume_csi_delete
        )
        route("GET", "/v1/volumes", volumes_list)
        route("PUT", "/v1/volumes", volume_register)
        route("POST", "/v1/volumes", volume_register)
        route("GET", "/v1/volume/(?P<id>[^/]+)", volume_get)
        route("DELETE", "/v1/volume/(?P<id>[^/]+)", volume_delete)
        route("PUT", "/v1/job/(?P<id>[^/]+)/plan", job_plan)
        route("POST", "/v1/job/(?P<id>[^/]+)/plan", job_plan)
        route("PUT", "/v1/job/(?P<id>[^/]+)/revert", job_revert)
        route("PUT", "/v1/job/(?P<id>[^/]+)/dispatch", job_dispatch)
        route("POST", "/v1/job/(?P<id>[^/]+)/dispatch", job_dispatch)
        route(
            "PUT", "/v1/job/(?P<id>[^/]+)/periodic/force", job_periodic_force
        )

        # -- nodes -----------------------------------------------------
        def nodes_list(p, q, body, tok):
            if other_region():
                return self.rpc_region("Node.list", {})
            data, idx = blocking([TABLE_NODES], q, srv.state.nodes)
            prefix = q.get("prefix", [""])[0]
            if prefix:
                data = [n for n in data if n.id.startswith(prefix)]
            return data, idx

        def node_get(p, q, body, tok):
            if other_region():
                node = self.rpc_region("Node.get", {"node_id": p["id"]})
                if node is None:
                    raise HTTPError(404, f"node {p['id']} not found")
                return node
            node = srv.state.node_by_id(p["id"])
            if node is None:
                raise HTTPError(404, f"node {p['id']} not found")
            return node

        def node_allocs(p, q, body, tok):
            if other_region():
                return self.rpc_region(
                    "Alloc.list_by_node", {"node_id": p["id"]}
                )
            data, idx = blocking(
                [TABLE_ALLOCS], q, lambda: srv.state.allocs_by_node(p["id"])
            )
            return data, idx

        def node_drain(p, q, body, tok):
            drain = (
                codec.from_wire(body["DrainSpec"])
                if body.get("DrainSpec") is not None
                else None
            )
            if isinstance(drain, dict):
                # raw-JSON clients (the browser UI, curl) send the
                # reference's plain shape {"Deadline": ns, ...} rather
                # than a codec-tagged struct — accept both
                from ..structs import DrainStrategy

                drain = DrainStrategy(
                    deadline_s=float(drain.get("Deadline", 0)) / 1e9,
                    ignore_system_jobs=bool(
                        drain.get("IgnoreSystemJobs", False)
                    ),
                )
            self.rpc_region(
                "Node.update_drain",
                {
                    "node_id": p["id"],
                    "drain": drain,
                    "mark_eligible": body.get("MarkEligible", False),
                },
            )
            if other_region():
                # the local index belongs to the wrong region's raft —
                # a bogus value would poison blocking queries
                return {"NodeModifyIndex": 0}
            return {"NodeModifyIndex": srv.state.latest_index()}

        def node_eligibility(p, q, body, tok):
            self.rpc_region(
                "Node.update_eligibility",
                {"node_id": p["id"], "eligibility": body["Eligibility"]},
            )
            return {}

        def node_purge(p, q, body, tok):
            self.rpc_region("Node.purge", {"node_id": p["id"]})
            return {}

        route("GET", "/v1/nodes", nodes_list)
        route("GET", "/v1/node/(?P<id>[^/]+)", node_get)
        route("GET", "/v1/node/(?P<id>[^/]+)/allocations", node_allocs)
        route("PUT", "/v1/node/(?P<id>[^/]+)/drain", node_drain)
        route("POST", "/v1/node/(?P<id>[^/]+)/drain", node_drain)
        route("PUT", "/v1/node/(?P<id>[^/]+)/eligibility", node_eligibility)
        route("PUT", "/v1/node/(?P<id>[^/]+)/purge", node_purge)

        # -- allocs / evals -------------------------------------------
        def allocs_list(p, q, body, tok):
            if other_region():
                data = self.rpc_region("Alloc.list", {})
                return self._ns_filter(tok, data, "read-job")
            data, idx = blocking([TABLE_ALLOCS], q, srv.state.allocs)
            return self._ns_filter(tok, data, "read-job"), idx

        def alloc_get(p, q, body, tok):
            a = (
                self.rpc_region("Alloc.get", {"alloc_id": p["id"]})
                if other_region()
                else srv.state.alloc_by_id(p["id"])
            )
            if a is None:
                raise HTTPError(404, f"alloc {p['id']} not found")
            self._ns_guard(tok, a.namespace, "read-job")
            return a

        def evals_list(p, q, body, tok):
            if other_region():
                data = self.rpc_region("Eval.list", {})
                return self._ns_filter(tok, data, "read-job")
            data, idx = blocking([TABLE_EVALS], q, srv.state.evals)
            return self._ns_filter(tok, data, "read-job"), idx

        def eval_get(p, q, body, tok):
            e = (
                self.rpc_region("Eval.get", {"eval_id": p["id"]})
                if other_region()
                else srv.state.eval_by_id(p["id"])
            )
            if e is None:
                raise HTTPError(404, f"eval {p['id']} not found")
            self._ns_guard(tok, e.namespace, "read-job")
            return e

        def eval_allocs(p, q, body, tok):
            # Filter by each alloc's own namespace: a token scoped to one
            # namespace must not enumerate another namespace's allocs.
            allocs = (
                self.rpc_region("Eval.allocs", {"eval_id": p["id"]})
                if other_region()
                else srv.state.allocs_by_eval(p["id"])
            )
            return self._ns_filter(tok, allocs, "read-job")

        route("GET", "/v1/allocations", allocs_list)
        route("GET", "/v1/allocation/(?P<id>[^/]+)", alloc_get)
        route("GET", "/v1/evaluations", evals_list)
        def eval_delete(p, q, body, tok):
            # the endpoint owns the terminal-only invariant (checked on
            # the leader right before the apply) and ?region= forwards
            try:
                self.rpc_region("Eval.delete", {"eval_ids": [p["id"]]})
            except KeyError as e:
                raise HTTPError(404, str(e))
            except ValueError as e:
                raise HTTPError(400, str(e))
            return None

        route("DELETE", "/v1/evaluation/(?P<id>[^/]+)", eval_delete)
        route("GET", "/v1/evaluation/(?P<id>[^/]+)", eval_get)
        route("GET", "/v1/evaluation/(?P<id>[^/]+)/allocations", eval_allocs)

        # -- deployments ----------------------------------------------
        def deployments_list(p, q, body, tok):
            if other_region():
                data = self.rpc_region("Deployment.list", {})
                return self._ns_filter(tok, data, "read-job")
            data, idx = blocking([TABLE_DEPLOYMENTS], q, srv.state.deployments)
            return self._ns_filter(tok, data, "read-job"), idx

        def deployment_get(p, q, body, tok):
            d = (
                self.rpc_region(
                    "Deployment.get", {"deployment_id": p["id"]}
                )
                if other_region()
                else srv.state.deployment_by_id(p["id"])
            )
            if d is None:
                raise HTTPError(404, f"deployment {p['id']} not found")
            self._ns_guard(tok, d.namespace, "read-job")
            return d

        def deployment_allocs(p, q, body, tok):
            return self._ns_filter(
                tok, srv.state.allocs_by_deployment(p["id"]), "read-job"
            )

        def deployment_promote(p, q, body, tok):
            d = srv.state.deployment_by_id(p["id"])
            if d is not None:
                self._ns_guard(tok, d.namespace, "submit-job")
            self.rpc_region(
                "Deployment.promote",
                {
                    "deployment_id": p["id"],
                    "groups": body.get("Groups"),
                },
            )
            return {}

        def deployment_pause(p, q, body, tok):
            d = srv.state.deployment_by_id(p["id"])
            if d is not None:
                self._ns_guard(tok, d.namespace, "submit-job")
            self.rpc_region(
                "Deployment.pause",
                {"deployment_id": p["id"], "pause": body.get("Pause", True)},
            )
            return {}

        def deployment_fail(p, q, body, tok):
            d = srv.state.deployment_by_id(p["id"])
            if d is not None:
                self._ns_guard(tok, d.namespace, "submit-job")
            self.rpc_region(
                "Deployment.fail", {"deployment_id": p["id"]}
            )
            return {}

        route("GET", "/v1/deployments", deployments_list)
        route("GET", "/v1/deployment/(?P<id>[^/]+)", deployment_get)
        route(
            "GET", "/v1/deployment/allocations/(?P<id>[^/]+)", deployment_allocs
        )
        route("PUT", "/v1/deployment/promote/(?P<id>[^/]+)", deployment_promote)
        route("PUT", "/v1/deployment/pause/(?P<id>[^/]+)", deployment_pause)
        route("PUT", "/v1/deployment/fail/(?P<id>[^/]+)", deployment_fail)

        # -- status / agent -------------------------------------------
        def status_leader(p, q, body, tok):
            if other_region():
                out = self.rpc_region("Status.leader", {})
                addr = (out or {}).get("leader")
                return f"{addr[0]}:{addr[1]}" if addr else None
            addr = self.cluster.raft.leader_addr()
            return f"{addr[0]}:{addr[1]}" if addr else None

        def status_peers(p, q, body, tok):
            return self.rpc_region("Status.peers", {})

        def regions_list(p, q, body, tok):
            return self.rpc_region("Status.regions", {})

        def _debug_gate():
            # reference: pprof 404s unless enable_debug (agent http.go)
            if not self.enable_debug:
                raise HTTPError(404, "debug endpoints disabled")

        def pprof_goroutine(p, q, body, tok):
            from . import debug as _debug

            _debug_gate()
            return {"profile": _debug.thread_dump()}

        def pprof_profile(p, q, body, tok):
            from . import debug as _debug

            _debug_gate()
            try:
                seconds = float(q.get("seconds", ["2"])[0])
            except ValueError:
                raise HTTPError(400, "seconds must be a number")
            # Single-flight: one wall-clock capture occupies a handler
            # thread for `seconds`; N concurrent captures would occupy N
            # threads sampling the SAME process for no extra signal.
            # Overlapping requests 429 with a Retry-After sized to the
            # in-flight capture's remaining time. (The always-on sampler
            # at /v1/profile/status never blocks and needs no guard.)
            # mirror cpu_profile's own clamp so Retry-After is honest
            clamped = max(0.1, min(seconds, 30.0)) if seconds == seconds else 2.0
            if not self._pprof_capture_lock.acquire(blocking=False):
                remaining = self._pprof_busy_until - time.monotonic()
                raise HTTPError(
                    429,
                    "a profile capture is already in progress",
                    retry_after=max(0.1, remaining),
                )
            try:
                # FIRST thing under the lock: a loser arriving in the
                # instant between our acquire and this store would read
                # a stale (expired) deadline and hint Retry-After 0.1s
                # against a capture that may run 30s
                self._pprof_busy_until = time.monotonic() + clamped
                return {"profile": _debug.cpu_profile(seconds)}
            finally:
                self._pprof_capture_lock.release()

        def pprof_heap(p, q, body, tok):
            from . import debug as _debug

            _debug_gate()
            return _debug.heap_summary()

        def agent_metrics(p, q, body, tok):
            # reference: /v1/metrics (command/agent/http.go MetricsRequest,
            # behind agent:read / AgentReadACL); ?format=prometheus serves
            # the text exposition format a stock Prometheus scrapes
            if q.get("format", [""])[0] == "prometheus":
                return RawResponse(
                    metrics.prometheus_text().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            return metrics.snapshot()

        def traces_list(p, q, body, tok):
            # /v1/traces: the tracing ring buffer (trace.py) — newest
            # first, filterable by eval/job id and trace name. Follows
            # the /v1/metrics pattern: agent-local observability surface.
            from .. import trace as _trace

            try:
                limit = int(q.get("limit", ["50"])[0])
            except ValueError:
                raise HTTPError(400, "limit must be an integer")
            return _trace.recorder().list(
                name=q.get("name", [""])[0],
                eval_id=q.get("eval_id", [""])[0],
                job_id=q.get("job_id", [""])[0],
                limit=max(1, min(limit, 1000)),
            )

        def trace_get(p, q, body, tok):
            from .. import trace as _trace

            t = _trace.recorder().get(p["id"])
            if t is None:
                raise HTTPError(404, f"trace {p['id']} not found")
            return t

        route("GET", "/v1/traces", traces_list)
        route("GET", "/v1/traces/(?P<id>[^/]+)", trace_get)

        def solver_status(p, q, body, tok):
            # /v1/solver/status: the solver observatory's snapshot —
            # launch-shape ledger (new shapes vs repeats), batch
            # occupancy/padding waste, host<->device transfer bytes,
            # and device memory (solverobs.py). Same agent:read gate as
            # /v1/metrics; always on (observability, not debug).
            import sys as _sys

            from .. import solverobs

            out = solverobs.snapshot()
            # the built variants the kernels hold (the library build,
            # K7's CUDA graphs by shape, the launch shapes chosen), under
            # the reference's key for jax's jit-cache sizes — only when
            # the solver stack is already loaded in this process (never
            # drag torch into a control plane)
            kmod = _sys.modules.get("nomad_tpu_torch.scheduler.gpu.kernels")
            out["jit_cache_sizes"] = (
                kmod.built_variants() if kmod is not None else None
            )
            w = getattr(srv, "tpu_worker", None)
            out["worker"] = w.stats_snapshot() if w is not None else None
            # solver-pool tier: membership + per-member in-flight for
            # the operator-top panel (cheap local snapshot; the fan-out
            # aggregation lives on /v1/solver/pool)
            pool = getattr(self.cluster, "solver_pool", None)
            out["pool"] = pool.stats_snapshot() if pool is not None else None
            return out

        route("GET", "/v1/solver/status", solver_status)

        def solver_pool_status(p, q, body, tok):
            # /v1/solver/pool: the pool tracker's snapshot plus each
            # member's own SolverPool.Status, pulled with a bounded
            # per-member deadline (docs/solver-pool.md). Same agent:read
            # gate as /v1/solver/status via the /v1/solver ACL prefix.
            pool = getattr(self.cluster, "solver_pool", None)
            if pool is None:
                raise HTTPError(404, "no solver pool on this agent")
            return pool.pool_status()

        route("GET", "/v1/solver/pool", solver_pool_status)

        def profile_status(p, q, body, tok):
            # /v1/profile/status: the always-on host profiler's summary
            # (hostobs.py) — span-correlated CPU self-time sites, GC
            # pause/collection accounting, lock-wait ledger, runtime
            # gauges. Same agent:read gate as /v1/metrics; available
            # even when enable_debug 404s the raw pprof capture
            # (observability is not a debug mode).
            from .. import hostobs

            try:
                top = int(q.get("top", ["50"])[0])
            except ValueError:
                raise HTTPError(400, "top must be an integer")
            return hostobs.snapshot(top=max(1, min(top, 500)))

        def profile_collapsed(p, q, body, tok):
            # /v1/profile/collapsed: collapsed-stack flamegraph text
            # ("role;span;frame;...;leaf count" per line) — pipe into
            # flamegraph.pl / speedscope verbatim (docs/profiling.md).
            from .. import hostobs

            try:
                limit = int(q.get("limit", ["0"])[0])
            except ValueError:
                raise HTTPError(400, "limit must be an integer")
            return RawResponse(
                hostobs.collapsed(limit=max(0, limit)).encode(),
                "text/plain; charset=utf-8",
            )

        route("GET", "/v1/profile/status", profile_status)
        route("GET", "/v1/profile/collapsed", profile_collapsed)

        def blackbox_status(p, q, body, tok):
            # /v1/blackbox/status: the flight recorder's summary —
            # journal occupancy, per-kind counts, trigger catalogue with
            # last-fired ages, recent incidents. Same agent:read gate as
            # /v1/metrics; ?journal=N appends the newest N journal rows.
            from .. import blackbox as _bb

            rec = _bb.recorder()
            wiring = getattr(self.cluster, "blackbox", None)
            try:
                tail = int(q.get("journal", ["0"])[0])
            except ValueError:
                raise HTTPError(400, "journal must be an integer")
            out = {
                "enabled": _bb.enabled()
                and bool(wiring and wiring.enabled),
                "stats": rec.stats(),
                "kinds": rec.kind_counts(),
                "triggers": rec.triggers.status(),
                "incident_dir": wiring.incident_dir if wiring else "",
                "incidents": rec.incidents()[:5],
            }
            if tail:
                out["journal"] = rec.snapshot(
                    limit=max(1, min(tail, 1000))
                )
            return out

        def incidents_list(p, q, body, tok):
            # /v1/incidents: the capture index, newest first (the
            # on-disk bundles live under each record's `path`).
            from .. import blackbox as _bb

            return _bb.recorder().incidents()

        def incident_get(p, q, body, tok):
            from .. import blackbox as _bb

            import os as _os

            rec = _bb.recorder().incident(p["id"])
            if rec is None:
                raise HTTPError(404, f"incident {p['id']} not found")
            files = []
            if rec.get("path"):
                try:
                    files = sorted(_os.listdir(rec["path"]))
                except OSError:
                    pass
            rec["files"] = files
            return rec

        def timeline_get(p, q, body, tok):
            # /v1/timeline/<kind>/<id>: the causal cross-object view —
            # journal rows (broker events with extracted rel links,
            # leadership edges, sheds, trims, expiries) merged with
            # finished traces, expanded through the link graph so an
            # eval's timeline reaches its plan, allocs, and nodes.
            from .. import blackbox as _bb
            from .. import trace as _trace

            kind = p["kind"]
            if kind not in _bb.TIMELINE_KINDS:
                raise HTTPError(
                    400,
                    "kind must be one of "
                    + ", ".join(_bb.TIMELINE_KINDS),
                )
            rows = _bb.recorder().snapshot()
            # traces keep monotonic clocks (trace.py); re-base onto wall
            # time so the merged view sorts on one axis (same-process
            # alignment only, which is what the journal is too)
            off = time.time() - time.monotonic()
            for t in _trace.recorder().list(limit=200):
                attrs = t.get("attrs") or {}
                rel = []
                for a, k in (("eval_id", "eval"), ("job_id", "job"),
                             ("node_id", "node")):
                    v = attrs.get(a)
                    if v:
                        rel.append(f"{k}:{v}")
                for e in attrs.get("eval_ids") or ():
                    rel.append(f"eval:{e}")
                if not rel:
                    continue
                rows.append({
                    "ts": t["start"] / 1e9 + off,
                    "kind": "trace",
                    "key": t["id"],
                    "detail": {
                        "name": t["name"],
                        "duration_ms": t.get("duration_ms"),
                        "spans": t.get("num_spans"),
                        "rel": rel,
                    },
                })
            return _bb.build_timeline(kind, p["id"], rows)

        route("GET", "/v1/blackbox/status", blackbox_status)
        route("GET", "/v1/incidents", incidents_list)
        route("GET", "/v1/incidents/(?P<id>[^/]+)", incident_get)
        route(
            "GET",
            "/v1/timeline/(?P<kind>[^/]+)/(?P<id>[^/]+)",
            timeline_get,
        )

        def agent_members(p, q, body, tok):
            return [m.to_wire() for m in self.cluster.serf.members()]

        def agent_monitor(p, q, body, tok):
            # handled specially in _dispatch (streaming); never reached
            raise HTTPError(500, "monitor is a streaming route")

        def agent_self(p, q, body, tok):
            return {
                "member": self.cluster.serf.local.to_wire(),
                # the fabric address: SDK/CLI exec dials this directly
                "rpc_addr": list(self.cluster.rpc.addr),
                "stats": {
                    "leader": self.cluster.is_leader(),
                    "raft_last_index": self.cluster.raft.last_index,
                },
                # fabric-auth keyring state: generation, key age, and
                # whether the dual-accept rotation window is open —
                # fingerprints only, never secrets (rpc/keyring.py)
                "keyring": self.cluster.keyring.status(),
            }

        def agent_keyring(p, q, body, tok):
            return self.cluster.keyring.status()

        def agent_keyring_rotate(p, q, body, tok):
            # Rotate THIS agent's keyring in place (the API analog of
            # editing rpc_secret + SIGHUP): the new secret becomes
            # current, the old stays accepted for the window. The
            # operator runs this against each agent in turn — the
            # window plus the ConnPool previous-secret fallback keeps
            # the mixed cluster flowing either way.
            secret = (body or {}).get("Secret", "")
            if not secret:
                raise HTTPError(400, "Secret required")
            window = (body or {}).get("Window")
            try:
                rotated = self.cluster.keyring.rotate(
                    secret,
                    window_s=(
                        float(window) if window is not None else None
                    ),
                )
            except (TypeError, ValueError) as e:
                raise HTTPError(400, f"invalid rotation: {e}")
            if rotated and self.on_keyring_rotate is not None:
                self.on_keyring_rotate(secret)
            out = self.cluster.keyring.status()
            out["rotated"] = rotated
            # The keyring is process state, not persisted: the operator
            # must also put the new secret in the config file or the
            # next RESTART boots with the stale one (runbook step in
            # docs/operations.md).
            out["persisted"] = False
            return out

        def agent_health(p, q, body, tok):
            return {"server": {"ok": True}, "client": {"ok": self.client is not None}}

        def agent_join(p, q, body, tok):
            # reference agent_endpoint.go AgentJoin: gossip-join the
            # given servers (CLI `server join`)
            addrs = []
            for a in q.get("address", []):
                if a.startswith("["):  # [::1]:4647 or bare [::1]
                    if "]:" in a:
                        host, _, port = a.rpartition(":")
                    else:
                        host, port = a, ""
                    host = host.strip("[]")
                elif a.count(":") > 1:  # bare IPv6: no port to split off
                    host, port = a, ""
                else:
                    host, _, port = a.rpartition(":")
                    if not host:  # bare hostname/IPv4, default port
                        host, port = a, ""
                try:
                    addrs.append((host, int(port or 4647)))
                except ValueError:
                    raise HTTPError(400, f"invalid address {a!r}")
            if not addrs:
                raise HTTPError(400, "address required")
            joined = self.cluster.join(addrs)
            err = "" if joined else "no servers could be contacted"
            return {"num_joined": joined, "error": err}

        # -- acl -------------------------------------------------------
        def acl_bootstrap(p, q, body, tok):
            return self.rpc_region("ACL.bootstrap", {})

        def acl_policies(p, q, body, tok):
            return self.rpc_region("ACL.policy_list", {})

        def acl_policy_get(p, q, body, tok):
            pol = self.rpc_region("ACL.policy_get", {"name": p["name"]})
            if pol is None:
                raise HTTPError(404, f"policy {p['name']} not found")
            return pol

        def acl_policy_put(p, q, body, tok):
            from ..acl import ACLPolicy

            pol = ACLPolicy(
                name=p["name"],
                description=body.get("Description", ""),
                rules=body.get("Rules", ""),
            )
            self.rpc_region("ACL.policy_upsert", {"policies": [pol]})
            return {}

        def acl_policy_delete(p, q, body, tok):
            self.rpc_region("ACL.policy_delete", {"names": [p["name"]]})
            return {}

        def acl_tokens(p, q, body, tok):
            return self.rpc_region("ACL.token_list", {})

        def acl_token_put(p, q, body, tok):
            from ..acl import ACLToken

            accessor = body.get("AccessorID", "")
            if accessor:
                # update: keep identity+secret, swap the mutable fields
                # (reference acl token update)
                existing = self.rpc_region(
                    "ACL.token_get", {"accessor_id": accessor}
                )
                if existing is None:
                    raise HTTPError(404, f"token {accessor} not found")
                t = existing.copy()
                if "Name" in body:
                    t.name = body["Name"]
                if "Policies" in body:
                    t.policies = list(body["Policies"] or [])
                if "Type" in body:
                    t.type = body["Type"]
            else:
                t = ACLToken(
                    name=body.get("Name", ""),
                    type=body.get("Type", "client"),
                    policies=body.get("Policies") or [],
                )
            if "Global" in body:
                t.global_ = bool(body["Global"])
            return self.rpc_region("ACL.token_create", {"token": t})

        def acl_token_get(p, q, body, tok):
            t = self.rpc_region(
                "ACL.token_get", {"accessor_id": p["id"]}
            )
            if t is None:
                raise HTTPError(404, f"token {p['id']} not found")
            return t

        def acl_token_delete(p, q, body, tok):
            self.rpc_region(
                "ACL.token_delete", {"accessor_ids": [p["id"]]}
            )
            return {}

        def acl_token_self(p, q, body, tok):
            t = self.cluster.server.state.acl_token_by_secret(tok)
            if t is None:
                raise HTTPError(404, "token not found")
            return t

        route("PUT", "/v1/acl/bootstrap", acl_bootstrap)
        route("POST", "/v1/acl/bootstrap", acl_bootstrap)
        route("GET", "/v1/acl/policies", acl_policies)
        route("GET", "/v1/acl/policy/(?P<name>[^/]+)", acl_policy_get)
        route("PUT", "/v1/acl/policy/(?P<name>[^/]+)", acl_policy_put)
        route("DELETE", "/v1/acl/policy/(?P<name>[^/]+)", acl_policy_delete)
        route("GET", "/v1/acl/tokens", acl_tokens)
        route("PUT", "/v1/acl/token", acl_token_put)
        route("GET", "/v1/acl/token/self", acl_token_self)
        route("GET", "/v1/acl/token/(?P<id>[^/]+)", acl_token_get)
        route("DELETE", "/v1/acl/token/(?P<id>[^/]+)", acl_token_delete)

        # -- client fs (non-streaming halves) --------------------------
        def client_fs_ls(p, q, body, tok):
            alloc = self._resolve_alloc(p["id"])
            self._ns_guard(tok, alloc.namespace, "read-fs")
            msg = self._client_roundtrip(
                alloc, "FS.ls", {"path": q.get("path", [""])[0]}
            )
            return msg.get("entries", [])

        def client_fs_stat(p, q, body, tok):
            alloc = self._resolve_alloc(p["id"])
            self._ns_guard(tok, alloc.namespace, "read-fs")
            msg = self._client_roundtrip(
                alloc, "FS.stat", {"path": q.get("path", [""])[0]}
            )
            return msg.get("stat")

        route("GET", "/v1/client/fs/ls/(?P<id>[^/]+)", client_fs_ls)
        route("GET", "/v1/client/fs/stat/(?P<id>[^/]+)", client_fs_stat)

        # -- alloc lifecycle (reference client/alloc_endpoint.go + the
        # server-side Stop in nomad/alloc_endpoint.go) ----------------
        def alloc_restart(p, q, body, tok):
            alloc = self._resolve_alloc(p["id"])
            self._ns_guard(tok, alloc.namespace, "alloc-lifecycle")
            msg = self._client_roundtrip(
                alloc, "Alloc.restart",
                {"task": (body or {}).get("TaskName", "")},
            )
            return {"ok": bool(msg.get("ok"))}

        def alloc_signal(p, q, body, tok):
            alloc = self._resolve_alloc(p["id"])
            self._ns_guard(tok, alloc.namespace, "alloc-lifecycle")
            msg = self._client_roundtrip(
                alloc, "Alloc.signal",
                {
                    "task": (body or {}).get("TaskName", ""),
                    "signal": (body or {}).get("Signal", "SIGTERM"),
                },
            )
            return {"ok": bool(msg.get("ok"))}

        def alloc_stop(p, q, body, tok):
            # stop is a pure server-side raft op: resolve from STATE, not
            # the client-streaming resolver — stopping an alloc off a
            # dead/unreachable node is exactly when this gets used
            if other_region():
                eval_id = self.rpc_region(
                    "Alloc.stop", {"alloc_id": p["id"]}
                )
                return {"EvalID": eval_id}
            try:
                alloc = self.cluster.find_alloc(p["id"])
            except LookupError as e:
                raise HTTPError(404, str(e)) from None
            self._ns_guard(tok, alloc.namespace, "alloc-lifecycle")
            eval_id = self.rpc_region("Alloc.stop", {"alloc_id": alloc.id})
            return {"EvalID": eval_id}

        def alloc_stats(p, q, body, tok):
            # reference: GET /v1/client/allocation/:id/stats
            # (client/alloc_endpoint.go Stats → AllocResourceUsage)
            alloc = self._resolve_alloc(p["id"])
            self._ns_guard(tok, alloc.namespace, "read-job")
            return self._client_roundtrip(alloc, "Alloc.stats", {})

        route(
            "GET", "/v1/client/allocation/(?P<id>[^/]+)/stats", alloc_stats
        )
        route(
            "PUT", "/v1/client/allocation/(?P<id>[^/]+)/restart",
            alloc_restart,
        )
        route(
            "POST", "/v1/client/allocation/(?P<id>[^/]+)/restart",
            alloc_restart,
        )
        route(
            "PUT", "/v1/client/allocation/(?P<id>[^/]+)/signal",
            alloc_signal,
        )
        route(
            "POST", "/v1/client/allocation/(?P<id>[^/]+)/signal",
            alloc_signal,
        )
        route("PUT", "/v1/allocation/(?P<id>[^/]+)/stop", alloc_stop)
        route("POST", "/v1/allocation/(?P<id>[^/]+)/stop", alloc_stop)

        # -- system ----------------------------------------------------
        def system_gc(p, q, body, tok):
            self.rpc_region("Operator.force_gc", {})
            return None

        def system_reconcile(p, q, body, tok):
            n = self.rpc_region("System.reconcile_summaries", {})
            return {"Reconciled": n}

        route("PUT", "/v1/system/gc", system_gc)
        route("POST", "/v1/system/gc", system_gc)
        route(
            "PUT", "/v1/system/reconcile/summaries", system_reconcile
        )
        route(
            "POST", "/v1/system/reconcile/summaries", system_reconcile
        )

        # -- operator --------------------------------------------------
        def scheduler_config_get(p, q, body, tok):
            return self.rpc_region("Operator.scheduler_get_config", {})

        def scheduler_config_set(p, q, body, tok):
            return self.rpc_region(
                "Operator.scheduler_set_config", {"config": body or {}}
            )

        route(
            "GET", "/v1/operator/scheduler/configuration",
            scheduler_config_get,
        )
        route(
            "PUT", "/v1/operator/scheduler/configuration",
            scheduler_config_set,
        )
        route(
            "POST", "/v1/operator/scheduler/configuration",
            scheduler_config_set,
        )

        def operator_snapshot_save(p, q, body, tok):
            import base64

            resp = self.rpc_region("Operator.snapshot_save", {})
            return {"Snapshot": base64.b64encode(resp["snapshot"]).decode()}

        def operator_snapshot_restore(p, q, body, tok):
            import base64

            data = base64.b64decode(body["Snapshot"])
            return self.rpc_region(
                "Operator.snapshot_restore", {"data": data}
            )

        def operator_raft_remove_peer(p, q, body, tok):
            peer = q.get("id", [""])[0] or (body or {}).get("ID", "")
            if not peer:
                raise HTTPError(400, "peer id required")
            self.rpc_region(
                "Operator.raft_remove_peer", {"peer_id": peer}
            )
            return None

        def operator_raft_config(p, q, body, tok):
            return self.rpc_region("Operator.raft_configuration", {})

        route("GET", "/v1/operator/snapshot", operator_snapshot_save)
        route("PUT", "/v1/operator/snapshot", operator_snapshot_restore)
        route("POST", "/v1/operator/snapshot", operator_snapshot_restore)
        def operator_cluster_health(p, q, body, tok):
            # /v1/operator/cluster/health: leader-side telemetry
            # federation (cluster.py cluster_health) — every member's
            # raft indices / broker + plan-queue depths / host CPU+RSS /
            # per-source cost top-K, with partitioned members flagged
            # `degraded` under a bounded per-peer deadline. agent:read
            # like the other observability surfaces (acl/enforce.py),
            # throttle-exempt so the dashboard stays readable during
            # the incident it diagnoses.
            try:
                timeout_s = float(q.get("timeout", ["2.0"])[0])
            except ValueError:
                raise HTTPError(400, "timeout must be a number")
            try:
                top = int(q.get("top", ["5"])[0])
            except ValueError:
                raise HTTPError(400, "top must be an integer")
            return self.cluster.cluster_health(
                per_peer_timeout_s=timeout_s, top=top
            )

        route(
            "GET", "/v1/operator/cluster/health", operator_cluster_health
        )
        route("GET", "/v1/operator/raft/configuration", operator_raft_config)
        route(
            "DELETE", "/v1/operator/raft/peer", operator_raft_remove_peer
        )

        def autopilot_get(p, q, body, tok):
            return self.rpc_region("Operator.autopilot_get_config", {})

        def autopilot_set(p, q, body, tok):
            return self.rpc_region(
                "Operator.autopilot_set_config", {"config": body or {}}
            )

        def agent_force_leave(p, q, body, tok):
            member = q.get("node", [""])[0]
            if not member:
                raise HTTPError(400, "node query param required")
            acked = self.rpc_region(
                "Operator.force_leave", {"member_id": member}
            )
            return {"Acked": acked}

        route(
            "GET", "/v1/operator/autopilot/configuration", autopilot_get
        )
        route(
            "PUT", "/v1/operator/autopilot/configuration", autopilot_set
        )
        route(
            "POST", "/v1/operator/autopilot/configuration", autopilot_set
        )
        route("PUT", "/v1/agent/force-leave", agent_force_leave)
        route("POST", "/v1/agent/force-leave", agent_force_leave)

        route("GET", "/v1/status/leader", status_leader)
        route("GET", "/v1/status/peers", status_peers)
        route("GET", "/v1/regions", regions_list)
        route("GET", "/v1/metrics", agent_metrics)
        # pprof analogs (reference command/agent/pprof, behind agent:read
        # via the /v1/agent/ ACL prefix)
        route("GET", "/v1/agent/pprof/goroutine", pprof_goroutine)
        route("GET", "/v1/agent/pprof/profile", pprof_profile)
        route("GET", "/v1/agent/pprof/heap", pprof_heap)
        route("GET", "/v1/agent/members", agent_members)
        route("GET", "/v1/agent/self", agent_self)
        route("GET", "/v1/agent/keyring", agent_keyring)
        route("PUT", "/v1/agent/keyring/rotate", agent_keyring_rotate)
        route("POST", "/v1/agent/keyring/rotate", agent_keyring_rotate)
        route("GET", "/v1/agent/monitor", agent_monitor)
        route("GET", "/v1/agent/health", agent_health)
        route("PUT", "/v1/agent/join", agent_join)
        route("POST", "/v1/agent/join", agent_join)

    # -- event stream (long-lived NDJSON response) ---------------------

    # -- browser exec (WebSocket bridge to the fabric exec stream) ------

    def _serve_exec_ws(self, handler, alloc_id, query, token) -> None:
        """RFC6455 WebSocket endpoint bridging a browser terminal to the
        fabric's interactive exec stream (reference: the Ember UI's
        /v1/client/allocation/:id/exec websocket, bridged to the same
        streaming RPC the CLI uses). Message protocol, JSON text frames:
        client -> {"stdin": <b64>}; server -> {"stdout": <b64>},
        {"error": str}, {"exit": true}. The browser cannot set
        X-Nomad-Token on a websocket, so ?token= is accepted here (as
        the reference does for its ws_handshake)."""
        import base64
        import hashlib
        import struct
        import threading

        alloc = self._resolve_alloc(alloc_id)
        self._ns_guard(token, alloc.namespace, "alloc-exec")
        key = handler.headers.get("Sec-WebSocket-Key", "")
        if not key:
            raise HTTPError(400, "missing Sec-WebSocket-Key")
        accept = base64.b64encode(
            hashlib.sha1(
                (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
            ).digest()
        ).decode()
        conn = handler.connection
        # exec sessions are long-lived and a browser sends nothing while
        # the user watches output — the handler's 120s read timeout must
        # not tear the session down
        conn.settimeout(None)
        conn.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept.encode() + b"\r\n\r\n"
        )
        handler.close_connection = True
        # one writer at a time: output frames (pump thread) and pong /
        # close frames (reader thread) must never interleave mid-frame
        wlock = threading.Lock()

        def raw_send(data: bytes) -> None:
            with wlock:
                conn.sendall(data)

        def ws_send(obj) -> None:
            payload = json.dumps(obj).encode()
            head = bytearray([0x81])  # FIN + text
            n = len(payload)
            if n < 126:
                head.append(n)
            elif n < 65536:
                head.append(126)
                head += struct.pack(">H", n)
            else:
                head.append(127)
                head += struct.pack(">Q", n)
            raw_send(bytes(head) + payload)

        rfile = handler.rfile

        def ws_recv():
            """One frame -> (opcode, payload) or None on EOF."""
            hdr = rfile.read(2)
            if len(hdr) < 2:
                return None
            opcode = hdr[0] & 0x0F
            masked = hdr[1] & 0x80
            n = hdr[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", rfile.read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", rfile.read(8))[0]
            mask = rfile.read(4) if masked else b""
            data = rfile.read(n) if n else b""
            if masked and data:
                data = bytes(
                    b ^ mask[i % 4] for i, b in enumerate(data)
                )
            return opcode, data

        cmd = query.get("command", []) or ["/bin/sh"]
        task = query.get("task", [""])[0]
        tty = query.get("tty", ["false"])[0] == "true"
        try:
            session = self.cluster.pool.stream(
                self.cluster.rpc.addr,
                "ClientExec.exec",
                {
                    "alloc_id": alloc.id,
                    "task": task,
                    "cmd": list(cmd),
                    "tty": tty,
                    "token": token,
                },
            )
        except Exception as e:
            # the 101 already went out: any failure from here on must be
            # a websocket frame, never HTTP bytes into the upgraded stream
            try:
                ws_send({"error": f"exec stream failed: {e}"})
                raw_send(b"\x88\x00")
            except OSError:
                pass
            return
        done = threading.Event()

        def pump_output() -> None:
            try:
                while not done.is_set():
                    try:
                        msg = session.recv(timeout_s=0.5)
                    except TimeoutError:
                        continue
                    except (ConnectionError, OSError):
                        break
                    if msg is None:
                        continue
                    if msg.get("error"):
                        ws_send({"error": msg["error"]})
                        break
                    data = msg.get("data")
                    if data:
                        ws_send(
                            {
                                "stdout": base64.b64encode(data).decode()
                            }
                        )
                    if msg.get("eof"):
                        ws_send({"exit": True})
                        break
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                done.set()
                try:
                    raw_send(b"\x88\x00")  # close frame
                except OSError:
                    pass

        t = threading.Thread(
            target=pump_output, name="ws-exec-out", daemon=True
        )
        t.start()
        try:
            while not done.is_set():
                frame = ws_recv()
                if frame is None:
                    break
                opcode, data = frame
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping -> pong
                    raw_send(b"\x8a" + bytes([len(data)]) + data)
                    continue
                if opcode != 0x1 or not data:
                    continue
                try:
                    msg = json.loads(data)
                except ValueError:
                    continue
                if "stdin" in msg:
                    session.send(
                        {"stdin": base64.b64decode(msg["stdin"])}
                    )
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            done.set()
            try:
                session.send({"eof": True})
            except (ConnectionError, OSError):
                pass
            session.close()
            t.join(timeout=2)

    def _serve_event_stream(self, handler, query) -> None:
        topics: dict[str, list[str]] = {}
        for t in query.get("topic", []):
            if ":" in t:
                topic, key = t.split(":", 1)
            else:
                topic, key = t, "*"
            topics.setdefault(topic, []).append(key)
        index = int(query.get("index", ["0"])[0])
        # Namespace defaults differ by mode: with ACLs enforced the stream
        # is scoped to one namespace ("default" unless asked); "*" (all)
        # is management-only and checked by the resolver. Without ACLs,
        # default to everything — the convenient open-mode behavior.
        if self.acl_resolver is not None:
            ns = query.get("namespace", ["default"])[0]
            if ns == "*":
                ns = ""
        else:
            ns = query.get("namespace", [""])[0]
        sub = self.cluster.server.event_broker.subscribe(
            topics or None, from_index=index, namespace=ns
        )
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        def write_chunk(data: bytes) -> None:
            handler.wfile.write(f"{len(data):x}\r\n".encode())
            handler.wfile.write(data + b"\r\n")
            handler.wfile.flush()

        def conn_alive() -> bool:
            # A quiet stream only touches the socket at heartbeat time,
            # so a streamer whose connection died parks its thread (and
            # its broker subscription) until the next write. Probe
            # between events: readable + empty MSG_PEEK = peer closed
            # (a streaming GET never pipelines more request bytes).
            try:
                readable, _w, _x = select.select(
                    [handler.connection], [], [], 0
                )
                if not readable:
                    return True
                return handler.connection.recv(1, socket.MSG_PEEK) != b""
            except (OSError, ValueError):
                return False

        last_write = time.monotonic()
        try:
            while True:
                try:
                    # short hold: bounds how long a dead connection can
                    # pin a subscription between liveness probes
                    events = sub.next(timeout_s=2.0)
                except SubscriptionClosedError:
                    return
                if not events:
                    if not conn_alive():
                        metrics.incr("nomad.stream.reaped")
                        return
                    if time.monotonic() - last_write >= 10.0:
                        write_chunk(b"{}\n")  # heartbeat (reference sends {})
                        last_write = time.monotonic()
                    continue
                payload = {
                    "Index": events[-1].index,
                    "Events": [
                        {
                            "Topic": e.topic,
                            "Type": e.type,
                            "Key": e.key,
                            "Namespace": e.namespace,
                            "Index": e.index,
                            "Payload": codec.to_wire(e.payload),
                        }
                        for e in events
                    ],
                }
                write_chunk(json.dumps(payload, default=_json_default).encode() + b"\n")
                last_write = time.monotonic()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            sub.close()
            try:
                write_chunk(b"")
            except OSError:
                pass

    # -- client fs/logs streaming (reference client_fs_endpoint.go) ----

    def _resolve_alloc(self, alloc_id: str):
        try:
            alloc, _ = self.cluster.find_alloc_client(alloc_id)
        except LookupError as e:
            raise HTTPError(
                400 if "ambiguous" in str(e) else 404, str(e)
            ) from e
        return alloc

    def _client_session(self, alloc, method: str, header: dict):
        """Dial the alloc's client agent (advertised node attr) and open
        a stream — the server half of the 4-boundary streaming path."""
        try:
            _, addr = self.cluster.find_alloc_client(alloc.id)
        except LookupError as e:
            raise HTTPError(404, str(e)) from e
        header = dict(header)
        header["alloc_id"] = alloc.id
        try:
            session = self.cluster.pool.stream(addr, method, header)
        except (ConnectionError, OSError) as e:
            # NAT/firewall fallback (reference client_rpc.go): open the
            # stream over a connection the client parked on this server.
            session = self.cluster.take_reverse_session(
                alloc.node_id, method, header
            )
            if session is None:
                raise HTTPError(
                    502,
                    f"client agent unreachable ({e}) and no reverse "
                    f"session parked for node {alloc.node_id[:8]}",
                )
        # Track live relay sessions (telemetry + the /v1/metrics gauge):
        # wrap close() so every exit path decrements exactly once.
        with self._relay_lock:
            if self._relay_active >= self._relay_max:
                session.close()
                raise HTTPError(
                    429,
                    f"too many concurrent client streams "
                    f"({self._relay_max}); retry shortly",
                )
            self._relay_active += 1
            metrics.set_gauge(
                "nomad.http.relay_sessions_active", self._relay_active
            )
        metrics.incr("nomad.http.relay_sessions_total")
        orig_close = session.close
        closed = [False]

        def tracked_close():
            with self._relay_lock:
                if not closed[0]:
                    closed[0] = True
                    self._relay_active -= 1
                    metrics.set_gauge(
                        "nomad.http.relay_sessions_active", self._relay_active
                    )
            orig_close()

        session.close = tracked_close
        return session

    def _serve_monitor(self, handler, query) -> None:
        """Stream the agent's own log records as NDJSON (reference
        command/agent/monitor: `nomad monitor` tails agent logs over
        HTTP). A queue-backed logging.Handler attaches for the life of
        the request; disconnect detaches it."""
        import logging as _logging
        import queue as _queue

        level = getattr(
            _logging,
            query.get("log_level", ["INFO"])[0].upper(),
            _logging.INFO,
        )
        q: "_queue.Queue" = _queue.Queue(maxsize=512)

        class _QueueHandler(_logging.Handler):
            def emit(self, record):
                try:
                    q.put_nowait({
                        "Level": record.levelname,
                        "Name": record.name,
                        "Message": record.getMessage(),
                        "Time": record.created,
                    })
                except _queue.Full:
                    pass  # slow consumer: drop, never block the logger

        qh = _QueueHandler(level=level)
        root = _logging.getLogger()
        # Concurrent monitors must not fight over the root level: keep a
        # refcounted set of requested levels; the root runs at the min
        # of (original, active requests) and restores the original only
        # when the LAST monitor detaches.
        with self._monitor_lock:
            if not self._monitor_levels:
                self._monitor_base_level = root.level
            self._monitor_levels.append(level)
            root.setLevel(min(self._monitor_base_level, *self._monitor_levels))
        root.addHandler(qh)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def chunk(data: bytes) -> None:
                handler.wfile.write(
                    f"{len(data):x}\r\n".encode() + data + b"\r\n"
                )
                handler.wfile.flush()

            while True:
                try:
                    rec = q.get(timeout=10.0)
                except _queue.Empty:
                    chunk(b"{}\n")  # keepalive; detects dead consumers
                    continue
                chunk((json.dumps(rec) + "\n").encode())
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            root.removeHandler(qh)
            with self._monitor_lock:
                self._monitor_levels.remove(level)
                if self._monitor_levels:
                    root.setLevel(
                        min(self._monitor_base_level, *self._monitor_levels)
                    )
                else:
                    root.setLevel(self._monitor_base_level)

    def _client_roundtrip(self, alloc, method: str, header: dict) -> dict:
        session = self._client_session(alloc, method, header)
        try:
            # short: a one-shot ls/stat against a local file — a slow
            # client agent must not pin an HTTP worker for 30s
            msg = session.recv(timeout_s=10)
        except TimeoutError:
            raise HTTPError(504, "client agent timed out")
        finally:
            session.close()
        if msg.get("error"):
            raise HTTPError(500, msg["error"])
        return msg

    def _serve_fs_raw(self, handler, alloc_id: str, method: str, header: dict):
        """Relay a client byte stream as a chunked HTTP response
        (logs/cat; follow=true keeps the connection open)."""
        alloc = self._resolve_alloc(alloc_id)
        session = self._client_session(alloc, method, header)
        started = False
        try:
            while True:
                try:
                    msg = session.recv(timeout_s=60)
                except (TimeoutError, ConnectionError, OSError):
                    break
                if msg.get("error"):
                    if not started:
                        raise HTTPError(500, msg["error"])
                    break
                if not started:
                    handler.send_response(200)
                    handler.send_header(
                        "Content-Type", "application/octet-stream"
                    )
                    handler.send_header("Transfer-Encoding", "chunked")
                    handler.end_headers()
                    started = True
                data = msg.get("data")
                if data:
                    handler.wfile.write(f"{len(data):x}\r\n".encode())
                    handler.wfile.write(data + b"\r\n")
                    handler.wfile.flush()
                if msg.get("eof"):
                    break
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            session.close()
            if started:
                try:
                    handler.wfile.write(b"0\r\n\r\n")
                    handler.wfile.flush()
                except OSError:
                    pass
        if not started:
            raise HTTPError(502, "no data from client agent")

    # -- the handler class ---------------------------------------------

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # bounds half-open connections AND the deferred TLS
            # handshake; long-lived streams (event stream, monitor,
            # logs -f) manage their own cadence under this
            timeout = 120

            def log_message(self, fmt, *args):  # quiet
                logger.debug("http: " + fmt, *args)

            def _dispatch(self, method: str) -> None:
                parsed = urlparse(self.path)
                query = parse_qs(parsed.query)
                _REQ_REGION.set(query.get("region", [""])[0])
                token = self.headers.get("X-Nomad-Token", "")
                _REQ_TOKEN.set(token)
                # Drain the body up front: on keep-alive connections an
                # unread body (404 path, ACL reject) would desync the
                # next request on the same socket.
                raw_body = b""
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw_body = self.rfile.read(length)
                # UI static shell (reference: http.go serves the Ember
                # app at /ui with / redirecting there). No auth: the
                # shell is public; every API call it makes carries the
                # operator's token.
                if method == "GET" and (
                    parsed.path == "/"
                    or parsed.path == "/ui"
                    or parsed.path.startswith("/ui/")
                ):
                    if parsed.path == "/":
                        self.send_response(307)
                        self.send_header("Location", "/ui/")
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    from .ui import INDEX_HTML

                    data = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/html; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                try:
                    # Front-door rate limit BEFORE token resolution and
                    # routing: during overload, rejected requests must
                    # cost as little as possible (observability routes
                    # are exempt — see _THROTTLE_EXEMPT).
                    outer._throttle_check(parsed.path, query, raw_body)
                    exec_m = re.match(
                        r"^/v1/client/allocation/(?P<id>[^/]+)/exec$",
                        parsed.path,
                    )
                    if (
                        method == "GET"
                        and exec_m
                        and "websocket"
                        in (self.headers.get("Upgrade") or "").lower()
                    ):
                        # BEFORE the generic resolver: browsers cannot
                        # set X-Nomad-Token on a websocket, so the token
                        # may ride ?token= — _serve_exec_ws enforces
                        # alloc-exec on the alloc's own namespace itself
                        outer._serve_exec_ws(
                            self,
                            exec_m.group("id"),
                            query,
                            token or query.get("token", [""])[0],
                        )
                        return
                    if outer.acl_resolver is not None:
                        from ..acl.enforce import AuthError

                        try:
                            outer.acl_resolver(
                                method, parsed.path, token, query, raw_body
                            )
                        except AuthError as ae:
                            raise HTTPError(ae.status, ae.message)
                    if parsed.path == "/v1/event/stream":
                        outer._serve_event_stream(self, query)
                        return
                    if parsed.path == "/v1/agent/monitor":
                        outer._serve_monitor(self, query)
                        return
                    fs_m = re.match(
                        r"^/v1/client/fs/(logs|cat)/(?P<id>[^/]+)$",
                        parsed.path,
                    )
                    if method == "GET" and fs_m:
                        alloc = outer._resolve_alloc(fs_m.group("id"))
                        if fs_m.group(1) == "logs":
                            outer._ns_guard(token, alloc.namespace, "read-logs")
                            hdr = {
                                "task": query.get("task", [""])[0],
                                "type": query.get("type", ["stdout"])[0],
                                "follow": query.get("follow", ["false"])[0]
                                == "true",
                                "origin": query.get("origin", ["start"])[0],
                                "offset": int(query.get("offset", ["0"])[0]),
                            }
                            outer._serve_fs_raw(self, alloc.id, "FS.logs", hdr)
                        else:
                            outer._ns_guard(token, alloc.namespace, "read-fs")
                            hdr = {"path": query.get("path", [""])[0]}
                            outer._serve_fs_raw(self, alloc.id, "FS.cat", hdr)
                        return
                    for m, pattern, fn, mlabel in outer._routes:
                        if m != method:
                            continue
                        match = pattern.match(parsed.path)
                        if match is None:
                            continue
                        t0 = time.perf_counter()
                        try:
                            self._run_route(
                                fn, match, query, raw_body, token, method,
                                parsed,
                            )
                        finally:
                            metrics.observe(
                                mlabel, time.perf_counter() - t0
                            )
                        return
                    self._reply(404, {"error": f"no route {method} {parsed.path}"})
                except HTTPError as e:
                    payload = {"error": e.message}
                    if e.retry_after is not None:
                        payload["retry_after_s"] = round(e.retry_after, 3)
                    self._reply(
                        e.status, payload, retry_after=e.retry_after
                    )
                except ConflictError as e:
                    # Expected operational rejections (e.g. re-running acl
                    # bootstrap): client error, not a 500.
                    self._reply(400, {"error": str(e)})
                except PermissionError as e:
                    # federated/endpoint-level ACL denials (e.g. the
                    # target region's cross-region precheck)
                    self._reply(403, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:
                    throttled = outer._map_throttle_error(e)
                    if throttled is not None:
                        payload = {"error": throttled.message}
                        if throttled.retry_after is not None:
                            payload["retry_after_s"] = round(
                                throttled.retry_after, 3
                            )
                        self._reply(
                            throttled.status,
                            payload,
                            retry_after=throttled.retry_after,
                        )
                        return
                    logger.exception("http handler failed")
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _run_route(
                self, fn, match, query, raw_body, token, method, parsed
            ) -> None:
                body = json.loads(raw_body or b"{}")
                # Write requests open a trace when tracing is on:
                # the RPC fabric forwards the context, so a
                # submit on a follower stitches through to the
                # leader's raft apply (trace.py).
                hctx = None
                if method != "GET":
                    from .. import trace as _trace

                    hctx = _trace.start_trace(
                        "http", method=method, path=parsed.path
                    )
                if hctx is not None:
                    try:
                        with _trace.use(hctx):
                            result = fn(
                                match.groupdict(), query, body, token
                            )
                    except BaseException as e:
                        # a failed write must not be recorded as
                        # status=ok — the surface exists to debug
                        # exactly these
                        hctx.set_attr("error", type(e).__name__)
                        hctx.finish("error")
                        raise
                    hctx.finish()
                else:
                    result = fn(match.groupdict(), query, body, token)
                index = None
                if isinstance(result, tuple):
                    result, index = result
                if isinstance(result, RawResponse):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", result.content_type
                    )
                    self.send_header(
                        "Content-Length", str(len(result.data))
                    )
                    self.end_headers()
                    self.wfile.write(result.data)
                    return
                self._reply(200, codec.to_wire(result), index)

            def _reply(self, status: int, payload,
                       index: Optional[int] = None,
                       retry_after: Optional[float] = None):
                data = json.dumps(payload, default=_json_default).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                if retry_after is not None:
                    # RFC 9110 delay-seconds is integral; sub-second
                    # precision rides in the JSON body (retry_after_s)
                    import math as _math

                    self.send_header(
                        "Retry-After",
                        str(max(1, int(_math.ceil(retry_after)))),
                    )
                # gzip negotiation (reference command/agent/http.go:248
                # wraps every handler in gziphandler): list payloads at
                # cluster scale compress ~10x; tiny replies skip the
                # header+CPU cost. Vary tells caches the body depends on
                # the request encoding; q=0 is an explicit refusal.
                self.send_header("Vary", "Accept-Encoding")
                if len(data) > 1024 and _accepts_gzip(
                    self.headers.get("Accept-Encoding")
                ):
                    import gzip as _gzip

                    data = _gzip.compress(data, compresslevel=1)
                    self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(len(data)))
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

        return Handler


def _accepts_gzip(header: Optional[str]) -> bool:
    """Accept-Encoding negotiation for gzip: present and not q=0."""
    for part in (header or "").split(","):
        toks = [t.strip() for t in part.split(";")]
        if not toks or toks[0] != "gzip":
            continue
        for t in toks[1:]:
            if t.startswith("q="):
                try:
                    return float(t[2:]) > 0
                except ValueError:
                    return True
        return True
    return False


def _parse_wait(raw: str) -> float:
    """'5s' / '1m' / '500ms' / plain seconds (reference parses duration)."""
    raw = raw.strip()
    if not raw or raw == "0":
        return 0.0
    if raw.endswith("ms"):
        return float(raw[:-2]) / 1000.0
    if raw.endswith("s"):
        return float(raw[:-1])
    if raw.endswith("m"):
        return float(raw[:-1]) * 60.0
    return float(raw)
