"""The agent process: embedded server and/or client plus the HTTP API.

Port of ``nomad_tpu/agent/agent.py``. Reference:
command/agent/agent.go + command/agent/command.go — `nomad agent` reads
config, conditionally starts an in-process server and/or client, wires
them together (a co-located client talks to its own server first), and
serves HTTP.

The agent runs a server, a client, or both. A co-located client talks
to its own server through the cluster endpoints (``InProcessClusterRPC``);
a client-only agent dials its servers over the RPC fabric
(``ClusterRPC``). ``AgentConfig.device`` names the card the server's
schedulers solve on ("cuda" unless the caller asks for "cpu"); it goes
into the ``SchedulerConfig`` the ``ClusterServer`` hands its ``Server``,
and "cuda" with no card raises at construction, as the solver does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from ..client import Client
from ..client.client import default_data_dir
from ..scheduler.context import SchedulerConfig
from ..server.cluster import ClusterRPC, ClusterServer

logger = logging.getLogger("nomad_tpu_torch.agent")

class InProcessClusterRPC:
    """Client→server verbs dispatched through the local ClusterServer's
    forwarding endpoints (no socket hop; leader forwarding intact)."""

    def __init__(self, cluster: ClusterServer) -> None:
        self.cluster = cluster

    def reverse_addrs(self) -> list:
        """The co-located server's fabric addr: reverse sessions parked
        there serve streams even when the advertised forward-dial
        address is unreachable."""
        return [tuple(self.cluster.rpc.addr)]

    def register(self, node) -> float:
        return self.cluster.rpc_self("Node.register", {"node": node})

    def alloc_client_addr(self, alloc_id: str):
        out = self.cluster.rpc_self("Alloc.client_addr", {"alloc_id": alloc_id})
        return tuple(out) if out else (None, None)

    def heartbeat(self, node_id: str) -> float:
        return self.cluster.rpc_self("Node.heartbeat", {"node_id": node_id})

    def get_client_allocs(self, node_id: str, min_index: int, timeout_s: float):
        resp = self.cluster.rpc_self(
            "Node.get_client_allocs",
            {"node_id": node_id, "min_index": min_index, "timeout_s": timeout_s},
        )
        return resp["allocs"], resp["index"]

    def update_allocs(self, allocs) -> None:
        self.cluster.rpc_self("Node.update_allocs", {"allocs": allocs})

    def volumes_for_alloc(self, alloc_id: str) -> list:
        return self.cluster.rpc_self(
            "Volume.for_alloc", {"alloc_id": alloc_id}
        )

    def services_register(self, regs: list) -> None:
        self.cluster.rpc_self("Service.register", {"regs": regs})

    def services_deregister_alloc(self, alloc_id: str) -> None:
        self.cluster.rpc_self(
            "Service.deregister_alloc", {"alloc_id": alloc_id}
        )

    def service_lookup(self, namespace: str, name: str) -> list:
        return self.cluster.rpc_self(
            "Service.get", {"namespace": namespace, "name": name}
        )

    def secret_read(self, namespace: str, path: str, token: str = ""):
        return self.cluster.rpc_self(
            "Secrets.read",
            {"namespace": namespace, "path": path, "token": token},
        )

    def derive_token(self, alloc_id: str, task_name: str) -> dict:
        return self.cluster.rpc_self(
            "Secrets.derive_token",
            {"alloc_id": alloc_id, "task_name": task_name},
        )

    def renew_token(self, accessor_id: str) -> float:
        return self.cluster.rpc_self(
            "Secrets.renew_token", {"accessor_id": accessor_id}
        )

    def revoke_token(self, accessor_id: str) -> None:
        self.cluster.rpc_self(
            "Secrets.revoke_token", {"accessor_id": accessor_id}
        )


def _tls_fingerprint(cert_file: str, key_file: str, ca_file: str = "") -> str:
    """Content hash of the TLS material triple — reload() compares it to
    detect in-place cert rotation (same paths, new bytes)."""
    import hashlib

    hsh = hashlib.sha256()
    for path in (cert_file, key_file, ca_file):
        if path:
            try:
                with open(path, "rb") as f:
                    hsh.update(f.read())
            except OSError:
                pass
    return hsh.hexdigest()


@dataclass
class AgentConfig:
    """Reference: command/agent/config.go (subset; grows with features)."""

    node_name: str = ""
    region: str = "global"
    datacenter: str = "dc1"
    data_dir: str = field(default_factory=default_data_dir)
    bind_addr: str = "127.0.0.1"
    # server stanza
    server_enabled: bool = False
    bootstrap_expect: int = 1
    rpc_port: int = 0  # 0 = ephemeral (reference default 4647)
    # client stanza
    client_enabled: bool = False
    client_servers: list = field(default_factory=list)  # [(host, port)]
    node_class: str = ""
    # CSI plugins: plugin_id -> builtin catalog name | "module:Class" ref
    csi_plugins: dict = field(default_factory=dict)
    # exec driver chroot map {host_src: dst_in_chroot} (reference:
    # client config chroot_env — operator-owned, never jobspec)
    chroot_env: dict = field(default_factory=dict)
    # operator-registered host volumes: name -> {path, read_only}
    # (reference: client config host_volume stanzas feed
    # Node.HostVolumes for the scheduler's HostVolumeChecker)
    host_volumes: dict = field(default_factory=dict)
    # static node metadata (reference: client config meta — constraint
    # and spread targets)
    node_meta: dict = field(default_factory=dict)
    # capacity carved out for the OS/agent (reference: client config
    # reserved stanza — subtracted from what the scheduler may pack)
    reserved: dict = field(default_factory=dict)
    # external task-driver plugins: driver name -> "module:Class" factory
    # ref, launched out-of-process over the plugin fabric (reference:
    # the go-plugin catalog, plugins/serve.go + helper/pluginutils)
    driver_plugins: dict = field(default_factory=dict)
    # external device plugins: name -> "module:Class" or
    # {"factory": ref, "config": {...}} (reference: plugins/device)
    device_plugins: dict = field(default_factory=dict)
    # http
    http_port: int = 0  # reference default 4646
    # scheduler
    num_schedulers: int = 2
    use_tpu_batch_worker: bool = False
    # the torch device the server's schedulers solve on: "cuda" (the
    # card) unless the caller asks for "cpu" (the kernels' plain twins)
    device: str = "cuda"
    # which eval types this server's workers serve (reference
    # EnabledSchedulers, config.go:159); None = all
    enabled_schedulers: Optional[list] = None
    # retry_join seeds (serf)
    server_join: list = field(default_factory=list)
    # acl stanza
    acl_enabled: bool = False
    # cluster shared secret authenticating the RPC fabric (rpc/server.py
    # trust-boundary note); empty ⇒ dev-mode trust-the-network.
    # Changing it in the config file + SIGHUP rotates the LIVE keyring
    # (Agent.reload): the old secret stays accepted for
    # rpc_secret_window_s while the rollout reaches every agent
    # (rpc/keyring.py dual-accept window).
    rpc_secret: str = ""
    rpc_secret_window_s: float = 60.0
    # dev mode: in-memory raft (the reference's -dev is ephemeral too)
    dev_mode: bool = False
    # pprof surface (reference enable_debug: off unless dev mode)
    enable_debug: bool = False
    # vault stanza: operator allowlist for task-derivable secret-token
    # policies (None = unrestricted, the reference default)
    vault_allowed_policies: Optional[list] = None
    # tls stanza (reference config tls { http rpc cert_file key_file
    # ca_file }): http serves the API over HTTPS; rpc wraps the fabric
    # (below) — the shared secret still authenticates when set
    tls_http: bool = False
    tls_cert_file: str = ""
    tls_key_file: str = ""
    # tls { rpc = true }: wrap the whole RPC fabric (server<->server,
    # server<->client, reverse-dial) in TLS; ca_file enables mTLS peer
    # verification (reference verify_incoming/verify_outgoing)
    tls_rpc: bool = False
    tls_ca_file: str = ""
    # telemetry stanza (reference: telemetry { statsd_address
    # collection_interval prometheus_metrics }): prometheus is pull-mode
    # via /v1/metrics?format=prometheus (always on); statsd pushes.
    telemetry_statsd_address: str = ""
    # DogStatsD push (reference telemetry { datadog_address }): statsd
    # wire format + constant |#tags (node/region/dc)
    telemetry_datadog_address: str = ""
    telemetry_interval_s: float = 10.0
    # eval-lifecycle tracing (trace.py): OFF by default — the no-op path
    # costs nothing on the hot paths. telemetry { trace_enabled = true
    # trace_buffer = 256 } turns on span collection into a bounded ring
    # served at /v1/traces; reloadable via SIGHUP (Agent.reload).
    trace_enabled: bool = False
    trace_buffer: int = 256
    # continuous host profiling (hostobs.py): ON by default — the whole
    # point is always-on attribution (the overhead gate holds it under
    # 5%). telemetry { host_profile = false } opts out;
    # host_profile_interval tunes the busy sampling period (the sampler
    # backs off ~10x on its own when the process idles). SIGHUP-
    # reloadable (Agent.reload).
    host_profile_enabled: bool = True
    host_profile_interval_ms: float = 10.0
    # broker stanza (overload protection; SIGHUP-reloadable): the eval
    # broker's delivery/nack knobs were constructor defaults only —
    # first-class config now — plus the admission bounds. broker {
    # delivery_limit nack_delay admission_depth namespace_cap
    # blocked_cap }. admission_depth 0 = unbounded (seed behavior);
    # namespace_cap 0 = no per-namespace fairness bound; blocked_cap 0
    # = unbounded blocked-evals tracker.
    broker_delivery_limit: int = 3
    broker_nack_delay_s: float = 5.0
    broker_admission_depth: int = 0
    broker_namespace_cap: int = 0
    blocked_evals_cap: int = 0
    # limits stanza (per-namespace token buckets on the front doors;
    # SIGHUP-reloadable): limits { http_rate http_burst rpc_rate
    # rpc_burst } in requests/second per namespace; 0 disables. Burst
    # defaults to the rate when unset.
    http_rate_limit: float = 0.0
    http_rate_burst: float = 0.0
    rpc_rate_limit: float = 0.0
    rpc_rate_burst: float = 0.0
    # limits { node_register_rate node_register_burst }: the server-wide
    # Node.register admission door (reconnect-storm pacing; 429 +
    # Retry-After). 0 disables; heartbeats are never limited.
    node_register_rate: float = 0.0
    node_register_burst: float = 0.0
    # solver_pool stanza (the warm placement tier, docs/solver-pool.md;
    # SIGHUP-reloadable): solver_pool { role members sync_interval }.
    # role "solver" advertises this server as a pool member (serf tag
    # solver=1) and runs the periodic resident-state warm loop; members
    # is an optional static allowlist of node names; sync_interval is
    # the member-side delta-sync period.
    solver_pool_role: str = ""
    solver_pool_members: tuple = ()
    solver_pool_sync_interval_s: float = 2.0
    # blackbox flight recorder (blackbox.py): ON by default — always-on
    # incident capture is the point (the throughput gate holds the
    # journal under 5%). telemetry { blackbox_enabled = false } opts
    # out; incident_dir overrides the data_dir/incidents default (dev
    # mode has no data_dir, so captures stay in-memory unless set);
    # incident_max bounds the capture index. SIGHUP-reloadable
    # (Agent.reload).
    blackbox_enabled: bool = True
    incident_dir: str = ""
    incident_max: int = 16

    @staticmethod
    def dev() -> "AgentConfig":
        """-dev mode: server + client in one process (reference
        DevConfig, command.go)."""
        return AgentConfig(server_enabled=True, client_enabled=True, dev_mode=True)


class Agent:
    def __init__(self, config: AgentConfig) -> None:
        if (config.tls_http or config.tls_rpc) and not (
            config.tls_cert_file and config.tls_key_file
        ):
            # silently serving plaintext when the operator asked for
            # TLS would put tokens on the wire in the clear
            raise ValueError(
                "tls { http/rpc = true } requires cert_file and key_file"
            )
        self.config = config
        # ONE keyring for every socket this agent owns — the server's
        # listener+dialer pool and the client's streaming listener and
        # ad-hoc pools all share it, so a single rotate() (SIGHUP with
        # a new rpc_secret, or POST /v1/agent/keyring/rotate) moves the
        # whole agent atomically (rpc/keyring.py).
        from ..rpc.keyring import Keyring

        self.keyring = Keyring(
            config.rpc_secret, window_s=config.rpc_secret_window_s
        )
        self.fabric_tls = None
        if config.tls_rpc:
            from ..rpc.tls import fabric_contexts

            self.fabric_tls = fabric_contexts(
                config.tls_cert_file,
                config.tls_key_file,
                config.tls_ca_file,
            )
        # baseline TLS-material fingerprint so reload() can detect
        # in-place cert rotation (same paths, new bytes)
        if config.tls_cert_file and config.tls_key_file:
            self._tls_fp = _tls_fingerprint(
                config.tls_cert_file, config.tls_key_file, config.tls_ca_file
            )
        self.server: Optional[ClusterServer] = None
        self.client: Optional[Client] = None
        self.http = None

        if config.server_enabled:
            # "cuda" with no card raises here, before anything starts
            from ..scheduler.gpu.solver import resolve_device

            resolve_device(config.device)
            # A join-configured server is joining an EXISTING cluster:
            # never self-bootstrap a cluster of one (expect=0 ⇒ wait to be
            # adopted), unless a larger bootstrap_expect says otherwise.
            expect = config.bootstrap_expect
            if config.server_join and expect <= 1:
                expect = 0
            # A durable server needs a STABLE identity across restarts
            # (the raft log/vote belongs to a node id) — persist the
            # generated name like the client persists its node id.
            name = config.node_name
            if not name and not config.dev_mode and config.data_dir:
                import os
                import uuid

                name_file = os.path.join(config.data_dir, "server", "node-name")
                try:
                    with open(name_file) as f:
                        name = f.read().strip()
                except OSError:
                    pass
                if not name:
                    name = f"server-{uuid.uuid4().hex[:8]}"
                    os.makedirs(os.path.dirname(name_file), exist_ok=True)
                    with open(name_file, "w") as f:
                        f.write(name)
            self.server = ClusterServer(
                name or f"server-{id(self) & 0xFFFF:x}",
                host=config.bind_addr,
                port=config.rpc_port,
                num_workers=config.num_schedulers,
                use_tpu_batch_worker=config.use_tpu_batch_worker,
                scheduler_config=SchedulerConfig(device=config.device),
                enabled_schedulers=config.enabled_schedulers,
                region=config.region,
                bootstrap_expect=expect,
                rpc_secret=self.keyring,
                data_dir=None if config.dev_mode else config.data_dir,
                acl_enforce=config.acl_enabled,
                tls=self.fabric_tls,
                solver_pool_role=config.solver_pool_role,
                solver_pool_members=config.solver_pool_members,
                solver_pool_sync_interval_s=config.solver_pool_sync_interval_s,
                blackbox_enabled=config.blackbox_enabled,
                # dev mode passes data_dir=None to ClusterServer, so an
                # explicitly configured incident_dir is the only way a
                # dev agent writes bundles to disk
                incident_dir=config.incident_dir or None,
                incident_max=config.incident_max,
            )
            self.server.server.vault_allowed_policies = (
                list(config.vault_allowed_policies)
                if config.vault_allowed_policies is not None
                else None
            )
        if config.client_enabled:
            if self.server is not None:
                # Co-located client: in-process, but through the CLUSTER
                # endpoints so writes forward to the leader — a client on
                # a follower server agent must still register (binding
                # ServerRPC to the local core server would NotLeaderError
                # forever).
                rpc = InProcessClusterRPC(self.server)
            else:
                if not config.client_servers:
                    raise ValueError("client agent needs `servers` addresses")
                rpc = ClusterRPC(
                    [tuple(a) for a in config.client_servers],
                    rpc_secret=self.keyring,
                    tls_context=(
                        self.fabric_tls[1] if self.fabric_tls else None
                    ),
                )
            self.client = Client(
                rpc,
                driver_plugins=config.driver_plugins,
                device_plugins=config.device_plugins,
                chroot_env=config.chroot_env,
                host_volumes=config.host_volumes,
                node_meta=config.node_meta,
                reserved=config.reserved,
                data_dir=config.data_dir,
                datacenter=config.datacenter,
                node_class=config.node_class,
                rpc_secret=self.keyring,
                advertise_host=config.bind_addr,
                csi_plugins=config.csi_plugins,
                tls=self.fabric_tls,
            )
        if self.server is not None:
            from .http import HTTPAgentServer

            resolver = None
            if config.acl_enabled:
                from ..acl.enforce import make_http_resolver

                resolver = make_http_resolver(self.server.server)
            self.http = HTTPAgentServer(
                self.server,
                client=self.client,
                host=config.bind_addr,
                port=config.http_port,
                acl_resolver=resolver,
                enable_debug=config.enable_debug or config.dev_mode,
                # API rotation must move the in-memory config too, or
                # the next SIGHUP would diff against the boot secret
                # and silently rotate BACK to the config file's value
                on_keyring_rotate=lambda s: setattr(
                    self.config, "rpc_secret", s
                ),
                tls_cert=(
                    config.tls_cert_file if config.tls_http else ""
                ),
                tls_key=(
                    config.tls_key_file if config.tls_http else ""
                ),
            )
        self._apply_overload_config(config)

    def _apply_overload_config(self, cfg: AgentConfig) -> None:
        """Push the broker/limits stanzas onto the live subsystems —
        shared by construction and SIGHUP reload."""
        if self.server is not None:
            self.server.server.eval_broker.configure(
                nack_delay_s=cfg.broker_nack_delay_s,
                delivery_limit=cfg.broker_delivery_limit,
                admission_depth=cfg.broker_admission_depth,
                namespace_cap=cfg.broker_namespace_cap,
            )
            self.server.server.blocked_evals.configure(
                cap=cfg.blocked_evals_cap
            )
            self.server.set_rate_limits(
                cfg.rpc_rate_limit, cfg.rpc_rate_burst
            )
            self.server.set_node_register_limit(
                cfg.node_register_rate, cfg.node_register_burst
            )
        if self.http is not None:
            self.http.set_rate_limits(
                cfg.http_rate_limit, cfg.http_rate_burst
            )

    def start(self) -> None:
        # Resolve the native wire codec before any lock exists to pack
        # under (nomad-vet NV-lock-blocking: the lazy first pack() can
        # otherwise compile the extension while holding the raft /
        # store / RPC-write lock).
        from .. import codec

        codec.warm_native()
        if self.config.trace_enabled:
            from .. import trace

            trace.configure(
                max_traces=self.config.trace_buffer, enabled_=True
            )
            self._trace_owner = True
        if self.config.host_profile_enabled:
            # before the server boots so bootstrap cost is attributable;
            # refcounted process-global singleton (in-process test
            # clusters share one sampler thread)
            from .. import hostobs

            hostobs.configure(
                interval_s=self.config.host_profile_interval_ms / 1e3,
                flush_interval_s=self.config.telemetry_interval_s or None,
            )
            hostobs.start()
            self._hostobs_started = True
        # telemetry { collection_interval } is also the histogram window
        # width (metrics.py windowed ring): "last window" in /v1/metrics
        # and `operator top` means the last collection interval. Applied
        # BEFORE the server starts — configure_windows only affects
        # histograms created after it, and server bootstrap (raft
        # applies at leadership) creates the first ones.
        if self.config.telemetry_interval_s:
            from .. import metrics as _metrics

            _metrics.registry().configure_windows(
                interval_s=self.config.telemetry_interval_s
            )
        if self.server is not None:
            self.server.start()
            if self.config.server_join:
                self.server.join([tuple(a) for a in self.config.server_join])
        # HTTP before the client: the API must come up even if client
        # registration is still waiting on a leader.
        if self.http is not None:
            self.http.start()
        if self.client is not None:
            self.client.start()
        if self.config.telemetry_statsd_address:
            from ..metrics import StatsdSink

            self.statsd = StatsdSink(
                self.config.telemetry_statsd_address,
                self.config.telemetry_interval_s,
            )
            self.statsd.start()
        if self.config.telemetry_datadog_address:
            from ..metrics import DatadogSink

            self.datadog = DatadogSink(
                self.config.telemetry_datadog_address,
                self.config.telemetry_interval_s,
                tags={
                    "node": self.config.node_name or "agent",
                    "region": self.config.region,
                    "datacenter": self.config.datacenter,
                },
            )
            self.datadog.start()
        # Everything built so far (modules, config, stores, subsystems)
        # is process-lifetime state: freeze it out of the cyclic
        # collector so steady-state GC passes only ever walk young
        # objects (gctune.py — the complement of the hot paths' pauses).
        from ..gctune import freeze_startup_heap

        freeze_startup_heap()

    def reload(self, new_config: AgentConfig) -> list[str]:
        """Apply the RELOADABLE subset of a re-read config to the live
        agent (reference command/agent/agent.go Agent.Reload, driven by
        SIGHUP in command.go handleSignals). Hot paths:

        - TLS material rotation: new certs/keys/CA load into the LIVE
          ssl contexts shared by every fabric socket and the HTTPS
          listener — subsequent handshakes present the new chain while
          established connections keep flowing (nothing is dropped).
        - client node_meta: replaced and re-registered so schedulers see
          new constraint/spread targets.
        - vault_allowed_policies: derivation allowlist swap.

        Everything else (ports, server/client enablement, data_dir,
        enabling TLS where it was off) still needs a restart — the same
        boundary the reference draws. Returns the list of applied
        changes for operator logs."""
        changed: list[str] = []
        old = self.config
        # rpc_secret rotation (the SIGHUP keyring push): the shared
        # keyring swaps the new secret in as current and keeps the old
        # one accepted for the dual-accept window; every listener and
        # pool in this agent reads the keyring live, so nothing is
        # restarted and established connections keep flowing. Rotating
        # BACK within the window swaps the slots again; a re-SIGHUP
        # with an unchanged secret is a no-op (Keyring.rotate contract).
        if new_config.rpc_secret_window_s != old.rpc_secret_window_s:
            self.keyring.window_s = new_config.rpc_secret_window_s
            old.rpc_secret_window_s = new_config.rpc_secret_window_s
        if new_config.rpc_secret != old.rpc_secret:
            if not new_config.rpc_secret:
                # refuse rather than silently opening the fabric — see
                # Keyring.rotate; removing auth needs a restart
                raise ValueError(
                    "cannot remove rpc_secret via reload (restart "
                    "the agent to disable fabric auth)"
                )
            if self.keyring.rotate(new_config.rpc_secret):
                changed.append("rpc_secret")
            old.rpc_secret = new_config.rpc_secret
        # Always re-read the material when TLS is on: operators rotate
        # certs IN PLACE (same path, new content) at least as often as
        # they change paths, and a path compare would silently skip
        # those. Re-loading unchanged files is harmless. A fingerprint
        # of the file contents decides whether to REPORT a change.
        if new_config.tls_cert_file and new_config.tls_key_file and (
            self.fabric_tls is not None or (self.http and self.http.tls)
        ):
            new_fp = _tls_fingerprint(
                new_config.tls_cert_file,
                new_config.tls_key_file,
                new_config.tls_ca_file,
            )
            rotated = new_fp != getattr(self, "_tls_fp", None) or (
                new_config.tls_cert_file,
                new_config.tls_key_file,
                new_config.tls_ca_file,
            ) != (old.tls_cert_file, old.tls_key_file, old.tls_ca_file)
            self._tls_fp = new_fp
            if rotated and self.fabric_tls is not None:
                server_ctx, client_ctx = self.fabric_tls
                server_ctx.load_cert_chain(
                    new_config.tls_cert_file, new_config.tls_key_file
                )
                client_ctx.load_cert_chain(
                    new_config.tls_cert_file, new_config.tls_key_file
                )
                if new_config.tls_ca_file:
                    server_ctx.load_verify_locations(new_config.tls_ca_file)
                    client_ctx.load_verify_locations(new_config.tls_ca_file)
                changed.append("tls_rpc_material")
            if (
                rotated
                and self.http is not None
                and old.tls_http
                and self.http.reload_tls(
                    new_config.tls_cert_file, new_config.tls_key_file
                )
            ):
                changed.append("tls_http_material")
            old.tls_cert_file = new_config.tls_cert_file
            old.tls_key_file = new_config.tls_key_file
            old.tls_ca_file = new_config.tls_ca_file
        if (
            self.client is not None
            and new_config.node_meta != old.node_meta
        ):
            self.client.update_node_meta(new_config.node_meta)
            old.node_meta = dict(new_config.node_meta)
            changed.append("client_node_meta")
        if (
            new_config.trace_enabled != old.trace_enabled
            or new_config.trace_buffer != old.trace_buffer
        ):
            from .. import trace

            trace.configure(
                max_traces=new_config.trace_buffer,
                enabled_=new_config.trace_enabled,
            )
            self._trace_owner = new_config.trace_enabled
            old.trace_enabled = new_config.trace_enabled
            old.trace_buffer = new_config.trace_buffer
            changed.append("trace")
        if (
            new_config.host_profile_enabled != old.host_profile_enabled
            or new_config.host_profile_interval_ms
            != old.host_profile_interval_ms
        ):
            from .. import hostobs

            hostobs.configure(
                interval_s=new_config.host_profile_interval_ms / 1e3
            )
            started = getattr(self, "_hostobs_started", False)
            if new_config.host_profile_enabled and not started:
                hostobs.start()
                self._hostobs_started = True
            elif not new_config.host_profile_enabled and started:
                # drops THIS agent's refcount; the sampler thread exits
                # when the last in-process owner lets go (no leaks
                # across SIGHUP cycles — the racecheck battery asserts)
                hostobs.stop()
                self._hostobs_started = False
            old.host_profile_enabled = new_config.host_profile_enabled
            old.host_profile_interval_ms = new_config.host_profile_interval_ms
            changed.append("host_profile")
        broker_keys = (
            "broker_delivery_limit",
            "broker_nack_delay_s",
            "broker_admission_depth",
            "broker_namespace_cap",
            "blocked_evals_cap",
        )
        limit_keys = (
            "http_rate_limit",
            "http_rate_burst",
            "rpc_rate_limit",
            "rpc_rate_burst",
            "node_register_rate",
            "node_register_burst",
        )
        broker_changed = any(
            getattr(new_config, k) != getattr(old, k) for k in broker_keys
        )
        limits_changed = any(
            getattr(new_config, k) != getattr(old, k) for k in limit_keys
        )
        if broker_changed or limits_changed:
            # one apply covers both stanzas; in-flight deliveries keep
            # their attempt counts and buckets keep their fill
            for k in broker_keys + limit_keys:
                setattr(old, k, getattr(new_config, k))
            self._apply_overload_config(old)
            if broker_changed:
                changed.append("broker")
            if limits_changed:
                changed.append("limits")
        blackbox_keys = ("blackbox_enabled", "incident_dir", "incident_max")
        if self.server is not None and any(
            getattr(new_config, k) != getattr(old, k) for k in blackbox_keys
        ):
            self.server.blackbox.reload(
                enabled=new_config.blackbox_enabled,
                incident_dir=new_config.incident_dir or None,
                incident_max=new_config.incident_max,
            )
            for k in blackbox_keys:
                setattr(old, k, getattr(new_config, k))
            changed.append("blackbox")
        pool_keys = (
            "solver_pool_role",
            "solver_pool_members",
            "solver_pool_sync_interval_s",
        )
        if self.server is not None and any(
            getattr(new_config, k) != getattr(old, k) for k in pool_keys
        ):
            self.server.solver_pool.configure(
                new_config.solver_pool_role,
                members=new_config.solver_pool_members,
                sync_interval_s=new_config.solver_pool_sync_interval_s,
            )
            for k in pool_keys:
                setattr(old, k, getattr(new_config, k))
            changed.append("solver_pool")
        if (
            self.server is not None
            and new_config.vault_allowed_policies != old.vault_allowed_policies
        ):
            self.server.server.vault_allowed_policies = (
                list(new_config.vault_allowed_policies)
                if new_config.vault_allowed_policies is not None
                else None
            )
            old.vault_allowed_policies = new_config.vault_allowed_policies
            changed.append("vault_allowed_policies")
        return changed

    def shutdown(self) -> None:
        if getattr(self, "_hostobs_started", False):
            from .. import hostobs

            hostobs.stop()
            self._hostobs_started = False
        if getattr(self, "_trace_owner", False):
            # tracing state is process-global (like the metrics registry):
            # only the agent that enabled it turns it back off
            from .. import trace

            trace.set_enabled(False)
        if getattr(self, "statsd", None) is not None:
            self.statsd.stop()
            self.statsd = None
        if getattr(self, "datadog", None) is not None:
            self.datadog.stop()
            self.datadog = None
        if self.http is not None:
            self.http.shutdown()
        if self.client is not None:
            self.client.shutdown()
        if self.server is not None:
            self.server.shutdown()

    @property
    def http_addr(self) -> Optional[tuple[str, int]]:
        return None if self.http is None else self.http.addr
