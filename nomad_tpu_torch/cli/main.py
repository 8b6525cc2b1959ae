"""`nomad-tpu-torch` command set.

Port of ``nomad_tpu/cli/main.py``.

Reference: command/commands.go:57 registers ~140 subcommands; this is the
working core — agent, job (run/plan/status/stop/inspect/history/revert/
dispatch/periodic), node (status/drain/eligibility), alloc/eval/
deployment status, server members/join, system gc, version. Exit codes
follow the reference where they are load-bearing (`job plan`: 0 = no
changes, 1 = changes, 255 = error).

All commands talk to the HTTP API (NOMAD_ADDR / -address), exactly like
the reference CLI — never to the RPC fabric directly.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Optional

from .. import codec
from ..api import APIError, NomadClient

VERSION = "0.1.0"


def _fmt_table(rows: list[list[str]], header: Optional[list[str]] = None) -> str:
    all_rows = ([header] if header else []) + rows
    if not all_rows:
        return ""
    widths = [
        max(len(str(r[i])) for r in all_rows) for i in range(len(all_rows[0]))
    ]
    lines = []
    for r in all_rows:
        lines.append(
            "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
        )
    return "\n".join(lines)


def _conn_opts(args) -> tuple[str, str, str]:
    """(address, token, region) with env fallbacks — the single place
    connection defaults are resolved."""
    addr = args.address or os.environ.get(
        "NOMAD_ADDR", "http://127.0.0.1:4646"
    )
    region = getattr(args, "region", "") or os.environ.get(
        "NOMAD_REGION", ""
    )
    token = args.token or os.environ.get("NOMAD_TOKEN", "")
    return addr, token, region


def _client(args) -> NomadClient:
    addr, token, region = _conn_opts(args)
    return NomadClient(
        addr,
        token=token,
        region=region,
        # TLS against an internal CA (reference NOMAD_CACERT /
        # -tls-skip-verify)
        ca_cert=os.environ.get("NOMAD_CACERT", ""),
        tls_skip_verify=os.environ.get("NOMAD_SKIP_VERIFY", "").lower()
        in ("1", "true", "t", "yes"),
    )


def _parse_vars(pairs: list[str]) -> dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"-var must be key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _load_jobfile(path: str, variables: dict):
    from ..jobspec import parse_job

    with open(path) as f:
        src = f.read()
    if path.endswith(".json"):
        data = json.loads(src)
        return codec.from_wire(data.get("Job", data))
    return parse_job(src, variables)


# ---------------------------------------------------------------------------
# agent


def cmd_agent(args) -> int:
    from ..agent import Agent, AgentConfig

    if args.config:
        cfg = _load_agent_config(args.config)
    else:
        cfg = AgentConfig()
    if args.dev:
        cfg.server_enabled = True
        cfg.client_enabled = True
        cfg.dev_mode = True  # ephemeral raft, like the reference's -dev
    if args.server:
        cfg.server_enabled = True
    if args.client:
        cfg.client_enabled = True
    if args.bootstrap_expect:
        cfg.bootstrap_expect = args.bootstrap_expect
    if args.join:
        cfg.server_join = [_addr(j) for j in args.join]
    if args.servers:
        cfg.client_servers = [_addr(j) for j in args.servers]
    if args.data_dir:
        cfg.data_dir = args.data_dir
    if args.node_name:
        cfg.node_name = args.node_name
    if args.http_port is not None:
        cfg.http_port = args.http_port
    if args.rpc_port is not None:
        cfg.rpc_port = args.rpc_port
    if args.tpu_scheduler:
        cfg.use_tpu_batch_worker = True

    stop = [False]
    hup = [False]

    def on_sig(sig, frame):
        stop[0] = True

    def on_hup(sig, frame):
        hup[0] = True  # handled on the main loop, not in the handler

    # The handlers go in before the agent starts: a client-only agent is
    # ready as soon as start() returns, so a SIGTERM sent on seeing the
    # banner must already find them.
    signal.signal(signal.SIGINT, on_sig)
    signal.signal(signal.SIGTERM, on_sig)
    # SIGHUP re-reads the config file and applies the reloadable subset
    # (TLS material, client meta, vault allowlist — Agent.reload);
    # reference command/agent/command.go handleSignals → handleReload.
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, on_hup)
    agent = Agent(cfg)
    agent.start()
    if agent.http_addr:
        print(f"==> HTTP API: http://{agent.http_addr[0]}:{agent.http_addr[1]}")
    if agent.server:
        print(f"==> RPC: {agent.server.addr[0]}:{agent.server.addr[1]}")
    print("==> Agent started! Ctrl-C to stop.")
    try:
        while not stop[0]:
            if hup[0]:
                hup[0] = False
                if args.config:
                    try:
                        changed = agent.reload(_load_agent_config(args.config))
                        print(f"==> Config reloaded: {changed or 'no changes'}")
                    except Exception as e:
                        print(f"==> Config reload FAILED: {e}")
                else:
                    print("==> SIGHUP ignored: agent started without -config")
            time.sleep(0.2)
    finally:
        print("==> Shutting down")
        agent.shutdown()
    return 0


def _addr(s: str) -> tuple[str, int]:
    host, _, port = s.partition(":")
    return (host, int(port or 4647))


def _load_agent_config(path: str):
    from ..agent import AgentConfig

    # NB: `from ..jobspec import parse` would bind the parse SUBMODULE
    # (import machinery rebinds the package attr), not the hcl function.
    from ..jobspec.hcl import parse as parse_hcl

    with open(path) as f:
        src = f.read()
    cfg = AgentConfig()
    if path.endswith(".json"):
        data = json.loads(src)
        _apply_config_dict(cfg, data)
        return cfg
    body = parse_hcl(src)
    a = body.attrs()
    for k in (
        "region",
        "datacenter",
        "data_dir",
        "bind_addr",
        "node_name",
        "rpc_secret",
        "device",
    ):
        if k in a:
            setattr(cfg, k, a[k])
    if "rpc_secret_window" in a:
        from ..jobspec.hcl import parse_duration

        cfg.rpc_secret_window_s = parse_duration(a["rpc_secret_window"])
    sb = body.block("server")
    if sb is not None:
        sa = sb.body.attrs()
        cfg.server_enabled = bool(sa.get("enabled", True))
        cfg.bootstrap_expect = int(sa.get("bootstrap_expect", 1))
        cfg.server_join = [_addr(s) for s in sa.get("server_join", [])]
    cb = body.block("client")
    if cb is not None:
        ca = cb.body.attrs()
        cfg.client_enabled = bool(ca.get("enabled", True))
        cfg.client_servers = [_addr(s) for s in ca.get("servers", [])]
        cfg.node_class = ca.get("node_class", "")
        cfg.csi_plugins = dict(ca.get("csi_plugins", {}))
        ce = cb.body.block("chroot_env")
        if ce is not None:
            cfg.chroot_env = {
                str(k): str(v) for k, v in ce.body.attrs().items()
            }
        mb2 = cb.body.block("meta")
        if mb2 is not None:
            cfg.node_meta = {
                str(k): str(v) for k, v in mb2.body.attrs().items()
            }
        rb2 = cb.body.block("reserved")
        if rb2 is not None:
            ra = rb2.body.attrs()
            cfg.reserved = {
                "cpu": int(ra.get("cpu", 0)),
                "memory": int(ra.get("memory", 0)),
                "disk": int(ra.get("disk", 0)),
            }
        for hv in cb.body.blocks("host_volume"):
            name = hv.labels[0] if hv.labels else ""
            a2 = hv.body.attrs()
            if name and a2.get("path"):
                cfg.host_volumes[name] = {
                    "path": str(a2["path"]),
                    "read_only": bool(a2.get("read_only", False)),
                }
    pb = body.block("ports")
    if pb is not None:
        pa = pb.body.attrs()
        cfg.http_port = int(pa.get("http", 0))
        cfg.rpc_port = int(pa.get("rpc", 0))
    ab = body.block("acl")
    if ab is not None:
        cfg.acl_enabled = bool(ab.body.attrs().get("enabled", False))
    vb = body.block("vault")
    if vb is not None:
        va = vb.body.attrs()
        if "allowed_policies" in va:
            cfg.vault_allowed_policies = [
                str(x) for x in va["allowed_policies"]
            ]
    tb = body.block("tls")
    if tb is not None:
        ta = tb.body.attrs()
        cfg.tls_http = bool(ta.get("http", False))
        cfg.tls_rpc = bool(ta.get("rpc", False))
        cfg.tls_cert_file = str(ta.get("cert_file", ""))
        cfg.tls_key_file = str(ta.get("key_file", ""))
        cfg.tls_ca_file = str(ta.get("ca_file", ""))
    teb = body.block("telemetry")
    if teb is not None:
        from ..jobspec.hcl import parse_duration

        tea = teb.body.attrs()
        cfg.telemetry_statsd_address = str(tea.get("statsd_address", ""))
        cfg.telemetry_datadog_address = str(tea.get("datadog_address", ""))
        if "collection_interval" in tea:
            cfg.telemetry_interval_s = parse_duration(
                tea["collection_interval"]
            )
        cfg.trace_enabled = bool(tea.get("trace_enabled", False))
        if "trace_buffer" in tea:
            cfg.trace_buffer = int(tea["trace_buffer"])
        if "host_profile" in tea:
            cfg.host_profile_enabled = bool(tea["host_profile"])
        if "host_profile_interval" in tea:
            cfg.host_profile_interval_ms = (
                parse_duration(tea["host_profile_interval"]) * 1e3
            )
        if "blackbox_enabled" in tea:
            cfg.blackbox_enabled = bool(tea["blackbox_enabled"])
        if "incident_dir" in tea:
            cfg.incident_dir = str(tea["incident_dir"])
        if "incident_max" in tea:
            cfg.incident_max = int(tea["incident_max"])
    brb = body.block("broker")
    if brb is not None:
        from ..jobspec.hcl import parse_duration

        bra = brb.body.attrs()
        if "delivery_limit" in bra:
            cfg.broker_delivery_limit = int(bra["delivery_limit"])
        if "nack_delay" in bra:
            cfg.broker_nack_delay_s = parse_duration(bra["nack_delay"])
        if "admission_depth" in bra:
            cfg.broker_admission_depth = int(bra["admission_depth"])
        if "namespace_cap" in bra:
            cfg.broker_namespace_cap = int(bra["namespace_cap"])
        if "blocked_cap" in bra:
            cfg.blocked_evals_cap = int(bra["blocked_cap"])
    lmb = body.block("limits")
    if lmb is not None:
        lma = lmb.body.attrs()
        cfg.http_rate_limit = float(lma.get("http_rate", 0) or 0)
        cfg.http_rate_burst = float(lma.get("http_burst", 0) or 0)
        cfg.rpc_rate_limit = float(lma.get("rpc_rate", 0) or 0)
        cfg.rpc_rate_burst = float(lma.get("rpc_burst", 0) or 0)
        cfg.node_register_rate = float(lma.get("node_register_rate", 0) or 0)
        cfg.node_register_burst = float(lma.get("node_register_burst", 0) or 0)
    spb = body.block("solver_pool")
    if spb is not None:
        from ..jobspec.hcl import parse_duration

        spa = spb.body.attrs()
        if "role" in spa:
            cfg.solver_pool_role = str(spa["role"])
        if "members" in spa:
            cfg.solver_pool_members = tuple(
                str(m) for m in (spa["members"] or [])
            )
        if "sync_interval" in spa:
            cfg.solver_pool_sync_interval_s = parse_duration(
                spa["sync_interval"]
            )
    for plug in body.blocks("plugin"):
        name = plug.labels[0] if plug.labels else ""
        ref = plug.body.attrs().get("factory", "")
        if name and ref:
            cfg.driver_plugins[name] = str(ref)
    for plug in body.blocks("device_plugin"):
        name = plug.labels[0] if plug.labels else ""
        pa = plug.body.attrs()
        ref = pa.get("factory", "")
        if name and ref:
            spec = {"factory": str(ref)}
            if pa.get("config"):
                spec["config"] = dict(pa["config"])
            cfg.device_plugins[name] = spec
    return cfg


def _apply_config_dict(cfg, data: dict) -> None:
    for k, v in data.items():
        if k == "server" and isinstance(v, dict):
            cfg.server_enabled = v.get("enabled", True)
            cfg.bootstrap_expect = v.get("bootstrap_expect", 1)
            cfg.server_join = [_addr(s) for s in v.get("server_join", [])]
        elif k == "client" and isinstance(v, dict):
            cfg.client_enabled = v.get("enabled", True)
            cfg.client_servers = [_addr(s) for s in v.get("servers", [])]
            cfg.csi_plugins = dict(v.get("csi_plugins", {}))
            cfg.chroot_env = dict(v.get("chroot_env", {}))
            cfg.host_volumes = {
                str(name): {
                    "path": str(hv.get("path", "")),
                    "read_only": bool(hv.get("read_only", False)),
                }
                for name, hv in (v.get("host_volumes") or {}).items()
                if hv.get("path")
            }
            cfg.node_meta = {
                str(k): str(vv) for k, vv in (v.get("meta") or {}).items()
            }
            if v.get("reserved"):
                cfg.reserved = {
                    "cpu": int(v["reserved"].get("cpu", 0)),
                    "memory": int(v["reserved"].get("memory", 0)),
                    "disk": int(v["reserved"].get("disk", 0)),
                }
        elif k == "device_plugins" and isinstance(v, dict):
            cfg.device_plugins = dict(v)
        elif k == "telemetry" and isinstance(v, dict):
            from ..jobspec.hcl import parse_duration

            cfg.telemetry_statsd_address = str(v.get("statsd_address", ""))
            cfg.telemetry_datadog_address = str(
                v.get("datadog_address", "")
            )
            cfg.trace_enabled = bool(v.get("trace_enabled", False))
            if "trace_buffer" in v:
                cfg.trace_buffer = int(v["trace_buffer"])
            if "collection_interval" in v:
                cfg.telemetry_interval_s = parse_duration(
                    v["collection_interval"]
                )
            if "host_profile" in v:
                cfg.host_profile_enabled = bool(v["host_profile"])
            if "host_profile_interval" in v:
                cfg.host_profile_interval_ms = (
                    parse_duration(v["host_profile_interval"]) * 1e3
                )
            if "blackbox_enabled" in v:
                cfg.blackbox_enabled = bool(v["blackbox_enabled"])
            if "incident_dir" in v:
                cfg.incident_dir = str(v["incident_dir"])
            if "incident_max" in v:
                cfg.incident_max = int(v["incident_max"])
        elif k == "broker" and isinstance(v, dict):
            from ..jobspec.hcl import parse_duration

            if "delivery_limit" in v:
                cfg.broker_delivery_limit = int(v["delivery_limit"])
            if "nack_delay" in v:
                cfg.broker_nack_delay_s = parse_duration(v["nack_delay"])
            if "admission_depth" in v:
                cfg.broker_admission_depth = int(v["admission_depth"])
            if "namespace_cap" in v:
                cfg.broker_namespace_cap = int(v["namespace_cap"])
            if "blocked_cap" in v:
                cfg.blocked_evals_cap = int(v["blocked_cap"])
        elif k == "limits" and isinstance(v, dict):
            cfg.http_rate_limit = float(v.get("http_rate", 0) or 0)
            cfg.http_rate_burst = float(v.get("http_burst", 0) or 0)
            cfg.rpc_rate_limit = float(v.get("rpc_rate", 0) or 0)
            cfg.rpc_rate_burst = float(v.get("rpc_burst", 0) or 0)
            cfg.node_register_rate = float(v.get("node_register_rate", 0) or 0)
            cfg.node_register_burst = float(v.get("node_register_burst", 0) or 0)
        elif k == "solver_pool" and isinstance(v, dict):
            from ..jobspec.hcl import parse_duration

            if "role" in v:
                cfg.solver_pool_role = str(v["role"])
            if "members" in v:
                cfg.solver_pool_members = tuple(
                    str(m) for m in (v["members"] or [])
                )
            if "sync_interval" in v:
                cfg.solver_pool_sync_interval_s = parse_duration(
                    v["sync_interval"]
                )
        elif k == "ports" and isinstance(v, dict):
            cfg.http_port = v.get("http", 0)
            cfg.rpc_port = v.get("rpc", 0)
        elif k == "acl" and isinstance(v, dict):
            cfg.acl_enabled = v.get("enabled", False)
        elif k == "tls" and isinstance(v, dict):
            cfg.tls_http = bool(v.get("http", False))
            cfg.tls_rpc = bool(v.get("rpc", False))
            cfg.tls_cert_file = str(v.get("cert_file", ""))
            cfg.tls_key_file = str(v.get("key_file", ""))
            cfg.tls_ca_file = str(v.get("ca_file", ""))
        elif hasattr(cfg, k):
            setattr(cfg, k, v)


# ---------------------------------------------------------------------------
# job


def cmd_job_run(args) -> int:
    api = _client(args)
    job = _load_jobfile(args.jobfile, _parse_vars(args.var))
    eval_id = api.jobs.register(job)
    print(f'==> Job "{job.id}" registered')
    if eval_id:
        print(f"    Evaluation ID: {eval_id}")
    if args.detach or not eval_id:
        return 0
    # monitor until the eval completes (reference: monitor.go)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        ev = api.evaluations.get(eval_id)
        if ev.status in ("complete", "failed", "canceled"):
            print(f'    Evaluation status: "{ev.status}"')
            return 0 if ev.status == "complete" else 2
        time.sleep(0.3)
    print("    Evaluation still pending (timeout); detaching")
    return 0


_DIFF_MARK = {"Added": "+", "Deleted": "-", "Edited": "~", "None": " "}


def _render_diff(d, indent=0) -> None:
    if not d or d.get("Type") == "None":
        return
    pad = " " * indent
    mark = _DIFF_MARK.get(d.get("Type", "Edited"), "~")
    print(f"{pad}{mark} {d.get('Name', '')}")
    for f in d.get("Fields") or []:
        fm = _DIFF_MARK.get(f.get("Type", "Edited"), "~")
        old, new = f.get("Old", ""), f.get("New", "")
        if f["Type"] == "Added":
            print(f'{pad}  {fm} {f["Name"]}: "{new}"')
        elif f["Type"] == "Deleted":
            print(f'{pad}  {fm} {f["Name"]}: "{old}"')
        else:
            print(f'{pad}  {fm} {f["Name"]}: "{old}" => "{new}"')
    for o in d.get("Objects") or []:
        _render_diff(o, indent + 2)


def cmd_job_plan(args) -> int:
    """Server-side dry-run (reference command/job_plan.go): the REAL
    scheduler runs against a snapshot without committing; the CLI renders
    its per-group annotations and structural diff. Exit codes match the
    reference: 0 no changes, 1 changes, 255 error."""
    api = _client(args)
    try:
        job = _load_jobfile(args.jobfile, _parse_vars(args.var))
        resp = api.jobs.plan(job)
        _render_diff(resp.get("Diff"))
        updates = resp.get("Annotations", {}).get("DesiredTGUpdates", {})
        for tg, s in sorted(updates.items()):
            parts = []
            for key, label in (
                ("place", "create"),
                ("destructive", "create/destroy update"),
                ("in_place", "in-place update"),
                ("migrate", "migrate"),
                ("stop", "destroy"),
                ("canary", "canary"),
                ("ignore", "ignore"),
            ):
                n = s.get(key, 0)
                if n:
                    parts.append(f"{n} {label}")
            if parts:
                print(f'Task Group: "{tg}" ({", ".join(parts)})')
        failed = resp.get("FailedTGAllocs") or {}
        for tg, metric in failed.items():
            print(f'! Task Group "{tg}": placement would fail')
        if resp.get("JobModifyIndex") is not None:
            print(f"Job Modify Index: {resp['JobModifyIndex']}")
        if not resp.get("Changes"):
            print("No changes. Job is up to date.")
            return 0
        return 1
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 255


def cmd_job_status(args) -> int:
    api = _client(args)
    if not args.job_id:
        jobs = api.jobs.list()
        if not jobs:
            print("No running jobs")
            return 0
        print(
            _fmt_table(
                [
                    [j.id, j.type, str(j.priority), j.status]
                    for j in sorted(jobs, key=lambda j: j.id)
                ],
                header=["ID", "Type", "Priority", "Status"],
            )
        )
        return 0
    job = api.jobs.get(args.job_id)
    print(f"ID            = {job.id}")
    print(f"Name          = {job.name}")
    print(f"Type          = {job.type}")
    print(f"Priority      = {job.priority}")
    print(f"Status        = {job.status}")
    print(f"Datacenters   = {','.join(job.datacenters)}")
    print(f"Version       = {job.version}")
    try:
        summary = api.jobs.summary(job.id)
        print("\nSummary")
        rows = [
            [
                g,
                str(c.get("queued", 0)),
                str(c.get("starting", 0)),
                str(c.get("running", 0)),
                str(c.get("failed", 0)),
                str(c.get("complete", 0)),
                str(c.get("lost", 0)),
            ]
            for g, c in sorted(summary.summary.items())
        ]
        print(
            _fmt_table(
                rows,
                header=[
                    "Task Group",
                    "Queued",
                    "Starting",
                    "Running",
                    "Failed",
                    "Complete",
                    "Lost",
                ],
            )
        )
    except APIError:
        pass
    try:
        deps = api.jobs.deployments(args.job_id)
        active = [d for d in deps if d.active()]
        latest = max(
            active or deps, key=lambda d: d.job_version, default=None
        )
        if latest is not None:
            print("\nLatest Deployment")
            print(f"ID          = {latest.id[:8]}")
            print(f"Status      = {latest.status}")
            print(f"Description = {latest.status_description}")
    except APIError:
        pass
    allocs = api.jobs.allocations(args.job_id)
    if allocs:
        print("\nAllocations")
        print(
            _fmt_table(
                [
                    [
                        a.id[:8],
                        a.node_id[:8],
                        a.task_group,
                        a.desired_status,
                        a.client_status,
                    ]
                    for a in allocs
                ],
                header=["ID", "Node ID", "Task Group", "Desired", "Status"],
            )
        )
    return 0


def cmd_job_stop(args) -> int:
    api = _client(args)
    eval_id = api.jobs.deregister(args.job_id, purge=args.purge)
    print(f'==> Job "{args.job_id}" deregistered')
    if eval_id:
        print(f"    Evaluation ID: {eval_id}")
    return 0


def cmd_job_inspect(args) -> int:
    api = _client(args)
    job = api.jobs.get(args.job_id)
    print(json.dumps(codec.to_wire(job), indent=2, default=codec.json_default))
    return 0


def cmd_job_history(args) -> int:
    api = _client(args)
    versions = api.jobs.versions(args.job_id)
    rows = [
        [str(j.version), "true" if j.stable else "false", j.status]
        for j in versions
    ]
    print(_fmt_table(rows, header=["Version", "Stable", "Status"]))
    return 0


def cmd_job_revert(args) -> int:
    api = _client(args)
    api.jobs.revert(args.job_id, args.version)
    print(f'==> Job "{args.job_id}" reverted to version {args.version}')
    return 0


def cmd_job_dispatch(args) -> int:
    api = _client(args)
    meta = _parse_vars(args.meta)
    payload = None
    if args.payload_file:
        with open(args.payload_file) as f:
            payload = f.read()
    result = api.jobs.dispatch(args.job_id, meta=meta, payload=payload)
    print(f"Dispatched Job ID = {result}")
    return 0


def cmd_job_periodic_force(args) -> int:
    api = _client(args)
    out = api.jobs.periodic_force(args.job_id)
    print(f"Forced periodic launch: {out}")
    return 0


# ---------------------------------------------------------------------------
# node / alloc / eval / deployment


def cmd_node_status(args) -> int:
    api = _client(args)
    if not args.node_id:
        nodes = api.nodes.list()
        print(
            _fmt_table(
                [
                    [
                        n.id[:8],
                        n.datacenter,
                        n.name,
                        n.node_class or "<none>",
                        n.scheduling_eligibility,
                        n.status,
                    ]
                    for n in nodes
                ],
                header=["ID", "DC", "Name", "Class", "Eligibility", "Status"],
            )
        )
        return 0
    node = _find_by_prefix(api.nodes.list(), args.node_id)
    node = api.nodes.get(node.id)
    print(f"ID          = {node.id}")
    print(f"Name        = {node.name}")
    print(f"Class       = {node.node_class or '<none>'}")
    print(f"DC          = {node.datacenter}")
    print(f"Drain       = {node.drain_strategy is not None}")
    print(f"Eligibility = {node.scheduling_eligibility}")
    print(f"Status      = {node.status}")
    allocs = api.nodes.allocations(node.id)
    if allocs:
        print("\nAllocations")
        print(
            _fmt_table(
                [
                    [a.id[:8], a.job_id, a.task_group, a.client_status]
                    for a in allocs
                ],
                header=["ID", "Job ID", "Task Group", "Status"],
            )
        )
    return 0


def _find_by_prefix(items, prefix: str):
    return _find_by_prefix_attr(items, "id", prefix)


def cmd_node_drain(args) -> int:
    api = _client(args)
    node = _find_by_prefix(api.nodes.list(), args.node_id)
    if args.disable:
        api.nodes.drain(node.id, None, mark_eligible=True)
        print(f"Node {node.id[:8]} drain disabled")
        return 0
    from ..structs.structs import DrainStrategy

    spec = DrainStrategy(
        deadline_s=_duration(args.deadline),
        ignore_system_jobs=args.ignore_system,
    )
    api.nodes.drain(node.id, spec)
    print(f"Node {node.id[:8]} drain enabled (deadline {args.deadline})")
    return 0


def _duration(s: str) -> float:
    from ..jobspec import parse_duration

    return parse_duration(s)


def cmd_node_eligibility(args) -> int:
    api = _client(args)
    node = _find_by_prefix(api.nodes.list(), args.node_id)
    api.nodes.eligibility(node.id, args.enable)
    print(
        f"Node {node.id[:8]} marked "
        + ("eligible" if args.enable else "ineligible")
    )
    return 0


def cmd_alloc_logs(args) -> int:
    """Reference: command/alloc_logs.go."""
    import sys as _sys

    api = _client(args)
    alloc = _find_by_prefix(api.allocations.list(), args.alloc_id)
    task = args.task
    if not task:
        # single-task groups don't need -task
        a = api.allocations.get(alloc.id)
        tasks = list(a.task_states) or [a.task_group]
        task = tasks[0]
    try:
        for chunk in api.allocations.logs(
            alloc.id,
            task=task,
            log_type="stderr" if args.stderr else "stdout",
            follow=args.follow,
        ):
            _sys.stdout.buffer.write(chunk)
            _sys.stdout.buffer.flush()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_alloc_fs(args) -> int:
    """Reference: command/alloc_fs.go — ls when the path is a directory,
    cat when it is a file."""
    import sys as _sys

    api = _client(args)
    alloc = _find_by_prefix(api.allocations.list(), args.alloc_id)
    path = args.path or ""
    st = api.allocations.fs_stat(alloc.id, path)
    if st and st.get("is_dir"):
        entries = api.allocations.fs_ls(alloc.id, path)
        rows = [
            [
                "dir" if e["is_dir"] else "file",
                str(e["size"]),
                e["name"],
            ]
            for e in entries
        ]
        print(_fmt_table(rows, ["Type", "Size", "Name"]))
    else:
        _sys.stdout.buffer.write(api.allocations.fs_cat(alloc.id, path))
    return 0


def cmd_alloc_exec(args) -> int:
    """Reference: command/alloc_exec.go — interactive exec into a task."""
    import os as _os
    import sys as _sys
    import threading as _threading

    api = _client(args)
    alloc = _find_by_prefix(api.allocations.list(), args.alloc_id)
    secret = args.rpc_secret or _os.environ.get("NOMAD_TPU_RPC_SECRET", "")
    # fabric TLS (tls { rpc = true }) is EXPLICIT opt-in (-fabric-tls):
    # inferring it from stray NOMAD_CLIENT_CERT would TLS-dial plaintext
    # fabrics. Creds come from the standard env vars; cert/key optional
    # against an encryption-only fabric, required together for mTLS.
    tls = None
    if args.fabric_tls:
        cert = _os.environ.get("NOMAD_CLIENT_CERT", "")
        key = _os.environ.get("NOMAD_CLIENT_KEY", "")
        if bool(cert) != bool(key):
            print(
                "alloc exec: NOMAD_CLIENT_CERT and NOMAD_CLIENT_KEY "
                "must both be set for fabric mTLS",
                file=_sys.stderr,
            )
            return 1
        ca = _os.environ.get("NOMAD_CACERT", "")
        if not ca:
            # no CA means verify_mode=CERT_NONE: the handshake succeeds
            # against ANY endpoint, and the rpc_secret preamble would go
            # to an unverified peer — loudly flag the downgrade
            print(
                "alloc exec: -fabric-tls without NOMAD_CACERT — server "
                "certificate will NOT be verified",
                file=_sys.stderr,
            )
        tls = (cert, key, ca)
    session = api.allocations.exec_session(
        alloc.id, args.cmd, task=args.task, tty=args.tty, rpc_secret=secret,
        tls=tls,
    )
    stop = _threading.Event()

    def pump_stdin() -> None:
        try:
            while not stop.is_set():
                data = _sys.stdin.buffer.raw.read(4096)
                if not data:
                    break
                session.send_stdin(data)
        except (OSError, ValueError):
            pass

    t = _threading.Thread(
        target=pump_stdin, name="exec-stdin-pump", daemon=True
    )
    t.start()
    try:
        while True:
            msg = session.recv(timeout_s=0.5)
            if msg is None:
                continue
            if msg.get("error"):
                print(f"exec error: {msg['error']}", file=_sys.stderr)
                return 1
            data = msg.get("data")
            if data:
                _sys.stdout.buffer.write(data)
                _sys.stdout.buffer.flush()
            if msg.get("eof"):
                return 0
    except KeyboardInterrupt:
        return 130
    finally:
        stop.set()
        session.close()


def cmd_alloc_status(args) -> int:
    api = _client(args)
    alloc = _find_by_prefix(api.allocations.list(), args.alloc_id)
    alloc = api.allocations.get(alloc.id)
    print(f"ID            = {alloc.id}")
    print(f"Job ID        = {alloc.job_id}")
    print(f"Node ID       = {alloc.node_id}")
    print(f"Task Group    = {alloc.task_group}")
    print(f"Desired       = {alloc.desired_status}")
    print(f"Client Status = {alloc.client_status}")
    # assigned device instances + live stats (reference: alloc status
    # shows Device Stats fed by the device plugin's Stats stream)
    if alloc.resources is not None:
        devlines = []
        for tname, tr in sorted(alloc.resources.tasks.items()):
            for dev in tr.devices or []:
                devlines.append(
                    f"  {tname}: {dev.get('id', '')} -> "
                    + ",".join(dev.get("device_ids", []))
                )
        if devlines:
            print("\nDevices")
            print("\n".join(devlines))
            try:
                stats = api.allocations.stats(alloc.id)
            except Exception:
                stats = {}
            for plugin, insts in sorted((stats.get("devices") or {}).items()):
                print(f"\nDevice Stats ({plugin})")
                for iid, s in sorted(insts.items()):
                    kv = ", ".join(f"{k}={v}" for k, v in sorted(s.items()))
                    print(f"  {iid}: {kv}")
    for task, state in sorted(alloc.task_states.items()):
        print(f"\nTask \"{task}\" is \"{state.state}\"")
        for ev in state.events[-5:]:
            etype = ev.get("type", "")
            msg = ev.get("display_message") or ev.get("message", "")
            print(f"  {etype}: {msg}")
    return 0


def cmd_eval_status(args) -> int:
    api = _client(args)
    ev = _find_by_prefix(api.evaluations.list(), args.eval_id)
    ev = api.evaluations.get(ev.id)
    print(f"ID           = {ev.id}")
    print(f"Status       = {ev.status}")
    print(f"Type         = {ev.type}")
    print(f"TriggeredBy  = {ev.triggered_by}")
    print(f"Job ID       = {ev.job_id}")
    print(f"Priority     = {ev.priority}")
    if ev.blocked_eval:
        print(f"Blocked Eval = {ev.blocked_eval}")
    return 0


def cmd_eval_list(args) -> int:
    api = _client(args)
    evals = api.evaluations.list()
    print(
        _fmt_table(
            [
                [e.id[:8], e.priority, e.triggered_by, e.job_id, e.status]
                for e in evals
            ],
            header=["ID", "Priority", "Triggered By", "Job ID", "Status"],
        )
    )
    return 0


def cmd_deployment_list(args) -> int:
    api = _client(args)
    deps = api.deployments.list()
    print(
        _fmt_table(
            [[d.id[:8], d.job_id, d.status, d.status_description] for d in deps],
            header=["ID", "Job ID", "Status", "Description"],
        )
    )
    return 0


def cmd_deployment_status(args) -> int:
    api = _client(args)
    d = _find_by_prefix(api.deployments.list(), args.deployment_id)
    d = api.deployments.get(d.id)
    print(f"ID          = {d.id}")
    print(f"Job ID      = {d.job_id}")
    print(f"Status      = {d.status}")
    print(f"Description = {d.status_description}")
    rows = []
    for g, s in sorted(d.task_groups.items()):
        rows.append(
            [
                g,
                str(s.desired_total),
                str(s.placed_allocs),
                str(s.healthy_allocs),
                str(s.unhealthy_allocs),
                str(s.desired_canaries),
                "true" if s.promoted else "false",
            ]
        )
    print(
        _fmt_table(
            rows,
            header=[
                "Group",
                "Desired",
                "Placed",
                "Healthy",
                "Unhealthy",
                "Canaries",
                "Promoted",
            ],
        )
    )
    return 0


def cmd_deployment_promote(args) -> int:
    api = _client(args)
    d = _find_by_prefix(api.deployments.list(), args.deployment_id)
    api.deployments.promote(d.id, groups=args.group or None)
    print(f"Deployment {d.id[:8]} promoted")
    return 0


def cmd_deployment_fail(args) -> int:
    api = _client(args)
    d = _find_by_prefix(api.deployments.list(), args.deployment_id)
    api.deployments.fail(d.id)
    print(f"Deployment {d.id[:8]} marked failed")
    return 0


def cmd_deployment_pause(args) -> int:
    api = _client(args)
    d = _find_by_prefix(api.deployments.list(), args.deployment_id)
    api.deployments.pause(d.id, pause=not args.resume)
    print(
        f"Deployment {d.id[:8]} " + ("resumed" if args.resume else "paused")
    )
    return 0


# ---------------------------------------------------------------------------
# server / status / misc


def cmd_acl_bootstrap(args) -> int:
    api = _client(args)
    token = api.acl.bootstrap()
    print(f"Accessor ID = {token.accessor_id}")
    print(f"Secret ID   = {token.secret_id}")
    print(f"Type        = {token.type}")
    return 0


def cmd_acl_policy_apply(args) -> int:
    api = _client(args)
    with open(args.rules_file) as f:
        rules = f.read()
    api.acl.policy_apply(args.name, rules, description=args.description or "")
    print(f'ACL policy "{args.name}" applied')
    return 0


def cmd_acl_policy_list(args) -> int:
    api = _client(args)
    pols = api.acl.policies()
    print(
        _fmt_table(
            [[p.name, p.description] for p in pols],
            header=["Name", "Description"],
        )
    )
    return 0


def cmd_acl_policy_delete(args) -> int:
    api = _client(args)
    api.acl.policy_delete(args.name)
    print(f'ACL policy "{args.name}" deleted')
    return 0


def cmd_acl_token_create(args) -> int:
    api = _client(args)
    token = api.acl.token_create(
        name=args.name or "", type=args.type, policies=args.policy or [],
        global_=getattr(args, "set_global", False),
    )
    print(f"Accessor ID = {token.accessor_id}")
    print(f"Secret ID   = {token.secret_id}")
    print(f"Type        = {token.type}")
    print(f"Policies    = {','.join(token.policies)}")
    return 0


def cmd_acl_token_list(args) -> int:
    api = _client(args)
    tokens = api.acl.tokens()
    print(
        _fmt_table(
            [
                [t.accessor_id[:8], t.name, t.type, ",".join(t.policies)]
                for t in tokens
            ],
            header=["Accessor", "Name", "Type", "Policies"],
        )
    )
    return 0


def cmd_acl_token_delete(args) -> int:
    api = _client(args)
    tokens = api.acl.tokens()
    match = _find_by_prefix_attr(tokens, "accessor_id", args.accessor_id)
    api.acl.token_delete(match.accessor_id)
    print(f"Token {match.accessor_id[:8]} deleted")
    return 0


def _print_token(t) -> None:
    print(f"Accessor ID = {t.accessor_id}")
    print(f"Secret ID   = {t.secret_id}")
    print(f"Name        = {t.name}")
    print(f"Type        = {t.type}")
    print(f"Global      = {t.global_}")
    print(f"Policies    = {','.join(t.policies)}")


def cmd_acl_policy_info(args) -> int:
    api = _client(args)
    p = api.acl.policy(args.name)
    print(f"Name        = {p.name}")
    print(f"Description = {p.description}")
    print("Rules:")
    print(p.rules)
    return 0


def cmd_acl_token_info(args) -> int:
    api = _client(args)
    tokens = api.acl.tokens()
    match = _find_by_prefix_attr(tokens, "accessor_id", args.accessor_id)
    _print_token(api.acl.token(match.accessor_id))
    return 0


def cmd_acl_token_self(args) -> int:
    api = _client(args)
    _print_token(api.acl.token_self())
    return 0


def cmd_acl_token_update(args) -> int:
    api = _client(args)
    fields = {}
    if args.name is not None:
        fields["name"] = args.name
    if args.policy:
        fields["policies"] = args.policy
    if args.type is not None:
        fields["type"] = args.type
    if args.set_global is not None:
        fields["global_"] = args.set_global == "true"
    t = api.acl.token_update(args.accessor_id, **fields)
    _print_token(t)
    return 0


def cmd_job_scaling_events(args) -> int:
    api = _client(args)
    st = api.jobs.scale_status(args.job_id)
    rows = []
    for group, events in sorted((st.get("ScalingEvents") or {}).items()):
        for e in events:
            when = time.strftime(
                "%Y-%m-%dT%H:%M:%S",
                time.localtime(e.get("Time", 0) / 1e9),
            )
            rows.append([
                when, group, e.get("PreviousCount", ""),
                e.get("Count", ""), str(e.get("EvalID", ""))[:8],
                e.get("Message", ""),
            ])
    if not rows:
        print("No scaling events")
        return 0
    print(_fmt_table(
        rows,
        header=["Time", "Group", "Previous", "Count", "Eval", "Message"],
    ))
    return 0


def cmd_namespace_inspect(args) -> int:
    api = _client(args)
    ns = next(
        (n for n in api.namespaces.list() if n.name == args.name), None
    )
    if ns is None:
        print(f"Namespace {args.name!r} not found", file=sys.stderr)
        return 1
    print(json.dumps(
        {"Name": ns.name, "Description": ns.description}, indent=2
    ))
    return 0


def cmd_server_join(args) -> int:
    api = _client(args)
    out = api.agent.join(*args.address)
    if out.get("error"):
        print(f"Join failed: {out['error']}", file=sys.stderr)
        return 1
    print(f"Joined {out['num_joined']} servers successfully")
    return 0


def cmd_check(args) -> int:
    """Agent health probe for external monitors (reference
    command/check.go): exit 0 healthy, 1 unhealthy/unreachable."""
    try:
        h = _client(args).agent.health()
    except Exception as e:
        print(f"unhealthy: {e}", file=sys.stderr)
        return 1
    ok = all(part.get("ok") for part in h.values())
    print("healthy" if ok else f"unhealthy: {h}")
    return 0 if ok else 1


VOLUME_INIT_TEMPLATE = """\
id        = "example-volume"
name      = "example-volume"
type      = "host"
node_id   = "<node-id>"
path      = "/srv/volumes/example"

capability {
  access_mode     = "single-node-writer"
  attachment_mode = "file-system"
}
"""


def cmd_volume_init(args) -> int:
    filename = args.filename or "volume.hcl"
    if os.path.exists(filename):
        print(f"File {filename} already exists", file=sys.stderr)
        return 1
    with open(filename, "w") as f:
        f.write(VOLUME_INIT_TEMPLATE)
    print(f"Example volume specification written to {filename}")
    return 0


def _find_by_prefix_attr(items, attr: str, prefix: str):
    matches = [i for i in items if getattr(i, attr).startswith(prefix)]
    if not matches:
        raise SystemExit(f"No object with ID prefix {prefix!r}")
    if len(matches) > 1:
        raise SystemExit(
            f"Ambiguous prefix {prefix!r} matches {len(matches)} objects"
        )
    return matches[0]


def cmd_operator_snapshot_save(args) -> int:
    """Reference: command/operator_snapshot_save.go."""
    api = _client(args)
    data = api.operator.snapshot_save()
    with open(args.file, "wb") as f:
        f.write(data)
    print(f"State file written to {args.file} ({len(data)} bytes)")
    return 0


def cmd_operator_snapshot_restore(args) -> int:
    """Reference: command/operator_snapshot_restore.go."""
    api = _client(args)
    with open(args.file, "rb") as f:
        data = f.read()
    api.operator.snapshot_restore(data)
    print("Snapshot restored")
    return 0


def cmd_namespace_list(args) -> int:
    api = _client(args)
    nss = api.namespaces.list()
    if not nss:
        print("No namespaces")
        return 0
    print(
        _fmt_table(
            [[n.name, n.description] for n in nss],
            header=["Name", "Description"],
        )
    )
    return 0


def cmd_namespace_apply(args) -> int:
    """Reference: command/namespace_apply.go."""
    from ..structs.structs import Namespace

    api = _client(args)
    api.namespaces.apply(
        Namespace(name=args.name, description=args.description or "")
    )
    print(f'Namespace "{args.name}" applied')
    return 0


def cmd_namespace_delete(args) -> int:
    api = _client(args)
    api.namespaces.delete(args.name)
    print(f'Namespace "{args.name}" deleted')
    return 0


def cmd_volume_register(args) -> int:
    """Reference: command/volume_register.go (host-volume shape)."""
    from ..structs.structs import Volume

    api = _client(args)
    vol = Volume(
        id=args.id,
        namespace=args.namespace or "default",
        name=args.name or args.id,
        type=args.type,
        node_id=args.node or "",
        path=args.path or "",
        access_mode=args.access_mode,
        plugin_id=args.plugin or "",
        external_id=args.external_id or "",
    )
    api.volumes.register(vol)
    print(f'Volume "{vol.id}" registered')
    return 0


def cmd_volume_create(args) -> int:
    """Reference: command/volume_create.go — provision via the CSI
    controller from an HCL volume spec, then register."""
    from ..jobspec.hcl import parse as parse_hcl
    from ..structs.structs import Volume

    with open(args.file) as f:
        body = parse_hcl(f.read())
    a = body.attrs()
    params = {}
    pb = body.block("parameters")
    if pb is not None:
        params = {k: str(v) for k, v in pb.body.attrs().items()}
    vol = Volume(
        id=a.get("id", ""),
        name=a.get("name", a.get("id", "")),
        namespace=a.get("namespace", args.namespace or "default"),
        type="csi",
        plugin_id=a.get("plugin_id", ""),
        access_mode=a.get(
            "access_mode", "multi-node-multi-writer"
        ),
        attachment_mode=a.get("attachment_mode", "file-system"),
        context=params,
    )
    if not vol.id or not vol.plugin_id:
        print("Error: volume spec requires id and plugin_id",
              file=sys.stderr)
        return 1
    api = _client(args)
    out = api.volumes.create(vol)
    print(f'Volume "{vol.id}" created (external id '
          f'"{getattr(out, "external_id", "")}")')
    return 0


def cmd_volume_delete(args) -> int:
    api = _client(args)
    api.volumes.delete(args.id, namespace=args.namespace)
    print(f'Volume "{args.id}" deleted')
    return 0


def cmd_volume_detach(args) -> int:
    api = _client(args)
    out = api.volumes.detach(
        args.volume_id, args.node_id, namespace=args.namespace
    )
    print(
        f"Volume {args.volume_id} detached from {args.node_id} "
        f"({out['released_claims']} claims released)"
    )
    return 0


def cmd_volume_snapshot_create(args) -> int:
    api = _client(args)
    out = api.volumes.snapshot_create(
        args.volume_id, name=args.name or "", namespace=args.namespace
    )
    print(f"Snapshot ID  = {out.get('snapshot_id')}")
    print(f"Volume ID    = {args.volume_id}")
    print(f"Size (MB)    = {out.get('size_mb')}")
    print(f"Ready        = {out.get('ready')}")
    return 0


def cmd_volume_snapshot_delete(args) -> int:
    api = _client(args)
    api.volumes.snapshot_delete(args.plugin_id, args.snapshot_id)
    print(f"Snapshot {args.snapshot_id} deleted")
    return 0


def cmd_volume_snapshot_list(args) -> int:
    api = _client(args)
    snaps = api.volumes.snapshot_list(args.plugin_id)
    print(_fmt_table(
        [
            [
                s.get("snapshot_id", ""),
                s.get("source_external_id", ""),
                s.get("size_mb", ""),
                "ready" if s.get("ready") else "pending",
            ]
            for s in snaps
        ],
        header=["Snapshot", "Volume", "Size MB", "Status"],
    ))
    return 0


def cmd_volume_status(args) -> int:
    api = _client(args)
    if args.id:
        vol = api.volumes.get(args.id, namespace=args.namespace)
        print(f"ID          = {vol.id}")
        print(f"Name        = {vol.name}")
        print(f"Namespace   = {vol.namespace}")
        print(f"Type        = {vol.type}")
        print(f"Access Mode = {vol.access_mode}")
        print(f"Claims      = {len(vol.claims)}")
        for c in vol.claims.values():
            mode = "read" if c.read_only else "write"
            print(f"  alloc {c.alloc_id[:8]} on {c.node_id[:8]} ({mode})")
        return 0
    vols = api.volumes.list(namespace=args.namespace)
    if not vols:
        print("No volumes")
        return 0
    print(
        _fmt_table(
            [
                [v.id, v.name, v.type, v.access_mode, str(len(v.claims))]
                for v in sorted(vols, key=lambda v: v.id)
            ],
            header=["ID", "Name", "Type", "Access Mode", "Claims"],
        )
    )
    return 0


def cmd_volume_deregister(args) -> int:
    api = _client(args)
    api.volumes.deregister(args.id, namespace=args.namespace)
    print(f'Volume "{args.id}" deregistered')
    return 0


def cmd_job_scale(args) -> int:
    """Reference: command/job_scale.go."""
    api = _client(args)
    out = api.jobs.scale(args.job_id, args.group, args.count)
    print(f'Job "{args.job_id}" group "{args.group}" scaled to {args.count}')
    if out.get("EvalID"):
        print(f"Evaluation ID: {out['EvalID']}")
    return 0


def cmd_monitor(args) -> int:
    """Reference: command/monitor.go — tail the agent's logs."""
    import urllib.request

    addr, tok, _ = _conn_opts(args)
    url = f"{addr}/v1/agent/monitor?log_level={args.log_level}"
    req = urllib.request.Request(url)
    if tok:
        req.add_header("X-Nomad-Token", tok)
    try:
        with urllib.request.urlopen(req) as resp:
            for line in resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue
                rec = json.loads(line)
                print(f"[{rec['Level']}] {rec['Name']}: {rec['Message']}")
    except KeyboardInterrupt:
        pass
    return 0


def cmd_operator_raft_remove_peer(args) -> int:
    api = _client(args)
    api.operator.raft_remove_peer(args.peer_id)
    print(f'Removed raft peer "{args.peer_id}"')
    return 0


def cmd_alloc_restart(args) -> int:
    """Reference: command/alloc_restart.go."""
    api = _client(args)
    api.allocations.restart(args.alloc_id, task=args.task or "")
    print(f"Allocation {args.alloc_id[:8]} restarted")
    return 0


def cmd_alloc_signal(args) -> int:
    """Reference: command/alloc_signal.go."""
    api = _client(args)
    api.allocations.signal(args.alloc_id, args.signal, task=args.task or "")
    print(f"Signalled allocation {args.alloc_id[:8]} with {args.signal}")
    return 0


def cmd_alloc_stop(args) -> int:
    """Reference: command/alloc_stop.go — stop + reschedule."""
    api = _client(args)
    out = api.allocations.stop(args.alloc_id)
    print(f"Allocation {args.alloc_id[:8]} stopping")
    if out.get("EvalID"):
        print(f"Evaluation ID: {out['EvalID']}")
    return 0


def cmd_scaling_policy_list(args) -> int:
    """Reference: command/scaling_policy_list.go."""
    api = _client(args)
    pols = api.scaling.list_policies(namespace=args.namespace)
    if not pols:
        print("No scaling policies")
        return 0
    print(
        _fmt_table(
            [
                [p.id, p.job_id, p.group, str(p.min), str(p.max),
                 str(p.enabled)]
                for p in pols
            ],
            header=["ID", "Job", "Group", "Min", "Max", "Enabled"],
        )
    )
    return 0


def cmd_scaling_policy_info(args) -> int:
    """Reference: command/scaling_policy_info.go."""
    api = _client(args)
    p = api.scaling.get_policy(args.policy_id)
    print(f"ID      = {p.id}")
    print(f"Job     = {p.job_id}")
    print(f"Group   = {p.group}")
    print(f"Type    = {p.type}")
    print(f"Min     = {p.min}")
    print(f"Max     = {p.max}")
    print(f"Enabled = {p.enabled}")
    if p.policy:
        print("Policy:")
        for k in sorted(p.policy):
            print(f"  {k} = {p.policy[k]}")
    return 0


def cmd_job_eval(args) -> int:
    """Reference: command/job_eval.go — force a new evaluation."""
    api = _client(args)
    out = api.jobs.evaluate(args.job_id)
    print(f"Created eval {out['EvalID'][:8]} for job \"{args.job_id}\"")
    return 0


def cmd_job_deployments(args) -> int:
    """Reference: command/job_deployments.go."""
    api = _client(args)
    deps = api.jobs.deployments(args.job_id)
    if not deps:
        print("No deployments")
        return 0
    print(
        _fmt_table(
            [
                [d.id[:8], str(d.job_version), d.status,
                 d.status_description[:60]]
                for d in sorted(
                    deps, key=lambda d: d.job_version, reverse=True
                )
            ],
            header=["ID", "Job Version", "Status", "Description"],
        )
    )
    return 0


def cmd_job_promote(args) -> int:
    """Reference: command/job_promote.go — promote the job's latest
    deployment's canaries."""
    api = _client(args)
    deps = api.jobs.deployments(args.job_id)
    active = [d for d in deps if d.active()]
    if not active:
        print(f'No active deployment for job "{args.job_id}"',
              file=sys.stderr)
        return 1
    d = max(active, key=lambda d: d.job_version)
    api.deployments.promote(d.id)
    print(f"Deployment {d.id[:8]} promoted")
    return 0


def cmd_namespace_status(args) -> int:
    """Reference: command/namespace_status.go."""
    api = _client(args)
    ns = api.namespaces.get(args.name)
    print(f"Name        = {ns.name}")
    print(f"Description = {ns.description}")
    jobs = api.jobs.list(namespace=args.name)
    print(f"Jobs        = {len(jobs)}")
    return 0


def cmd_system_reconcile(args) -> int:
    """Reference: command/system_reconcile_summaries.go."""
    api = _client(args)
    out = api.system.reconcile_summaries()
    print(f"Reconciled {out['Reconciled']} job summaries")
    return 0


def cmd_server_force_leave(args) -> int:
    """Reference: command/server_force_leave.go."""
    api = _client(args)
    out = api.agent.force_leave(args.node)
    print(f'Member "{args.node}" force-left ({out["Acked"]} peers acked)')
    return 0


def cmd_operator_autopilot_get(args) -> int:
    api = _client(args)
    cfg = api.operator.autopilot_configuration()
    print(f"CleanupDeadServers = {cfg['CleanupDeadServers']}")
    return 0


def cmd_operator_autopilot_set(args) -> int:
    api = _client(args)
    cfg = {}
    if args.cleanup_dead_servers is not None:
        cfg["CleanupDeadServers"] = args.cleanup_dead_servers == "true"
    api.operator.autopilot_set_configuration(cfg)
    print("Autopilot configuration updated!")
    return 0


def cmd_operator_keygen(args) -> int:
    """Reference: command/operator_keygen.go — a random fabric secret
    (rpc_secret in agent config)."""
    import base64
    import secrets as _secrets

    print(base64.b64encode(_secrets.token_bytes(32)).decode())
    return 0


def _render_keyring_status(st: dict) -> None:
    print(f"Enabled          = {st.get('enabled')}")
    print(f"Generation       = {st.get('generation')}")
    print(f"Current Key      = {st.get('current_fingerprint') or '(none)'}")
    print(f"Key Age          = {st.get('age_s')}s")
    if st.get("dual_accept"):
        print(
            f"Dual-Accept      = open (previous "
            f"{st.get('previous_fingerprint')}, "
            f"{st.get('window_remaining_s')}s remaining)"
        )
    else:
        print("Dual-Accept      = closed")


def cmd_operator_keyring_status(args) -> int:
    """Reference: command/operator_keyring.go list — here the fabric
    rpc_secret keyring (rpc/keyring.py), fingerprints only."""
    api = _client(args)
    st = api.agent.keyring_status()
    if args.as_json:
        print(json.dumps(st, indent=2))
        return 0
    _render_keyring_status(st)
    return 0


def cmd_operator_keyring_rotate(args) -> int:
    """Rotate the TARGET AGENT's fabric secret live (the API analog of
    editing rpc_secret + SIGHUP; run against each agent in turn — the
    dual-accept window keeps the mixed cluster flowing)."""
    from ..jobspec.hcl import parse_duration

    api = _client(args)
    window = parse_duration(args.window) if args.window else None
    st = api.agent.keyring_rotate(args.secret, window_s=window)
    if args.as_json:
        print(json.dumps(st, indent=2))
        return 0
    if st.get("rotated"):
        print("Keyring rotated!")
    else:
        print("Keyring unchanged (secret already current)")
    _render_keyring_status(st)
    return 0


def cmd_operator_snapshot_inspect(args) -> int:
    """Reference: command/operator_snapshot_inspect.go."""
    from .. import codec

    with open(args.file, "rb") as f:
        raw = f.read()
    data = codec.unpack(raw)
    tables = data.get("tables", data) if isinstance(data, dict) else {}
    print(f"File    = {args.file}")
    print(f"Size    = {len(raw)} bytes")
    rows = []
    for name, t in sorted(tables.items()):
        try:
            rows.append([name, str(len(t))])
        except TypeError:
            rows.append([name, "?"])
    if rows:
        print(_fmt_table(rows, header=["Table", "Entries"]))
    return 0


def cmd_ui(args) -> int:
    """Reference: command/ui.go — print (and try to open) the web UI."""
    addr, _, _ = _conn_opts(args)
    url = f"{addr}/ui/"
    print(f"Opening URL {url}")
    try:
        import webbrowser

        webbrowser.open(url)
    except Exception:
        pass
    return 0


def cmd_eval_delete(args) -> int:
    """Reference: command/eval_delete.go."""
    api = _client(args)
    api.evaluations.delete(args.eval_id)
    print(f"Deleted evaluation {args.eval_id[:8]}")
    return 0


def cmd_node_purge(args) -> int:
    """Reference: command/node_status.go -purge path (Node.Purge)."""
    api = _client(args)
    api.put(f"/v1/node/{args.node_id}/purge")
    print(f"Node {args.node_id[:8]} purged")
    return 0


def cmd_system_gc(args) -> int:
    """Reference: command/system_gc.go."""
    api = _client(args)
    api.system.gc()
    print("System GC triggered")
    return 0


def cmd_operator_scheduler_get(args) -> int:
    api = _client(args)
    cfg = api.operator.scheduler_configuration()
    print(f"Scheduler Algorithm          = {cfg['SchedulerAlgorithm']}")
    pre = cfg["PreemptionConfig"]
    print(f"Preemption Service Enabled   = {pre['ServiceSchedulerEnabled']}")
    print(f"Preemption Batch Enabled     = {pre['BatchSchedulerEnabled']}")
    print(f"Preemption System Enabled    = {pre['SystemSchedulerEnabled']}")
    print(f"Preemption SysBatch Enabled  = {pre['SysBatchSchedulerEnabled']}")
    print(
        f"Memory Oversubscription      = "
        f"{cfg['MemoryOversubscriptionEnabled']}"
    )
    print(f"Placement Backend            = {cfg.get('Backend', 'host')}")
    return 0


def cmd_operator_scheduler_set(args) -> int:
    api = _client(args)
    cfg: dict = {}
    if args.scheduler_algorithm:
        cfg["SchedulerAlgorithm"] = args.scheduler_algorithm
    pre = {}
    for flag, key in (
        (args.preempt_service, "ServiceSchedulerEnabled"),
        (args.preempt_batch, "BatchSchedulerEnabled"),
        (args.preempt_system, "SystemSchedulerEnabled"),
        (args.preempt_sysbatch, "SysBatchSchedulerEnabled"),
    ):
        if flag is not None:
            pre[key] = flag == "true"
    if pre:
        cfg["PreemptionConfig"] = pre
    if args.memory_oversubscription is not None:
        cfg["MemoryOversubscriptionEnabled"] = (
            args.memory_oversubscription == "true"
        )
    api.operator.scheduler_set_configuration(cfg)
    print("Scheduler configuration updated!")
    return 0


def cmd_agent_info(args) -> int:
    """Reference: command/agent_info.go."""
    api = _client(args)
    info = api.get("/v1/agent/self")
    print(json.dumps(info, indent=2, default=codec.json_default))
    return 0


def cmd_job_validate(args) -> int:
    """Reference: command/job_validate.go — parse + validate locally,
    then server-side (/v1/validate/job) when a server is reachable."""
    try:
        job = _load_jobfile(args.jobfile, _parse_vars(args.var))
        job.canonicalize()
        job.validate()
    except Exception as e:
        print(f"Job validation errors:\n  {e}", file=sys.stderr)
        return 1
    try:
        out = _client(args).jobs.validate(job)
    except APIError as e:
        # a REACHABLE server's error (ACL denial, 500) must surface —
        # only an unreachable server downgrades to local-only checks
        print(f"Server-side validation failed: {e}", file=sys.stderr)
        return 1
    except Exception:
        out = None  # no server: local validation stands alone
    if out and out.get("Error"):
        print(f"Job validation errors:\n  {out['Error']}", file=sys.stderr)
        return 1
    print("Job validation successful")
    return 0


_EXAMPLE_JOB = """\
# Example jobspec (reference: command/job_init.go's example.nomad)
job "example" {
  datacenters = ["dc1"]
  type        = "service"

  group "cache" {
    count = 1

    task "redis" {
      driver = "rawexec"

      config {
        command = "/bin/sleep"
        args    = ["3600"]
      }

      resources {
        cpu    = 500
        memory = 256
      }
    }
  }
}
"""


def cmd_job_init(args) -> int:
    """Reference: command/job_init.go."""
    path = args.filename or "example.nomad"
    if os.path.exists(path):
        print(f"Error: {path} already exists", file=sys.stderr)
        return 1
    with open(path, "w") as f:
        f.write(_EXAMPLE_JOB)
    print(f"Example job file written to {path}")
    return 0


def cmd_node_meta(args) -> int:
    """Reference: command/node_meta_read.go."""
    api = _client(args)
    node = api.nodes.get(args.node_id)
    for k in sorted(node.meta):
        print(f"{k} = {node.meta[k]}")
    if not node.meta:
        print("No node metadata")
    return 0


def cmd_secret_put(args) -> int:
    api = _client(args)
    items = {}
    for kv in args.items:
        if "=" not in kv:
            print(f"Error: item {kv!r} must be key=value", file=sys.stderr)
            return 1
        k, _, v = kv.partition("=")
        items[k] = v
    api.secrets.put(args.path, items, namespace=args.namespace)
    print(f'Secret "{args.path}" written ({len(items)} keys)')
    return 0


def cmd_secret_get(args) -> int:
    api = _client(args)
    entry = api.secrets.get(args.path, namespace=args.namespace)
    for k in sorted(entry.items):
        print(f"{k} = {entry.items[k]}")
    return 0


def cmd_secret_list(args) -> int:
    api = _client(args)
    rows = api.secrets.list(namespace=args.namespace)
    if not rows:
        print("No secrets")
        return 0
    print(
        _fmt_table(
            [[r["path"], ",".join(r["keys"])] for r in rows],
            header=["Path", "Keys"],
        )
    )
    return 0


def cmd_secret_delete(args) -> int:
    api = _client(args)
    api.secrets.delete(args.path, namespace=args.namespace)
    print(f'Secret "{args.path}" deleted')
    return 0


def cmd_service_list(args) -> int:
    """Reference: command/service_list.go."""
    api = _client(args)
    rows = api.services.list(namespace=args.namespace)
    if not rows:
        print("No services")
        return 0
    print(
        _fmt_table(
            [
                [r["service_name"], ",".join(r["tags"]), str(r["instances"])]
                for r in rows
            ],
            header=["Service Name", "Tags", "Instances"],
        )
    )
    return 0


def cmd_service_info(args) -> int:
    """Reference: command/service_info.go."""
    api = _client(args)
    try:
        regs = api.services.get(args.name, namespace=args.namespace)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(
        _fmt_table(
            [
                [
                    f"{r.address}:{r.port}",
                    r.status or "-",
                    r.alloc_id[:8],
                    r.node_id[:8],
                    ",".join(r.tags),
                ]
                for r in regs
            ],
            header=["Address", "Status", "Alloc ID", "Node ID", "Tags"],
        )
    )
    return 0


def cmd_plugin_status(args) -> int:
    """Reference: command/plugin_status.go (CSI plugin health)."""
    api = _client(args)
    if args.id:
        p = api.plugins.get(args.id)
        print(f"ID                   = {p['id']}")
        print(f"Version              = {p.get('version', '')}")
        print(
            f"Controllers Healthy  = "
            f"{p['controllers_healthy']}/{p['controllers_expected']}"
        )
        print(
            f"Nodes Healthy        = "
            f"{p['nodes_healthy']}/{p['nodes_expected']}"
        )
        return 0
    plugins = api.plugins.list()
    if not plugins:
        print("No CSI plugins")
        return 0
    print(
        _fmt_table(
            [
                [
                    p["id"],
                    p.get("version", ""),
                    f"{p['controllers_healthy']}/{p['controllers_expected']}",
                    f"{p['nodes_healthy']}/{p['nodes_expected']}",
                ]
                for p in plugins
            ],
            header=["ID", "Version", "Controllers Healthy", "Nodes Healthy"],
        )
    )
    return 0


def cmd_operator_debug(args) -> int:
    """Reference: command/operator_debug.go — capture a support bundle
    (cluster state, metrics, thread dumps) into an archive."""
    import json as _json
    import tarfile
    import time as _time

    from .. import codec
    from ..agent.debug import debug_bundle

    api = _client(args)
    bundle = debug_bundle(api)
    out = args.output or f"nomad-debug-{_time.strftime('%Y%m%d-%H%M%S')}.tar.gz"
    with tarfile.open(out, "w:gz") as tar:
        for name, payload in bundle.items():
            data = _json.dumps(
                codec.to_wire(payload), indent=2, default=codec.json_default
            ).encode()
            info = tarfile.TarInfo(name=f"debug/{name}.json")
            info.size = len(data)
            import io as _io

            tar.addfile(info, _io.BytesIO(data))
    print(f"Debug capture written to {out}")
    return 0


def cmd_operator_metrics(args) -> int:
    """Reference: command/operator_metrics.go — dump agent telemetry."""
    import json as _json

    api = _client(args)
    snap = api.agent.metrics()
    if args.as_json:
        print(_json.dumps(snap, indent=2, sort_keys=True))
        return 0
    print(f"Uptime: {snap.get('uptime_seconds', 0):.0f}s")
    for section in ("counters", "gauges"):
        vals = snap.get(section) or {}
        if vals:
            print(f"\n{section.capitalize()}:")
            for k in sorted(vals):
                print(f"  {k} = {vals[k]}")
    samples = snap.get("samples") or {}
    if samples:
        print("\nSamples (count/mean/max):")
        for k in sorted(samples):
            s = samples[k]
            print(
                f"  {k} = {int(s['count'])} / {s['mean']:.6f} / "
                f"{s['max']:.6f}"
            )
    return 0


def _fmt_dur(s: float) -> str:
    """Compact duration: 840us / 12.5ms / 1.24s."""
    if s < 0.001:
        return f"{s * 1e6:.0f}us"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


# `operator top` row order: the end-to-end pipeline first (enqueue →
# dequeue → solve → queue → verify/apply), then whatever else is hot
_TOP_STAGE_ORDER = [
    "nomad.eval.e2e_seconds",
    "nomad.broker.wait_seconds",
    "nomad.worker.invoke_seconds.service",
    "nomad.worker.invoke_seconds.batch",
    "nomad.worker.lane.interactive_seconds",
    "nomad.worker.lane.batch_seconds",
    "nomad.tpu.batch_dispatch_seconds",
    "nomad.tpu.micro_seconds",
    "nomad.tpu.host_prep_seconds",
    "nomad.tpu.device_seconds",
    "nomad.tpu.readback_seconds",
    "nomad.tpu.materialize_seconds",
    "nomad.tpu.commit_seconds",
    "nomad.plan.submit_seconds",
    "nomad.plan_queue.wait_seconds",
    "nomad.plan_apply.batch_seconds",
    "nomad.raft.apply_seconds",
]


def _render_top(
    snap: dict, prev, solver=None, profile=None, blackbox=None
) -> str:
    """One `operator top` frame from a /v1/metrics snapshot. prev is
    (monotonic_time, snapshot) of the previous frame (None on the
    first) — eval throughput is the e2e-count delta between frames,
    falling back to the last window's rate. solver is the optional
    /v1/solver/status payload feeding the solver panel row; profile the
    optional /v1/profile/status payload feeding the host row; blackbox
    the optional /v1/blackbox/status payload feeding the incidents
    row."""
    import time as _time

    gauges = snap.get("gauges") or {}
    samples = snap.get("samples") or {}
    e2e = samples.get("nomad.eval.e2e_seconds") or {}
    total_evals = int(e2e.get("count", 0))
    rate = None
    if prev is not None:
        prev_t, prev_snap = prev
        dt = _time.monotonic() - prev_t
        prev_count = int(
            (prev_snap.get("samples", {}).get("nomad.eval.e2e_seconds")
             or {}).get("count", 0)
        )
        if dt > 0:
            rate = (total_evals - prev_count) / dt
    if rate is None:
        win = e2e.get("window")
        if win and win.get("interval_s"):
            rate = win["count"] / max(win["interval_s"], 1e-9)
    lines = [
        f"nomad-tpu top — uptime {snap.get('uptime_seconds', 0):.0f}s",
        "",
        (
            f"Throughput  {rate:.1f} evals/s" if rate is not None
            else "Throughput  -"
        )
        + f"   total {total_evals} evals"
        + f"   failed {int(gauges.get('nomad.broker.failed', 0))}",
        (
            "Queues      broker ready "
            f"{int(gauges.get('nomad.broker.total_ready', 0))}"
            f"  unacked {int(gauges.get('nomad.broker.total_unacked', 0))}"
            f"  blocked {int(gauges.get('nomad.broker.total_blocked', 0))}"
            f"  waiting {int(gauges.get('nomad.broker.total_waiting', 0))}"
            f"   plan queue {int(gauges.get('nomad.plan_queue.depth', 0))}"
        ),
        (
            f"Workers     {int(gauges.get('nomad.workers.count', 0))}"
            " scheduler worker(s)"
            f"   processed {int(gauges.get('nomad.workers.processed', 0))}"
        ),
    ]
    # overload panel: admission shed / front-door throttle / backpressure
    # counters (docs/operations.md § Surviving overload). Rendered when
    # admission control is configured or any overload signal has fired —
    # an unconfigured quiet cluster keeps the compact layout.
    counters = snap.get("counters") or {}
    shed = int(counters.get("nomad.broker.shed", 0))
    rejected = int(counters.get("nomad.broker.rejected", 0))
    throttled = int(
        counters.get("nomad.http.throttled", 0)
        + counters.get("nomad.rpc.throttled", 0)
    )
    bp_level = gauges.get("nomad.worker.backpressure_level")
    if (
        shed or rejected or throttled or bp_level
        or gauges.get("nomad.broker.admission_depth")
    ):
        lines.append(
            f"Overload    shed {shed}   rejected(429) {rejected}"
            f"   throttled http+rpc {throttled}"
            f"   pending {int(gauges.get('nomad.broker.total_pending', 0))}"
            + (
                f"/{int(gauges.get('nomad.broker.admission_depth', 0))}"
                if gauges.get("nomad.broker.admission_depth")
                else ""
            )
            + (
                f"   backpressure {bp_level * 100:.0f}%"
                if bp_level is not None
                else ""
            )
        )
    # priority-lane panel (the interactive fast path, docs/pipeline.md):
    # rendered once the TPU worker has classified anything — lane
    # counters plus the two lanes' p50s side by side, so lane starvation
    # (interactive p50 drifting toward the batch cadence) reads straight
    # off the dashboard (docs/operations.md § Diagnosing a slow
    # interactive eval).
    ia_n = int(counters.get("nomad.worker.lane.interactive", 0))
    if ia_n:
        ia_s = samples.get("nomad.worker.lane.interactive_seconds") or {}
        b_s = samples.get("nomad.worker.lane.batch_seconds") or {}
        micro_n = int(counters.get("nomad.worker.lane.micro", 0))
        preempted = int(
            counters.get("nomad.worker.lane.drain_preempted", 0)
        )
        lines.append(
            f"Lanes       interactive {ia_n}"
            + (
                f" (p50 {_fmt_dur(ia_s['p50'])})"
                if ia_s.get("count") and "p50" in ia_s
                else ""
            )
            + f"   micro {micro_n}"
            + f"   drain preempted {preempted}"
            + (
                f"   batch p50 {_fmt_dur(b_s['p50'])}"
                if b_s.get("count") and "p50" in b_s
                else ""
            )
        )
    # solver panel: occupancy %, steady-state recompiles, device p95 —
    # /v1/solver/status for the ledger, /v1/metrics for the occupancy
    # histogram and the device-stage percentiles. Rendered only when a
    # solver actually exists here: a TPU batch worker is wired, or
    # batches have been solved (the snapshot itself is always truthy,
    # control-plane-only agents included).
    occ_s = samples.get("nomad.solver.occupancy")
    has_solver = solver is not None and (
        solver.get("worker") is not None
        or (solver.get("occupancy") or {}).get("batches")
    )
    if has_solver or (occ_s and occ_s.get("count")):
        ledger = (solver or {}).get("ledger") or {}
        steady = ledger.get("steady_recompiles", "-")
        dev = samples.get("nomad.tpu.device_seconds") or {}
        occ_txt = (
            f"{occ_s['last'] * 100:.1f}%"
            if occ_s and occ_s.get("count")
            else "-"
        )
        lines.append(
            f"Solver      occupancy {occ_txt}"
            f"   steady recompiles {steady}"
            + (
                f"   device p95 {_fmt_dur(dev['p95'])}"
                if dev.get("count") and "p95" in dev
                else "   device p95 -"
            )
        )
        # solver-pool row (only-when-nonzero, like the overload rows):
        # membership with per-member in-flight counts shown only for
        # members that actually hold a dispatched batch right now
        pool = (solver or {}).get("pool") or {}
        pmembers = [
            m for m in pool.get("members") or [] if not m.get("self")
        ]
        if pmembers or pool.get("dispatched"):
            mem_txt = " ".join(
                f"{m['id']}:{m['in_flight']}"
                if m.get("in_flight")
                else str(m["id"])
                for m in pmembers
            ) or "-"
            lines.append(
                f"SolverPool  members {len(pmembers)} [{mem_txt}]"
                f"   dispatched {pool.get('dispatched', 0)}"
                + (
                    f"   in-flight {pool['in_flight']}"
                    if pool.get("in_flight")
                    else ""
                )
                + (
                    f"   faults {pool['faults']}"
                    if pool.get("faults")
                    else ""
                )
            )
    # host-attribution row (always-on profiler, hostobs.py): rendered
    # only when the profiler has actually attributed something — busy
    # samples or GC activity (the only-render-when-nonzero pattern the
    # overload/solver rows follow); a quiet un-profiled agent keeps the
    # compact layout.
    if profile is not None:
        p_busy = profile.get("busy_seconds", 0.0)
        p_gc = (profile.get("gc") or {}).get("collections") or {}
        gc_n = sum(p_gc.values())
        if p_busy or gc_n:
            window = max(profile.get("window_seconds", 0.0), 1e-9)
            spans = profile.get("spans") or {}
            top_span = next(
                (s for s in spans if s != "-"), None
            ) or (next(iter(spans), None))
            gc_tot = (profile.get("gc") or {}).get(
                "pause_seconds_total", 0.0
            )
            lines.append(
                f"Host        busy {p_busy / window * 100:.1f}%"
                + (f"   top span {top_span}" if top_span else "")
                + f"   gc {gc_n} pauses"
                + (f" ({_fmt_dur(gc_tot)})" if gc_tot else "")
                + (
                    f"   rss {_fmt_bytes(profile['runtime']['rss_bytes'])}"
                    if (profile.get("runtime") or {}).get("rss_bytes")
                    else ""
                )
            )
    # fleet panel (heartbeat wheel + alloc-watch hub + node door,
    # docs/operations.md § Surviving a reconnect storm): rendered once
    # any node TTL is armed or a fleet signal has fired — a cluster
    # with no client nodes keeps the compact layout.
    armed = int(gauges.get("nomad.heartbeat.armed", 0))
    nodes_down = int(gauges.get("nomad.fleet.nodes_down", 0))
    expired = int(counters.get("nomad.heartbeat.expired", 0))
    node_throttled = int(counters.get("nomad.rpc.node_throttled", 0))
    if armed or nodes_down or expired or node_throttled:
        lines.append(
            f"Fleet       nodes ready "
            f"{int(gauges.get('nomad.fleet.nodes_ready', 0))}"
            f"  down {nodes_down}"
            f"   ttl armed {armed}"
            f" ({int(gauges.get('nomad.heartbeat.wheel_buckets', 0))}"
            " buckets)"
            f"   expired {expired}"
            f"   watchers "
            f"{int(gauges.get('nomad.fleet.watch_subscribers', 0))}"
            + (
                f"   node throttled(429) {node_throttled}"
                if node_throttled
                else ""
            )
        )
    # incidents row (flight recorder, blackbox.py): rendered only when
    # the recorder has fired a trigger or captured/suppressed an
    # incident — a healthy cluster keeps the compact layout, and the
    # row appearing at all is itself the signal (docs/incidents.md).
    if blackbox is not None:
        bstats = blackbox.get("stats") or {}
        fired = int(bstats.get("triggers_fired", 0))
        captured = int(bstats.get("incidents_captured", 0))
        suppressed = int(bstats.get("incidents_suppressed", 0))
        if fired or captured or suppressed:
            last = next(iter(blackbox.get("incidents") or []), None)
            lines.append(
                f"Incidents   captured {captured}"
                f" (stored {int(bstats.get('incidents_stored', 0))})"
                f"   triggers fired {fired}"
                f"  deduped {int(bstats.get('triggers_deduped', 0))}"
                + (
                    f"   suppressed {suppressed}" if suppressed else ""
                )
                + (
                    f"   last {last['id']}" if last else ""
                )
            )
    lines += [
        "",
        "Stage latencies (cumulative | last window):",
    ]
    ordered = [n for n in _TOP_STAGE_ORDER if n in samples]
    rest = sorted(
        (
            n for n in samples
            if "_seconds" in n and n not in _TOP_STAGE_ORDER
        ),
        key=lambda n: -samples[n].get("count", 0),
    )
    rows = []
    for name in ordered + rest:
        s = samples[name]
        if "p50" not in s:
            continue  # legacy-mode sample: no distribution to show
        win = s.get("window") or {}
        rows.append([
            name,
            str(int(s["count"])),
            _fmt_dur(s["p50"]), _fmt_dur(s["p95"]), _fmt_dur(s["p99"]),
            "|",
            str(int(win.get("count", 0))),
            _fmt_dur(win["p50"]) if win else "-",
            _fmt_dur(win["p95"]) if win else "-",
            _fmt_dur(win["p99"]) if win else "-",
        ])
    lines.append(_fmt_table(
        rows,
        ["STAGE", "COUNT", "P50", "P95", "P99",
         "|", "WCOUNT", "WP50", "WP95", "WP99"],
    ))
    return "\n".join(lines)


def _render_cluster_health(h: dict, prev=None) -> str:
    """Render one /v1/operator/cluster/health payload: per-server rows
    (raft indices, depths, host CPU/RSS, top source) + fleet totals.
    prev is (monotonic_time, health) of the previous frame — per-server
    CPU% is the cpu_seconds delta between frames (operator top
    -cluster); '-' on the first frame or for degraded members."""
    import time as _time

    servers = h.get("servers") or []
    n = len(servers)
    lines = [
        f"Cluster health — region {h.get('region', '-')}"
        f"   leader {h.get('leader') or '-'}"
        f"   {h.get('healthy', 0)}/{n} healthy"
        f"   queried via {h.get('queried_by', '-')}"
        f" in {h.get('elapsed_s', 0)}s",
        "",
    ]
    prev_cpu: dict = {}
    dt = None
    if prev is not None:
        prev_t, prev_h = prev
        dt = max(_time.monotonic() - prev_t, 1e-9)
        for s in prev_h.get("servers") or []:
            host = s.get("host") or {}
            if s.get("status") == "ok" and "cpu_seconds" in host:
                prev_cpu[s["id"]] = host["cpu_seconds"]
    rows = []
    for s in servers:
        if s.get("status") != "ok":
            rows.append([
                s.get("id", "?"), "degraded", "-", "-", "-", "-",
                "-", "-", (s.get("error") or "")[:40],
            ])
            continue
        raft = s.get("raft") or {}
        broker = s.get("broker") or {}
        host = s.get("host") or {}
        top_src = next(
            (r["source"] for r in (s.get("sources") or {}).get(
                "top", []
            )),
            "-",
        )
        cpu = host.get("cpu_seconds")
        cpu_txt = "-"
        if cpu is not None and s["id"] in prev_cpu and dt:
            cpu_txt = f"{(cpu - prev_cpu[s['id']]) / dt * 100:.0f}%"
        elif cpu is not None:
            cpu_txt = f"{cpu:.1f}s"
        rows.append([
            s["id"] + ("*" if s.get("leader") else ""),
            "ok",
            f"{raft.get('commit_index', 0)}/"
            f"{raft.get('applied_index', 0)}",
            str(int(broker.get("total_ready", 0))),
            str(int(broker.get("total_unacked", 0))),
            str(int(s.get("plan_queue_depth", 0))),
            cpu_txt,
            _fmt_bytes(host.get("rss_bytes", 0)),
            top_src,
        ])
    lines.append(_fmt_table(
        rows,
        ["SERVER", "STATUS", "RAFT C/A", "READY", "UNACKED",
         "PLANQ", "CPU", "RSS", "TOP SOURCE"],
    ))
    fleet = h.get("fleet") or {}
    lines += [
        "",
        (
            "Fleet totals"
            f"   broker ready {fleet.get('broker_ready', 0)}"
            f"  unacked {fleet.get('broker_unacked', 0)}"
            f"   plan queue {fleet.get('plan_queue_depth', 0)}"
            f"   cpu {fleet.get('cpu_seconds', 0.0):.1f}s"
            f"   rss {_fmt_bytes(fleet.get('rss_bytes', 0))}"
        ),
    ]
    src_rows = [
        [r["source"], str(r["calls"]), f"{r['seconds']:.3f}s"]
        for r in fleet.get("sources_top") or []
    ]
    if src_rows:
        lines += [
            "",
            "Top sources by handler seconds (fleet-wide):",
            _fmt_table(src_rows, ["SOURCE", "CALLS", "SECONDS"]),
        ]
    if h.get("degraded"):
        lines += ["", f"DEGRADED members: {', '.join(h['degraded'])}"]
    return "\n".join(lines)


def cmd_operator_cluster_health(args) -> int:
    """`operator cluster health` — the federated health surface
    (/v1/operator/cluster/health): every member's raft indices, queue
    depths, host CPU/RSS, and per-source cost top-K; partitioned
    members flagged degraded without blocking the response."""
    import json as _json

    api = _client(args)
    h = api.operator.cluster_health(
        timeout_s=args.timeout, top=args.top
    )
    if args.as_json:
        print(_json.dumps(h, indent=2, sort_keys=True))
    else:
        print(_render_cluster_health(h))
    # exit 1 when any member is degraded: scriptable like `check`
    return 1 if h.get("degraded") else 0


def cmd_operator_top(args) -> int:
    """Live telemetry dashboard: throughput, queue depths, worker
    utilization, and per-stage p50/p95/p99 (cumulative + last window)
    from /v1/metrics — the answer to "where is the batch spending its
    second", refreshed in place."""
    import time as _time

    api = _client(args)
    interval = max(0.2, float(args.interval))
    frames = 0
    prev = None
    try:
        while True:
            if getattr(args, "cluster", False):
                # -cluster: the federated per-server view — one health
                # pull renders every member's columns + fleet totals
                # (CPU% from the cpu_seconds delta between frames)
                health = api.operator.cluster_health(
                    timeout_s=max(0.5, interval / 2)
                )
                frame = _render_cluster_health(health, prev)
                prev = (_time.monotonic(), health)
                frames += 1
                last = args.once or (args.n and frames >= args.n)
                if not last and sys.stdout.isatty():
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(frame)
                sys.stdout.flush()
                if last:
                    return 0
                _time.sleep(interval)
                continue
            snap = api.agent.metrics()
            try:
                solver = api.agent.solver_status()
            except Exception:
                solver = None  # older agent / route unavailable
            try:
                profile = api.agent.profile_status(top=1)
            except Exception:
                profile = None  # older agent / route unavailable
            try:
                bb = api.agent.blackbox_status()
            except Exception:
                bb = None  # older agent / route unavailable
            frame = _render_top(
                snap, prev, solver=solver, profile=profile, blackbox=bb
            )
            prev = (_time.monotonic(), snap)
            frames += 1
            last = args.once or (args.n and frames >= args.n)
            if not last and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(frame)
            sys.stdout.flush()
            if last:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_operator_trace(args) -> int:
    """Render eval-lifecycle traces from the agent's /v1/traces ring
    (trace.py): span tree with self-times for one trace, a listing when
    no id is given, and -summary for the critical-path analyzer (top
    span names by total self-time across the last N traces)."""
    from ..trace import critical_path, render_tree

    api = _client(args)
    if args.summary:
        summaries = api.traces.list(
            name=args.name, eval_id=args.eval_id, job_id=args.job_id,
            limit=args.n,
        )
        if not summaries:
            print("No traces recorded (is trace_enabled on?)")
            return 1
        traces = [api.traces.get(s["id"]) for s in summaries]
        total_ms = sum(t.get("duration_ms") or 0 for t in traces)
        print(
            f"Critical path over last {len(traces)} traces "
            f"({total_ms:.1f}ms total): top spans by self-time"
        )
        rows = [
            [name, f"{ns / 1e6:.3f}ms",
             f"{ns / max(total_ms * 1e6, 1) * 100:.1f}%"]
            for name, ns in critical_path(traces, top=args.top)
        ]
        print(_fmt_table(rows, ["Span", "Self Time", "Of Total"]))
        return 0
    if args.trace_id:
        trace_doc = api.traces.get(args.trace_id)
        print(render_tree(trace_doc))
        return 0
    summaries = api.traces.list(
        name=args.name, eval_id=args.eval_id, job_id=args.job_id,
        limit=args.n,
    )
    if not summaries:
        print("No traces recorded (is trace_enabled on?)")
        return 1
    rows = []
    for s in summaries:
        a = s.get("attrs") or {}
        rows.append(
            [
                s["id"],
                s["name"],
                f"{s.get('duration_ms', 0)}ms",
                str(s.get("num_spans", 0)),
                a.get("status", ""),
                a.get("eval_id", "") or ",".join(
                    (a.get("eval_ids") or [])[:2]
                ),
            ]
        )
    print(_fmt_table(
        rows, ["ID", "Name", "Duration", "Spans", "Status", "Evals"]
    ))
    return 0


def _fmt_wallclock(ts: float) -> str:
    """Wall-clock timestamp for incident/timeline rows (local time)."""
    import time as _time

    return _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime(ts))


def cmd_operator_incidents_list(args) -> int:
    """`operator incidents list` — the flight recorder's incident index
    (/v1/incidents): every anomaly-triggered capture with its trigger
    rule, observed value, and on-disk bundle path (docs/incidents.md)."""
    import json as _json

    api = _client(args)
    incidents = api.agent.incidents()
    if args.as_json:
        print(_json.dumps(incidents, indent=2, sort_keys=True))
        return 0
    if not incidents:
        print("No incidents captured (the blackbox is quiet).")
        return 0
    rows = []
    for rec in incidents:
        d = rec.get("detail") or {}
        rows.append([
            rec["id"],
            _fmt_wallclock(rec.get("ts", 0)),
            d.get("rule", rec.get("reason", "")),
            str(d.get("value", "-")),
            str(d.get("threshold", "-")),
            rec.get("path") or "(memory only)",
        ])
    print(_fmt_table(
        rows,
        ["ID", "CAPTURED", "RULE", "VALUE", "THRESHOLD", "BUNDLE"],
    ))
    return 0


def cmd_operator_incidents_show(args) -> int:
    """`operator incidents show <id>` — one incident's capture record:
    trigger detail, bundle path, and the files the capture wrote."""
    import json as _json

    api = _client(args)
    rec = api.agent.incident(args.incident_id)
    if args.as_json:
        print(_json.dumps(rec, indent=2, sort_keys=True))
        return 0
    d = rec.get("detail") or {}
    print(f"Incident  {rec['id']}")
    print(f"Captured  {_fmt_wallclock(rec.get('ts', 0))}")
    print(f"Rule      {d.get('rule', rec.get('reason', '-'))}")
    if d.get("reason"):
        print(f"Reason    {d['reason']}")
    if "value" in d:
        print(
            f"Observed  {d.get('value')}"
            f" (threshold {d.get('threshold', '-')},"
            f" source {d.get('source', '-')})"
        )
    print(f"Bundle    {rec.get('path') or '(memory only)'}")
    files = rec.get("files") or []
    if files:
        print("Files:")
        for name in files:
            print(f"  {name}")
    return 0


def cmd_operator_timeline(args) -> int:
    """`operator timeline <kind> <id>` — the causal timeline for one
    object (/v1/timeline): flight-recorder journal rows + finished
    traces that touch the object or anything reachable from it within
    two relation hops, merged onto one wall-clock axis."""
    import json as _json

    api = _client(args)
    tl = api.agent.timeline(args.kind, args.object_id)
    if args.as_json:
        print(_json.dumps(tl, indent=2, sort_keys=True))
        return 0
    related = tl.get("related") or []
    print(
        f"Timeline for {tl.get('kind')}:{tl.get('id')}"
        f" — {len(tl.get('rows') or [])} row(s),"
        f" {len(related)} related object(s)"
    )
    if related:
        print("Related: " + " ".join(sorted(related)))
    rows = []
    for row in tl.get("rows") or []:
        d = row.get("detail") or {}
        extra = " ".join(
            f"{k}={d[k]}" for k in sorted(d)
            if k != "rel" and not isinstance(d[k], (dict, list))
        )
        rows.append([
            _fmt_wallclock(row.get("ts", 0)),
            row.get("kind", ""),
            row.get("key", ""),
            extra[:60],
        ])
    print(_fmt_table(rows, ["TIME", "KIND", "KEY", "DETAIL"]))
    if tl.get("truncated"):
        print("(truncated — raise the journal capacity for more)")
    return 0


def _fmt_bytes(n) -> str:
    """Compact byte count: 512B / 3.2KB / 1.5MB / 2.1GB."""
    n = float(n or 0)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def _render_solver_status(snap: dict) -> str:
    """One `operator solver status` frame from /v1/solver/status."""
    lines = ["nomad-tpu solver status", ""]
    w = snap.get("worker")
    if w:
        lines.append(
            f"Worker      batch_size {w['batch_size']}"
            f"  pipeline {'on' if w.get('pipeline') else 'off'}"
            f"  processed {w.get('processed', 0)} evals"
        )
    occ = snap.get("occupancy") or {}
    last = occ.get("last_batch") or {}
    asks = occ.get("last_asks") or {}
    mean = occ.get("mean")
    lines.append(
        "Occupancy   "
        + (
            f"last {last['occupancy'] * 100:.1f}% "
            f"({last['n']}x{last['g']} real in "
            f"{last['pad_n']}x{last['pad_g']} padded, "
            f"waste {last['pad_waste'] * 100:.1f}%)"
            if last
            else "no batches solved yet"
        )
        + (f"   mean {mean * 100:.1f}%" if mean is not None else "")
        + (
            f"   asks {asks['groups']} groups / "
            f"{asks['requests']} requests"
            if asks
            else ""
        )
    )
    tr = snap.get("transfers") or {}
    lines.append(
        f"Transfers   h2d {_fmt_bytes(tr.get('h2d_bytes'))}"
        f"   d2h {_fmt_bytes(tr.get('d2h_bytes'))}"
        + (
            f"   allgather {_fmt_bytes(tr.get('allgather_bytes'))}"
            f"   scatter {_fmt_bytes(tr.get('scatter_bytes'))}"
            if tr.get("allgather_bytes") or tr.get("scatter_bytes")
            else ""
        )
        + " (cumulative)"
    )
    mem = snap.get("device_memory")
    lines.append(
        "Device mem  "
        + (
            f"in use {_fmt_bytes(mem.get('bytes_in_use'))}"
            + (
                f" / limit {_fmt_bytes(mem['bytes_limit'])}"
                if mem.get("bytes_limit")
                else ""
            )
            if mem
            else "unreported by backend (CPU fallback reports none)"
        )
        + f"   live arrays {_fmt_bytes(snap.get('live_array_bytes'))}"
        + f" (highwater {_fmt_bytes(snap.get('live_array_highwater_bytes'))})"
    )
    sharding = snap.get("sharding") or {}
    shards = sharding.get("last_shards")
    if shards:
        lines.append("")
        lines.append(
            f"Mesh        {sharding.get('devices', len(shards))} devices, "
            "node axis sharded (docs/sharding.md)"
        )
        lines.append(_fmt_table(
            [
                [
                    str(s.get("shard")),
                    str(s.get("rows")),
                    str(s.get("real_rows")),
                    f"{(s.get('occupancy') or 0) * 100:.1f}%",
                ]
                for s in shards
            ],
            ["SHARD", "ROWS", "REAL", "OCCUPANCY"],
        ))
    ledger = snap.get("ledger") or {}
    lines.append("")
    lines.append(
        f"Compile ledger: {ledger.get('compiles', 0)} compiles, "
        f"{ledger.get('cache_hits', 0)} cache hits, "
        f"{ledger.get('steady_recompiles', 0)} steady-state recompiles"
    )
    rows = []
    for name, k in sorted((ledger.get("kernels") or {}).items()):
        rows.append([
            name,
            str(k.get("launches", 0)),
            str(k["compiles"]),
            str(k["steady_recompiles"]),
            str(k["cache_hits"]),
            f"{k['first_compile_ms']:.1f}ms",
            f"{k['steady_compile_ms']:.1f}ms",
            str(k["signatures"]),
        ])
    if rows:
        # a "compile" is a launch at a padded shape not seen before
        # (solverobs.py): the port builds its kernels once
        lines.append(_fmt_table(
            rows,
            ["KERNEL", "LAUNCHES", "COMPILES", "RECOMPILES", "HITS",
             "FIRST-COMPILE", "STEADY-COMPILE", "SHAPES"],
        ))
    jit = snap.get("jit_cache_sizes")
    if jit:
        lines.append(
            "built variants: "
            + "  ".join(f"{k}={v}" for k, v in sorted(jit.items()))
        )
    pool = snap.get("pool") or {}
    if (pool.get("members") or pool.get("dispatched")
            or pool.get("role")):
        lines.append("")
        lines.append(_render_solver_pool(pool))
    return "\n".join(lines)


def _render_solver_pool(pool: dict) -> str:
    """The solver-pool section shared by `operator solver status` and
    `operator solver pool status` (docs/solver-pool.md)."""
    lines = [
        f"Solver pool role {pool.get('role') or '-'}"
        f"   dispatched {pool.get('dispatched', 0)}"
        f"   completed {pool.get('completed', 0)}"
        f"   fallback-local {pool.get('fallback_local', 0)}"
        + (
            f"   faults {pool['faults']}" if pool.get("faults") else ""
        )
        + (
            f"   aborted {pool['aborted']}" if pool.get("aborted") else ""
        )
    ]
    rows = []
    for m in pool.get("members") or []:
        remote = m.get("remote") or {}
        rows.append([
            str(m["id"]) + (" (self)" if m.get("self") else ""),
            m.get("status", "-"),
            str(m.get("in_flight", 0)),
            str(m.get("dispatched", 0)),
            str(m.get("faults", 0)),
            str(remote.get("warmups", "-")),
            str(remote.get("solves", "-")),
            str(remote.get("last_sync", "-")),
        ])
    if rows:
        lines.append(_fmt_table(
            rows,
            ["MEMBER", "STATUS", "IN-FLIGHT", "DISPATCHED", "FAULTS",
             "WARMUPS", "SOLVES", "LAST-SYNC"],
        ))
    else:
        lines.append("no pool members advertised (serf tag solver=1)")
    local = pool.get("local")
    if local:
        lines.append(
            f"local solver: warmups {local.get('warmups', 0)}"
            f"  solves {local.get('solves', 0)}"
            f"  syncs {local.get('syncs', 0)}"
            f"  last sync {local.get('last_sync', 'cold')}"
        )
    return "\n".join(lines)


def cmd_operator_solver_pool_status(args) -> int:
    """Render /v1/solver/pool: pool membership + health, leader-side
    dispatch stats, and each member's own warm-solver counters
    (docs/solver-pool.md; runbook operations.md § Scaling the placement
    plane)."""
    import json as _json

    api = _client(args)
    snap = api.agent.solver_pool()
    if args.as_json:
        print(_json.dumps(snap, indent=2, sort_keys=True))
        return 0
    print("nomad-tpu solver pool")
    print("")
    print(_render_solver_pool(snap))
    return 0


def cmd_operator_solver_status(args) -> int:
    """Render /v1/solver/status: the compile ledger (bucket recompiles
    vs cache hits), batch occupancy vs padding waste, host<->device
    transfer bytes, and device memory — the triage surface for a slow
    solve (operations.md § Diagnosing a slow solve)."""
    import json as _json

    api = _client(args)
    snap = api.agent.solver_status()
    if args.as_json:
        print(_json.dumps(snap, indent=2, sort_keys=True))
        return 0
    print(_render_solver_status(snap))
    return 0


def cmd_operator_solver_top(args) -> int:
    """Refresh-loop solver dashboard: occupancy, recompile rate, and
    transfer rates from /v1/solver/status, beside the device-stage
    percentiles from /v1/metrics."""
    import time as _time

    api = _client(args)
    interval = max(0.2, float(args.interval))
    frames = 0
    prev = None
    try:
        while True:
            snap = api.agent.solver_status()
            msnap = api.agent.metrics()
            lines = [_render_solver_status(snap)]
            ledger = snap.get("ledger") or {}
            tr = snap.get("transfers") or {}
            if prev is not None:
                prev_t, prev_ledger, prev_tr = prev
                dt = max(_time.monotonic() - prev_t, 1e-9)
                # clamp at 0: an agent restart between frames resets
                # the cumulative counters and would render negatives
                compiled = max(0, ledger.get("compiles", 0) - prev_ledger)
                h2d_rate = max(0, tr.get("h2d_bytes", 0) - prev_tr[0]) / dt
                d2h_rate = max(0, tr.get("d2h_bytes", 0) - prev_tr[1]) / dt
                lines.append(
                    f"\nRates       compiles {compiled} in {dt:.1f}s"
                    f"   h2d {_fmt_bytes(h2d_rate)}/s"
                    f"   d2h {_fmt_bytes(d2h_rate)}/s"
                )
            samples = msnap.get("samples") or {}
            rows = []
            for name in (
                "nomad.tpu.host_prep_seconds",
                "nomad.tpu.device_seconds",
                "nomad.tpu.readback_seconds",
                "nomad.tpu.materialize_seconds",
                "nomad.solver.compile_seconds",
            ):
                s = samples.get(name)
                if not s or "p50" not in s:
                    continue
                rows.append([
                    name, str(int(s["count"])),
                    _fmt_dur(s["p50"]), _fmt_dur(s["p95"]),
                    _fmt_dur(s["p99"]),
                ])
            if rows:
                lines.append("")
                lines.append(_fmt_table(
                    rows, ["DEVICE STAGE", "COUNT", "P50", "P95", "P99"]
                ))
            prev = (
                _time.monotonic(), ledger.get("compiles", 0),
                (tr.get("h2d_bytes", 0), tr.get("d2h_bytes", 0)),
            )
            frames += 1
            last = args.once or (args.n and frames >= args.n)
            if not last and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print("\n".join(lines))
            sys.stdout.flush()
            if last:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def _render_profile_status(snap: dict) -> str:
    """One `operator profile status` frame from /v1/profile/status."""
    lines = ["nomad-tpu host profile", ""]
    samples = snap.get("samples", 0)
    busy = snap.get("busy_seconds", 0.0)
    window = max(snap.get("window_seconds", 0.0), 1e-9)
    overhead = snap.get("overhead") or {}
    lines.append(
        f"Sampler     {samples} samples over {window:.0f}s"
        f"  ({snap.get('interval_ms', 0):.0f}ms interval"
        f"{'' if snap.get('running') else ', STOPPED'})"
        f"   busy {busy:.1f}s ({busy / window * 100:.1f}% of window)"
        f"   overhead {overhead.get('duty_cycle', 0) * 100:.2f}%"
    )
    gc_s = snap.get("gc") or {}
    cols = gc_s.get("collections") or {}
    lines.append(
        "GC          "
        + " ".join(f"{g} {n}" for g, n in sorted(cols.items()))
        + f"   pauses {_fmt_dur(gc_s.get('pause_seconds_total', 0.0))}"
        + f" (max {_fmt_dur(gc_s.get('pause_max_s', 0.0))})"
        + f"   paused sections {gc_s.get('paused_sections', 0)}"
        + f" ({_fmt_dur(gc_s.get('paused_section_seconds', 0.0))})"
    )
    rt = snap.get("runtime") or {}
    lines.append(
        f"Runtime     rss {_fmt_bytes(rt.get('rss_bytes'))}"
        f"   threads {rt.get('threads', 0)}"
        f"   fds {rt.get('fds', '-')}"
    )
    locks = snap.get("locks") or {}
    hot = [
        (name, s) for name, s in sorted(locks.items())
        if s.get("contended")
    ]
    if hot:
        lines.append(
            "Locks       "
            + "   ".join(
                f"{name}: {s['contended']} contended, "
                f"{_fmt_dur(s['wait_seconds_total'])} waited "
                f"(max {_fmt_dur(s['max_wait_s'])})"
                for name, s in hot
            )
        )
    lines.append("")
    by_role = snap.get("threads") or {}
    if by_role:
        busy_roles = {
            r: s for r, s in by_role.items() if s.get("busy_seconds")
        }
        if busy_roles:
            lines.append(
                "Busy by role: "
                + "  ".join(
                    f"{r} {s['busy_seconds']:.2f}s"
                    for r, s in sorted(
                        busy_roles.items(),
                        key=lambda kv: -kv[1]["busy_seconds"],
                    )
                )
            )
    sites = snap.get("top_sites") or []
    rows = [
        [
            s["role"],
            s["span"],
            s["site"],
            f"{s['seconds']:.3f}s",
            f"{s['seconds'] / max(busy, 1e-9) * 100:.1f}%",
            str(s["samples"]),
        ]
        for s in sites[:15]
    ]
    if rows:
        lines.append("")
        lines.append("Top self-time sites (role x span x function):")
        lines.append(_fmt_table(
            rows,
            ["ROLE", "SPAN", "SITE", "SELF", "OF-BUSY", "SAMPLES"],
        ))
    else:
        lines.append("")
        lines.append(
            "No busy samples yet (an idle agent profiles as idle; "
            "span names appear once tracing is enabled)."
        )
    dropped = snap.get("sites_evicted", 0) + snap.get("stacks_dropped", 0)
    if dropped:
        lines.append(
            f"NOTE: bounded ledgers overflowed "
            f"({snap.get('sites_evicted', 0)} site samples -> (other), "
            f"{snap.get('stacks_dropped', 0)} stacks dropped)"
        )
    return "\n".join(lines)


def cmd_operator_profile_status(args) -> int:
    """Render /v1/profile/status: the always-on host profiler's
    span-correlated CPU attribution, GC/runtime telemetry, and lock-wait
    ledger — the triage surface for "where does the host second go"
    (docs/operations.md)."""
    import json as _json

    api = _client(args)
    snap = api.agent.profile_status()
    if args.as_json:
        print(_json.dumps(snap, indent=2, sort_keys=True))
        return 0
    print(_render_profile_status(snap))
    return 0


def cmd_operator_profile_top(args) -> int:
    """Refresh-loop host-profile dashboard: /v1/profile/status rendered
    in place, plus busy-rate deltas between frames."""
    import time as _time

    api = _client(args)
    interval = max(0.2, float(args.interval))
    frames = 0
    prev = None
    try:
        while True:
            snap = api.agent.profile_status()
            lines = [_render_profile_status(snap)]
            if prev is not None:
                prev_t, prev_busy, prev_gc = prev
                dt = max(_time.monotonic() - prev_t, 1e-9)
                busy_rate = max(
                    0.0, snap.get("busy_seconds", 0.0) - prev_busy
                ) / dt
                gc_now = (snap.get("gc") or {}).get(
                    "pause_seconds_total", 0.0
                )
                lines.append(
                    f"\nRates       busy {busy_rate * 100:.1f}% of wall"
                    f"   gc {_fmt_dur(max(0.0, gc_now - prev_gc))} paused"
                    f" in {dt:.1f}s"
                )
            prev = (
                _time.monotonic(),
                snap.get("busy_seconds", 0.0),
                (snap.get("gc") or {}).get("pause_seconds_total", 0.0),
            )
            frames += 1
            last = args.once or (args.n and frames >= args.n)
            if not last and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print("\n".join(lines))
            sys.stdout.flush()
            if last:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_operator_profile_stacks(args) -> int:
    """Download the collapsed-stack flamegraph text
    (/v1/profile/collapsed): `role;span;frame;...;leaf count` per line —
    pipe into flamegraph.pl or load into speedscope as-is."""
    api = _client(args)
    text = api.agent.profile_collapsed()
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(
            f"Collapsed stacks written to {args.output} "
            f"({len(text.splitlines())} unique stacks)"
        )
        return 0
    sys.stdout.write(text)
    return 0


def cmd_operator_vet(args) -> int:
    """nomad-vet: the AST-level concurrency & layering analyzer
    (nomad_tpu_torch/analysis, the reference's rules re-aimed at the
    port). Purely local — it walks this checkout's nomad_tpu_torch
    tree, no running agent needed.
    Exit 1 on any unsuppressed finding, stale baseline entry, or
    ledger defect: the same zero-findings contract CI enforces."""
    import json as _json

    from ..analysis import dynamic_edges_from_json, run_vet

    dyn = None
    try:
        if args.dynamic_edges:
            with open(args.dynamic_edges, encoding="utf-8") as f:
                dyn = dynamic_edges_from_json(f.read())
        report = run_vet(
            rules=args.rules or None,
            baseline_path=args.baseline,
            dynamic_edges=dyn,
        )
    except (OSError, ValueError) as e:
        # unknown -rule, unreadable -dynamic-edges/-baseline file, or
        # malformed JSON: a one-line operator error, distinct from the
        # exit-1 findings contract
        print(f"Error: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(_json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render(advisories=args.advisory))
    return 1 if report.gate_count else 0


def cmd_event_stream(args) -> int:
    """Follow /v1/event/stream as NDJSON (reference api/event_stream.go
    + `nomad event` tooling): one frame per line, payloads wire-lowered.
    -topic Topic[:Key] filters (repeatable); -index resumes from an
    index; interrupt to stop."""
    import json as _json

    from .. import codec
    from ..api.client import event_stream

    api = _client(args)
    topics: dict[str, list[str]] = {}
    for t in args.topic:
        topic, sep, key = t.partition(":")
        topics.setdefault(topic, []).append(key if sep else "*")
    try:
        for frame in event_stream(
            api, topics=topics, index=args.index, namespace=args.namespace
        ):
            print(_json.dumps(
                codec.to_wire(frame), default=codec.json_default
            ))
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    return 0


def cmd_operator_raft_list_peers(args) -> int:
    """Reference: command/operator_raft_list.go."""
    api = _client(args)
    peers = api.operator.raft_configuration()
    print(
        _fmt_table(
            [
                [
                    p["id"],
                    f"{p['address'][0]}:{p['address'][1]}",
                    "leader" if p["leader"] else "follower",
                ]
                for p in peers
            ],
            ["Node", "Address", "State"],
        )
    )
    return 0


def cmd_server_members(args) -> int:
    api = _client(args)
    members = api.agent.members()
    print(
        _fmt_table(
            [
                [
                    m["id"],
                    f"{m['addr'][0]}:{m['addr'][1]}",
                    m["status"],
                    m["tags"].get("region", ""),
                ]
                for m in members
            ],
            header=["Name", "Address", "Status", "Region"],
        )
    )
    return 0


def cmd_status(args) -> int:
    """Reference command/status.go: a bare id resolves by prefix search
    across every context; unambiguous hits print the object's status."""
    if not args.job_id:
        return cmd_job_status(args)
    api = _client(args)
    try:
        result = api.search.prefix(args.job_id)
    except APIError:
        return cmd_job_status(args)
    matches = result.get("Matches") or {}
    flat = [(ctx, i) for ctx, ids in matches.items() for i in ids]
    if not flat:
        print(f'No matches for "{args.job_id}"')
        return 1
    if len(flat) > 1:
        print(f'Multiple matches for "{args.job_id}":\n')
        for ctx, ident in flat:
            print(f"  {ctx[:-1] if ctx.endswith('s') else ctx}: {ident}")
        return 1
    ctx, ident = flat[0]
    args.job_id = ident
    if ctx == "jobs":
        return cmd_job_status(args)
    if ctx == "nodes":
        args.node_id = ident
        return cmd_node_status(args)
    if ctx == "allocs":
        args.alloc_id = ident
        return cmd_alloc_status(args)
    if ctx == "evals":
        args.eval_id = ident
        return cmd_eval_status(args)
    print(f"{ctx[:-1]}: {ident}")
    return 0


def cmd_version(args) -> int:
    print(f"nomad-tpu-torch v{VERSION}")
    return 0


# ---------------------------------------------------------------------------


def _args_job_run(p):
    p.add_argument("jobfile")
    p.add_argument("-var", action="append", default=[])
    p.add_argument("-detach", action="store_true")
    p.set_defaults(fn=cmd_job_run)


def _args_job_stop(p):
    p.add_argument("job_id")
    p.add_argument("-purge", action="store_true")
    p.set_defaults(fn=cmd_job_stop)


def _args_job_plan(p):
    p.add_argument("jobfile")
    p.add_argument("-var", action="append", default=[])
    p.set_defaults(fn=cmd_job_plan)


def _args_job_validate(p):
    p.add_argument("jobfile")
    p.add_argument("-var", action="append", default=[])
    p.set_defaults(fn=cmd_job_validate)


def _args_job_init(p):
    p.add_argument("filename", nargs="?")
    p.set_defaults(fn=cmd_job_init)


def _args_job_inspect(p):
    p.add_argument("job_id")
    p.set_defaults(fn=cmd_job_inspect)


def _args_alloc_exec(p):
    p.add_argument("-t", "-tty", dest="tty", action="store_true")
    p.add_argument("-task", default="")
    p.add_argument("-rpc-secret", dest="rpc_secret", default="")
    p.add_argument(
        "-fabric-tls", dest="fabric_tls", action="store_true",
        help="dial the RPC fabric over TLS (tls { rpc = true }); "
        "creds from NOMAD_CLIENT_CERT/KEY + NOMAD_CACERT",
    )
    p.add_argument("alloc_id")
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_alloc_exec)


def _args_alloc_logs(p):
    p.add_argument("-f", "-follow", dest="follow", action="store_true")
    p.add_argument("-stderr", action="store_true")
    p.add_argument("-task", default="")
    p.add_argument("alloc_id")
    p.set_defaults(fn=cmd_alloc_logs)


def _args_alloc_fs(p):
    p.add_argument("alloc_id")
    p.add_argument("path", nargs="?", default="")
    p.set_defaults(fn=cmd_alloc_fs)


def _args_alloc_status(p):
    p.add_argument("alloc_id")
    p.set_defaults(fn=cmd_alloc_status)


def _args_eval_status(p):
    p.add_argument("eval_id")
    p.set_defaults(fn=cmd_eval_status)


def _args_node_status(p):
    p.add_argument("node_id", nargs="?")
    p.set_defaults(fn=cmd_node_status)


def _args_node_drain(p):
    p.add_argument("node_id")
    p.add_argument("-enable", action="store_true")
    p.add_argument("-disable", action="store_true")
    p.add_argument("-deadline", default="1h")
    p.add_argument("-ignore-system", dest="ignore_system",
                   action="store_true")
    p.set_defaults(fn=cmd_node_drain)


def _args_server_join(p):
    p.add_argument("address", nargs="+")
    p.set_defaults(fn=cmd_server_join)


def _args_server_force_leave(p):
    p.add_argument("node")
    p.set_defaults(fn=cmd_server_force_leave)


def _args_operator_debug(p):
    p.add_argument("-output", default="")
    p.set_defaults(fn=cmd_operator_debug)


def _args_conn(sp) -> None:
    """Accept -address/-token AFTER the subcommand too (the natural
    spelling when pointing a dashboard at a specific server: `operator
    top -address http://s2:4646`). The top-level flags keep working:
    SUPPRESS means an absent subcommand flag never clobbers a value the
    top-level parse already set, while a present one wins."""
    sp.add_argument(
        "-address", default=argparse.SUPPRESS,
        help="HTTP API address of the target agent",
    )
    sp.add_argument(
        "-token", default=argparse.SUPPRESS, help="ACL token"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu-torch")
    p.add_argument("-address", default=None, help="HTTP API address")
    p.add_argument("-token", default=None, help="ACL token")
    p.add_argument(
        "-region", default=None,
        help="federated region to address (default: the server's own)",
    )
    sub = p.add_subparsers(dest="cmd")

    ag = sub.add_parser("agent", help="run an agent")
    ag.add_argument("-dev", action="store_true")
    ag.add_argument("-server", action="store_true")
    ag.add_argument("-client", action="store_true")
    ag.add_argument("-config", default=None)
    ag.add_argument("-bootstrap-expect", dest="bootstrap_expect", type=int)
    ag.add_argument("-join", action="append", default=[])
    ag.add_argument("-servers", action="append", default=[])
    ag.add_argument("-data-dir", dest="data_dir", default=None)
    ag.add_argument("-node-name", dest="node_name", default=None)
    ag.add_argument("-http-port", dest="http_port", type=int, default=None)
    ag.add_argument("-rpc-port", dest="rpc_port", type=int, default=None)
    ag.add_argument("-tpu-scheduler", action="store_true", dest="tpu_scheduler")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands")
    jsub = job.add_subparsers(dest="subcmd")
    _args_job_run(jsub.add_parser("run"))
    _args_job_plan(jsub.add_parser("plan"))
    js = jsub.add_parser("status")
    js.add_argument("job_id", nargs="?")
    js.set_defaults(fn=cmd_job_status)
    _args_job_stop(jsub.add_parser("stop"))
    jev = jsub.add_parser("eval")
    jev.add_argument("job_id")
    jev.set_defaults(fn=cmd_job_eval)
    jdp = jsub.add_parser("deployments")
    jdp.add_argument("job_id")
    jdp.set_defaults(fn=cmd_job_deployments)
    jpr = jsub.add_parser("promote")
    jpr.add_argument("job_id")
    jpr.set_defaults(fn=cmd_job_promote)
    jsc = jsub.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.set_defaults(fn=cmd_job_scale)
    jse = jsub.add_parser("scaling-events")
    jse.add_argument("job_id")
    jse.set_defaults(fn=cmd_job_scaling_events)
    _args_job_validate(jsub.add_parser("validate"))
    _args_job_init(jsub.add_parser("init"))
    _args_job_inspect(jsub.add_parser("inspect"))
    jh = jsub.add_parser("history")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    jv = jsub.add_parser("revert")
    jv.add_argument("job_id")
    jv.add_argument("version", type=int)
    jv.set_defaults(fn=cmd_job_revert)
    jd = jsub.add_parser("dispatch")
    jd.add_argument("job_id")
    jd.add_argument("-meta", action="append", default=[])
    jd.add_argument("-payload-file", dest="payload_file", default=None)
    jd.set_defaults(fn=cmd_job_dispatch)
    jpf = jsub.add_parser("periodic")
    jpfsub = jpf.add_subparsers(dest="subsubcmd")
    jpff = jpfsub.add_parser("force")
    jpff.add_argument("job_id")
    jpff.set_defaults(fn=cmd_job_periodic_force)

    node = sub.add_parser("node", help="node commands")
    nsub = node.add_subparsers(dest="subcmd")
    _args_node_status(nsub.add_parser("status"))
    _args_node_drain(nsub.add_parser("drain"))
    ne = nsub.add_parser("eligibility")
    ne.add_argument("node_id")
    ne.add_argument("-enable", action="store_true")
    ne.add_argument("-disable", action="store_true")
    ne.set_defaults(fn=lambda a: cmd_node_eligibility(_elig_fix(a)))
    nm = nsub.add_parser("meta")
    nm.add_argument("node_id")
    nm.set_defaults(fn=cmd_node_meta)
    np_ = nsub.add_parser("purge")
    np_.add_argument("node_id")
    np_.set_defaults(fn=cmd_node_purge)

    alloc = sub.add_parser("alloc", help="alloc commands")
    asub = alloc.add_subparsers(dest="subcmd")
    _args_alloc_status(asub.add_parser("status"))
    _args_alloc_logs(asub.add_parser("logs"))
    _args_alloc_fs(asub.add_parser("fs"))
    arst = asub.add_parser("restart")
    arst.add_argument("alloc_id")
    arst.add_argument("-task", default="")
    arst.set_defaults(fn=cmd_alloc_restart)
    asig = asub.add_parser("signal")
    asig.add_argument("alloc_id")
    asig.add_argument("-s", dest="signal", default="SIGTERM")
    asig.add_argument("-task", default="")
    asig.set_defaults(fn=cmd_alloc_signal)
    astp = asub.add_parser("stop")
    astp.add_argument("alloc_id")
    astp.set_defaults(fn=cmd_alloc_stop)
    # REMAINDER semantics (everything after the alloc id belongs to the
    # command, its own dashed flags included) live in _args_alloc_exec
    _args_alloc_exec(asub.add_parser("exec"))

    ev = sub.add_parser("eval", help="eval commands")
    esub = ev.add_subparsers(dest="subcmd")
    _args_eval_status(esub.add_parser("status"))
    el = esub.add_parser("list")
    el.set_defaults(fn=cmd_eval_list)
    edel = esub.add_parser("delete")
    edel.add_argument("eval_id")
    edel.set_defaults(fn=cmd_eval_delete)

    evt = sub.add_parser("event", help="event stream commands")
    evtsub = evt.add_subparsers(dest="subcmd")
    evst = evtsub.add_parser(
        "stream", help="follow /v1/event/stream as NDJSON"
    )
    evst.add_argument(
        "-topic", action="append", default=[],
        help="Topic[:Key] filter, repeatable (e.g. Job:web)",
    )
    evst.add_argument("-index", type=int, default=0,
                      help="resume from this index")
    evst.add_argument("-namespace", default="")
    evst.set_defaults(fn=cmd_event_stream)

    dep = sub.add_parser("deployment", help="deployment commands")
    dsub = dep.add_subparsers(dest="subcmd")
    dl = dsub.add_parser("list")
    dl.set_defaults(fn=cmd_deployment_list)
    dst = dsub.add_parser("status")
    dst.add_argument("deployment_id")
    dst.set_defaults(fn=cmd_deployment_status)
    dpr = dsub.add_parser("promote")
    dpr.add_argument("deployment_id")
    dpr.add_argument("-group", action="append", default=[])
    dpr.set_defaults(fn=cmd_deployment_promote)
    dfa = dsub.add_parser("fail")
    dfa.add_argument("deployment_id")
    dfa.set_defaults(fn=cmd_deployment_fail)
    dpa = dsub.add_parser("pause")
    dpa.add_argument("deployment_id")
    dpa.add_argument("-resume", action="store_true")
    dpa.set_defaults(fn=cmd_deployment_pause)
    dre = dsub.add_parser("resume")
    dre.add_argument("deployment_id")
    dre.set_defaults(
        fn=lambda a: cmd_deployment_pause(_set_resume(a))
    )

    acl = sub.add_parser("acl", help="ACL commands")
    aclsub = acl.add_subparsers(dest="subcmd")
    ab = aclsub.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl_bootstrap)
    ap_ = aclsub.add_parser("policy")
    apsub = ap_.add_subparsers(dest="subsubcmd")
    apa = apsub.add_parser("apply")
    apa.add_argument("name")
    apa.add_argument("rules_file")
    apa.add_argument("-description", default=None)
    apa.set_defaults(fn=cmd_acl_policy_apply)
    apl = apsub.add_parser("list")
    apl.set_defaults(fn=cmd_acl_policy_list)
    apd = apsub.add_parser("delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl_policy_delete)
    api_ = apsub.add_parser("info")
    api_.add_argument("name")
    api_.set_defaults(fn=cmd_acl_policy_info)
    at = aclsub.add_parser("token")
    atsub = at.add_subparsers(dest="subsubcmd")
    atc = atsub.add_parser("create")
    atc.add_argument("-name", default=None)
    atc.add_argument("-type", default="client")
    atc.add_argument("-policy", action="append", default=[])
    atc.add_argument("-global", dest="set_global", action="store_true")
    atc.set_defaults(fn=cmd_acl_token_create)
    atl = atsub.add_parser("list")
    atl.set_defaults(fn=cmd_acl_token_list)
    atd = atsub.add_parser("delete")
    atd.add_argument("accessor_id")
    atd.set_defaults(fn=cmd_acl_token_delete)
    ati = atsub.add_parser("info")
    ati.add_argument("accessor_id")
    ati.set_defaults(fn=cmd_acl_token_info)
    ats = atsub.add_parser("self")
    ats.set_defaults(fn=cmd_acl_token_self)
    atu = atsub.add_parser("update")
    atu.add_argument("accessor_id")
    atu.add_argument("-name", default=None)
    atu.add_argument("-type", default=None)
    atu.add_argument("-policy", action="append", default=[])
    atu.add_argument("-global", dest="set_global", choices=["true", "false"],
                     default=None)
    atu.set_defaults(fn=cmd_acl_token_update)

    srv = sub.add_parser("server", help="server commands")
    ssub = srv.add_subparsers(dest="subcmd")
    sm = ssub.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)
    _args_server_force_leave(ssub.add_parser("force-leave"))
    _args_server_join(ssub.add_parser("join"))

    nsp = sub.add_parser("namespace", help="namespace commands")
    nssub = nsp.add_subparsers(dest="subcmd")
    nst = nssub.add_parser("status")
    nst.add_argument("name")
    nst.set_defaults(fn=cmd_namespace_status)
    nsl = nssub.add_parser("list")
    nsl.set_defaults(fn=cmd_namespace_list)
    nsa = nssub.add_parser("apply")
    nsa.add_argument("name")
    nsa.add_argument("-description", default="")
    nsa.set_defaults(fn=cmd_namespace_apply)
    nsd = nssub.add_parser("delete")
    nsd.add_argument("name")
    nsd.set_defaults(fn=cmd_namespace_delete)
    nsi = nssub.add_parser("inspect")
    nsi.add_argument("name")
    nsi.set_defaults(fn=cmd_namespace_inspect)

    vol = sub.add_parser("volume", help="volume commands")
    volsub = vol.add_subparsers(dest="subcmd")
    vreg = volsub.add_parser("register")
    vreg.add_argument("id")
    vreg.add_argument("-name", default="")
    vreg.add_argument("-namespace", default="default")
    vreg.add_argument("-node", default="")
    vreg.add_argument("-path", default="")
    vreg.add_argument(
        "-access-mode", dest="access_mode", default="multi-node-multi-writer"
    )
    vreg.add_argument("-type", default="host", choices=["host", "csi"])
    vreg.add_argument("-plugin", default="")
    vreg.add_argument("-external-id", dest="external_id", default="")
    vreg.set_defaults(fn=cmd_volume_register)
    vinit = volsub.add_parser("init")
    vinit.add_argument("filename", nargs="?")
    vinit.set_defaults(fn=cmd_volume_init)
    vdet = volsub.add_parser("detach")
    vdet.add_argument("volume_id")
    vdet.add_argument("node_id")
    vdet.add_argument("-namespace", default="default")
    vdet.set_defaults(fn=cmd_volume_detach)
    vsnap = volsub.add_parser("snapshot")
    vsnapsub = vsnap.add_subparsers(dest="subsubcmd")
    vsc = vsnapsub.add_parser("create")
    vsc.add_argument("volume_id")
    vsc.add_argument("name", nargs="?")
    vsc.add_argument("-namespace", default="default")
    vsc.set_defaults(fn=cmd_volume_snapshot_create)
    vsd = vsnapsub.add_parser("delete")
    vsd.add_argument("plugin_id")
    vsd.add_argument("snapshot_id")
    vsd.set_defaults(fn=cmd_volume_snapshot_delete)
    vsl = vsnapsub.add_parser("list")
    vsl.add_argument("-plugin", dest="plugin_id", required=True)
    vsl.set_defaults(fn=cmd_volume_snapshot_list)
    vstat = volsub.add_parser("status")
    vstat.add_argument("id", nargs="?")
    vstat.add_argument("-namespace", default="default")
    vstat.set_defaults(fn=cmd_volume_status)
    vcre = volsub.add_parser("create")
    vcre.add_argument("file")
    vcre.add_argument("-namespace", default="default")
    vcre.set_defaults(fn=cmd_volume_create)
    vdel = volsub.add_parser("delete")
    vdel.add_argument("id")
    vdel.add_argument("-namespace", default="default")
    vdel.set_defaults(fn=cmd_volume_delete)
    vdereg = volsub.add_parser("deregister")
    vdereg.add_argument("id")
    vdereg.add_argument("-namespace", default="default")
    vdereg.set_defaults(fn=cmd_volume_deregister)

    system = sub.add_parser("system", help="system maintenance commands")
    syssub = system.add_subparsers(dest="subcmd")
    sgc = syssub.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)
    srec = syssub.add_parser("reconcile")
    srecsub = srec.add_subparsers(dest="subsubcmd")
    srs = srecsub.add_parser("summaries")
    srs.set_defaults(fn=cmd_system_reconcile)

    sec = sub.add_parser("secret", help="embedded secrets store commands")
    secsub = sec.add_subparsers(dest="subcmd")
    sput = secsub.add_parser("put")
    sput.add_argument("path")
    sput.add_argument("items", nargs="+", help="key=value ...")
    sput.add_argument("-namespace", default="default")
    sput.set_defaults(fn=cmd_secret_put)
    sget = secsub.add_parser("get")
    sget.add_argument("path")
    sget.add_argument("-namespace", default="default")
    sget.set_defaults(fn=cmd_secret_get)
    sls = secsub.add_parser("list")
    sls.add_argument("-namespace", default="default")
    sls.set_defaults(fn=cmd_secret_list)
    sdel = secsub.add_parser("delete")
    sdel.add_argument("path")
    sdel.add_argument("-namespace", default="default")
    sdel.set_defaults(fn=cmd_secret_delete)

    uic = sub.add_parser("ui", help="open the web UI")
    uic.set_defaults(fn=cmd_ui)

    scal = sub.add_parser("scaling", help="scaling policy commands")
    scalsub = scal.add_subparsers(dest="subcmd")
    scp = scalsub.add_parser("policy")
    scpsub = scp.add_subparsers(dest="subsubcmd")
    scpl = scpsub.add_parser("list")
    scpl.add_argument("-namespace", default="default")
    scpl.set_defaults(fn=cmd_scaling_policy_list)
    scpi = scpsub.add_parser("info")
    scpi.add_argument("policy_id")
    scpi.set_defaults(fn=cmd_scaling_policy_info)

    svc = sub.add_parser("service", help="service discovery commands")
    svcsub = svc.add_subparsers(dest="subcmd")
    slist = svcsub.add_parser("list")
    slist.add_argument("-namespace", default="default")
    slist.set_defaults(fn=cmd_service_list)
    sinfo = svcsub.add_parser("info")
    sinfo.add_argument("name")
    sinfo.add_argument("-namespace", default="default")
    sinfo.set_defaults(fn=cmd_service_info)

    plug = sub.add_parser("plugin", help="CSI plugin commands")
    plugsub = plug.add_subparsers(dest="subcmd")
    pstat = plugsub.add_parser("status")
    pstat.add_argument("id", nargs="?")
    pstat.set_defaults(fn=cmd_plugin_status)

    op = sub.add_parser("operator", help="operator commands")
    opsub = op.add_subparsers(dest="subcmd")
    opsnap = opsub.add_parser("snapshot")
    opsnapsub = opsnap.add_subparsers(dest="subsubcmd")
    opss = opsnapsub.add_parser("save")
    opss.add_argument("file")
    opss.set_defaults(fn=cmd_operator_snapshot_save)
    opsi = opsnapsub.add_parser("inspect")
    opsi.add_argument("file")
    opsi.set_defaults(fn=cmd_operator_snapshot_inspect)
    opsr = opsnapsub.add_parser("restore")
    opsr.add_argument("file")
    opsr.set_defaults(fn=cmd_operator_snapshot_restore)
    opraft = opsub.add_parser("raft")
    opraftsub = opraft.add_subparsers(dest="subsubcmd")
    oplp = opraftsub.add_parser("list-peers")
    oplp.set_defaults(fn=cmd_operator_raft_list_peers)
    oprm = opraftsub.add_parser("remove-peer")
    oprm.add_argument("peer_id")
    oprm.set_defaults(fn=cmd_operator_raft_remove_peer)
    opap = opsub.add_parser("autopilot")
    opapsub = opap.add_subparsers(dest="subsubcmd")
    opag = opapsub.add_parser("get-config")
    opag.set_defaults(fn=cmd_operator_autopilot_get)
    opas = opapsub.add_parser("set-config")
    opas.add_argument(
        "-cleanup-dead-servers", dest="cleanup_dead_servers",
        default=None, choices=["true", "false"],
    )
    opas.set_defaults(fn=cmd_operator_autopilot_set)
    opkg = opsub.add_parser("keygen")
    opkg.set_defaults(fn=cmd_operator_keygen)
    opkr = opsub.add_parser(
        "keyring", help="fabric rpc_secret keyring (dual-accept rotation)"
    )
    opkrsub = opkr.add_subparsers(dest="subsubcmd")
    opkrs = opkrsub.add_parser(
        "status", help="keyring generation/age/window (/v1/agent/keyring)"
    )
    opkrs.add_argument("-json", action="store_true", dest="as_json")
    opkrs.set_defaults(fn=cmd_operator_keyring_status)
    opkrr = opkrsub.add_parser(
        "rotate", help="install a new secret on the target agent, live"
    )
    opkrr.add_argument(
        "-secret", required=True,
        help="the new cluster secret (see `operator keygen`)",
    )
    opkrr.add_argument(
        "-window", default="",
        help="dual-accept window for the old secret (e.g. 60s; "
        "default: the agent's rpc_secret_window)",
    )
    opkrr.add_argument("-json", action="store_true", dest="as_json")
    opkrr.set_defaults(fn=cmd_operator_keyring_rotate)
    opmet = opsub.add_parser("metrics")
    opmet.add_argument("-json", action="store_true", dest="as_json")
    _args_conn(opmet)
    opmet.set_defaults(fn=cmd_operator_metrics)
    optop = opsub.add_parser(
        "top", help="live telemetry dashboard (/v1/metrics)"
    )
    optop.add_argument("-interval", type=float, default=2.0,
                       help="seconds between refreshes")
    optop.add_argument("-n", type=int, default=0,
                       help="frames to render (0 = until interrupted)")
    optop.add_argument("-once", action="store_true",
                       help="render a single frame and exit")
    optop.add_argument(
        "-cluster", action="store_true",
        help="federated per-server columns + fleet totals "
        "(/v1/operator/cluster/health)",
    )
    _args_conn(optop)
    optop.set_defaults(fn=cmd_operator_top)
    opcl = opsub.add_parser(
        "cluster", help="cluster-scope observability"
    )
    opclsub = opcl.add_subparsers(dest="subsubcmd")
    opclh = opclsub.add_parser(
        "health",
        help="federated member health: raft indices, depths, host "
        "CPU/RSS, per-source cost (/v1/operator/cluster/health)",
    )
    opclh.add_argument("-json", action="store_true", dest="as_json")
    opclh.add_argument(
        "-timeout", type=float, default=2.0,
        help="per-peer deadline in seconds (slow members go degraded)",
    )
    opclh.add_argument("-top", type=int, default=5,
                       help="per-source top-K rows per member")
    _args_conn(opclh)
    opclh.set_defaults(fn=cmd_operator_cluster_health)
    optr = opsub.add_parser(
        "trace", help="render eval-lifecycle traces (/v1/traces)"
    )
    optr.add_argument("trace_id", nargs="?", default="")
    optr.add_argument("-summary", action="store_true",
                      help="critical-path: top spans by total self-time")
    optr.add_argument("-n", type=int, default=20,
                      help="how many recent traces to list/summarize")
    optr.add_argument("-top", type=int, default=5,
                      help="how many span names in the summary")
    optr.add_argument("-name", default="",
                      help="filter by trace name (eval, tpu.batch, http)")
    optr.add_argument("-eval-id", dest="eval_id", default="")
    optr.add_argument("-job-id", dest="job_id", default="")
    optr.set_defaults(fn=cmd_operator_trace)
    opinc = opsub.add_parser(
        "incidents",
        help="flight-recorder incident captures (/v1/incidents)",
    )
    opincsub = opinc.add_subparsers(dest="subsubcmd")
    opincl = opincsub.add_parser(
        "list", help="anomaly-triggered capture index"
    )
    opincl.add_argument("-json", action="store_true", dest="as_json")
    _args_conn(opincl)
    opincl.set_defaults(fn=cmd_operator_incidents_list)
    opincs = opincsub.add_parser(
        "show", help="one incident's trigger detail + bundle files"
    )
    opincs.add_argument("incident_id")
    opincs.add_argument("-json", action="store_true", dest="as_json")
    _args_conn(opincs)
    opincs.set_defaults(fn=cmd_operator_incidents_show)
    optl = opsub.add_parser(
        "timeline",
        help="causal timeline for one object (/v1/timeline)",
    )
    optl.add_argument(
        "kind", help="eval | alloc | node | job | deployment | plan"
    )
    optl.add_argument("object_id")
    optl.add_argument("-json", action="store_true", dest="as_json")
    _args_conn(optl)
    optl.set_defaults(fn=cmd_operator_timeline)
    opsol = opsub.add_parser(
        "solver", help="solver device observability (/v1/solver/status)"
    )
    opsolsub = opsol.add_subparsers(dest="subsubcmd")
    opsst = opsolsub.add_parser(
        "status", help="compile ledger, occupancy, transfers, device memory"
    )
    opsst.add_argument("-json", action="store_true", dest="as_json")
    opsst.set_defaults(fn=cmd_operator_solver_status)
    opstp = opsolsub.add_parser(
        "top", help="refresh-loop solver dashboard"
    )
    opstp.add_argument("-interval", type=float, default=2.0,
                       help="seconds between refreshes")
    opstp.add_argument("-n", type=int, default=0,
                       help="frames to render (0 = until interrupted)")
    opstp.add_argument("-once", action="store_true",
                       help="render a single frame and exit")
    opstp.set_defaults(fn=cmd_operator_solver_top)
    oppool = opsolsub.add_parser(
        "pool", help="solver-pool tier (/v1/solver/pool)"
    )
    oppoolsub = oppool.add_subparsers(dest="subsubsubcmd")
    opplst = oppoolsub.add_parser(
        "status",
        help="pool membership, dispatch stats, per-member warm solvers",
    )
    opplst.add_argument("-json", action="store_true", dest="as_json")
    opplst.set_defaults(fn=cmd_operator_solver_pool_status)
    opprof = opsub.add_parser(
        "profile", help="continuous host profiler (/v1/profile/status)"
    )
    opprofsub = opprof.add_subparsers(dest="subsubcmd")
    oppst = opprofsub.add_parser(
        "status",
        help="span-correlated CPU self-time, GC/lock/runtime telemetry",
    )
    oppst.add_argument("-json", action="store_true", dest="as_json")
    oppst.set_defaults(fn=cmd_operator_profile_status)
    opptp = opprofsub.add_parser(
        "top", help="refresh-loop host-profile dashboard"
    )
    opptp.add_argument("-interval", type=float, default=2.0,
                       help="seconds between refreshes")
    opptp.add_argument("-n", type=int, default=0,
                       help="frames to render (0 = until interrupted)")
    opptp.add_argument("-once", action="store_true",
                       help="render a single frame and exit")
    opptp.set_defaults(fn=cmd_operator_profile_top)
    oppsk = opprofsub.add_parser(
        "stacks",
        help="collapsed-stack flamegraph text (/v1/profile/collapsed)",
    )
    oppsk.add_argument("-output", default="",
                       help="write to a file instead of stdout")
    oppsk.set_defaults(fn=cmd_operator_profile_stacks)
    opvet = opsub.add_parser(
        "vet",
        help="static concurrency & layering analyzer (nomad-vet)",
    )
    opvet.add_argument("-json", action="store_true", dest="as_json")
    opvet.add_argument(
        "-rule", action="append", dest="rules", metavar="RULE",
        help="run only this rule id (repeatable; e.g. NV-lock-blocking)",
    )
    opvet.add_argument(
        "-baseline", default=None,
        help="suppression ledger (default: analysis/baseline.toml)",
    )
    opvet.add_argument(
        "-dynamic-edges", dest="dynamic_edges", default=None,
        help="racecheck edges() JSON for the NV-lock-order cross-check",
    )
    opvet.add_argument(
        "-advisory", action="store_true",
        help="also print advisories (dynamic-coverage gaps)",
    )
    opvet.set_defaults(fn=cmd_operator_vet)
    _args_operator_debug(opsub.add_parser("debug"))
    opsch = opsub.add_parser("scheduler")
    opschsub = opsch.add_subparsers(dest="subsubcmd")
    opsg = opschsub.add_parser("get-config")
    opsg.set_defaults(fn=cmd_operator_scheduler_get)
    opss2 = opschsub.add_parser("set-config")
    opss2.add_argument(
        "-scheduler-algorithm", dest="scheduler_algorithm", default=None,
        choices=["binpack", "spread"],
    )
    for flag, dest in (
        ("-preempt-service-scheduler", "preempt_service"),
        ("-preempt-batch-scheduler", "preempt_batch"),
        ("-preempt-system-scheduler", "preempt_system"),
        ("-preempt-sysbatch-scheduler", "preempt_sysbatch"),
        ("-memory-oversubscription", "memory_oversubscription"),
    ):
        opss2.add_argument(
            flag, dest=dest, default=None, choices=["true", "false"]
        )
    opss2.set_defaults(fn=cmd_operator_scheduler_set)

    ai = sub.add_parser("agent-info", help="agent runtime info")
    ai.set_defaults(fn=cmd_agent_info)

    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", dest="log_level", default="INFO")
    mon.set_defaults(fn=cmd_monitor)

    st = sub.add_parser("status", help="list jobs")
    st.add_argument("job_id", nargs="?")
    st.set_defaults(fn=cmd_status)

    # -- top-level aliases (reference commands.go registers these
    # shortcuts alongside the namespaced forms: run == job run, etc.) —
    # each shares its canonical subcommand's argument-registration
    # helper, so flags can never drift between the two spellings
    _args_job_run(sub.add_parser("run", help="alias of `job run`"))
    _args_job_stop(sub.add_parser("stop", help="alias of `job stop`"))
    _args_job_plan(sub.add_parser("plan", help="alias of `job plan`"))
    _args_job_validate(
        sub.add_parser("validate", help="alias of `job validate`")
    )
    _args_job_init(sub.add_parser("init", help="alias of `job init`"))
    _args_job_inspect(
        sub.add_parser("inspect", help="alias of `job inspect`")
    )
    _args_alloc_exec(sub.add_parser("exec", help="alias of `alloc exec`"))
    _args_alloc_logs(sub.add_parser("logs", help="alias of `alloc logs`"))
    _args_alloc_fs(sub.add_parser("fs", help="alias of `alloc fs`"))
    _args_alloc_status(
        sub.add_parser("alloc-status", help="alias of `alloc status`")
    )
    _args_eval_status(
        sub.add_parser("eval-status", help="alias of `eval status`")
    )
    _args_node_status(
        sub.add_parser("node-status", help="alias of `node status`")
    )
    _args_node_drain(
        sub.add_parser("node-drain", help="alias of `node drain`")
    )
    al_sm = sub.add_parser("server-members", help="alias of `server members`")
    al_sm.set_defaults(fn=cmd_server_members)
    _args_server_join(
        sub.add_parser("server-join", help="alias of `server join`")
    )
    _args_server_force_leave(
        sub.add_parser(
            "server-force-leave", help="alias of `server force-leave`"
        )
    )
    al_kg = sub.add_parser("keygen", help="alias of `operator keygen`")
    al_kg.set_defaults(fn=cmd_operator_keygen)
    _args_operator_debug(
        sub.add_parser("debug", help="alias of `operator debug`")
    )
    chk = sub.add_parser("check", help="agent health probe")
    chk.set_defaults(fn=cmd_check)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    return p


def _set_resume(a):
    a.resume = True
    return a


def _elig_fix(a):
    if a.disable:
        a.enable = False
    elif not a.enable:
        raise SystemExit("one of -enable / -disable required")
    return a


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    fn = getattr(args, "fn", None)
    if fn is None:
        parser.print_help()
        return 127
    try:
        ret = fn(args)
        # Flush inside the try: small outputs sit in the stdio buffer until
        # interpreter exit, where an EPIPE would bypass this handler.
        sys.stdout.flush()
        return ret
    except BrokenPipeError:
        # stdout consumer (a pager, `head`) closed early — exit quietly
        # like standard unix tools; suppress the interpreter's flush error.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0
    except APIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except SystemExit as e:
        if isinstance(e.code, str):
            print(f"Error: {e.code}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
