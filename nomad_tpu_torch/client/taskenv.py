"""Task environment construction + interpolation.

Port of ``nomad_tpu/client/taskenv.py``.

Reference: client/taskenv/ (~1,200 LoC) — env.go Builder assembles the
NOMAD_* environment from alloc/task/node state; taskenv.ReplaceEnv
interpolates ``${...}`` references in task config, constraints, and
templates. Same surface here: `build_env` and `interpolate`.
"""

from __future__ import annotations

import re
from typing import Any, Optional

from ..structs import Allocation, Node, Task

_VAR_RE = re.compile(r"\$\{([^}]+)\}")


def build_env(
    alloc: Allocation,
    task: Task,
    node: Optional[Node] = None,
    alloc_dir: str = "",
    task_dir: str = "",
    secrets_dir: str = "",
) -> dict[str, str]:
    job = alloc.job
    env: dict[str, str] = {
        "NOMAD_ALLOC_ID": alloc.id,
        "NOMAD_ALLOC_NAME": alloc.name,
        "NOMAD_ALLOC_INDEX": str(alloc.index()),
        "NOMAD_TASK_NAME": task.name,
        "NOMAD_GROUP_NAME": alloc.task_group,
        "NOMAD_JOB_ID": alloc.job_id,
        "NOMAD_JOB_NAME": job.name if job else "",
        "NOMAD_JOB_PARENT_ID": job.parent_id if job else "",
        "NOMAD_NAMESPACE": alloc.namespace,
        "NOMAD_REGION": job.region if job else "",
        "NOMAD_CPU_LIMIT": str(task.resources.cpu),
        "NOMAD_MEMORY_LIMIT": str(task.resources.memory_mb),
    }
    # oversubscription cap: set only when memory_max survived the
    # scheduler-config gate (reference NOMAD_MEMORY_MAX_LIMIT)
    if task.resources.memory_max_mb:
        env["NOMAD_MEMORY_MAX_LIMIT"] = str(task.resources.memory_max_mb)
    # dedicated cores the scheduler granted (reference NOMAD_CPU_CORES,
    # taskenv/env.go — comma list of core ids; drivers pin to them)
    if alloc.resources is not None:
        granted = alloc.resources.tasks.get(task.name)
        if granted is not None and granted.reserved_cores:
            env["NOMAD_CPU_CORES"] = ",".join(
                str(c) for c in granted.reserved_cores
            )
    if alloc_dir:
        env["NOMAD_ALLOC_DIR"] = alloc_dir
    if task_dir:
        env["NOMAD_TASK_DIR"] = task_dir
    if secrets_dir:
        env["NOMAD_SECRETS_DIR"] = secrets_dir
    if node is not None:
        env["NOMAD_DC"] = node.datacenter
        # the node's advertised IP (same selection as service
        # registration): lets netns'd tasks — the connect sidecar —
        # recognize "this host's own address", which is invisible from
        # inside the namespace
        host_ip = node.attributes.get("unique.network.ip-address", "")
        if not host_ip and node.http_addr:
            host_ip = node.http_addr.rsplit(":", 1)[0]
        if host_ip:
            env["NOMAD_HOST_IP"] = host_ip
        env["node.unique.id"] = node.id
        env["node.datacenter"] = node.datacenter
        env["node.unique.name"] = node.name
        env["node.class"] = node.node_class
        for k, v in node.attributes.items():
            env[f"attr.{k}"] = str(v)
        for k, v in node.meta.items():
            env[f"meta.{k}"] = str(v)
    # merged meta: job < group < task (reference CombinedTaskMeta)
    meta: dict[str, str] = {}
    if job is not None:
        meta.update(job.meta)
        tg = job.lookup_task_group(alloc.task_group)
        if tg is not None:
            meta.update(tg.meta)
    meta.update(task.meta)
    for k, v in meta.items():
        env[f"NOMAD_META_{k.upper().replace('-', '_')}"] = v
        env[f"NOMAD_META_{k}"] = v
    # network ports (reference: NOMAD_PORT_<label> / NOMAD_ADDR_<label>);
    # group-level (shared) networks are visible to every task
    if alloc.resources is not None:
        tr = alloc.resources.tasks.get(task.name)
        nets = list(alloc.resources.shared_networks)
        if tr is not None:
            nets.extend(tr.networks)
        if nets:
            for net in nets:
                for p in list(net.reserved_ports) + list(net.dynamic_ports):
                    # with a `to` mapping (bridge mode) the task binds the
                    # container-side port; NOMAD_HOST_PORT carries the
                    # host side (reference taskenv: AddrPrefix/HostPort)
                    env[f"NOMAD_PORT_{p.label}"] = str(p.to or p.value)
                    env[f"NOMAD_IP_{p.label}"] = net.ip
                    env[f"NOMAD_ADDR_{p.label}"] = f"{net.ip}:{p.value}"
                    env[f"NOMAD_HOST_PORT_{p.label}"] = str(p.value)
    # connect upstreams: tasks reach the mesh through the sidecar's
    # local listener (reference taskenv: NOMAD_UPSTREAM_ADDR_<dest>)
    tg = job.lookup_task_group(alloc.task_group) if job is not None else None
    if tg is not None:
        for svc in tg.services:
            if svc.connect is None or svc.connect.sidecar_service is None:
                continue
            for up in svc.connect.sidecar_service.upstreams:
                key = up.destination_name.upper().replace("-", "_")
                env[f"NOMAD_UPSTREAM_ADDR_{key}"] = (
                    f"127.0.0.1:{up.local_bind_port}"
                )
                env[f"NOMAD_UPSTREAM_PORT_{key}"] = str(up.local_bind_port)
    for k, v in task.env.items():
        env[k] = interpolate(v, env)
    return env


def interpolate(value: Any, env: dict[str, str]) -> Any:
    """Replace ``${...}`` references with env values, recursively through
    lists/dicts (reference taskenv.ReplaceEnv). Unknown references stay
    literal, matching the reference's pass-through behavior."""
    if isinstance(value, str):

        def sub(m: re.Match) -> str:
            key = m.group(1).strip()
            if key in env:
                return env[key]
            if key.startswith("env."):
                return env.get(key[4:], m.group(0))
            return m.group(0)

        return _VAR_RE.sub(sub, value)
    if isinstance(value, list):
        return [interpolate(v, env) for v in value]
    if isinstance(value, dict):
        return {k: interpolate(v, env) for k, v in value.items()}
    return value
