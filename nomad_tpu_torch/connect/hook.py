"""Server-side Connect admission hook.

Port of ``nomad_tpu/connect/hook.py``, whole; the injected task runs the
port's own sidecar (``nomad_tpu_torch.connect.sidecar``). Reference: nomad/job_endpoint_hooks.go:60 (jobImpliedConstraints +
jobConnectHook) — groups whose services carry a connect stanza get a
sidecar task, its port, and the mesh registration injected at job
admission, so the scheduler and clients see a perfectly ordinary job.
"""

from __future__ import annotations

import json

from ..structs.structs import (
    Port,
    Resources,
    Service,
    Task,
    Template,
)

#: in-namespace port the Nth connect service's sidecar listens on
SIDECAR_BASE_PORT = 20000


def connect_sidecar_port_label(service_name: str) -> str:
    return f"connect-proxy-{service_name}"


def mesh_service_name(service_name: str) -> str:
    return f"{service_name}-sidecar-proxy"


class ConnectValidationError(ValueError):
    pass


def inject_connect_sidecars(job) -> None:
    """Mutate the job in place: one sidecar task per connect service.
    Idempotent — re-registering an already-injected job changes
    nothing."""
    for tg in job.task_groups:
        connect_services = [
            s
            for s in tg.services
            if s.connect is not None and s.connect.sidecar_service is not None
        ]
        if not connect_services:
            continue
        if not tg.networks or tg.networks[0].mode != "bridge":
            raise ConnectValidationError(
                f"group {tg.name!r}: connect services require bridge "
                "network mode"
            )
        net = tg.networks[0]
        port_to = {
            p.label: (p.to or p.value)
            for p in list(net.reserved_ports) + list(net.dynamic_ports)
        }
        existing_tasks = {t.name for t in tg.tasks}
        existing_services = {s.name for s in tg.services}
        for idx, svc in enumerate(connect_services):
            local_port = port_to.get(svc.port_label)
            if not local_port:
                if svc.port_label in port_to:
                    # the label exists but has neither `to` nor a static
                    # value — the sidecar must know the in-namespace port
                    # at admission time
                    raise ConnectValidationError(
                        f"connect service {svc.name!r}: port "
                        f"{svc.port_label!r} needs a `to = <port>` "
                        "mapping (or a static port) for connect"
                    )
                raise ConnectValidationError(
                    f"connect service {svc.name!r}: port "
                    f"{svc.port_label!r} is not defined on the group "
                    "network"
                )
            label = connect_sidecar_port_label(svc.name)
            listen_port = SIDECAR_BASE_PORT + idx
            if label not in port_to:
                net.dynamic_ports.append(Port(label=label, to=listen_port))
                port_to[label] = listen_port
            if mesh_service_name(svc.name) not in existing_services:
                tg.services.append(
                    Service(
                        name=mesh_service_name(svc.name),
                        port_label=label,
                        tags=["sidecar-proxy"],
                    )
                )
            task_name = f"connect-proxy-{svc.name}"
            if task_name in existing_tasks:
                continue
            tg.tasks.append(
                _sidecar_task(task_name, listen_port, local_port, svc)
            )


def _sidecar_task(task_name, listen_port, local_port, svc) -> Task:
    upstreams = svc.connect.sidecar_service.upstreams
    config = {
        "inbound": {"listen_port": listen_port, "local_port": local_port},
        "upstreams": [
            {
                "name": u.destination_name,
                "listen_port": u.local_bind_port,
                "addresses_file": f"local/upstream-{u.destination_name}.addrs",
            }
            for u in upstreams
        ],
    }
    templates = [
        Template(
            dest_path="local/sidecar.json",
            embedded_tmpl=json.dumps(config),
            change_mode="noop",
        )
    ]
    for u in upstreams:
        templates.append(
            Template(
                dest_path=f"local/upstream-{u.destination_name}.addrs",
                embedded_tmpl=(
                    '{{service "'
                    + mesh_service_name(u.destination_name)
                    + '"}}'
                ),
                change_mode="noop",  # the sidecar watches the file
            )
        )
    return Task(
        name=task_name,
        driver="rawexec",
        # the CLIENT resolves its own interpreter/package location via
        # its nomad fingerprint attributes (task config and env are
        # interpolated node-side) — the server's paths never leak into
        # the task
        config={
            "command": "${attr.unique.nomad.python}",
            "args": ["-m", "nomad_tpu_torch.connect.sidecar",
                 "local/sidecar.json"],
        },
        env={"PYTHONPATH": "${attr.unique.nomad.pkg_root}"},
        resources=Resources(cpu=50, memory_mb=64),
        templates=templates,
    )
