"""Service mesh (Connect analog).

Port of ``nomad_tpu/connect/``: the admission hook and the sidecar, with
the relay under it (``nomad_tpu_torch/tcprelay.py``). Host code: nothing
here imports torch. The client side (the template engine that renders
the sidecar's config, the catalog) comes with the port's client.

Reference: the Consul Connect integration — sidecar task injection
(nomad/job_endpoint_hooks.go:60), the envoy bootstrap hook
(client/allocrunner/taskrunner/envoybootstrap_hook.go), and sidecar
service registration (command/agent/consul/connect.go).

TPU-native redesign: there is no Consul and no Envoy here. The mesh is
built from this framework's own parts —

  * the server's job admission hook (hook.py) injects a sidecar TASK
    (``python -m nomad_tpu_torch.connect.sidecar``) plus its dynamic port and
    a ``<service>-sidecar-proxy`` catalog registration into any group
    whose service carries a ``connect { sidecar_service {} }`` stanza;
  * the sidecar's config is a TEMPLATE rendered by the client's
    template engine — upstream addresses come from the native service
    catalog via ``{{service "<dest>-sidecar-proxy"}}`` and re-render on
    change (change_mode=noop; the sidecar watches the file);
  * the sidecar itself (sidecar.py) is a TCP relay: an inbound listener
    forwarding mesh traffic to the local service port, and one local
    listener per upstream forwarding to the destination's advertised
    sidecar, exactly the data path envoy provides in the reference.

mTLS between sidecars is NOT implemented (the reference derives leaf
certs from the Consul CA); transport security today is the cluster
network — documented as a known departure.
"""

from .hook import connect_sidecar_port_label, inject_connect_sidecars

__all__ = ["inject_connect_sidecars", "connect_sidecar_port_label"]
