"""The sidecar proxy process (the envoy-analog data plane).

Port of ``nomad_tpu/connect/sidecar.py``, whole: the task the admission
hook (hook.py) injects runs this module.

Run as: python -m nomad_tpu_torch.connect.sidecar <config.json>

Config (rendered by the client's template engine, re-rendered when the
service catalog changes; this process re-reads it on mtime change):

    {
      "inbound": {"listen_port": 20000, "local_port": 8080},
      "upstreams": [
        {"name": "api", "listen_port": 5000,
         "addresses_file": "local/upstream-api.addrs"}
      ]
    }

Each addresses_file holds "host:port" lines — the destination's
advertised sidecars, rendered from the service catalog by the client's
template engine and re-rendered when the catalog changes; this process
re-reads on mtime change. Inbound mesh traffic arriving on listen_port
relays to the co-located service at 127.0.0.1:local_port; each upstream
gets a local listener relaying to one of the destination's sidecars
(round-robin)."""

from __future__ import annotations

import itertools
import json
import os
import sys
import time


def _default_gateway() -> str | None:
    """This namespace's IPv4 default-gateway address, or None.

    ip(8) first — netlink answers for the CALLING namespace, which is
    what the nsenter'd sidecar needs; /proc/net/route is only the
    fallback because user-space kernels (gVisor-style) serve the host's
    table through procfs regardless of the reader's netns."""
    import socket
    import struct
    import subprocess

    try:
        proc = subprocess.run(
            ["ip", "route", "show", "default"],
            capture_output=True, text=True, timeout=5,
        )
        for line in proc.stdout.splitlines():
            parts = line.split()
            if len(parts) >= 3 and parts[0] == "default" and parts[1] == "via":
                return parts[2]
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open("/proc/net/route") as f:
            next(f, None)  # header
            for line in f:
                parts = line.split()
                if len(parts) < 4:
                    continue
                dest, gw, flags = parts[1], parts[2], int(parts[3], 16)
                # default route (0.0.0.0) with RTF_GATEWAY set
                if dest == "00000000" and flags & 0x2:
                    return socket.inet_ntoa(
                        struct.pack("<L", int(gw, 16))
                    )
    except (OSError, ValueError):
        pass
    return None


class _Relay:
    """One listener relaying to a dynamic target list (round-robin),
    built on the shared TcpRelay data plane.

    Each pick also offers the (gateway, port) rewrite as a dial
    FALLBACK: on NAT-less hosts (no iptables/nft — client/network.py
    logs the condition) a netns'd dialer has NO ROUTE to the host's own
    advertised IP, but the same host-port listener is reachable through
    the bridge gateway address. Two guards keep the fallback from ever
    rerouting a stream that should fail: (1) TcpRelay only takes it on
    a no-route dial error (ENETUNREACH/EHOSTUNREACH) — a refused or
    timed-out primary fails the connection; (2) it is only offered when
    the target IS this host's own advertised IP (NOMAD_HOST_IP, set by
    the client's task env — the address is invisible from inside the
    netns), so a dead CROSS-host target that happens to raise
    EHOSTUNREACH (ARP/ICMP host-unreachable on the same L2) is never
    rewritten to whatever occupies the same port on the gateway. When
    NOMAD_HOST_IP is absent (pre-upgrade client), the fallback keeps
    the errno guard only — single-host dev topologies are the only
    NAT-less deployments we support, and failing them closed would
    break the hairpin path the fallback exists for."""

    def __init__(self, listen_port: int, targets: list[str]) -> None:
        from nomad_tpu_torch.tcprelay import TcpRelay

        self._targets = targets
        self._rr = itertools.count()
        self._gateway = _default_gateway()
        self._host_ip = os.environ.get("NOMAD_HOST_IP", "")
        self._relay = TcpRelay(listen_port, self._pick)

    def set_targets(self, targets: list[str]) -> None:
        self._targets = targets

    def _pick(self) -> list[tuple[str, int]] | None:
        targets = self._targets
        if not targets:
            return None
        raw = targets[next(self._rr) % len(targets)]
        host, _, port = raw.rpartition(":")
        try:
            cands = [(host, int(port))]
        except ValueError:
            return None
        gw = self._gateway
        hairpin = (
            host == self._host_ip
            if self._host_ip
            else host not in ("127.0.0.1", "localhost")
        )
        if gw and host != gw and hairpin:
            cands.append((gw, cands[0][1]))
        return cands


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _read_addresses(path: str) -> list[str]:
    try:
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []


def main() -> int:
    if len(sys.argv) != 2:
        sys.stderr.write("usage: sidecar <config.json>\n")
        return 2
    cfg = _load(sys.argv[1])
    relays: dict[str, _Relay] = {}
    inbound = cfg.get("inbound")
    if inbound:
        relays["__inbound__"] = _Relay(
            int(inbound["listen_port"]),
            [f"127.0.0.1:{inbound['local_port']}"],
        )
    watched: list[tuple[str, str, float]] = []  # (name, path, mtime)
    for up in cfg.get("upstreams", []):
        addr_path = up.get("addresses_file", "")
        relays[up["name"]] = _Relay(
            int(up["listen_port"]), _read_addresses(addr_path)
        )
        try:
            mtime = os.path.getmtime(addr_path)
        except OSError:
            mtime = 0.0
        watched.append((up["name"], addr_path, mtime))
    sys.stderr.write("sidecar up\n")
    sys.stderr.flush()
    while True:
        time.sleep(1.0)
        for i, (name, addr_path, last) in enumerate(watched):
            try:
                mtime = os.path.getmtime(addr_path)
            except OSError:
                continue
            if mtime != last:
                watched[i] = (name, addr_path, mtime)
                relays[name].set_targets(_read_addresses(addr_path))


if __name__ == "__main__":
    sys.exit(main())
