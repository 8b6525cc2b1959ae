"""Bridge networking: a network namespace per alloc with enforced port

Port of ``nomad_tpu/client/network.py``.

mapping.

Reference: client/allocrunner/networking_bridge_linux.go:1 (+
networking_cni.go): bridge mode gives each alloc its own netns, a veth
pair onto a shared bridge, and host-port → container-port forwards.

Deliberate departure from the reference's CNI/iptables pipeline: port
forwards here are USERSPACE TCP relays (the approach of Docker's
userland-proxy) run by the client process. That removes the iptables/CNI
plugin dependency — which sandboxed and minimal hosts often lack — while
enforcing exactly the same contract: the workload binds its container
port inside the netns; outside traffic reaches it only through the
host port the scheduler granted.

Everything shells out to ip(8); `available()` probes for root +
netns capability once and bridge mode degrades with a clear error when
the host can't do it.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import threading
from typing import Optional

logger = logging.getLogger("nomad_tpu_torch.network")

BRIDGE_NAME = "nomadtpu0"
SUBNET_PREFIX = "172.26.64"  # /24 carved for alloc addresses
GATEWAY = f"{SUBNET_PREFIX}.1"
NETNS_DIR = "/var/run/netns"


def _ip(*args: str, check: bool = True) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        ["ip", *args], capture_output=True, text=True, timeout=10
    )
    if check and proc.returncode != 0:
        raise NetworkError(
            f"ip {' '.join(args)}: {proc.stderr.strip() or proc.returncode}"
        )
    return proc


class NetworkError(Exception):
    pass


class AllocNetwork:
    """One alloc's namespace + its port forwards."""

    def __init__(self, ns_name: str, ip: str) -> None:
        self.ns_name = ns_name
        self.ip = ip
        self.ns_path = f"{NETNS_DIR}/{ns_name}"
        self.proxies: list[PortProxy] = []

    def close(self) -> None:
        for p in self.proxies:
            p.stop()
        self.proxies.clear()


class BridgeNetwork:
    """Manages the shared bridge and per-alloc namespaces."""

    _probe: Optional[bool] = None

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._used_ips: set[int] = set()
        self._allocs: dict[str, AllocNetwork] = {}

    @classmethod
    def available(cls) -> bool:
        """Can this host do netns + bridge? Probed once per process."""
        if cls._probe is None:
            if os.geteuid() != 0:
                cls._probe = False
            else:
                name = f"ntprobe{os.getpid() % 10000}"
                try:
                    _ip("netns", "add", name)
                    _ip("netns", "del", name)
                    cls._probe = True
                except (NetworkError, FileNotFoundError, OSError):
                    cls._probe = False
        return cls._probe

    def ensure_bridge(self) -> None:
        probe = _ip("link", "show", BRIDGE_NAME, check=False)
        if probe.returncode != 0:
            _ip("link", "add", BRIDGE_NAME, "type", "bridge")
        _ip("addr", "replace", f"{GATEWAY}/24", "dev", BRIDGE_NAME)
        _ip("link", "set", BRIDGE_NAME, "up")
        self._setup_egress()

    _egress_done = False

    def _setup_egress(self) -> None:
        """Best-effort outbound path for bridge allocs: enable forwarding
        and, when an nftables/iptables binary exists, masquerade the
        subnet. Hosts with neither (this build's sandbox) still get
        host↔alloc and alloc↔alloc connectivity plus inbound service
        traffic via the port relays — egress NAT is logged as absent,
        never silently faked."""
        if BridgeNetwork._egress_done:
            return
        BridgeNetwork._egress_done = True
        try:
            with open("/proc/sys/net/ipv4/ip_forward", "w") as f:
                f.write("1")
        except OSError:
            pass
        subnet = f"{SUBNET_PREFIX}.0/24"
        import shutil as _shutil

        if _shutil.which("iptables"):
            subprocess.run(
                ["iptables", "-t", "nat", "-C", "POSTROUTING", "-s",
                 subnet, "-j", "MASQUERADE"],
                capture_output=True,
            ).returncode == 0 or subprocess.run(
                ["iptables", "-t", "nat", "-A", "POSTROUTING", "-s",
                 subnet, "-j", "MASQUERADE"],
                capture_output=True,
            )
        elif _shutil.which("nft"):
            script = (
                "add table ip nomadtpu\n"
                "add chain ip nomadtpu post { type nat hook postrouting "
                "priority 100 ; }\n"
                f"add rule ip nomadtpu post ip saddr {subnet} masquerade\n"
            )
            subprocess.run(
                ["nft", "-f", "-"], input=script, text=True,
                capture_output=True,
            )
        else:
            logger.warning(
                "no iptables/nft: bridge allocs have no egress NAT "
                "(inbound service traffic still flows via port relays)"
            )

    # -- alloc lifecycle ------------------------------------------------

    def create(self, alloc_id: str) -> AllocNetwork:
        """netns + veth onto the bridge + addressing; idempotent per
        alloc. A namespace surviving from a previous agent incarnation
        (tasks outlive the agent) is ADOPTED, never recreated — deleting
        it would sever the live task's connectivity."""
        with self._lock:
            existing = self._allocs.get(alloc_id)
            if existing is not None:
                return existing
            self.ensure_bridge()
            short = alloc_id.replace("-", "")[:8]
            ns = f"nt-{short}"
            host_if = f"vh{short}"  # veth names cap at 15 chars
            peer_if = f"vp{short}"
            if _ip("netns", "list", check=False).stdout.find(ns) >= 0:
                adopted = self._adopt(alloc_id, ns)
                if adopted is not None:
                    return adopted
                # unusable leftover (no eth0/address): rebuild it
                _ip("netns", "del", ns, check=False)
            octet = self._pick_octet(alloc_id)
            ip = f"{SUBNET_PREFIX}.{octet}"
            try:
                _ip("netns", "add", ns)
                _ip(
                    "link", "add", host_if, "type", "veth",
                    "peer", "name", peer_if,
                )
                _ip("link", "set", host_if, "master", BRIDGE_NAME, "up")
                _ip("link", "set", peer_if, "netns", ns)
                _ip("-n", ns, "link", "set", peer_if, "name", "eth0")
                _ip("-n", ns, "addr", "add", f"{ip}/24", "dev", "eth0")
                _ip("-n", ns, "link", "set", "eth0", "up")
                _ip("-n", ns, "link", "set", "lo", "up")
                _ip("-n", ns, "route", "add", "default", "via", GATEWAY)
            except NetworkError:
                self._cleanup(ns, host_if)
                self._used_ips.discard(octet)
                raise
            net = AllocNetwork(ns, ip)
            self._allocs[alloc_id] = net
            return net

    def _adopt(self, alloc_id: str, ns: str) -> Optional[AllocNetwork]:
        """Reclaim a live namespace from a previous agent incarnation:
        read its eth0 address back instead of reassigning."""
        probe = _ip("-n", ns, "-4", "addr", "show", "eth0", check=False)
        if probe.returncode != 0:
            return None
        for tok in probe.stdout.split():
            if tok.startswith(SUBNET_PREFIX + "."):
                ip = tok.split("/")[0]
                self._used_ips.add(int(ip.rsplit(".", 1)[1]))
                net = AllocNetwork(ns, ip)
                self._allocs[alloc_id] = net
                logger.info("adopted existing netns %s (%s)", ns, ip)
                return net
        return None

    def destroy(self, alloc_id: str) -> None:
        with self._lock:
            net = self._allocs.pop(alloc_id, None)
            if net is None:
                return
            net.close()
            self._cleanup(net.ns_name, f"vh{alloc_id.replace('-', '')[:8]}")
            octet = int(net.ip.rsplit(".", 1)[1])
            self._used_ips.discard(octet)

    def shutdown(self, keep_namespaces: bool = False) -> None:
        """keep_namespaces=True is agent-restart semantics: stop the
        in-process port relays (they die with us anyway; the next
        incarnation adopts the netns and restarts them) but leave every
        namespace — its task is still running inside."""
        if keep_namespaces:
            for net in self._allocs.values():
                net.close()
            self._allocs.clear()
            return
        for alloc_id in list(self._allocs):
            try:
                self.destroy(alloc_id)
            except Exception:
                logger.exception("network teardown failed for %s", alloc_id)

    @staticmethod
    def _cleanup(ns: str, host_if: str) -> None:
        # deleting the ns destroys the veth peer; the host side follows,
        # but belt-and-suspenders in case the move never happened
        _ip("netns", "del", ns, check=False)
        _ip("link", "del", host_if, check=False)

    def _pick_octet(self, alloc_id: str) -> int:
        # stable-ish address per alloc with linear probing (2..254)
        start = (int(alloc_id.replace("-", "")[:8], 16) % 253) + 2
        for i in range(253):
            octet = ((start - 2 + i) % 253) + 2
            if octet not in self._used_ips:
                self._used_ips.add(octet)
                return octet
        raise NetworkError("bridge subnet exhausted")


class PortProxy:
    """Host-port forward into an alloc namespace: a TcpRelay with a
    fixed target (reference: the CNI portmap; approach: Docker's
    userland-proxy)."""

    def __init__(self, host_port: int, target_ip: str, target_port: int) -> None:
        from ..tcprelay import TcpRelay

        self.host_port = host_port
        self.target = (target_ip, target_port)
        self._relay = TcpRelay(host_port, lambda: self.target)

    def stop(self) -> None:
        self._relay.stop()
