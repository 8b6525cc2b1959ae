"""Network fingerprinter (reference client/fingerprint/network.go).

Port of ``nomad_tpu/client/fingerprint/network.py``.
"""

from __future__ import annotations

import socket

from ...structs import NetworkResource
from .base import Fingerprinter, FingerprintResponse


def default_ip() -> str:
    """The host's outbound IP (no packets are sent by a UDP connect)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 9))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


class NetworkFingerprint(Fingerprinter):
    name = "network"

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        ip = default_ip()
        resp.attributes = {
            "unique.network.ip-address": ip,
        }
        resp.resources["networks"] = [
            NetworkResource(
                device="lo", cidr="127.0.0.1/32", ip="127.0.0.1",
                mbits=1000,
            )
        ]
        resp.detected = True
        return resp
