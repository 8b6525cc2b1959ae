"""Fingerprinter contract.

Port of ``nomad_tpu/client/fingerprint/base.py``.

Reference: client/fingerprint/fingerprint.go — each fingerprinter
implements Fingerprint(request, response) adding attributes/resources
to the node; periodic ones re-run on their own cadence (:31-48
builtinFingerprintMap + periodic dispatch).
"""

from __future__ import annotations


class FingerprintResponse:
    """What one fingerprinter contributes."""

    def __init__(self) -> None:
        self.attributes: dict[str, str] = {}
        self.resources: dict = {}  # cpu / memory_mb / disk_mb / networks
        self.detected = False


class Fingerprinter:
    name = "base"
    #: periodic fingerprinters re-run in the client's re-fingerprint
    #: loop (reference: Periodic() (bool, time.Duration))
    periodic = False

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        raise NotImplementedError
