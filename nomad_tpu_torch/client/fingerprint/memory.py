"""Memory fingerprinter (reference client/fingerprint/memory.go).

Port of ``nomad_tpu/client/fingerprint/memory.py``.
"""

from __future__ import annotations

from .base import Fingerprinter, FingerprintResponse


def total_memory_mb() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 1024


class MemoryFingerprint(Fingerprinter):
    name = "memory"

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        mb = total_memory_mb()
        resp.attributes["memory.totalbytes"] = str(mb * 1024 * 1024)
        resp.resources["memory_mb"] = mb
        resp.detected = True
        return resp
