"""Storage fingerprinter — PERIODIC (reference

Port of ``nomad_tpu/client/fingerprint/storage.py``.

client/fingerprint/storage.go re-samples free space)."""

from __future__ import annotations

import shutil

from .base import Fingerprinter, FingerprintResponse

# Granularity keeps jitter (a few MB of disk churn) from re-registering
# the node every fingerprint period.
STORAGE_GRANULARITY_MB = 1024


class StorageFingerprint(Fingerprinter):
    name = "storage"
    periodic = True

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        try:
            disk = shutil.disk_usage(data_dir)
        except OSError:
            return resp
        free_mb = (disk.free // (1024 * 1024)) // STORAGE_GRANULARITY_MB
        free_mb *= STORAGE_GRANULARITY_MB
        total_mb = disk.total // (1024 * 1024)
        resp.attributes = {
            "unique.storage.volume": data_dir,
            "unique.storage.bytesfree": str(free_mb * 1024 * 1024),
            "unique.storage.bytestotal": str(total_mb * 1024 * 1024),
        }
        # same granularity as the attribute: disk_mb is hashed into the
        # computed node class, and raw free-byte jitter would fragment
        # the per-class feasibility memoization
        resp.resources["disk_mb"] = free_mb
        resp.detected = True
        return resp
