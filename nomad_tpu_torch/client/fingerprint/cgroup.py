"""Cgroup fingerprinter (reference client/fingerprint/cgroup_linux.go —

Port of ``nomad_tpu/client/fingerprint/cgroup.py``.

the exec driver's isolation depends on it)."""

from __future__ import annotations

import os

from .base import Fingerprinter, FingerprintResponse


class CgroupFingerprint(Fingerprinter):
    name = "cgroup"
    periodic = True  # mounts can appear after boot (reference: 15s period)

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        # USABLE v2 detection is the exec driver's _cgroup_available
        # (it also requires write access) — one detector, two consumers,
        # so the node attribute and driver.exec.cgroups can't disagree.
        from ...drivers.exec import _cgroup_available

        resp = FingerprintResponse()
        if _cgroup_available():
            resp.attributes["unique.cgroup.version"] = "v2"
            resp.attributes["unique.cgroup.mountpoint"] = "/sys/fs/cgroup"
            resp.detected = True
        elif os.path.isdir("/sys/fs/cgroup/cpu"):
            resp.attributes["unique.cgroup.version"] = "v1"
            resp.attributes["unique.cgroup.mountpoint"] = "/sys/fs/cgroup"
            resp.detected = True
        return resp
