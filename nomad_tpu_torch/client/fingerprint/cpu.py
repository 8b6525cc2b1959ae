"""CPU fingerprinter (reference client/fingerprint/cpu.go).

Port of ``nomad_tpu/client/fingerprint/cpu.py``.
"""

from __future__ import annotations

import os
import platform

from .base import Fingerprinter, FingerprintResponse


def cpu_mhz_total() -> int:
    cores = os.cpu_count() or 1
    mhz = 2000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except OSError:
        pass
    return int(cores * mhz)


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


class CPUFingerprint(Fingerprinter):
    name = "cpu"

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        cores = os.cpu_count() or 1
        total = cpu_mhz_total()
        resp.attributes = {
            "cpu.numcores": str(cores),
            "cpu.totalcompute": str(total),
            "cpu.arch": platform.machine(),
            "cpu.modelname": cpu_model(),
            "cpu.frequency": str(total // cores),
        }
        resp.resources["cpu"] = total
        resp.resources["total_cores"] = cores
        resp.detected = True
        return resp
