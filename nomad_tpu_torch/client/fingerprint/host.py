"""Host/kernel/OS fingerprinter (reference client/fingerprint/host.go

Port of ``nomad_tpu/client/fingerprint/host.py``.

+ arch.go + signal.go)."""

from __future__ import annotations

import platform
import signal as _signal
import socket

from .base import Fingerprinter, FingerprintResponse


class HostFingerprint(Fingerprinter):
    name = "host"

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        supported = sorted(
            s.name for s in _signal.Signals
            if s.name.startswith("SIG") and not s.name.startswith("SIGRT")
        )
        resp.attributes = {
            "kernel.name": platform.system().lower(),
            "kernel.version": platform.release(),
            "arch": platform.machine(),
            "os.name": platform.system().lower(),
            "os.version": platform.version(),
            "unique.hostname": socket.gethostname(),
            # drivers consult this for `signal`/change_signal support
            # (reference fingerprint/signal.go)
            "os.signals": ",".join(supported),
        }
        resp.detected = True
        return resp
