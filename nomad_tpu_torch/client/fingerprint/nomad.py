"""Framework-version fingerprinter (reference

Port of ``nomad_tpu/client/fingerprint/nomad.py``.

client/fingerprint/nomad.go)."""

from __future__ import annotations

from ... import __version__
from .base import Fingerprinter, FingerprintResponse


class NomadFingerprint(Fingerprinter):
    name = "nomad"

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        import os
        import sys

        import nomad_tpu_torch

        resp = FingerprintResponse()
        resp.attributes["nomad.version"] = __version__
        # Where THIS node can run framework-owned helper tasks (the
        # connect sidecar): its own interpreter and package root — the
        # server must never bake its paths into injected tasks.
        resp.attributes["unique.nomad.python"] = sys.executable
        resp.attributes["unique.nomad.pkg_root"] = os.path.dirname(
            os.path.dirname(os.path.abspath(nomad_tpu_torch.__file__))
        )
        resp.detected = True
        return resp
