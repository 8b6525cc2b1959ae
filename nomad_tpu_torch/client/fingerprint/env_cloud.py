"""Cloud environment fingerprinters: AWS / GCE / Azure metadata.

Port of ``nomad_tpu/client/fingerprint/env_cloud.py``.

Reference: client/fingerprint/env_aws.go:1 (EC2 metadata keys :90,
platform.aws.* attributes :124, link-speed estimate), env_gce.go,
env_azure.go. Each probes the cloud's link-local metadata service with a
short timeout; a machine not on that cloud simply reports undetected.

The metadata URL is overridable through the same environment variables
the reference honors (AWS_ENV_URL / GCE_ENV_URL / AZURE_ENV_URL), which
is also how tests point the fingerprinters at a fake metadata server.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

from .base import Fingerprinter, FingerprintResponse

#: seconds to wait on the metadata service; the reference uses 2s, but a
#: non-cloud host pays this at every boot per cloud, so stay snappy
DEFAULT_TIMEOUT_S = 0.25


def _get(
    url: str,
    headers: dict[str, str],
    timeout: float,
    method: str = "GET",
) -> str | None:
    req = urllib.request.Request(url, method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8", "replace").strip()
    except (urllib.error.URLError, OSError, ValueError):
        return None


class EnvAWSFingerprint(Fingerprinter):
    """EC2 instance metadata → platform.aws.* attributes
    (reference env_aws.go:90 keys / :124 attribute naming)."""

    name = "env_aws"

    #: metadata key -> is node-unique (reference env_aws.go:90)
    KEYS = {
        "ami-id": False,
        "hostname": True,
        "instance-id": True,
        "instance-type": False,
        "local-hostname": True,
        "local-ipv4": True,
        "public-hostname": True,
        "public-ipv4": True,
        "mac": True,
        "placement/availability-zone": False,
    }

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        base = os.environ.get(
            "AWS_ENV_URL", "http://169.254.169.254/latest/meta-data/"
        )
        timeout = float(os.environ.get("AWS_ENV_TIMEOUT", DEFAULT_TIMEOUT_S))
        # IMDSv2 first (required on current-default EC2 launches): a
        # session token from PUT /latest/api/token; fall back to the
        # headerless v1 GETs when the token endpoint is absent.
        headers: dict[str, str] = {}
        token_url = base.rsplit("/meta-data", 1)[0].rstrip("/")
        if token_url.endswith("/latest"):
            token = _get(
                token_url + "/api/token",
                {"X-aws-ec2-metadata-token-ttl-seconds": "60"},
                timeout,
                method="PUT",
            )
            if token:
                headers["X-aws-ec2-metadata-token"] = token
        # cheap liveness probe first (reference isAWS :286 reads ami-id)
        if _get(base + "ami-id", headers, timeout) is None:
            return resp
        for key, unique in self.KEYS.items():
            val = _get(base + key, headers, timeout)
            if val is None or "\n" in val:
                continue
            attr = "platform.aws." + key.replace("/", ".")
            if unique:
                attr = "unique." + attr
            resp.attributes[attr] = val
        if resp.attributes:
            resp.attributes["platform.aws"] = "true"
            resp.detected = True
        return resp


class EnvGCEFingerprint(Fingerprinter):
    """GCE instance metadata → platform.gce.* attributes (reference
    env_gce.go; requires the Metadata-Flavor: Google header)."""

    name = "env_gce"

    KEYS = {
        "id": True,
        "hostname": True,
        "name": True,
        "machine-type": False,
        "zone": False,
        "cpu-platform": False,
    }
    HEADERS = {"Metadata-Flavor": "Google"}

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        base = os.environ.get(
            "GCE_ENV_URL",
            "http://169.254.169.254/computeMetadata/v1/instance/",
        )
        timeout = float(os.environ.get("GCE_ENV_TIMEOUT", DEFAULT_TIMEOUT_S))
        if _get(base + "id", self.HEADERS, timeout) is None:
            return resp
        for key, unique in self.KEYS.items():
            val = _get(base + key, self.HEADERS, timeout)
            if val is None:
                continue
            # zone/machine-type come as full resource paths; keep the leaf
            if key in ("zone", "machine-type"):
                val = val.rsplit("/", 1)[-1]
            attr = "platform.gce." + key
            if unique:
                attr = "unique." + attr
            resp.attributes[attr] = val
        if resp.attributes:
            resp.attributes["platform.gce"] = "true"
            resp.detected = True
        return resp


class EnvAzureFingerprint(Fingerprinter):
    """Azure IMDS compute metadata → platform.azure.* attributes
    (reference env_azure.go; requires the Metadata: true header)."""

    name = "env_azure"

    #: compute-document field -> is node-unique
    KEYS = {
        "name": True,
        "vmId": True,
        "vmSize": False,
        "location": False,
        "resourceGroupName": False,
    }
    HEADERS = {"Metadata": "true"}

    def fingerprint(self, data_dir: str) -> FingerprintResponse:
        resp = FingerprintResponse()
        base = os.environ.get(
            "AZURE_ENV_URL", "http://169.254.169.254/metadata/instance/"
        )
        timeout = float(
            os.environ.get("AZURE_ENV_TIMEOUT", DEFAULT_TIMEOUT_S)
        )
        raw = _get(
            base + "compute?api-version=2021-02-01&format=json",
            self.HEADERS,
            timeout,
        )
        if raw is None:
            return resp
        try:
            doc = json.loads(raw)
        except ValueError:
            return resp
        for key, unique in self.KEYS.items():
            val = doc.get(key)
            if not isinstance(val, str) or not val:
                continue
            attr = "platform.azure." + key
            if unique:
                attr = "unique." + attr
            resp.attributes[attr] = val
        if resp.attributes:
            resp.attributes["platform.azure"] = "true"
            resp.detected = True
        return resp
