"""``tests/test_env_fingerprint.py`` against the port.

The reference's cases against the port, with the reference's
assertions: imports pointed at ``nomad_tpu_torch``, and every
Server and ClusterServer given its scheduler config
(``backend="host"``, the reference's default, on ``device="cpu"``)
and every agent ``device="cpu"``.

Cloud environment fingerprinters against fake metadata servers
(reference: client/fingerprint/env_aws_test.go's httptest server).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from nomad_tpu_torch.client.fingerprint import fingerprint_node
from nomad_tpu_torch.client.fingerprint.env_cloud import (
    EnvAWSFingerprint,
    EnvAzureFingerprint,
    EnvGCEFingerprint,
)

AWS_DOC = {
    "ami-id": "ami-1234",
    "hostname": "ip-10-0-0-207.ec2.internal",
    "instance-id": "i-b3ba3875",
    "instance-type": "m3.2xlarge",
    "local-hostname": "ip-10-0-0-207.ec2.internal",
    "local-ipv4": "10.0.0.207",
    "public-hostname": "ec2-54-77-11-29.compute-1.amazonaws.com",
    "public-ipv4": "54.77.11.29",
    "mac": "0e:4d:12:ab:cd:ef",
    "placement/availability-zone": "us-west-2a",
}

GCE_DOC = {
    "id": "6302128916163050422",
    "hostname": "inst.c.proj.internal",
    "name": "inst",
    "machine-type": "projects/1/machineTypes/n1-standard-1",
    "zone": "projects/1/zones/us-central1-f",
    "cpu-platform": "Intel Haswell",
}


@pytest.fixture
def metadata_server():
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            path = self.path
            if path.startswith("/aws/"):
                key = path[len("/aws/"):]
                val = AWS_DOC.get(key)
            elif path.startswith("/gce/"):
                if self.headers.get("Metadata-Flavor") != "Google":
                    self.send_response(403)
                    self.end_headers()
                    return
                key = path[len("/gce/"):]
                val = GCE_DOC.get(key)
            elif path.startswith("/azure/compute"):
                if self.headers.get("Metadata") != "true":
                    self.send_response(403)
                    self.end_headers()
                    return
                val = json.dumps(
                    {
                        "name": "nomad-vm",
                        "vmId": "13f56399-bd52-4150-9748-7190aae1ff21",
                        "vmSize": "Standard_DS2",
                        "location": "westus2",
                        "resourceGroupName": "rg-prod",
                    }
                )
            else:
                val = None
            if val is None:
                self.send_response(404)
                self.end_headers()
                return
            data = val.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def test_aws_fingerprint(metadata_server, monkeypatch):
    monkeypatch.setenv("AWS_ENV_URL", metadata_server + "/aws/")
    resp = EnvAWSFingerprint().fingerprint("/tmp")
    assert resp.detected
    a = resp.attributes
    assert a["platform.aws"] == "true"
    assert a["unique.platform.aws.instance-id"] == "i-b3ba3875"
    assert a["platform.aws.instance-type"] == "m3.2xlarge"
    assert a["platform.aws.placement.availability-zone"] == "us-west-2a"
    assert a["unique.platform.aws.local-ipv4"] == "10.0.0.207"


def test_gce_fingerprint(metadata_server, monkeypatch):
    monkeypatch.setenv("GCE_ENV_URL", metadata_server + "/gce/")
    resp = EnvGCEFingerprint().fingerprint("/tmp")
    assert resp.detected
    a = resp.attributes
    assert a["platform.gce"] == "true"
    assert a["unique.platform.gce.id"] == "6302128916163050422"
    # resource paths keep only the leaf
    assert a["platform.gce.machine-type"] == "n1-standard-1"
    assert a["platform.gce.zone"] == "us-central1-f"


def test_azure_fingerprint(metadata_server, monkeypatch):
    monkeypatch.setenv("AZURE_ENV_URL", metadata_server + "/azure/")
    resp = EnvAzureFingerprint().fingerprint("/tmp")
    assert resp.detected
    a = resp.attributes
    assert a["platform.azure"] == "true"
    assert a["unique.platform.azure.vmId"].startswith("13f56399")
    assert a["platform.azure.vmSize"] == "Standard_DS2"


def test_not_on_cloud_is_undetected(monkeypatch):
    monkeypatch.setenv("AWS_ENV_URL", "http://127.0.0.1:1/")
    monkeypatch.setenv("GCE_ENV_URL", "http://127.0.0.1:1/")
    monkeypatch.setenv("AZURE_ENV_URL", "http://127.0.0.1:1/")
    for fp in (EnvAWSFingerprint(), EnvGCEFingerprint(), EnvAzureFingerprint()):
        resp = fp.fingerprint("/tmp")
        assert not resp.detected
        assert not resp.attributes


def test_node_attributes_populated_end_to_end(metadata_server, monkeypatch):
    """The assembled Node carries the cloud attributes, so constraints
    like ${attr.platform.aws.instance-type} are schedulable."""
    monkeypatch.setenv("AWS_ENV_URL", metadata_server + "/aws/")
    node = fingerprint_node(datacenter="dc1")
    assert node.attributes["platform.aws"] == "true"
    assert node.attributes["unique.platform.aws.instance-id"] == "i-b3ba3875"
    # the computed class must not absorb unique attributes
    assert node.computed_class
