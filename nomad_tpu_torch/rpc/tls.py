"""Fabric TLS: encrypt server<->server and server<->client RPC.

Port of ``nomad_tpu/rpc/tls.py``. Reference: nomad/rpc.go (rpcTLS /
tlsutil.Config) — the fabric listener multiplexes a TLS-wrapped byte stream when `tls { rpc = true }`; with a
ca_file both directions verify peer certificates (the reference's
verify_incoming/verify_outgoing mTLS posture). Certificates are
IP/host-agnostic here (check_hostname off) because fabric peers are
addressed by gossip-advertised IPs, matching the reference's
verify_server_hostname=false default.
"""

from __future__ import annotations

import ssl


def fabric_contexts(
    cert_file: str, key_file: str, ca_file: str = ""
) -> tuple[ssl.SSLContext, ssl.SSLContext]:
    """Build the (server_side, client_side) contexts every fabric socket
    shares. With ca_file: full mTLS — servers require client certs and
    dialers verify the presented chain. Without: encryption only
    (dev-mode, analogous to verify_incoming/outgoing = false)."""
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(cert_file, key_file)
    client = client_context(ca_file, cert_file, key_file)
    if ca_file:
        server.load_verify_locations(ca_file)
        server.verify_mode = ssl.CERT_REQUIRED
    return server, client


def client_context(
    ca_file: str = "", cert_file: str = "", key_file: str = ""
) -> ssl.SSLContext:
    """Dialer-side context alone — for tools (alloc exec) that talk TO
    a TLS fabric without being fabric members. Cert/key optional: an
    encryption-only fabric (no ca_file server-side) accepts cert-less
    dialers; an mTLS fabric requires them."""
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.check_hostname = False
    if cert_file:
        # present identity when we have one: mTLS servers demand it,
        # harmless otherwise
        client.load_cert_chain(cert_file, key_file)
    if ca_file:
        client.load_verify_locations(ca_file)
        client.verify_mode = ssl.CERT_REQUIRED
    else:
        client.verify_mode = ssl.CERT_NONE
    return client
