"""Framing + protocol bytes shared by RPC client and server.

Port of ``nomad_tpu/rpc/wire.py``. Reference: nomad/rpc.go:229-316 — a
raw TCP connection's first byte selects the protocol (RpcNomad/RpcRaft/
RpcMultiplex/RpcTLS/RpcStreaming). The fabric keeps the same first-byte
switch with length-prefixed frames instead of net/rpc + yamux: one
logical request/response (or stream chunk) per frame, with interleaving
by sequence number replacing stream multiplexing. A frame's body is the
port's ``codec.pack``: msgpack of the tagged wire form, byte for byte
what ``nomad_tpu``'s codec writes, so the two packages' frames are
interchangeable.
"""

from __future__ import annotations

import socket
import struct

# First-byte protocol identifiers (reference nomad/rpc.go RpcNomad=0x01...)
BYTE_RPC = 0x01
BYTE_RAFT = 0x02
BYTE_STREAMING = 0x03

# Trace-context propagation fields in the RPC envelope (trace.py): a
# request may carry TRACE_KEY = {"id": trace_id, "parent": span_id}; the
# handler side opens a remote segment of that trace and sends its spans
# back under TRACE_SPANS_KEY in the response, so a trace stitches a
# client submit on a follower to the raft apply on the leader. Absent
# fields cost nothing — the envelope stays byte-identical when tracing
# is off.
TRACE_KEY = "trace"
TRACE_SPANS_KEY = "trace_spans"

# Source-identity propagation field (clusterobs.py): a dialing pool
# whose owner has a node label stamps SRC_KEY on every request so the
# handler side can attribute served seconds to the PEER (server-to-
# server forwards, raft, serf). Requests about a node (heartbeats)
# attribute to that node from the args instead — see
# clusterobs.source_of. Absent costs nothing, like TRACE_KEY.
SRC_KEY = "src"

MAX_FRAME = 256 * 1024 * 1024

_LEN = struct.Struct("!I")


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    return recv_exact(sock, length)
