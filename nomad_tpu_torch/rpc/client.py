"""RPC client: pooled, pipelined connections.

Port of ``nomad_tpu/rpc/client.py``. Reference: helper/pool/pool.go —
one pooled session per remote address, many in-flight requests
multiplexed over it (the reference uses yamux streams; here, pipelined
frames matched by sequence number), with connection rundown on error
and a streaming-connection escape hatch.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
from typing import Optional

from .. import codec, metrics, trace
from .. import faultplane
from .keyring import ensure_keyring
from .server import StreamSession
from .wire import (
    BYTE_RPC,
    BYTE_STREAMING,
    SRC_KEY,
    TRACE_KEY,
    TRACE_SPANS_KEY,
    recv_frame,
    send_frame,
)

logger = logging.getLogger("nomad_tpu_torch.rpc")


class RPCError(Exception):
    """A handler-side error string carried back over the wire."""


class AuthFailedError(ConnectionError):
    """The peer rejected our secret at the connection preamble. Nothing
    pipelined behind the preamble was ever dispatched (the server
    authenticates BEFORE its request loop), so `request_sent` is False:
    callers may redial and re-send blindly — the pool does, re-reading
    its keyring so a rotated secret takes effect without a restart."""

    def __init__(self, msg: str = "permission denied: bad rpc secret"):
        super().__init__(msg)
        self.request_sent = False


class _Conn:
    """One pipelined connection: writer = any caller thread (locked),
    reader = dedicated thread demuxing responses by seq."""

    def __init__(
        self, addr: tuple[str, int], connect_timeout_s: float,
        secret: str = "", tls_context=None, src: str = "",
    ) -> None:
        # source-identity stamp for every request on this connection
        # (wire.SRC_KEY): the dialing pool's owner label, so the peer
        # can attribute served seconds to us (clusterobs.py)
        self._src = src
        self.sock = socket.create_connection(addr, timeout=connect_timeout_s)
        if tls_context is not None:
            self.sock = tls_context.wrap_socket(
                self.sock, server_hostname=addr[0]
            )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)
        self.sock.sendall(bytes([BYTE_RPC]))
        if secret:
            send_frame(self.sock, secret.encode())
        self._wlock = threading.Lock()
        self._seq = itertools.count()
        self._pending: dict[int, dict] = {}
        self._pending_lock = threading.Lock()
        self.dead = False
        # set by the reader when the peer answers the preamble with an
        # auth reject (rotated secret): pending + future calls fail
        # with AuthFailedError instead of a generic dead-conn error
        self.auth_failed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="rpc-conn-reader", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                resp = codec.unpack(recv_frame(self.sock))
                if isinstance(resp, dict) and "auth_error" in resp:
                    # preamble reject (rpc/server.py _authenticate):
                    # the server dispatched nothing on this connection
                    self.auth_failed = True
                    return
                with self._pending_lock:
                    waiter = self._pending.pop(resp.get("seq"), None)
                if waiter is not None:
                    waiter["resp"] = resp
                    waiter["event"].set()
        except (ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("rpc reader failed")
        finally:
            self.dead = True
            # Close our half immediately so the peer's port can leave
            # FIN_WAIT and be rebound (matters for fast server restarts).
            try:
                self.sock.close()
            except OSError:
                pass
            with self._pending_lock:
                pending, self._pending = self._pending, {}
            for waiter in pending.values():
                waiter["resp"] = (
                    {"error": "auth failed", "auth_error": True}
                    if self.auth_failed
                    else {"error": "connection closed"}
                )
                waiter["event"].set()

    def call(self, method: str, args, timeout_s: float):
        """Errors carry `request_sent`: False means the request never
        reached the peer (dead conn found up front, send failed — a
        partial frame is never dispatched), so a caller may re-send
        blindly; True means it WAS delivered and only the response is
        unaccounted for (timeout, conn died while waiting) — re-sending
        could double-apply a non-idempotent write."""
        seq = next(self._seq)
        waiter = {"event": threading.Event(), "resp": None}
        if not self.dead and self._peer_closed():
            # the peer's FIN is here and the reader has not run yet: a
            # request sent now would be lost as delivered
            self.dead = True
        with self._pending_lock:
            if self.dead:
                if self.auth_failed:
                    raise AuthFailedError()
                err = ConnectionError("connection closed")
                err.request_sent = False
                raise err
            self._pending[seq] = waiter
        # Trace propagation (wire.py TRACE_KEY): when the calling thread
        # carries a trace, the request envelope forwards its context and
        # the response brings the remote segment's spans home.
        tctx = trace.current()
        rpc_span = None
        if tctx is not None:
            rpc_span = tctx.start_span("rpc.call", method=method)
        # the span must end on EVERY exit (a codec TypeError included) or
        # it stays open on this thread's active-span stack and mis-parents
        # everything the thread records afterwards
        try:
            try:
                req = {"seq": seq, "method": method, "args": args}
                if self._src:
                    req[SRC_KEY] = self._src
                if tctx is not None:
                    req[TRACE_KEY] = trace.wire_ref(tctx, rpc_span)
                payload = codec.pack(req)
                # request bytes per method (the reply side counts
                # nomad.rpc.reply_bytes.<method>)
                metrics.incr(f"nomad.rpc.sent_bytes.{method}", len(payload))
                with self._wlock:
                    send_frame(self.sock, payload)
            except (ConnectionError, OSError) as e:
                with self._pending_lock:
                    self._pending.pop(seq, None)
                self.dead = True
                e.request_sent = False
                raise
            ok = waiter["event"].wait(timeout_s)
        finally:
            if rpc_span is not None:
                tctx.end_span(rpc_span)
        if not ok:
            with self._pending_lock:
                self._pending.pop(seq, None)
            err = TimeoutError(f"rpc {method} timed out after {timeout_s}s")
            err.request_sent = True
            raise err
        resp = waiter["resp"]
        if tctx is not None and resp.get(TRACE_SPANS_KEY):
            tctx.merge_remote(resp[TRACE_SPANS_KEY], rpc_span)
        if "error" in resp:
            if resp.get("auth_error"):
                raise AuthFailedError()
            if resp["error"] == "connection closed":
                err = ConnectionError("connection closed")
                err.request_sent = True  # delivered; the reply was lost
                raise err
            raise RPCError(resp["error"])
        return resp.get("result")

    def _peer_closed(self) -> bool:
        """True when the peer's end of stream already waits on the
        socket. A peek (the base socket's recv, which TLS does not wrap)
        that consumes nothing the reader thread would read."""
        try:
            return socket.socket.recv(
                self.sock, 1, socket.MSG_PEEK | socket.MSG_DONTWAIT
            ) == b""
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True

    def close(self) -> None:
        self.dead = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class ConnPool:
    """Pooled RPC connections keyed by address (reference helper/pool)."""

    def __init__(self, connect_timeout_s: float = 5.0, secret="",
                 tls_context=None) -> None:
        self._conns: dict[tuple[str, int], _Conn] = {}
        self._lock = threading.Lock()
        self._connect_timeout_s = connect_timeout_s
        # Single-flight dial tracking: addr -> Event set when the
        # in-flight dial to that peer resolves. Callers that find a
        # flight in progress queue behind it instead of stacking their
        # own TCP/TLS handshakes against a peer that is likely down.
        self._dials: dict[tuple[str, int], threading.Event] = {}
        self._dial_waiters = 0
        # Dual-accept keyring (rpc/keyring.py): the CURRENT secret is
        # read at every dial, never cached per-connection state — a
        # rotation pushed via SIGHUP takes effect on the next redial
        # without restarting the process. A plain string gets a private
        # keyring; the agent passes its shared instance.
        self.keyring = ensure_keyring(secret)
        self.tls_context = tls_context  # ssl client ctx — fabric TLS
        # Fault-plane identity: the owning node's label (a cluster node
        # sets its node_id) so injected partitions can match this pool's
        # outbound calls. Empty = an unlabeled client pool.
        self.owner = ""

    @property
    def secret(self) -> str:
        """The current dial secret (legacy accessor — prefer sharing
        the keyring itself so rotation propagates)."""
        return self.keyring.current

    def call(
        self,
        addr: tuple[str, int],
        method: str,
        args=None,
        timeout_s: float = 30.0,
        retries: int = 1,
    ):
        """Invoke `Endpoint.method` at addr. One automatic retry on a dead
        pooled connection (the reference's pool does the same rundown +
        redial) — but ONLY when the request provably never reached the
        peer (`request_sent` False): re-sending a delivered request
        whose response was lost could double-apply a non-idempotent
        write (at-most-once at this layer; idempotent or
        leaderless-classified retries happen above, retry.py)."""
        addr = (addr[0], addr[1])
        last_err: Optional[Exception] = None
        # per-method latency as the CALLER saw it — redial retries
        # included (that stall is real caller-visible latency). Method
        # names are the closed Endpoint.method set, so cardinality is
        # bounded.
        t0 = time.perf_counter()
        try:
            attempts = retries + 1
            use_previous = False
            while attempts > 0:
                attempts -= 1
                conn = self._get(addr, use_previous=use_previous)
                try:
                    # Fault plane (faultplane.py): injected drops/
                    # delays/partitions act here, inside the attempt, so
                    # they ride the SAME rundown + redial path a real
                    # network failure does — a times=1 drop is absorbed
                    # by the pool's retry exactly like a transient blip,
                    # while a persistent partition fails every attempt.
                    # No-op unless a plane is installed.
                    if faultplane.plane is not None:
                        faultplane.plane.on_rpc_call(self.owner, addr, method)
                    return conn.call(method, args, timeout_s)
                except AuthFailedError as e:
                    last_err = e
                    self._drop(addr, conn)
                    # The peer rejected the secret this dial presented
                    # (nothing was dispatched — safe to re-send). One
                    # extra attempt presents the PREVIOUS secret: during
                    # a staggered rotation a not-yet-rotated server
                    # still speaks the old one (dual-accept's mirror
                    # image, rpc/keyring.py module docs).
                    if not use_previous and self.keyring.previous_active():
                        use_previous = True
                        attempts += 1
                        metrics.incr("nomad.keyring.dial_fallback")
                        continue
                    raise
                except (ConnectionError, OSError) as e:
                    last_err = e
                    self._drop(addr, conn)
                    if getattr(e, "request_sent", False):
                        raise
            raise last_err  # type: ignore[misc]
        finally:
            metrics.observe(
                f"nomad.rpc.call_seconds.{method}",
                time.perf_counter() - t0,
            )

    def stream(
        self, addr: tuple[str, int], method: str, header: Optional[dict] = None
    ) -> StreamSession:
        """Open a dedicated streaming session (reference RpcStreaming).
        Same keyring discipline as call(): present the current secret,
        fall back to the previous one within the rotation window."""
        try:
            return self._stream_dial(addr, method, header,
                                     self.keyring.current)
        except AuthFailedError:
            prev = self.keyring.previous_active()
            if not prev:
                raise
            metrics.incr("nomad.keyring.dial_fallback")
            return self._stream_dial(addr, method, header, prev)

    def _stream_dial(
        self, addr: tuple[str, int], method: str,
        header: Optional[dict], secret: str,
    ) -> StreamSession:
        sock = socket.create_connection(addr, timeout=self._connect_timeout_s)
        if self.tls_context is not None:
            sock = self.tls_context.wrap_socket(
                sock, server_hostname=addr[0]
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        sock.sendall(bytes([BYTE_STREAMING]))
        if secret:
            send_frame(sock, secret.encode())
        session = StreamSession(sock)
        hdr = dict(header or {})
        hdr["method"] = method
        session.send(hdr)
        ack = session.recv(timeout_s=30)
        if isinstance(ack, dict) and "auth_error" in ack:
            session.close()
            raise AuthFailedError()
        if "error" in ack:
            session.close()
            raise RPCError(ack["error"])
        return session

    def _get(self, addr: tuple[str, int], use_previous: bool = False) -> _Conn:
        """Pooled conn for addr, dialing at most ONCE per peer at a time.

        The seed dialed inside the pool-wide lock: during a reconnect
        storm every RPC thread whose pooled conn died lined up on the
        lock while ONE of them sat in a 5s connect timeout — to ANY
        peer. Dials now run outside the lock (other peers' traffic is
        unaffected) and are single-flight per addr: concurrent callers
        queue behind the in-flight dial (``nomad.rpc.dial_queue_depth``)
        and adopt its result instead of stacking handshakes against a
        peer that is likely down.
        """
        while True:
            dial_flight: Optional[threading.Event] = None
            waiting = False
            with self._lock:
                conn = self._conns.get(addr)
                if conn is not None and not conn.dead:
                    return conn
                # rotation-window fallback dials present the PREVIOUS
                # secret — never share a flight keyed to the current one
                if not use_previous:
                    flight = self._dials.get(addr)
                    if flight is not None:
                        waiting = True
                        self._dial_waiters += 1
                        depth = self._dial_waiters
                    else:
                        dial_flight = threading.Event()
                        self._dials[addr] = dial_flight
                # dial-time secret read: rotation propagates to every
                # redial without pool (or process) restarts
                secret = (
                    self.keyring.previous_active()
                    if use_previous
                    else self.keyring.current
                )
            if waiting:
                metrics.set_gauge("nomad.rpc.dial_queue_depth", depth)
                flight.wait(self._connect_timeout_s + 1.0)
                with self._lock:
                    self._dial_waiters -= 1
                    depth = self._dial_waiters
                metrics.set_gauge("nomad.rpc.dial_queue_depth", depth)
                continue  # adopt the dialed conn, or take over the flight
            try:
                conn = _Conn(addr, self._connect_timeout_s, secret,
                             tls_context=self.tls_context, src=self.owner)
            except BaseException:
                if dial_flight is not None:
                    with self._lock:
                        if self._dials.get(addr) is dial_flight:
                            del self._dials[addr]
                    dial_flight.set()  # waiters retry (and fail) promptly
                raise
            with self._lock:
                stale = self._conns.get(addr)
                self._conns[addr] = conn
                if dial_flight is not None and self._dials.get(addr) is dial_flight:
                    del self._dials[addr]
            if dial_flight is not None:
                dial_flight.set()
            if stale is not None and stale is not conn:
                stale.close()
            return conn

    def _drop(self, addr: tuple[str, int], conn: _Conn) -> None:
        with self._lock:
            if self._conns.get(addr) is conn:
                del self._conns[addr]
        conn.close()

    def shutdown(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
