"""RPC server: TCP listener with first-byte protocol switch.

Port of ``nomad_tpu/rpc/server.py``; request and response bodies go
through the port's ``codec.pack``/``unpack``. Reference: nomad/rpc.go —
listen loop (:178 listen), handleConn (:229, first-byte switch),
handleNomadConn request loop (:352), endpoint structs registered on a
net/rpc server (nomad/server.go:1137-1184), streaming handlers (:299
RpcStreaming), and the dedicated Raft stream layer (nomad/raft_rpc.go).

Design: each accepted connection gets a reader thread. RPC requests are
dispatched to a small worker pool so one slow handler doesn't stall the
connection (net/rpc semantics — responses may arrive out of order, matched
by seq). Streaming connections hand the raw socket to the registered
stream handler. Raft connections are dispatched to the raft transport
handler installed by the replication layer.

Trust boundary: the fabric authenticates PEERS, not requests — when a
cluster `secret` is configured every connection (RPC, streaming, raft)
must present it in a preamble frame right after the protocol byte, or
it is dropped. This is the reference's mTLS-on-the-fabric posture in
shared-secret form: any authenticated peer (server or client agent) may
invoke any endpoint; per-request ACL capability checks happen at the
HTTP layer. Without a secret the fabric trusts the network (dev mode).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from .. import clusterobs, codec, metrics, trace
from .. import faultplane
from .keyring import ensure_keyring
from .wire import (
    BYTE_RAFT,
    BYTE_RPC,
    BYTE_STREAMING,
    SRC_KEY,
    TRACE_KEY,
    TRACE_SPANS_KEY,
    recv_frame,
    send_frame,
)

logger = logging.getLogger("nomad_tpu_torch.rpc")


class StreamSession:
    """A byte-frame session handed to streaming handlers (reference:
    nomad/structs/streaming_rpc.go)."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._wlock = threading.Lock()

    def send(self, obj) -> None:
        with self._wlock:
            send_frame(self._sock, codec.pack(obj))

    def recv(self, timeout_s: Optional[float] = None):
        self._sock.settimeout(timeout_s)
        return codec.unpack(recv_frame(self._sock))

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class RPCServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        num_workers: int = 8,
        secret="",  # str | Keyring — the agent shares ONE Keyring
        tls_context=None,  # ssl.SSLContext (server side) — fabric TLS
    ) -> None:
        # Dual-accept keyring (rpc/keyring.py): a plain string gets a
        # private keyring; the agent passes its shared instance so a
        # live rotation moves listener + dialers together.
        self.keyring = ensure_keyring(secret)
        self.tls_context = tls_context
        self._endpoints: dict[str, object] = {}
        self._stream_handlers: dict[str, Callable[[StreamSession, dict], None]] = {}
        self.raft_handler: Optional[Callable[[StreamSession], None]] = None
        # Fixed-port binds retry briefly: an in-process restart races the
        # previous incarnation's sockets draining out of FIN_WAIT.
        deadline = time.monotonic() + (5.0 if port else 0.0)
        while True:
            try:
                self._listener = socket.create_server((host, port))
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self.addr = self._listener.getsockname()  # (host, port)
        self._pool = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="rpc"
        )
        # Raft traffic gets its own lane: blocking queries and slow
        # forwards on the shared pool must never delay heartbeats or
        # elections destabilize (the reference runs raft on a dedicated
        # stream layer, nomad/raft_rpc.go, for the same reason).
        self._priority_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rpc-raft"
        )
        # Serf shares the lane: a starved probe ack looks like a dead
        # member and gets a live raft peer removed.
        self._priority_prefixes = ("Raft.", "Serf.")
        self._shutdown = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # Fault-plane identity (faultplane.py): the owning node's
        # label, so injected response drops can target this server.
        self.chaos_label = ""
        # Per-source cost ledger (clusterobs.py): every dispatched
        # request's handler seconds are attributed to its source node /
        # peer / namespace. An owner may install its own instance so
        # in-process clusters attribute per member; a bare RPCServer
        # shares the process-global default.
        self.source_ledger = clusterobs.ledger()

    @property
    def secret(self) -> str:
        """The current cluster secret (legacy accessor — prefer passing
        the keyring itself so rotation propagates)."""
        return self.keyring.current

    # -- registration --------------------------------------------------

    def register(self, name: str, endpoint: object) -> None:
        """Register an endpoint struct; its public methods become
        `Name.method` RPCs (reference nomad/server.go setupRpcServer)."""
        self._endpoints[name] = endpoint

    def register_stream(
        self, method: str, handler: Callable[[StreamSession, dict], None]
    ) -> None:
        self._stream_handlers[method] = handler

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        # shutdown() interrupts the thread blocked in accept(); a bare
        # close() would leave the fd (and the LISTEN port) held until the
        # accept call returned.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        self._pool.shutdown(wait=False)
        self._priority_pool.shutdown(wait=False)
        if self._accept_thread:
            self._accept_thread.join(timeout=5)

    # -- connection handling -------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._handle_conn, args=(conn,),
                name="rpc-conn", daemon=True,
            ).start()

    def _drop_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _authenticate(self, conn: socket.socket) -> bool:
        """When a cluster secret is configured, require the auth
        preamble frame before serving any protocol. The keyring accepts
        the current secret always and the previous one during the
        dual-accept window (live rotation, rpc/keyring.py)."""
        if not self.keyring.enabled:
            return True
        conn.settimeout(10.0)
        try:
            presented = recv_frame(conn)
        except (ConnectionError, OSError):
            return False
        finally:
            conn.settimeout(None)
        if not self.keyring.accepts(presented):
            logger.warning("rpc connection rejected: bad cluster secret")
            # Tell the dialer WHY before closing: a silent close is
            # indistinguishable from a crash, but an auth reject means
            # "nothing you pipelined was dispatched — redial with a
            # fresh secret" (ConnPool re-reads its keyring and falls
            # back to the previous secret within the window).
            try:
                send_frame(
                    conn,
                    codec.pack(
                        {"auth_error": "permission denied: bad rpc secret"}
                    ),
                )
                # The frame must SURVIVE the close: the dialer pipelines
                # request frames right behind the preamble, and closing
                # with them unread emits an RST that discards our reject
                # on the peer (it would see a bare ECONNRESET and skip
                # the previous-secret fallback). Half-close so FIN
                # follows the frame, then drain the pipelined bytes
                # until the client sees the reject and hangs up.
                conn.settimeout(1.0)
                conn.shutdown(socket.SHUT_WR)
                # bounded BOTH ways: 1s idle gap per recv, 5s overall —
                # a peer that keeps streaming must not pin this thread
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline and conn.recv(4096):
                    pass
            except (ConnectionError, OSError):
                pass
            return False
        return True

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            if self.tls_context is not None:
                # per-connection handshake in THIS worker thread — the
                # accept loop must never block on a silent client
                conn.settimeout(30.0)
                plain = conn
                try:
                    conn = self.tls_context.wrap_socket(
                        conn, server_side=True
                    )
                except (OSError, ValueError) as e:
                    logger.debug("fabric TLS handshake failed: %s", e)
                    return
                # wrap_socket DETACHES the plain socket: re-track the
                # SSLSocket or shutdown() force-closes a dead husk while
                # the live connection's reader blocks forever
                with self._conns_lock:
                    self._conns.discard(plain)
                    if self._shutdown.is_set():
                        conn.close()
                        return
                    self._conns.add(conn)
                conn.settimeout(None)
            first = conn.recv(1)
            if not first:
                return
            proto = first[0]
            if not self._authenticate(conn):
                return
            if proto == BYTE_RPC:
                self._handle_rpc_conn(conn)
            elif proto == BYTE_STREAMING:
                self._handle_stream_conn(conn)
            elif proto == BYTE_RAFT:
                if self.raft_handler is not None:
                    self.raft_handler(StreamSession(conn))
                else:
                    logger.warning("raft connection but no raft handler")
            else:
                logger.warning("unrecognized rpc protocol byte %#x", proto)
        except (ConnectionError, OSError):
            pass
        except Exception:
            logger.exception("rpc connection handler failed")
        finally:
            self._drop_conn(conn)

    def _handle_rpc_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        while not self._shutdown.is_set():
            req = codec.unpack(recv_frame(conn))
            method = req.get("method", "")
            pool = (
                self._priority_pool
                if method.startswith(self._priority_prefixes)
                else self._pool
            )
            pool.submit(self._dispatch, conn, wlock, req)

    def _dispatch(self, conn: socket.socket, wlock: threading.Lock, req) -> None:
        seq = req.get("seq")
        method = req.get("method", "")
        if faultplane.plane is not None:
            # Injected response drop: the request was DELIVERED but the
            # answer is lost — the caller sees a timeout, the nastier
            # half of a partition (retries must tolerate a possibly
            # already-applied write).
            try:
                faultplane.plane.on_rpc_serve(self.chaos_label, method)
            except faultplane.DropResponse:
                return
        # Remote trace segment (wire.py TRACE_KEY): the handler runs with
        # the caller's trace installed as this thread's current context,
        # so every span recorded below (raft applies included) stitches
        # into the originator's trace; the spans ride back in the
        # response rather than landing in this server's ring.
        segment = None
        ref = req.get(TRACE_KEY)
        if isinstance(ref, dict) and ref.get("id"):
            segment = trace.open_segment(f"rpc.{method}", ref)
        # Source attribution (clusterobs.py): derive who this request is
        # FOR, publish it on the thread->source registry so the hostobs
        # sampler can attribute handler CPU to the source, and record
        # the handler seconds in the bounded per-source ledger.
        args = req.get("args")
        source = clusterobs.source_of(req.get(SRC_KEY) or "", args)
        clusterobs.set_thread_source(source)
        t0 = time.perf_counter()
        try:
            with trace.use(segment):
                result = self.dispatch_local(method, args)
            resp = {"seq": seq, "result": result}
        except Exception as e:  # handler errors travel as strings
            logger.debug("rpc %s failed: %s", method, e)
            resp = {"seq": seq, "error": f"{type(e).__name__}: {e}"}
        finally:
            clusterobs.clear_thread_source()
        dt = time.perf_counter() - t0
        self.source_ledger.record(source, method, dt)
        # handler-side latency (the client-side nomad.rpc.call_seconds
        # minus this is wire + queueing time)
        metrics.observe(f"nomad.rpc.served_seconds.{method}", dt)
        if segment is not None:
            segment.finish(record=False)
            resp[TRACE_SPANS_KEY] = [s.to_wire() for s in segment.spans]
        try:
            payload = codec.pack(resp)
        except TypeError as e:  # a result the codec cannot carry
            payload = codec.pack(
                {"seq": seq, "error": f"{type(e).__name__}: {e}"}
            )
        metrics.incr(f"nomad.rpc.reply_bytes.{method}", len(payload))
        try:
            with wlock:
                send_frame(conn, payload)
        except (ConnectionError, OSError):
            pass

    # Optional pre-dispatch hook: (method, args) -> None, raising to
    # reject. The cluster layer uses it to re-authorize cross-region
    # requests regardless of whether they arrive in-process or over the
    # fabric socket.
    precheck = None

    def dispatch_local(self, method: str, args):
        """Resolve `Endpoint.method` and invoke it (also used in-process to
        skip the socket for self-calls, like the reference's
        server.RPC fast path)."""
        if self.precheck is not None:
            self.precheck(method, args)
        try:
            name, meth = method.split(".", 1)
        except ValueError:
            raise ValueError(f"malformed rpc method {method!r}")
        endpoint = self._endpoints.get(name)
        if endpoint is None:
            raise ValueError(f"unknown rpc endpoint {name!r}")
        if meth.startswith("_"):
            raise ValueError(f"invalid rpc method {method!r}")
        fn = getattr(endpoint, meth, None)
        if fn is None or not callable(fn):
            raise ValueError(f"unknown rpc method {method!r}")
        return fn(args)

    def _handle_stream_conn(self, conn: socket.socket) -> None:
        session = StreamSession(conn)
        header = session.recv(timeout_s=30)
        method = header.get("method", "")
        handler = self._stream_handlers.get(method)
        if handler is None:
            session.send({"error": f"unknown stream method {method!r}"})
            session.close()
            return
        session.send({"ok": True})
        handler(session, header)
