"""Userspace TCP relay: the connect sidecar's data plane
(connect/sidecar.py).

Port of ``nomad_tpu/tcprelay.py``, whole. The reference shares it with
bridge-mode port forwarding (client/network.py PortProxy), which comes
with the port's client.

Semantics:
  * accept() errors are transient unless stopped — EMFILE/ECONNABORTED
    back off 50ms and keep serving; a relay must not die while its
    workload lives.
  * EOF on one direction propagates as shutdown(SHUT_WR) on the OTHER
    socket only (TCP half-close): a client that closes its write side
    after the request still receives the full response.
"""

from __future__ import annotations

import errno
import socket
import threading
import time
from typing import Callable, Optional


class TcpRelay:
    """Listener forwarding each connection to pick_target()'s choice.

    pick_target may return one ``(host, port)`` target or an ordered
    list of candidate targets; a later candidate is dialed ONLY when
    the earlier one fails with a no-route error (ENETUNREACH /
    EHOSTUNREACH) — a refused or timed-out dial means the primary was
    routable and falling through could deliver the stream to an
    unrelated service listening on the same port at the fallback
    address. The list form exists for the connect sidecar's gateway
    fallback (connect/sidecar.py): a netns'd dialer on a NAT-less host
    has NO ROUTE to a same-host advertised address and reaches the
    same listener through the bridge gateway; the fallback happens
    per-connection, inside the relay, so the unroutable primary never
    turns into a client-visible connection reset."""

    def __init__(
        self,
        listen_port: int,
        pick_target: Callable[[], Optional[tuple[str, int]]],
        listen_host: str = "0.0.0.0",
    ) -> None:
        self.pick_target = pick_target
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, listen_port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop,
            daemon=True,
            name=f"tcprelay-{self.port}",
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                if self._stop.is_set():
                    return
                time.sleep(0.05)  # transient: keep serving
                continue
            threading.Thread(
                target=self._relay, args=(conn,),
                name="tcprelay-conn", daemon=True,
            ).start()

    def _relay(self, conn: socket.socket) -> None:
        target = self.pick_target()
        if target is None:
            conn.close()
            return
        candidates = [target] if isinstance(target, tuple) else list(target)
        upstream = None
        for cand in candidates:
            try:
                upstream = socket.create_connection(cand, timeout=10)
                break
            except OSError as e:
                # fall through ONLY when there was no route at all;
                # refused/timeout mean the primary was the right place
                # and merely unhealthy — never reroute those
                if e.errno not in (errno.ENETUNREACH, errno.EHOSTUNREACH):
                    break
        if upstream is None:
            conn.close()
            return

        def pump(src: socket.socket, dst: socket.socket) -> None:
            try:
                while True:
                    data = src.recv(1 << 16)
                    if not data:
                        # half-close: tell the peer this DIRECTION is
                        # done; the reverse stream stays open
                        try:
                            dst.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        break
                    dst.sendall(data)
            except OSError:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t = threading.Thread(
            target=pump, args=(conn, upstream),
            name="tcprelay-pump", daemon=True,
        )
        t.start()
        pump(upstream, conn)
        t.join(timeout=30)
        for s in (conn, upstream):
            try:
                s.close()
            except OSError:
                pass
