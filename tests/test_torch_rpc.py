"""The port's RPC fabric, keyring and gossip membership, held to
nomad_tpu's scenarios on the CPU.

The 19 cases of tests/test_rpc.py (the codec, the fabric's calls,
errors, pipelining, reconnects and timeouts, streaming sessions, the
single-flight dial, the shared-secret preamble), the 13 of
tests/test_keyring.py's TestKeyring and TestFabricAuth (rotation
windows, the dial-time secret read, auth-failure recovery) and the 3 of
tests/test_membership.py's TestMembership (join, failure detection,
graceful leave), each with the same assertions, run against
nomad_tpu_torch.rpc, its codec and nomad_tpu_torch.server.membership.
The port's frames carry its own codec (compact JSON), not msgpack.
"""

import threading
import time

import pytest

from nomad_tpu_torch import codec, mock
from nomad_tpu_torch.rpc import (
    AuthFailedError,
    ConnPool,
    Keyring,
    RPCError,
    RPCServer,
)
from nomad_tpu_torch.rpc.keyring import ensure_keyring, key_fingerprint
from nomad_tpu_torch.server.membership import FAILED, Membership


def wait_until(fn, timeout_s=15.0, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


# ---------------------------------------------------------------------------
# tests/test_rpc.py
# ---------------------------------------------------------------------------


class TestCodec:
    def test_roundtrip_primitives(self):
        for v in (None, True, 42, 3.5, "x", b"raw", [1, 2], {"a": 1}):
            assert codec.unpack(codec.pack(v)) == v

    def test_roundtrip_tuple_and_tuple_keys(self):
        v = {("ns", "job"): [1, 2], "plain": (3, 4)}
        out = codec.unpack(codec.pack(v))
        assert out == {("ns", "job"): [1, 2], "plain": (3, 4)}

    def test_roundtrip_job(self):
        job = mock.job()
        out = codec.unpack(codec.pack(job))
        assert out.id == job.id
        assert out.task_groups[0].tasks[0].resources.cpu == \
            job.task_groups[0].tasks[0].resources.cpu
        # independent object, not a reference
        out.task_groups[0].count = 999
        assert job.task_groups[0].count != 999

    def test_roundtrip_node_alloc_eval(self):
        node = mock.node()
        job = mock.job()
        alloc = mock.alloc(job_=job, node_=node)
        ev = mock.eval_for_job(job)
        out = codec.unpack(codec.pack({"n": node, "a": alloc, "e": ev}))
        assert out["n"].id == node.id
        assert (
            out["a"].resources.tasks["web"].cpu
            == alloc.resources.tasks["web"].cpu
        )
        assert out["e"].job_id == job.id

    def test_unknown_type_rejected(self):
        class NotRegistered:
            pass

        with pytest.raises(TypeError):
            codec.pack(NotRegistered())


class Echo:
    def echo(self, args):
        return args

    def boom(self, args):
        raise RuntimeError("kaboom")

    def slow(self, args):
        time.sleep(args["delay"])
        return args["delay"]


@pytest.fixture
def rpc():
    server = RPCServer()
    server.register("Echo", Echo())
    server.start()
    pool = ConnPool()
    yield server, pool
    pool.shutdown()
    server.shutdown()


class TestRPC:
    def test_echo(self, rpc):
        server, pool = rpc
        job = mock.job()
        out = pool.call(server.addr, "Echo.echo", {"job": job})
        assert out["job"].id == job.id

    def test_error_propagates(self, rpc):
        server, pool = rpc
        with pytest.raises(RPCError, match="kaboom"):
            pool.call(server.addr, "Echo.boom")

    def test_unknown_method(self, rpc):
        server, pool = rpc
        with pytest.raises(RPCError, match="unknown rpc"):
            pool.call(server.addr, "Echo.nope")
        with pytest.raises(RPCError, match="unknown rpc"):
            pool.call(server.addr, "Nope.echo")

    def test_private_method_rejected(self, rpc):
        server, pool = rpc
        with pytest.raises(RPCError):
            pool.call(server.addr, "Echo._dispatch")

    def test_pipelining_out_of_order(self, rpc):
        """A slow call must not block a fast one on the same pooled conn."""
        server, pool = rpc
        results = {}

        def slow():
            results["slow"] = pool.call(
                server.addr, "Echo.slow", {"delay": 0.5}, timeout_s=5
            )

        t = threading.Thread(target=slow)
        t.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        assert pool.call(server.addr, "Echo.echo", 1) == 1
        fast_elapsed = time.monotonic() - t0
        t.join()
        assert results["slow"] == 0.5
        assert fast_elapsed < 0.4, "fast call waited behind slow call"

    def test_concurrent_calls(self, rpc):
        server, pool = rpc
        errs = []

        def worker(i):
            try:
                for j in range(20):
                    assert pool.call(server.addr, "Echo.echo", [i, j]) == [i, j]
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs

    def test_reconnect_after_server_restart(self):
        server = RPCServer()
        server.register("Echo", Echo())
        server.start()
        pool = ConnPool()
        try:
            port = server.addr[1]
            assert pool.call(server.addr, "Echo.echo", "a") == "a"
            server.shutdown()
            server2 = RPCServer(port=port)
            server2.register("Echo", Echo())
            server2.start()
            try:
                assert pool.call(server2.addr, "Echo.echo", "b") == "b"
            finally:
                server2.shutdown()
        finally:
            pool.shutdown()

    def test_timeout(self, rpc):
        server, pool = rpc
        with pytest.raises(TimeoutError):
            pool.call(server.addr, "Echo.slow", {"delay": 2}, timeout_s=0.1)


class TestStreaming:
    def test_stream_session(self):
        server = RPCServer()

        def handler(session, header):
            # echo frames back until the peer sends {"eof": True}
            while True:
                msg = session.recv(timeout_s=5)
                if msg.get("eof"):
                    session.send({"bye": True})
                    session.close()
                    return
                session.send({"echo": msg["data"]})

        server.register_stream("FileSystem.logs", handler)
        server.start()
        pool = ConnPool()
        try:
            s = pool.stream(server.addr, "FileSystem.logs", {"alloc_id": "x"})
            s.send({"data": "hello"})
            assert s.recv(timeout_s=5)["echo"] == "hello"
            s.send({"data": b"bytes"})
            assert s.recv(timeout_s=5)["echo"] == b"bytes"
            s.send({"eof": True})
            assert s.recv(timeout_s=5)["bye"] is True
        finally:
            pool.shutdown()
            server.shutdown()

    def test_unknown_stream_method(self):
        server = RPCServer()
        server.start()
        pool = ConnPool()
        try:
            with pytest.raises(RPCError, match="unknown stream"):
                pool.stream(server.addr, "Nope.stream")
        finally:
            pool.shutdown()
            server.shutdown()


class TestDialSingleFlight:
    """Reconnect-storm dial discipline (round 21): concurrent callers
    whose pooled conn died queue behind ONE in-flight dial per peer
    instead of stacking TCP handshakes against a likely-dead address."""

    def test_dial_storm_never_stacks_handshakes(self, monkeypatch):
        from nomad_tpu_torch.rpc import client as rpc_client

        server = RPCServer()
        server.register("Echo", Echo())
        server.start()
        pool = ConnPool()
        # The guaranteed property is CONCURRENCY, not total count: a
        # pooled conn that dies (the host can RST loopback conns under
        # fd/TIME_WAIT pressure) is legitimately redialed — but never
        # while another dial to the same peer is already in flight.
        state = {"cur": 0, "peak": 0, "total": 0}
        state_lock = threading.Lock()
        real_conn = rpc_client._Conn

        class CountingConn(real_conn):
            def __init__(self, *a, **kw):
                # the patch is module-global: stray background dials to
                # OTHER peers (leaked retry loops from earlier test
                # modules) must not count against OUR peer's flight
                addr = a[0] if a else kw.get("addr")
                ours = addr == server.addr
                if ours:
                    with state_lock:
                        state["cur"] += 1
                        state["total"] += 1
                        state["peak"] = max(state["peak"], state["cur"])
                    time.sleep(0.2)  # a slow handshake the storm piles on
                try:
                    super().__init__(*a, **kw)
                finally:
                    if ours:
                        with state_lock:
                            state["cur"] -= 1

        monkeypatch.setattr(rpc_client, "_Conn", CountingConn)
        try:
            conns = []
            errs = []

            def caller():
                # _get is the single-flight unit under test; pool.call's
                # dead-conn retry layer above it may legitimately redial
                try:
                    conns.append(pool._get(server.addr))
                except Exception as e:
                    errs.append(e)

            threads = [threading.Thread(target=caller) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            assert not errs
            assert state["peak"] == 1, (
                f"{state['peak']} concurrent handshakes for one peer — "
                "waiters must adopt the in-flight dial"
            )
            assert state["total"] < 8, (
                f"{state['total']} dials for 8 callers — the storm "
                "never coalesced"
            )
            assert len(conns) == 8
            # and the pooled conn actually works
            assert pool.call(server.addr, "Echo.echo", 7) == 7
        finally:
            pool.shutdown()
            server.shutdown()

    def test_failed_dial_wakes_waiters_promptly(self, monkeypatch):
        from nomad_tpu_torch.rpc import client as rpc_client

        pool = ConnPool(connect_timeout_s=1.0)
        addr = ("127.0.0.1", 1)  # never dialed — _Conn is patched
        real_conn = rpc_client._Conn

        def boom(a, *rest, **kw):
            # global patch: fail only OUR peer, pass strays through
            if a == addr:
                raise ConnectionRefusedError("peer down")
            return real_conn(a, *rest, **kw)

        monkeypatch.setattr(rpc_client, "_Conn", boom)
        try:
            errs = []

            def caller():
                try:
                    pool.call(addr, "Echo.echo", 1, timeout_s=2)
                except Exception as e:
                    errs.append(e)

            t0 = time.monotonic()
            threads = [threading.Thread(target=caller) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            elapsed = time.monotonic() - t0
            assert len(errs) == 6
            # waiters retried or failed right behind the flight — nobody
            # sat out a full connect timeout queue serially
            assert elapsed < 5.0, f"dial-failure fan-out took {elapsed:.1f}s"
        finally:
            pool.shutdown()


class TestCodecEscaping:
    def test_dollar_key_user_dict_roundtrips(self):
        """Reserved-tag collision: user data with $-keys must survive."""
        v = {"$b64": "hello", "$t": "NotAType", "normal": 1}
        assert codec.unpack(codec.pack(v)) == v


class TestRPCSecret:
    """Cluster shared-secret preamble on the fabric (trust boundary in
    rpc/server.py): unauthenticated peers can't invoke any endpoint."""

    def test_secret_required(self):
        server = RPCServer(secret="s3cret")
        server.register("Echo", Echo())
        server.start()
        try:
            good = ConnPool(secret="s3cret")
            assert good.call(server.addr, "Echo.echo", {"x": 1}) == {"x": 1}
            good.shutdown()
            bad = ConnPool(secret="wrong")
            with pytest.raises((ConnectionError, OSError, TimeoutError)):
                bad.call(server.addr, "Echo.echo", {"x": 1}, timeout_s=3)
            bad.shutdown()
            none = ConnPool()
            with pytest.raises((ConnectionError, OSError, TimeoutError)):
                none.call(server.addr, "Echo.echo", {"x": 1}, timeout_s=3)
            none.shutdown()
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# tests/test_keyring.py: TestKeyring, TestFabricAuth
# ---------------------------------------------------------------------------


class PingEcho:
    def ping(self, args):
        return args


@pytest.fixture
def fabric():
    """(make_server, make_pool) factories with shutdown bookkeeping."""
    servers, pools = [], []

    def make_server(secret):
        s = RPCServer(secret=secret)
        s.register("Echo", PingEcho())
        s.start()
        servers.append(s)
        return s

    def make_pool(secret):
        p = ConnPool(secret=secret)
        pools.append(p)
        return p

    yield make_server, make_pool
    for p in pools:
        p.shutdown()
    for s in servers:
        s.shutdown()


# ---------------------------------------------------------------------------
# Keyring units
# ---------------------------------------------------------------------------


class TestKeyring:
    def test_rotate_opens_window_then_expires(self):
        kr = Keyring("a", window_s=0.2)
        assert kr.rotate("b") is True
        assert kr.accepts(b"b")
        assert kr.accepts(b"a"), "previous must pass inside the window"
        assert kr.previous_active() == "a"
        time.sleep(0.3)
        assert not kr.accepts(b"a"), "window closed: previous rejected"
        assert kr.previous_active() == ""
        assert kr.accepts(b"b")

    def test_rotate_same_secret_is_noop(self):
        kr = Keyring("a")
        gen = kr.generation
        assert kr.rotate("a") is False
        assert kr.generation == gen
        assert not kr.status()["dual_accept"], (
            "a no-op rotation must not open a window"
        )

    def test_rotate_back_within_window_swaps_slots(self):
        kr = Keyring("a", window_s=5.0)
        kr.rotate("b")
        assert kr.rotate("a") is True  # the rollout was aborted
        assert kr.current == "a"
        assert kr.accepts(b"a")
        assert kr.accepts(b"b"), (
            "the aborted secret drains out through its own window"
        )

    def test_rotate_to_empty_refused(self):
        kr = Keyring("a")
        with pytest.raises(ValueError):
            kr.rotate("")
        assert kr.current == "a"

    def test_enable_from_empty_has_no_window(self):
        kr = Keyring("")
        assert not kr.enabled
        assert kr.rotate("s") is True
        assert kr.enabled
        assert not kr.status()["dual_accept"]
        assert not kr.accepts(b"")

    def test_status_never_leaks_secrets(self):
        kr = Keyring("super-secret-value", window_s=5.0)
        kr.rotate("next-secret-value")
        st = kr.status()
        assert "super-secret-value" not in str(st)
        assert "next-secret-value" not in str(st)
        assert st["current_fingerprint"] == key_fingerprint(
            "next-secret-value"
        )
        assert st["previous_fingerprint"] == key_fingerprint(
            "super-secret-value"
        )
        assert st["dual_accept"] and st["generation"] == 1

    def test_ensure_keyring_passthrough(self):
        kr = Keyring("x")
        assert ensure_keyring(kr) is kr
        assert ensure_keyring("x").current == "x"
        assert not ensure_keyring(None).enabled


# ---------------------------------------------------------------------------
# Fabric: accept/reject/fallback/redial
# ---------------------------------------------------------------------------


class TestFabricAuth:
    def test_wrong_secret_fails_fast_and_unsent(self, fabric):
        make_server, make_pool = fabric
        srv = make_server("right")
        pool = make_pool("wrong")
        t0 = time.monotonic()
        with pytest.raises(AuthFailedError) as exc:
            pool.call(srv.addr, "Echo.ping", 1, timeout_s=10)
        assert time.monotonic() - t0 < 5, (
            "auth reject must be an explicit error, not a timeout"
        )
        assert exc.value.request_sent is False, (
            "nothing was dispatched: safe to re-send after a rotation"
        )

    def test_server_dual_accept_during_window(self, fabric):
        make_server, make_pool = fabric
        kr = Keyring("v1", window_s=5.0)
        srv = make_server(kr)
        old_pool = make_pool("v1")
        assert old_pool.call(srv.addr, "Echo.ping", 1) == 1
        kr.rotate("v2")
        # fresh dial with the OLD secret: accepted via the window
        fresh = make_pool("v1")
        assert fresh.call(srv.addr, "Echo.ping", 2) == 2

    def test_pool_previous_fallback_against_unrotated_server(self, fabric):
        """The mirror image: the DIALER rotated first; the server still
        only knows the old secret. The pool's auth-failure fallback
        presents the previous secret and the call succeeds."""
        make_server, make_pool = fabric
        srv = make_server("v1")
        ckr = Keyring("v1")
        ckr.rotate("v2", window_s=5.0)
        pool = make_pool(ckr)
        assert pool.call(srv.addr, "Echo.ping", 3) == 3

    def test_window_expiry_rejects_old_secret_dials(self, fabric):
        make_server, make_pool = fabric
        kr = Keyring("v1", window_s=0.2)
        srv = make_server(kr)
        kr.rotate("v2")
        assert make_pool("v1").call(srv.addr, "Echo.ping", 1) == 1
        time.sleep(0.3)
        with pytest.raises(AuthFailedError):
            make_pool("v1").call(srv.addr, "Echo.ping", 2, timeout_s=10)
        assert make_pool("v2").call(srv.addr, "Echo.ping", 3) == 3

    def test_redial_rereads_current_secret_after_rotation(self, fabric):
        """REGRESSION (the rotated-client-recovers-without-restart
        satellite): the pool must read its keyring at every dial, not
        cache the secret it first dialed with. A client whose keyring
        rotated recovers on the very next call once its stale
        connection dies."""
        make_server, make_pool = fabric
        skr = Keyring("v1", window_s=0.0)  # hard cutover on the server
        srv = make_server(skr)
        ckr = Keyring("v1")
        pool = make_pool(ckr)
        assert pool.call(srv.addr, "Echo.ping", 1) == 1  # conn est. w/ v1
        skr.rotate("v2")  # window 0: v1 now rejected outright
        # established connection keeps working (auth is per-connection)
        assert pool.call(srv.addr, "Echo.ping", 2) == 2
        # the connection dies (server restart analog: kill the conn)
        with pool._lock:
            conn = pool._conns[(srv.addr[0], srv.addr[1])]
        conn.close()
        # un-rotated client: redial presents v1, rejected
        with pytest.raises(AuthFailedError):
            pool.call(srv.addr, "Echo.ping", 3, timeout_s=10)
        # rotate the CLIENT keyring (the SIGHUP push): the next call
        # redials with the new secret — no pool or process restart
        ckr.rotate("v2")
        assert pool.call(srv.addr, "Echo.ping", 4) == 4

    def test_stream_dials_fall_back_within_window(self, fabric):
        """Streaming sessions ride the same keyring discipline."""
        make_server, make_pool = fabric
        srv = make_server("v1")
        srv.register_stream(
            "Echo.stream", lambda session, header: session.send({"ok": 2})
        )
        ckr = Keyring("v1")
        ckr.rotate("v2", window_s=5.0)
        pool = make_pool(ckr)
        session = pool.stream(srv.addr, "Echo.stream", {})
        try:
            assert session.recv(timeout_s=5)["ok"] == 2
        finally:
            session.close()


# ---------------------------------------------------------------------------
# tests/test_membership.py: TestMembership
# ---------------------------------------------------------------------------


class TestMembership:
    def _mk(self, n, **kw):
        """n members, each with its own RPC server."""
        rpcs, mgrs = [], []
        for i in range(n):
            rpc = RPCServer()
            mgr = Membership(
                f"m{i}",
                rpc.addr,
                tags={"role": "server"},
                probe_interval_s=0.1,
                probe_timeout_s=0.3,
                suspicion_timeout_s=0.8,
                **kw,
            )
            rpc.register("Serf", mgr.endpoint)
            rpc.start()
            mgr.start()
            rpcs.append(rpc)
            mgrs.append(mgr)
        return rpcs, mgrs

    def test_join_and_converge(self):
        rpcs, mgrs = self._mk(3)
        try:
            mgrs[1].join([rpcs[0].addr])
            mgrs[2].join([rpcs[0].addr])
            assert wait_until(
                lambda: all(len(m.alive_members()) == 3 for m in mgrs), 10
            ), "all three should converge on 3 alive members"
        finally:
            for r in rpcs:
                r.shutdown()
            for m in mgrs:
                m.stop()

    def test_failure_detection(self):
        rpcs, mgrs = self._mk(3)
        events = []
        mgrs[0].on_event = lambda kind, m: events.append((kind, m.id))
        try:
            mgrs[1].join([rpcs[0].addr])
            mgrs[2].join([rpcs[0].addr])
            assert wait_until(
                lambda: all(len(m.alive_members()) == 3 for m in mgrs), 10
            )
            # kill m2 hard (no graceful leave)
            rpcs[2].shutdown()
            mgrs[2].stop()
            assert wait_until(
                lambda: any(
                    m.id == "m2" and m.status == FAILED
                    for m in mgrs[0].members()
                ),
                10,
            ), "m0 should detect m2 failed"
            assert ("member-failed", "m2") in events
        finally:
            for r in rpcs[:2]:
                r.shutdown()
            for m in mgrs[:2]:
                m.stop()

    def test_graceful_leave(self):
        rpcs, mgrs = self._mk(2)
        try:
            mgrs[1].join([rpcs[0].addr])
            assert wait_until(
                lambda: len(mgrs[0].alive_members()) == 2, 10
            )
            mgrs[1].leave()
            assert wait_until(
                lambda: any(
                    m.id == "m1" and m.status == "left"
                    for m in mgrs[0].members()
                ),
                5,
            )
        finally:
            for r in rpcs:
                r.shutdown()
            mgrs[0].stop()
