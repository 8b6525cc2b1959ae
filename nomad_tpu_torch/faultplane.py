"""The fault plane: deterministic, seedable fault injection.

Port of ``nomad_tpu/faultplane.py``. A production-side leaf holding the
:class:`FaultPlane` rule engine and the process-global ``plane`` slot
that the hook sites read:

  - ``rpc/client.py`` ConnPool.call -> :meth:`FaultPlane.on_rpc_call`
    (drops, delays and partitions by node label);
  - ``rpc/server.py`` RPCServer._dispatch ->
    :meth:`FaultPlane.on_rpc_serve` (a delivered request whose answer is
    lost);
  - ``server/raft_store.py`` append/set_state/store_snapshot ->
    :meth:`FaultPlane.on_disk` (fsync failures and slow disk on the
    raft log);
  - the batch worker's device stage -> :meth:`FaultPlane.on_device`,
    called at the start of the solve stage's dispatch (``"dispatch"``)
    and of the commit stage's device wait (``"finish"``). A firing rule
    raises :class:`DeviceFault`, whose ``retriable`` flag the worker
    classifies: retriable faults fall back to the host solve path,
    terminal ones nack the batch. :class:`DeviceLost` is a real CUDA
    fault at the device wait or readback, always terminal.

Each rule is optionally probabilistic (one seeded RNG consulted under one
lock, so a seed fixes the whole fault schedule) and/or bounded by a
count. :func:`env_knobs_active` names every live injection knob. The
scenario harness (ChaosCluster) lives in ``testing/chaos.py``, which
re-exports this module.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Iterable, Optional

# The installed plane. Hook sites read this module attribute directly
# (`if faultplane.plane is not None: ...`) so the disabled cost is one
# attribute load per hook.
plane: Optional["FaultPlane"] = None


def install(p: "FaultPlane") -> "FaultPlane":
    """Install the fault plane process-wide. Returns it for chaining."""
    global plane
    plane = p
    return p


def uninstall() -> None:
    global plane
    plane = None


def active() -> bool:
    """Is any fault injection live (installed plane with rules)?"""
    return plane is not None and plane.has_rules()


def env_knobs_active() -> list[str]:
    """Names of NOMAD_TPU_INJECT_* env knobs currently set non-zero,
    plus a sentinel for an installed fault plane."""
    out = [
        k
        for k, v in os.environ.items()
        if k.startswith("NOMAD_TPU_INJECT_") and v.strip() not in ("", "0")
    ]
    if active():
        out.append("<fault-plane-installed>")
    return out


class InjectedRPCError(ConnectionError):
    """An injected connection-level drop; subclasses ConnectionError so
    the production rundown/redial paths treat it as a real network
    failure."""


class DropResponse(Exception):
    """Server-side injection: swallow the request, send no response
    (the caller sees a timeout, as with a partition after delivery)."""


class InjectedDiskError(OSError):
    """An injected fsync/write failure on the raft log store."""


class DeviceFault(Exception):
    """An injected device-stage failure. ``retriable`` mirrors the
    classification the worker applies to real device errors: retriable
    faults fall back to the host solve path; terminal ones nack the
    batch."""

    def __init__(self, msg: str = "injected device fault", retriable: bool = True):
        super().__init__(msg)
        self.retriable = retriable


class DeviceLost(Exception):
    """A real CUDA fault at the device wait or readback of a batch (an
    illegal address, a device-side assert): the runtime's error, which
    leaves the process's CUDA context unusable. The solver
    (scheduler/gpu/solver.py) raises it with the CUDA error as its
    ``__cause__``. It is terminal: the worker nacks the batch and parks,
    and never re-solves it on the host."""


class _Rule:
    """One fault rule. `times=None` means unlimited; `prob` draws from
    the plane's seeded RNG (under its lock — one global draw order, so
    a seed fixes the whole schedule)."""

    __slots__ = ("kind", "match", "action", "prob", "times")

    def __init__(self, kind: str, match: Callable, action, prob: float,
                 times: Optional[int]) -> None:
        self.kind = kind
        self.match = match
        self.action = action
        self.prob = prob
        self.times = times


class FaultPlane:
    def __init__(self, seed: int = 0) -> None:
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._rules: list[_Rule] = []
        # node label <-> advertised fabric addr, so partition rules
        # written in terms of node ids can match a ConnPool's dial target
        self._addr_label: dict[tuple[str, int], str] = {}
        # observability for assertions: kind -> injections fired
        self.fired: dict[str, int] = {}

    # -- wiring --------------------------------------------------------

    def register_addr(self, label: str, addr: tuple[str, int]) -> None:
        with self._lock:
            self._addr_label[(addr[0], addr[1])] = label

    def label_of(self, addr) -> str:
        try:
            return self._addr_label.get((addr[0], addr[1]), "")
        except (TypeError, IndexError):
            return ""

    def has_rules(self) -> bool:
        with self._lock:
            return bool(self._rules)

    def heal(self, kind: Optional[str] = None) -> None:
        """Drop all rules (or all rules of one kind)."""
        with self._lock:
            if kind is None:
                self._rules.clear()
            else:
                self._rules = [r for r in self._rules if r.kind != kind]

    # -- rule builders -------------------------------------------------

    def _add(self, rule: _Rule) -> "FaultPlane":
        with self._lock:
            self._rules.append(rule)
        return self

    @staticmethod
    def _rpc_match(src, dst, method):
        def match(s, d, m):
            return (
                (src is None or s == src)
                and (dst is None or d == dst)
                and (method is None or m == method or m.startswith(method))
            )

        return match

    def drop_rpc(self, src: Optional[str] = None, dst: Optional[str] = None,
                 method: Optional[str] = None, prob: float = 1.0,
                 times: Optional[int] = None) -> "FaultPlane":
        """Fail matching client-side calls with InjectedRPCError before
        the frame is written (the request is never delivered)."""
        return self._add(_Rule("rpc.drop", self._rpc_match(src, dst, method),
                               None, prob, times))

    def delay_rpc(self, delay_s: float, src: Optional[str] = None,
                  dst: Optional[str] = None, method: Optional[str] = None,
                  prob: float = 1.0, times: Optional[int] = None) -> "FaultPlane":
        return self._add(_Rule("rpc.delay", self._rpc_match(src, dst, method),
                               delay_s, prob, times))

    def partition(self, group_a: Iterable[str],
                  group_b: Iterable[str]) -> "FaultPlane":
        """Symmetric partition between two node-label groups: every call
        whose (src, dst) crosses the cut is dropped, both directions."""
        a, b = frozenset(group_a), frozenset(group_b)

        def match(s, d, m):
            return (s in a and d in b) or (s in b and d in a)

        return self._add(_Rule("rpc.drop", match, None, 1.0, None))

    def isolate(self, label: str, others: Iterable[str]) -> "FaultPlane":
        return self.partition([label], others)

    def drop_response(self, label: Optional[str] = None,
                      method: Optional[str] = None, prob: float = 1.0,
                      times: Optional[int] = None) -> "FaultPlane":
        """Server-side: the handler never runs and no response is sent —
        the request was DELIVERED but the answer is lost."""

        def match(lbl, m):
            return (label is None or lbl == label) and (
                method is None or m == method or m.startswith(method)
            )

        return self._add(_Rule("serve.drop", match, None, prob, times))

    def fail_disk(self, label: Optional[str] = None, op: Optional[str] = None,
                  prob: float = 1.0, times: Optional[int] = None) -> "FaultPlane":
        """Inject InjectedDiskError from the raft store's write ops
        (op in {append, state, snapshot}; None = all)."""

        def match(lbl, o):
            return (label is None or lbl == label) and (op is None or o == op)

        return self._add(_Rule("disk.fail", match, None, prob, times))

    def slow_disk(self, delay_s: float, label: Optional[str] = None,
                  op: Optional[str] = None, prob: float = 1.0,
                  times: Optional[int] = None) -> "FaultPlane":
        def match(lbl, o):
            return (label is None or lbl == label) and (op is None or o == op)

        return self._add(_Rule("disk.slow", match, delay_s, prob, times))

    def fail_device(self, phase: Optional[str] = None, retriable: bool = True,
                    prob: float = 1.0, times: Optional[int] = None) -> "FaultPlane":
        """Raise DeviceFault from the worker's device stage (phase in
        {dispatch, finish}; None = both)."""

        def match(p):
            return phase is None or p == phase

        return self._add(_Rule("device.fail", match, retriable, prob, times))

    # -- hook entry points (called from production code) ---------------

    def _fire(self, kinds: tuple[str, ...], *args):
        """Match rules of the given kinds against args; return the first
        firing rule (consuming its count / probability draw) or None."""
        with self._lock:
            for rule in self._rules:
                if rule.kind not in kinds:
                    continue
                if rule.times is not None and rule.times <= 0:
                    continue
                if not rule.match(*args):
                    continue
                if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                    continue
                if rule.times is not None:
                    rule.times -= 1
                self.fired[rule.kind] = self.fired.get(rule.kind, 0) + 1
                return rule
        return None

    def on_rpc_call(self, src_label: str, addr, method: str) -> None:
        dst = self.label_of(addr)
        rule = self._fire(("rpc.delay",), src_label, dst, method)
        if rule is not None:
            time.sleep(rule.action)
        rule = self._fire(("rpc.drop",), src_label, dst, method)
        if rule is not None:
            raise InjectedRPCError(
                f"injected rpc drop {src_label or '?'} -> {dst or addr} {method}"
            )

    def on_rpc_serve(self, label: str, method: str) -> None:
        rule = self._fire(("serve.drop",), label, method)
        if rule is not None:
            raise DropResponse(f"injected response drop at {label} {method}")

    def on_disk(self, label: str, op: str) -> None:
        rule = self._fire(("disk.slow",), label, op)
        if rule is not None:
            time.sleep(rule.action)
        rule = self._fire(("disk.fail",), label, op)
        if rule is not None:
            raise InjectedDiskError(f"injected {op} failure at {label}")

    def on_device(self, phase: str) -> None:
        rule = self._fire(("device.fail",), phase)
        if rule is not None:
            raise DeviceFault(
                f"injected device fault in {phase}", retriable=rule.action
            )
