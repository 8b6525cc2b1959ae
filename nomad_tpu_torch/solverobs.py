"""Solver device observability: launch-shape ledger, batch occupancy,
and host<->device transfer / device-memory accounting.

The batched solver pads every problem to shape buckets
(scheduler/gpu/kernels.py pad_n/pad_g/pad_c). A new bucket, padding
waste, and host<->device transfer cost all look identical from the
outside (a slow solve). This module is the always-on attribution layer
that separates them:

  * launch-shape ledger — every kernel entry-point call records its
    padded-shape signature and the host time the call took to enqueue;
    a signature not seen before is a new shape (the kernels are built
    once, so a new shape costs no compile: the ledger shows how many
    buckets the traffic spreads over). The ledger is bounded
    (per-kernel signature FIFO). It keeps the reference's compile-ledger
    wire keys: a new shape counts as a "compile" (the reference's jit
    traces and compiles there; the port launches a built kernel at a new
    launch shape), a repeat as a "cache hit", and a new shape after the
    kernel had served repeats as a "steady recompile" — a climbing count
    is traffic spreading over more buckets. ``record_call`` is the
    reference's entry point onto the same ledger.
  * batch occupancy — real rows/cols vs the padded bucket shapes:
    occupancy fraction, padding-waste fraction, and asks-per-batch.
  * transfer accounting — host->device bytes from the numpy arrays
    actually uploaded per dispatch (device-resident inputs excluded),
    device->host bytes read back, and on a mesh the modeled all-gather
    bytes of the node-sharded solves and the delta rows scattered into
    their owning shards (scheduler/gpu/sharding.py);
  * sharding — the shard count and per-shard occupancy of the last
    node-sharded dispatch.
  * device memory — ``torch.cuda.memory_allocated`` /
    ``memory_reserved`` and their high-water mark, when torch is loaded
    and a card is present (an explicit null otherwise, never
    fabricated).

A stdlib-only leaf: torch is touched only inside
:func:`sample_device_memory`, and only when it is already loaded.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from . import metrics, trace

# Bounds: kernels are a closed set (the entry points in scheduler/gpu);
# signatures per kernel are the shape buckets, a handful in practice.
MAX_KERNELS = 64
MAX_SIGNATURES = 256

_enabled = True


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """The e2e overhead comparator's off switch (tests); production
    leaves this on — the whole point is always-on attribution."""
    global _enabled
    _enabled = bool(on)


class _Kernel:
    __slots__ = (
        "sigs", "launches", "new_shapes", "enqueue_ns", "last_sig",
        "evicted", "routes", "cache_hits", "steady_recompiles",
        "first_compile_ns", "steady_compile_ns",
    )

    def __init__(self) -> None:
        # sig -> repeat count; insertion-ordered dict IS the FIFO bound
        self.sigs: dict = {}
        self.launches = 0
        self.new_shapes = 0
        self.enqueue_ns = 0
        self.last_sig: Optional[tuple] = None
        self.evicted = 0
        # route -> calls, for entry points that report one (a CUDA graph's
        # capture or replay, or step-by-step launches)
        self.routes: dict = {}
        # the reference's compile-ledger counters (new_shapes is its
        # "compiles"); the *_compile_ns sums are the host time of the
        # calls that met a new shape
        self.cache_hits = 0
        self.steady_recompiles = 0
        self.first_compile_ns = 0
        self.steady_compile_ns = 0

    def to_wire(self) -> dict:
        return {
            "compiles": self.new_shapes,
            "cache_hits": self.cache_hits,
            "steady_recompiles": self.steady_recompiles,
            "first_compile_ms": round(self.first_compile_ns / 1e6, 3),
            "steady_compile_ms": round(self.steady_compile_ns / 1e6, 3),
            "launches": self.launches,
            "new_shapes": self.new_shapes,
            "enqueue_ms": round(self.enqueue_ns / 1e6, 3),
            "signatures": len(self.sigs),
            "signatures_evicted": self.evicted,
            "last_signature": (
                list(self.last_sig) if self.last_sig is not None else None
            ),
            "routes": dict(self.routes),
        }


class SolverObservatory:
    """One process-wide instance (module functions below delegate);
    tests may install a fresh one via _install()."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._kernels: dict[str, _Kernel] = {}
        # occupancy over batches
        self.batches = 0
        self.occupancy_sum = 0.0
        self.last_batch: Optional[dict] = None
        # asks-per-batch (recorded at the eval-batch layer, scheduler.py)
        self.last_asks: Optional[dict] = None
        # lowered node-table shape (lower.py build_node_table)
        self.last_table: Optional[dict] = None
        # transfer totals (bytes); allgather = modeled gather traffic of
        # node-sharded solves, scatter = delta-sync rows landing in
        # their owning resident shard (scheduler/gpu/sharding.py)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.allgather_bytes = 0
        self.scatter_bytes = 0
        # sharding: shard count + per-shard occupancy of the last
        # node-sharded dispatch (bounded to 64 rows)
        self.mesh_devices = 0
        self.last_shards: Optional[list] = None
        # device memory
        self.device_memory: Optional[dict] = None
        self._last_mem_sample = 0.0

    # -- launch-shape ledger -------------------------------------------

    def record_launch(self, kernel: str, signature: tuple,
                      wall_ns: int, route: Optional[str] = None) -> bool:
        """One kernel entry-point call, `wall_ns` of host time to
        enqueue, and the route it took where it reports one: True when
        its padded-shape signature is new."""
        if not _enabled:
            return False
        with self._lock:
            k = self._kernels.get(kernel)
            if k is None:
                if len(self._kernels) >= MAX_KERNELS:
                    return False  # closed set in practice; never grow past
                k = self._kernels[kernel] = _Kernel()
            k.last_sig = signature
            k.launches += 1
            k.enqueue_ns += wall_ns
            if route is not None:
                k.routes[route] = k.routes.get(route, 0) + 1
            new = signature not in k.sigs
            if new:
                while len(k.sigs) >= MAX_SIGNATURES:
                    k.sigs.pop(next(iter(k.sigs)))
                    k.evicted += 1
                k.sigs[signature] = 0
                k.new_shapes += 1
                # a new shape once the kernel served repeats is a steady
                # recompile; the warm-up shapes before any repeat are not
                if k.cache_hits > 0:
                    k.steady_recompiles += 1
                    k.steady_compile_ns += wall_ns
                else:
                    k.first_compile_ns += wall_ns
            else:
                k.sigs[signature] += 1
                k.cache_hits += 1
        metrics.incr("nomad.solver.launches")
        metrics.observe("nomad.solver.enqueue_seconds", wall_ns / 1e9)
        if not new:
            metrics.incr("nomad.solver.cache_hits")
            return False
        metrics.incr("nomad.solver.new_shapes")
        metrics.incr("nomad.solver.compiles")
        metrics.observe("nomad.solver.compile_seconds", wall_ns / 1e9)
        trace.stage_attrs(
            "solver.compile", wall_ns, kernel=kernel,
            signature=str(signature),
        )
        return True

    def record_call(self, kernel: str, signature: tuple,
                    wall_ns: int) -> bool:
        """The reference's compile-ledger entry point: one kernel call,
        True when its padded-shape signature is new (a "compile"),
        False on a repeat (a "cache hit")."""
        return self.record_launch(kernel, signature, wall_ns)

    def _sum(self, field: str, prefix: str) -> int:
        with self._lock:
            return sum(
                getattr(k, field)
                for name, k in self._kernels.items()
                if name.startswith(prefix)
            )

    def new_shapes(self, prefix: str = "") -> int:
        return self._sum("new_shapes", prefix)

    def compiles(self, prefix: str = "") -> int:
        """New launch shapes (the reference's compile events)."""
        return self._sum("new_shapes", prefix)

    def steady_recompiles(self, prefix: str = "") -> int:
        return self._sum("steady_recompiles", prefix)

    # -- batch occupancy ------------------------------------------------

    def record_batch(self, n: int, g: int, pad_n: int, pad_g: int) -> None:
        """One kernel dispatch's real vs padded shape."""
        if not _enabled:
            return
        denom = max(1, pad_n * pad_g)
        occ = (n * g) / denom
        waste = 1.0 - occ
        with self._lock:
            self.batches += 1
            self.occupancy_sum += occ
            self.last_batch = {
                "n": n, "g": g, "pad_n": pad_n, "pad_g": pad_g,
                "occupancy": round(occ, 4), "pad_waste": round(waste, 4),
            }
        metrics.observe("nomad.solver.occupancy", occ)
        metrics.observe("nomad.solver.pad_waste", waste)

    def note_asks(self, groups: int, requests: int) -> None:
        """Asks-per-batch at the eval-batch layer (scheduler.py)."""
        if not _enabled:
            return
        with self._lock:
            self.last_asks = {"groups": groups, "requests": requests}
        metrics.observe("nomad.solver.batch_asks", float(groups))
        metrics.observe("nomad.solver.batch_requests", float(requests))

    def note_table(self, n: int, nbytes: int) -> None:
        """The lowered node table's host-side tensor footprint
        (lower.py build_node_table)."""
        if not _enabled:
            return
        with self._lock:
            self.last_table = {"nodes": n, "host_bytes": int(nbytes)}

    def record_shards(self, n_dev: int, shards: list) -> None:
        """Per-shard occupancy of one node-sharded dispatch
        (sharding.SolverMesh.shard_occupancy rows). Bounded: a mesh
        larger than 64 shards keeps its first 64 rows plus the count."""
        if not _enabled:
            return
        shards = list(shards[:64])
        with self._lock:
            self.mesh_devices = int(n_dev)
            self.last_shards = shards
        for s in shards:
            metrics.observe(
                "nomad.solver.shard_occupancy", float(s.get("occupancy", 0.0))
            )

    # -- transfers ------------------------------------------------------

    def record_transfer(
        self, direction: str, nbytes: int, dur_ns: int = 0, span: bool = False
    ) -> None:
        """direction: 'h2d' | 'd2h' | 'allgather' | 'scatter'. span=True
        also lands a solver.transfer span of dur_ns on the live trace."""
        if not _enabled or nbytes <= 0:
            return
        with self._lock:
            if direction == "h2d":
                self.h2d_bytes += nbytes
            elif direction == "allgather":
                self.allgather_bytes += nbytes
            elif direction == "scatter":
                self.scatter_bytes += nbytes
            else:
                self.d2h_bytes += nbytes
        metrics.incr(f"nomad.solver.transfer_bytes.{direction}", nbytes)
        # per-dispatch size distribution in MEGABYTES: the registry's
        # fixed exponential bounds (1e-4 .. ~1677, tuned for seconds)
        # then cover 100B .. ~1.6GB per dispatch — byte-unit values
        # would all land in the +Inf bucket and make the percentiles
        # meaningless
        metrics.observe(f"nomad.solver.{direction}_mb", nbytes / 1e6)
        if span:
            trace.stage_attrs(
                "solver.transfer", dur_ns, direction=direction, bytes=nbytes
            )

    # -- device memory --------------------------------------------------

    def sample_device_memory(self, force: bool = False) -> None:
        """Sample the CUDA caching allocator's counters. Only touches
        torch when it is already imported, and only when a card is
        present; rate-limited to ~1/s on the solve path, force=True
        always samples fresh."""
        if not _enabled or "torch" not in sys.modules:
            return
        now = time.monotonic()
        if not force and now - self._last_mem_sample < 1.0:
            return
        self._last_mem_sample = now
        import torch

        if not torch.cuda.is_available():
            return
        stats = {
            "bytes_in_use": torch.cuda.memory_allocated(),
            "bytes_reserved": torch.cuda.memory_reserved(),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
        }
        with self._lock:
            self.device_memory = stats
        metrics.set_gauge(
            "nomad.solver.device_bytes_in_use", float(stats["bytes_in_use"])
        )
        metrics.set_gauge(
            "nomad.solver.device_bytes_reserved",
            float(stats["bytes_reserved"]),
        )

    # -- read side ------------------------------------------------------

    def snapshot(self, sample: bool = True) -> dict:
        """The solver-status payload. sample=True refreshes the
        device-memory counters first (no-op without torch or a card)."""
        if sample:
            self.sample_device_memory(force=True)
        with self._lock:
            kernels = {
                name: k.to_wire() for name, k in self._kernels.items()
            }
            batches = self.batches
            occ_mean = (
                self.occupancy_sum / batches if batches else None
            )
            return {
                "enabled": _enabled,
                "ledger": {
                    "kernels": kernels,
                    "compiles": sum(
                        k.new_shapes for k in self._kernels.values()
                    ),
                    "cache_hits": sum(
                        k.cache_hits for k in self._kernels.values()
                    ),
                    "steady_recompiles": sum(
                        k.steady_recompiles for k in self._kernels.values()
                    ),
                    "launches": sum(
                        k.launches for k in self._kernels.values()
                    ),
                    "new_shapes": sum(
                        k.new_shapes for k in self._kernels.values()
                    ),
                },
                "occupancy": {
                    "batches": batches,
                    "mean": round(occ_mean, 4) if occ_mean is not None else None,
                    "last_batch": dict(self.last_batch)
                    if self.last_batch else None,
                    "last_asks": dict(self.last_asks)
                    if self.last_asks else None,
                    "last_table": dict(self.last_table)
                    if self.last_table else None,
                },
                "transfers": {
                    "h2d_bytes": self.h2d_bytes,
                    "d2h_bytes": self.d2h_bytes,
                    "allgather_bytes": self.allgather_bytes,
                    "scatter_bytes": self.scatter_bytes,
                },
                "sharding": {
                    "devices": self.mesh_devices,
                    "last_shards": (
                        [dict(s) for s in self.last_shards]
                        if self.last_shards else None
                    ),
                },
                "device_memory": dict(self.device_memory)
                if self.device_memory else None,
            }


_global = SolverObservatory()


def observatory() -> SolverObservatory:
    return _global


def _install(obs: SolverObservatory) -> SolverObservatory:
    """Swap the process-global observatory (returns the previous one) —
    the test isolation hook, mirroring metrics._install_registry."""
    global _global, record_launch, record_batch, note_asks, note_table
    global record_transfer, record_shards, sample_device_memory, snapshot
    global new_shapes, record_call, compiles, steady_recompiles
    old = _global
    _global = obs
    record_launch = obs.record_launch
    record_batch = obs.record_batch
    note_asks = obs.note_asks
    note_table = obs.note_table
    record_transfer = obs.record_transfer
    record_shards = obs.record_shards
    sample_device_memory = obs.sample_device_memory
    snapshot = obs.snapshot
    new_shapes = obs.new_shapes
    record_call = obs.record_call
    compiles = obs.compiles
    steady_recompiles = obs.steady_recompiles
    return old


# Module-level conveniences, rebindable via _install (call sites read
# `solverobs.<fn>` through the module at call time).
record_launch = _global.record_launch
record_batch = _global.record_batch
note_asks = _global.note_asks
note_table = _global.note_table
record_transfer = _global.record_transfer
record_shards = _global.record_shards
sample_device_memory = _global.sample_device_memory
snapshot = _global.snapshot
new_shapes = _global.new_shapes
record_call = _global.record_call
compiles = _global.compiles
steady_recompiles = _global.steady_recompiles


def timed_call(kernel: str, signature: tuple, fn, *args, **kwargs):
    """Run a kernel entry point under the launch-shape ledger: times the
    call on the host (the enqueue; the very first call also pays the
    one-time library load; execution is async on the card and NOT
    awaited here) and records whether its shape is new."""
    t0 = time.monotonic_ns()
    out = fn(*args, **kwargs)
    record_launch(kernel, signature, time.monotonic_ns() - t0,
                  getattr(fn, "last_route", None))
    return out
