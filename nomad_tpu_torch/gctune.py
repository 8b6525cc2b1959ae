"""CPython GC tuning for the scheduling hot paths.

Port of ``nomad_tpu/gctune.py``.

CPython's generational collector triggers every ~700 container
allocations and each young-gen pass walks survivors while the whole
multi-hundred-thousand-object cluster state (nodes, allocs, jobs) sits
in the older generations, and the cost applies equally to the store's
insert loop and the reconciler's request minting.

The batch scheduler and plan applier therefore pause the collector for
the duration of one batch (a bounded, non-reentrant critical section)
and re-enable it on exit; servers additionally `freeze()` their
post-bootstrap heap so the long-lived cluster state is never rescanned.
This mirrors what the reference gets for free from Go's concurrent
collector (no stop-the-world young-gen scans proportional to live set)
and the gc.freeze() pattern CPython grew for exactly this shape of
workload (long-lived heap + high allocation rate).

The pause is reentrancy-safe: nested sections (solve inside plan apply
inside an agent request) keep the collector off until the outermost
exit, and a section never re-enables a collector the process had
disabled globally.
"""

from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_depth = 0
_was_enabled = False
_section_t0 = 0

# Host-observability hook (hostobs.py sets this to its
# paused-section recorder when the profiler starts): called with the
# OUTERMOST section's duration in ns on exit. One attribute test when
# unset — the hot paths pay nothing until a profiler is attached. A
# long paused section is itself a signal: the re-enable pays one
# young-gen scan proportional to everything allocated inside it.
on_section_end = None


@contextmanager
def paused_gc(freeze_on_exit: bool = False):
    """Pause the cyclic collector for a bounded batch of allocations.

    The depth counter is process-wide (the collector is), so sections
    entered concurrently from scheduler workers and the plan applier
    coordinate under a lock: the collector comes back when the LAST
    section exits, and never if the process had it disabled globally.

    freeze_on_exit: when this section is the LAST one out (the flag is
    honored only at the outermost exit; a concurrent section still open
    elsewhere wins and the freeze is skipped), gc.freeze() right before
    re-enabling. A paused section only DEFERS the young-gen scan — the
    first collection after re-enable still walks everything the section
    allocated (a c2m cluster build is ~10^6 objects, and every
    registered gc callback runs against it).
    Freezing instead moves the section's survivors straight to the
    permanent generation: no scan ever happens, which is exactly right
    when the survivors ARE resident state (a built cluster, committed
    store rows). Dead temporaries still free by refcount, but CYCLES
    allocated inside the section are frozen forever — so this is for
    bounded-lifetime resident-heap bursts (the bench process), never
    for arbitrary scratch work in a long-lived server (production
    agents use freeze_resident_heap at warmup instead).
    """
    global _depth, _was_enabled, _section_t0
    with _lock:
        if _depth == 0:
            _was_enabled = gc.isenabled()
            gc.disable()
            _section_t0 = time.monotonic_ns()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            last_out = _depth == 0
            if last_out:
                if freeze_on_exit:
                    gc.freeze()
                if _was_enabled:
                    gc.enable()
            dur_ns = (
                time.monotonic_ns() - _section_t0 if last_out else 0
            )
        if last_out and on_section_end is not None:
            on_section_end(dur_ns)


def freeze_startup_heap() -> None:
    """Move everything currently alive out of the collector's sight.

    Called by the agent after bootstrap (modules, config, stores built):
    the long-lived heap no longer participates in any generational scan,
    so steady-state collections only walk genuinely young objects.
    """
    gc.collect()
    gc.freeze()


def release_frozen_garbage() -> int:
    """Unfreeze, collect, re-freeze: reclaim CYCLES stranded in the
    permanent generation.

    Loops that rebuild a frozen resident heap (the bench's
    fresh-cluster passes: build, freeze, measure, drop, repeat) leak
    each dropped heap's cyclic residue — refcounting frees the acyclic
    bulk, but cycles sit frozen where no collection ever looks
    (measured: ~64MB/pass at c2m scale, unbounded). One
    unfreeze + full collect walks everything ONCE and re-freezes the
    true survivors; call it in the untimed gap between passes, never
    inside a measured section (the walk is proportional to the whole
    live heap). Returns the collected-object count."""
    gc.unfreeze()
    n = gc.collect()
    gc.freeze()
    return n


def freeze_resident_heap() -> int:
    """Re-freeze the CURRENT live heap (post-warmup form of
    freeze_startup_heap): after a server replays its log or a bench
    config builds its cluster, the resident store/log heap is orders of
    magnitude bigger than at bootstrap, and every collection that walks
    it also runs every registered gc callback. One collect + freeze
    moves the whole resident set into the permanent generation; later
    collections see only genuinely young objects. Safe to call
    repeatedly (freeze is additive); frozen objects still free by
    refcount — only CYCLES frozen here would outlive their heap, so
    callers freeze long-lived resident state, not per-batch scratch.
    Returns the frozen-object count for telemetry.
    """
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()
