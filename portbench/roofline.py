"""The yardstick for kernels: the card's published peaks, the bytes and
operations each kernel's call needs (from its launch shapes), and the
recorder that notes those shapes on the timed path.

The bound of a call is the least time the card could take for it: the
larger of its bytes over the memory bandwidth and its operations over
the float32 rate. Bytes count each input read once and each output
written once. Operations count one scoring pass of SCORE_FLOPS float32
operations for each live group (count > 0) over every node: the
kernels' group-to-group chain and a preemption solve's second pass are
not counted, so the bound never runs above what the work needs.
"""

from __future__ import annotations

import threading

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flop_per_s": 67e12,
}
# float32 operations a (live group, node) in a scoring pass: 2 int to
# float adds, 2 max, 2 div, 2 sub, 2 mul, 2 exp, add, sub, 2 clamp, div,
# bias add
SCORE_FLOPS = 19

# the entry points the recorder wraps, by their names in the solver
# module, and the device kernel each launches (a regular expression on
# the profiler's kernel name)
KERNELS = {
    "solve_placement_compact": r"solve_compact_kernel",
    "solve_placement_preempt": r"solve_placement_kernel<\w+, true>",
}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(nbytes_: int, ops: int) -> float:
    return max(nbytes_ / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["fp32_flop_per_s"])


class LaunchRecorder:
    """Wraps the solver module's kernel entry points for one window.
    Each call keeps its byte count and its `counts` tensor (a few
    hundred bytes on the card); live groups are read after the window,
    so the wrapper adds no wait on the card inside it."""

    def __init__(self, solver_mod) -> None:
        self.mod = solver_mod
        self.calls: dict = {name: [] for name in KERNELS}
        self._orig = {}
        self._lock = threading.Lock()
        for name in KERNELS:
            orig = getattr(solver_mod, name)
            self._orig[name] = orig
            setattr(solver_mod, name, self._wrap(name, orig))

    def _wrap(self, name: str, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            if name == "solve_placement_compact":
                cap, counts = args[0], args[3]
            else:
                cap, counts = args[0], args[4]
            rec = (nbytes(*[a for a in args if hasattr(a, "element_size")],
                          *outs), cap.shape[0], counts)
            with self._lock:
                self.calls[name].append(rec)
            return out
        call.__wrapped__ = fn
        return call

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.mod, name, fn)

    def bounds(self) -> dict:
        """{entry point: (launches, summed bound seconds)}."""
        out = {}
        for name, recs in self.calls.items():
            total = 0.0
            for nb, np_, counts in recs:
                live = int((counts > 0).sum())
                total += bound_s(nb, live * np_ * SCORE_FLOPS)
            out[name] = (len(recs), total)
        return out
