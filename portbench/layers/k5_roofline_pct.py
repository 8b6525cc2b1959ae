"""K5 (solve_placement_preempt, csrc/solve_dense.cu): the summed bound
of its window's calls over its device time."""

from portbench.readings import roofline_pct
from portbench.roofline import KERNELS

ENTRY = "solve_placement_preempt"


def read(rec):
    return roofline_pct(rec, ENTRY, KERNELS[ENTRY])
