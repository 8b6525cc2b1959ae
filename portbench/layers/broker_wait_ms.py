"""Mean time an eval waited ready in the broker (nomad.broker.wait_seconds)."""

from portbench.readings import hist_mean


def read(rec):
    return hist_mean(rec, "nomad.broker.wait_seconds", 1e3)
