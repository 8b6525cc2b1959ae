"""Mean time a batch's plans took from submit to applied: plan queue,
verify, raft apply and the store (nomad.plan.submit_seconds)."""

from portbench.readings import hist_mean


def read(rec):
    return hist_mean(rec, "nomad.plan.submit_seconds", 1e3)
