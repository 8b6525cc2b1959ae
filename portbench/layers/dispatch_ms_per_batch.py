"""Mean phase A of a batch: snapshot, reconcile, lower and the launch
(nomad.tpu.batch_dispatch_seconds)."""

from portbench.readings import hist_mean


def read(rec):
    return hist_mean(rec, "nomad.tpu.batch_dispatch_seconds", 1e3)
