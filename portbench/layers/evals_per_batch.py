"""Mean evals a solve took (nomad.tpu.batch_evals; the interactive
lane's solves count as batches of one)."""

from portbench.readings import hist_mean


def read(rec):
    return hist_mean(rec, "nomad.tpu.batch_evals")
