"""Mean commit.finish span of a batch: the wait on the card, the
readback and materialize (with pick_victims when it preempts)."""

from portbench.readings import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "commit.finish")
