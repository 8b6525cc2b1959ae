"""95th percentile of the registrations' latency, from the moment the
user could send to the eval's end, over every registration of the
window: the tail, a per-layer reading beside the mean (a window holds
some tens of registrations, too few for a steady 95th percentile)."""

import numpy as np

from portbench.readings import registration_latencies_s


def read(rec):
    lat = registration_latencies_s(rec)
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
