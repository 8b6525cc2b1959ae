"""Mean latency of every registration of the window, from the moment
the user could send to the eval's end."""

from portbench.readings import registration_latencies_s


def read(rec):
    lat = registration_latencies_s(rec)
    return 1e3 * sum(lat) / len(lat) if lat else None
