"""What the metric readers share: a window's record and the arithmetic
on the program's metrics registry over it.

A record (`rec`) is the dict run.py fills for one window: setup_s, t0
(host seconds the window opened), window_s, calls (driver.Call, sent in
the window), ended ({eval id: (host seconds, status)}), drain_end (host
seconds), m0 / m1 (registry snapshots at the window's edges), and with
a trace: spans ((name, start ns, end ns) of the program's batch
traces), device ({"ops", "busy_ns", "window_ns"}) and bounds ({entry
point: (launches, bound seconds)}).
"""

from __future__ import annotations


def hist_delta(rec: dict, name: str):
    """(count, sum) a histogram gained over the window."""
    a = rec["m0"]["samples"].get(name, {})
    b = rec["m1"]["samples"].get(name, {})
    return (b.get("count", 0) - a.get("count", 0),
            b.get("sum", 0.0) - a.get("sum", 0.0))


def hist_mean(rec: dict, name: str, scale: float = 1.0):
    """The mean of the samples the histogram took in the window (its
    exact count and sum; the buckets' quantiles are not used)."""
    n, s = hist_delta(rec, name)
    return scale * s / n if n > 0 else None


def span_mean_ms(rec: dict, name: str):
    durs = [e - s for n, s, e in rec.get("spans", ()) if n == name]
    return sum(durs) / len(durs) / 1e6 if durs else None


def registration_latencies_s(rec: dict) -> list:
    """Seconds from each registration's due time (when its user could
    send it) to its eval's end; a registration refused, failed or still
    running after the drain is taken at the drain's end."""
    out = []
    for call in rec["calls"]:
        if call.kind != "register":
            continue
        end = rec["ended"].get(call.eval_id)
        if call.error or end is None or end[1] != "complete":
            out.append(rec["drain_end"] - call.due)
        else:
            out.append(end[0] - call.due)
    return out


def roofline_pct(rec: dict, entry: str, pattern: str):
    """100 x the summed bound of an entry point's calls in the window
    over the device time of its kernel there; None without either."""
    from portbench.devtrace import device_seconds

    dev = rec.get("device")
    if not dev:
        return None
    launches, bound = rec["bounds"].get(entry, (0, 0.0))
    n, secs = device_seconds(dev["ops"], pattern)
    if not launches or not n or secs <= 0:
        return None
    return 100.0 * bound / secs
