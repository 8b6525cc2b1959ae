"""Share of the traced window in which the card ran nothing."""


def read(rec):
    dev = rec.get("device")
    if not dev or dev["window_ns"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_ns"] / dev["window_ns"])
