"""Seconds from the process's start to the window's first second:
imports, the card, the kernel library, the fleet, the fill and the
warm-up."""


def read(rec):
    return rec["setup_s"]
