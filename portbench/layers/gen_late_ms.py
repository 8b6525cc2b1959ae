"""Mean delay from the moment a user could send (its registration's
eval ended, on the thread that applied it) to the moment the generator
sent the next call: the generator shares the interpreter with the
server."""


def read(rec):
    late = [c.sent - c.due for c in rec["calls"] if c.kind == "register"]
    return 1e3 * sum(late) / len(late) if late else None
