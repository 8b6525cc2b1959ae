"""Urgent registrations answered a second: the window's registrations
whose eval completed inside it, over the window's seconds. The cell's
users deregister a job only once its registration is answered, so every
one counted had its job registered when it was answered; the users wait
on the server, so the rate is the server's and no offered rate caps
it."""


def read(rec):
    end = rec["t0"] + rec["window_s"]
    done = 0
    for call in rec["calls"]:
        got = rec["ended"].get(call.eval_id)
        if (call.kind == "register" and got is not None
                and got[1] == "complete" and got[0] <= end):
            done += 1
    return done / rec["window_s"]
