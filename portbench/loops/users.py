"""A closed loop of users who each keep a few jobs registered.

Each of `users` users holds `keep` live jobs of the cell's job shape.
When a registration of theirs is answered (its eval ends), they
register a fresh job and then deregister their oldest, at once and
without waiting for either: the new job is asked for while the old one
still runs, as a replacement is. So a job is stopped only after its own
registration was answered, every registration the window counts has
its job registered when its eval ends, and the rate is the server's
own: no offered rate caps it.

Parameters (`traffic/<mix>.json`, with ``"loop": "users"``):

- ``users``: users sending at once (registrations in flight);
- ``keep``: live jobs each user holds;
- ``warm_rounds``: rounds of the loop run in set-up after the users'
  first `keep` jobs are placed, so the window opens in the steady
  state (every path the window runs already run);
- ``drain_s``: how long the window's calls are followed after it.

The loop draws nothing from the seed: every seed sends the same calls
in the same order, to a fleet the seed orders and names.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import time


@dataclasses.dataclass(frozen=True)
class Params:
    users: int
    keep: int
    warm_rounds: int
    drain_s: float


def parse(doc: dict) -> Params:
    p = Params(users=int(doc.get("users", 0)), keep=int(doc.get("keep", 0)),
               warm_rounds=int(doc.get("warm_rounds", 0)),
               drain_s=float(doc.get("drain_s", 60.0)))
    if p.users < 1 or p.keep < 1 or p.warm_rounds < 0 or p.drain_s <= 0:
        raise ValueError("users, keep >= 1; warm_rounds >= 0; drain_s > 0")
    return p


def warm(ctx, p: Params) -> list:
    """Each user registers its `keep` jobs, then the loop runs
    `warm_rounds` rounds; every eval is waited for. Returns the users'
    live job ids, oldest first."""
    live = [collections.deque() for _ in range(p.users)]
    calls = []
    for _ in range(p.keep):
        for u in range(p.users):
            spec = ctx.fresh()
            calls.append(ctx.driver.send("register", spec,
                                         time.perf_counter()))
            live[u].append(spec.id)
    ctx.wait([c.eval_id for c in calls])
    for _ in range(p.warm_rounds):
        calls = []
        for u in range(p.users):
            now = time.perf_counter()
            spec = ctx.fresh()
            calls.append(ctx.driver.send("register", spec, now))
            live[u].append(spec.id)
            calls.append(ctx.driver.send("deregister", live[u].popleft(),
                                         now))
        ctx.wait([c.eval_id for c in calls])
    return live


def window(ctx, p: Params, live: list, until: float) -> None:
    """The users send until the host clock passes `until`. A user whose
    call was refused (no eval) stops; the call counts as failed."""
    drv = ctx.driver
    done = ctx.system.watch.done
    ends = ctx.system.watch.ends
    waiting = {}  # registration's eval id -> (user, job id)
    answered = collections.deque()  # eval ids ended before we looked

    def register(u, due):
        spec = ctx.fresh()
        call = drv.send("register", spec, due)
        if call.eval_id:
            waiting[call.eval_id] = (u, spec.id)
            if call.eval_id in done:
                answered.append(call.eval_id)
        return spec.id

    now = time.perf_counter()
    for u in range(p.users):
        register(u, now)
    while waiting:
        if answered:
            eval_id = answered.popleft()
        else:
            left = until - time.perf_counter()
            if left <= 0:
                return
            try:
                eval_id = ends.get(timeout=left)
            except queue.Empty:
                return
        got = waiting.pop(eval_id, None)
        if got is None:
            continue
        if time.perf_counter() >= until:
            return
        u, job_id = got
        live[u].append(job_id)
        due = done[eval_id][0]
        register(u, due)
        if len(live[u]) > p.keep:
            drv.send("deregister", live[u].popleft(), due)


def ops(p: Params, fresh, n: int) -> list:
    """The loop's calls in one order, for a placer that answers each
    call before the next: the warm-up, then n registrations of the
    window, the users taking turns."""
    live = [collections.deque() for _ in range(p.users)]
    out = []
    for _ in range(p.keep):
        for u in range(p.users):
            spec = fresh()
            out.append(("register", spec))
            live[u].append(spec.id)
    for k in range(p.warm_rounds * p.users + n):
        u = k % p.users
        spec = fresh()
        out.append(("register", spec))
        live[u].append(spec.id)
        out.append(("deregister", live[u].popleft()))
    return out
