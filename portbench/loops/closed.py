"""A closed loop with one caller: request i is job ``i mod jobs``, sent
once the previous request's answer is on the host, until ``seconds``
have passed and every job has been sent once."""

from __future__ import annotations

import time


def window(driver, jobs: list, seconds: float, keep) -> tuple[int, float, list]:
    """Run the window; ``keep(i, answer)`` sees every answer. Returns the
    requests answered, the window's seconds and each request's wall."""
    walls = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t = t0
    while t < deadline or len(walls) < len(jobs):
        n = len(walls)
        out = driver(jobs[n % len(jobs)])
        keep(n, out)
        del out
        now = time.perf_counter()
        walls.append(now - t)
        t = now
    return len(walls), t - t0, walls
