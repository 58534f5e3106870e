"""Small shared array utilities."""

from __future__ import annotations

import numpy as np


def group_spans(keys: np.ndarray):
    """Yield ``(lo, hi)`` index spans of equal consecutive values.

    ``keys`` must already be grouped (equal values contiguous — e.g.
    the output of a stable argsort). This is the one implementation of
    the cuts/starts/ends idiom the install plane uses to hand each
    switch its contiguous slice of a dpid-sorted window
    (control/router.py, control/southbound.py, and the config-10 bench
    mirror of that path).
    """
    n = len(keys)
    if n == 0:
        return
    cuts = np.flatnonzero(np.diff(keys)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [n]])
    for lo, hi in zip(starts, ends):
        yield int(lo), int(hi)
