"""UGAL adaptive routing: the host-side link-load helper.

Counterpart of ``sdnmpi_tpu/oracle/adaptive.py``. Only
:func:`link_loads`, which the collective path's reap uses for the
discrete congestion figure, is ported; the adaptive policy itself
(``dag_weighted_costs``, ``ugal_choose``, ``route_adaptive``) waits for
ROADMAP A8.
"""

from __future__ import annotations

import numpy as np


def link_loads(paths: np.ndarray, weight: np.ndarray, v: int) -> np.ndarray:
    """Discrete ``[V, V]`` link loads of node paths (host-side; the
    native C++ scatter-add when built, numpy otherwise)."""
    from sdnmpi_tpu_torch import native

    return native.link_loads(paths, weight, v)
