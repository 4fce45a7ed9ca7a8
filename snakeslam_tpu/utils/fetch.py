"""Batched device->host fetches.

Every *synchronous* fetch blocks the host until the device catches up,
but async D2H copies batch: starting ``copy_to_host_async`` on every array
first lets a single blocking wait sync them all.  Every back-end that needs
more than one result array should fetch through ``fetch_np``.
"""

from __future__ import annotations

import numpy as np


def fetch_np(*arrays):
    """Fetch several jax arrays to numpy with one device round trip."""
    for a in arrays:
        if hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()
    out = tuple(np.asarray(a) for a in arrays)
    return out if len(out) != 1 else out[0]


def fetch_list(arrays):
    """Like fetch_np but always takes/returns a list."""
    for a in arrays:
        if hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()
    return [np.asarray(a) for a in arrays]
