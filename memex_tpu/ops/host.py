"""Device->host fetch that overlaps transfers.

Every blocking host fetch waits for its own transfer; fetching a jit
call's outputs one `np.asarray` at a time pays that latency once PER
ARRAY. `fetch` starts non-blocking copy_to_host_async transfers for every
array first, then materializes them, so the transfers overlap.

Parity note: the reference has no device, so its analogue is simply "don't
do N+1 fetches" (it makes the same class of mistake with SQL hydration,
lib/api/src/endpoints/collections/handlers.rs:87-102).
"""

from __future__ import annotations

import numpy as np


def fetch(*arrays) -> tuple[np.ndarray, ...]:
    """Fetch device arrays to host numpy, overlapping the transfers."""
    for a in arrays:
        if hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()
    return tuple(np.asarray(a) for a in arrays)
