"""Multi-host bring-up.

The cards of one host need no setup: one process drives them all.
Several hosts coordinate through jax.distributed, which replaces an
NCCL/MPI bootstrap (the reference has neither; SURVEY.md §5
distributed-communication).
"""

from __future__ import annotations

import os

from ..log import get_logger

logger = get_logger(__name__)


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or MEMEX_COORDINATOR /
    MEMEX_NUM_PROCESSES / MEMEX_PROCESS_ID env vars. Returns True if
    multi-host mode was initialized, False for single-process mode."""
    import jax

    coordinator = coordinator or os.environ.get("MEMEX_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("MEMEX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("MEMEX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "jax.distributed initialized: process %d/%d via %s",
        process_id, num_processes, coordinator,
    )
    return True
