"""Multi-host launch glue (counterpart:
``freerl_tpu/distributed/multihost.py``).

Each process calls :func:`initialize` to join one ``torch.distributed``
process group (one process per device), then builds ONE mesh over every
rank with :func:`global_mesh`. Env batches and replays stay with their
rank (``distributed/dp.py``), so experience never crosses processes; the
only traffic is the gradient and normalizer all-reduce.

Single-process runs are the identity: :func:`initialize` does nothing and
returns False when nothing is configured. It joins on its own only under
``torchrun`` with ``WORLD_SIZE`` > 1 (``init_method="env://"``: its
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``).

This module imports only torch, and the package's ``__init__`` touches no
device, so a launcher can load it before it picks a card.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group; a no-op for single-process runs.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous (or
    any ``init_method`` URL, such as ``file:///shared/path``),
    ``num_processes`` the world size and ``process_id`` this rank. Without
    them, a ``torchrun`` launch with ``WORLD_SIZE`` > 1 is joined from its
    environment. The default group (gloo) carries only the rendezvous;
    ``make_mesh`` builds the mesh's own group on the backend it is asked
    for. Returns True if a group was joined.
    """
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        # torchrun's variables (and its agent's store, where it keeps one)
        dist.init_process_group(backend="gloo", init_method="env://",
                                timeout=timeout)
        return True
    if num_processes is None or process_id is None:
        raise ValueError("initialize: coordinator_address needs "
                         "num_processes and process_id")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend="gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def global_mesh(axis: str = "dp", **kwargs):
    """One mesh over every rank of every host (the ``dp`` axis); ``kwargs``
    go to ``make_mesh``."""
    from freerl_tpu_torch.distributed.dp import make_mesh

    return make_mesh(axis=axis, **kwargs)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def hosts() -> int:
    """The number of processes in the group (1 when there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


__all__ = ["initialize", "global_mesh", "is_primary", "hosts"]
