"""Ranks: several processes rendering on one mesh (port of
``fractal_tpu/parallel/multihost.py``).

The reference joins a multi-host JAX cluster; here every process joins a
``torch.distributed`` process group on the gloo backend, and
``sharding.make_mesh()`` then spans every rank's local devices in rank
order.  Each rank renders its own shards; the stripes are all-gathered and
the fern's hits all-reduced over gloo on host copies, so every rank returns
the whole image.

    from fractal_tpu_torch.parallel import multihost, sharding
    multihost.initialize("127.0.0.1:29500", num_processes=2, process_id=rank)
    mesh = sharding.make_mesh()          # both ranks' devices
    img = sharding.render_escape_sharded(scene, mesh)

Single-process runs need none of this: every entry point works without
calling ``initialize``.  Ranks on distinct GPUs would gather over NCCL
rather than host copies; that transport is not written yet.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

#: The longest ``initialize`` waits for the other ranks, in seconds.
MAX_TIMEOUT_S = 120

_status = "not-initialized"


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None) -> None:
    """Join the process group (idempotent).

    With an explicit ``coordinator_address`` ("host:port"; rank 0 listens
    there) the caller means a multi-rank launch, so any failure raises
    ``RuntimeError``.  The no-argument form reads the coordinator from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` sets them); where there is none, or it cannot be
    joined, it is a single-process no-op that ``status()`` reports.  The
    wait is at most ``MAX_TIMEOUT_S`` seconds."""
    global _status
    dist = _dist()
    if dist.is_initialized():
        _status = "joined"
        return
    explicit = coordinator_address is not None
    timeout = datetime.timedelta(seconds=min(initialization_timeout or MAX_TIMEOUT_S,
                                             MAX_TIMEOUT_S))
    try:
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError("an explicit coordinator needs num_processes and "
                                 "process_id")
            dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id),
                                    timeout=timeout)
        else:
            missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                       if k not in os.environ]
            if missing:
                raise ValueError(f"no coordinator in the environment ({', '.join(missing)})")
            dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        _status = "joined"
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise RuntimeError(f"multi-host initialize failed for coordinator "
                               f"{coordinator_address!r}: {e}") from e
        _status = f"single-host ({type(e).__name__})"


def status() -> str:
    """'joined', 'single-host (...)' or 'not-initialized'."""
    return _status


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def is_multihost() -> bool:
    return process_count() > 1


def local_row_range(height: int) -> tuple:
    """The contiguous output rows [lo, hi) this rank owns when each rank
    writes only its part of a render."""
    p, i = process_count(), process_index()
    rows = -(-height // p)
    lo = min(i * rows, height)
    return lo, min(lo + rows, height)
