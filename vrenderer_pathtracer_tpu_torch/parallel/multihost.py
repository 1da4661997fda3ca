"""Multi-process bootstrap and output collection (port of
``parallel/multihost.py``).

* :func:`initialize` — ``torch.distributed.init_process_group`` for every
  process of a run (NCCL where there is a card, gloo on the CPU); call it
  first, then build the mesh (``sharding.make_render_mesh``);
* :func:`gather_image` — the whole frame on every rank from each rank's
  tile: an all-gather over the tiles of the mesh;
* :func:`local_shard` / :func:`local_tile_bounds` — this rank's rows of the
  frame, for per-process tile output without communication;
* :func:`is_main_process` — whether this process writes the run's files.

A single process without an address is a no-op, so the render scripts are
the same from one card to many processes; only the mesh changes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# How long a collective or the rendezvous may wait for the other ranks.
TIMEOUT = timedelta(seconds=300)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> None:
    """Join the process group; a no-op for one process without an address.

    ``coordinator_address`` is ``host:port`` (or any ``init_method`` URL,
    such as ``tcp://host:port`` or ``file:///path``); None reads the
    ``MASTER_ADDR``/``MASTER_PORT`` that ``torchrun`` sets.  With an
    address the group always starts, even for one process, so one- and
    many-process runs take the same path.  ``backend`` defaults to NCCL
    when a card is present and gloo otherwise; a NCCL rank takes card
    ``LOCAL_RANK`` (else ``process_id``) modulo the cards it sees.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", 0))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes or 1, rank=rank,
                            timeout=TIMEOUT)


def is_main_process() -> bool:
    """Whether this process writes a run's files: rank 0, or a process
    without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _tiles_group(mesh):
    from vrenderer_pathtracer_tpu_torch.parallel.sharding import TILE_AXIS

    return None if mesh is None else mesh.get_group(TILE_AXIS)


def gather_image(img_tile: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole frame on every rank from each rank's tile (rows along the
    flattened pixel axis, tile order): an all-gather over the tiles of
    ``mesh`` (every rank of the group when None).  Without a group, or
    with one tile, the tile is the frame."""
    if not dist.is_initialized():
        return img_tile
    group = _tiles_group(mesh)
    n = dist.get_world_size(group)
    if n == 1:
        return img_tile
    tile = img_tile.contiguous()
    out = torch.empty((n * tile.shape[0], *tile.shape[1:]), dtype=tile.dtype,
                      device=tile.device)
    dist.all_gather_into_tensor(out, tile, group=group)
    return out


def local_shard(img_tile: torch.Tensor) -> np.ndarray:
    """This rank's rows of the frame on the host (no communication)."""
    return img_tile.detach().cpu().numpy()


def local_tile_bounds(img_tile: torch.Tensor, mesh=None) -> tuple[int, int]:
    """(start, stop) rows of the flattened pixel axis this rank holds: its
    tile index in ``mesh`` (its rank when None) times the tile's rows."""
    from vrenderer_pathtracer_tpu_torch.parallel.sharding import TILE_AXIS

    if mesh is not None:
        tile = mesh.get_local_rank(TILE_AXIS)
    else:
        tile = dist.get_rank() if dist.is_initialized() else 0
    rows = img_tile.shape[0]
    return tile * rows, (tile + 1) * rows
