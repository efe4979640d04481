"""The (channel, time) grid of ranks (fun_ofdm_tpu/parallel/mesh.py).

The scaling axes are the JAX package's:

  * `channel` - independent RF channels or captures: no communication;
  * `time`    - one long capture cut into blocks; each rank needs the head
    of its right time neighbour's block (the halo) to decode the frames
    that straddle the cut.

JAX's mesh holds devices, and one process may drive several. Here the
idiom is PyTorch's: one torch.distributed rank per device, and a rank is
one block of the grid. A Mesh only describes the grid; nothing touches a
device or the network until a sharded receive runs on it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A (channel, time) grid of global ranks and this rank's place in it.

    ranks: the grid, rank-major (rank r sits at (r // time, r % time)
    when the grid is every rank of the group). rank: this process's
    global rank. device: where its block lives. group: the process group
    the grid's collectives run in (None: one process, no collectives).
    """

    ranks: tuple[tuple[int, ...], ...]
    rank: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.ranks), len(self.ranks[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (channel, time) block."""
        for c, row in enumerate(self.ranks):
            if self.rank in row:
                return c, row.index(self.rank)
        raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks}")


def default_device(rank: int) -> torch.device:
    """A rank's card: cuda:<local rank>, the local rank from the
    LOCAL_RANK variable that torchrun sets, else the rank itself."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))


def make_mesh(ranks=None, channel: int | None = None,
              time: int | None = None, *, rank: int | None = None,
              device=None) -> Mesh:
    """Build a (channel, time) mesh over `ranks`.

    ranks: a count or a sequence of global ranks; None = every rank of
    the initialised process group, or one. If only one of channel/time
    is given the other is inferred; by default the channel axis takes
    2^floor(log2(n) / 2) ranks. rank: this process's rank (default: its
    rank in the group, or the first of `ranks`). device: default
    cuda:<local rank> (default_device). The group is the whole process
    group when torch.distributed is initialised, else None.
    """
    initialised = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = dist.get_world_size() if initialised else 1
    ranks = list(range(ranks)) if isinstance(ranks, int) else list(ranks)
    n = len(ranks)
    if channel is None and time is None:
        channel = int(2 ** int(np.floor(np.log2(max(n, 1)) / 2)))
        time = n // channel
    elif channel is None:
        channel = n // time
    elif time is None:
        time = n // channel
    if channel * time != n or n == 0:
        raise ValueError(f"mesh {channel}x{time} != {n} ranks")
    if rank is None:
        rank = dist.get_rank() if initialised else ranks[0]
    grid = tuple(tuple(ranks[c * time:(c + 1) * time])
                 for c in range(channel))
    return Mesh(grid, int(rank), torch.device(
        default_device(rank) if device is None else device),
        dist.group.WORLD if initialised else None)
