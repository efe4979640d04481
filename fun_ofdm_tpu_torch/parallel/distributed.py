"""Process-group bring-up and the global mesh
(fun_ofdm_tpu/parallel/distributed.py).

One rank per device: every process runs the same program on its own
block of the capture, and torch.distributed links them (NCCL between
cards, gloo through host memory).

Typical launch (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT):

    from fun_ofdm_tpu_torch.parallel import distributed, stream_shard
    distributed.initialize()
    mesh = distributed.global_mesh()
    block = distributed.shard_host_capture(mesh, local_re, local_im,
                                           global_shape=(C, N))
    out = stream_shard.sharded_receive(block, rate, length, mesh, ...)

Without torchrun, pass the address, world size and rank explicitly.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

#: the variables torchrun sets for the env:// rendezvous
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: how long the rendezvous and every collective may wait for a rank
TIMEOUT = timedelta(seconds=60)


def initialize(address: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str = "nccl") -> bool:
    """Join the process group (idempotent); True when one is up.

    address: "tcp://host:port" (or "host:port") of rank 0's store; None =
    torchrun's environment (env://). world_size and rank default to the
    environment's WORLD_SIZE and RANK. backend: "nccl" (cards) or "gloo"
    (host memory). The group times out after TIMEOUT. When nothing at all
    is configured (no argument and none of the variables) this is one
    process and nothing happens (False). Any other failure raises: a
    half-configured run must not carry on as one process over a fraction
    of the data.
    """
    if dist.is_initialized():
        return True
    if address is None and world_size is None and rank is None \
            and not any(k in os.environ for k in _ENV):
        return False
    if address is None:
        init_method = "env://"
    else:
        init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank), timeout=TIMEOUT)
    return True


def global_mesh(channel: int | None = None, time: int | None = None,
                device=None) -> Mesh:
    """A (channel, time) mesh over every rank of the group, rank-major,
    with this rank's block on `device` (default cuda:<local rank>)."""
    return make_mesh(None, channel=channel, time=time, device=device)


def local_capture_shape(mesh: Mesh, channels_global: int,
                        n_global: int) -> tuple[int, int]:
    """The (C_local, N_local) block a rank supplies for a
    (channels_global, n_global) capture: a rank is one block."""
    n_chan, n_time = mesh.shape
    if channels_global % n_chan or n_global % n_time:
        raise ValueError(
            f"capture shape ({channels_global}, {n_global}) must divide "
            f"the ({n_chan}, {n_time}) (channel, time) mesh evenly; pad "
            f"the capture")
    return channels_global // n_chan, n_global // n_time


def shard_host_capture(mesh: Mesh, local_re: np.ndarray,
                       local_im: np.ndarray, global_shape: tuple[int, int]):
    """This rank's slab of a (C, N) = global_shape capture, as planar
    float32 tensors on its device; the slab must have
    local_capture_shape(mesh, C, N)."""
    re, im = (torch.as_tensor(np.asarray(x, np.float32))
              for x in (local_re, local_im))
    want = local_capture_shape(mesh, *global_shape)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(f"slabs of {tuple(re.shape)} and {tuple(im.shape)} "
                         f"for a capture of {tuple(global_shape)} on a "
                         f"{mesh.shape} mesh; expected {want}")
    return re.to(mesh.device), im.to(mesh.device)
