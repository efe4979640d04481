"""Sharded overlap-save receive over a (channel, time) mesh of ranks
(fun_ofdm_tpu/parallel/stream_shard.py).

Every rank runs the same program on its own (C_loc, n_local) block of the
global capture (planar re, im). A frame whose preamble starts in a block
may run into the next time block, so each rank appends a halo: the head of
its right time neighbour's block, sent with one point-to-point exchange
(the last time block appends zeros). A rank delivers exactly the frames
whose detected start lies in its own block, not in the halo, so every
frame comes out once however the blocks are cut. The per-block results
are all-gathered into fun_ofdm_tpu's global slot layout, (C,
T * max_frames_per_block, ...), on every rank.

With the gloo backend the exchange and the gather go through host memory
(gloo moves CPU tensors); with NCCL they stay on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import DEFAULT_PARAMS, ChainParams
from ..models import frontend
from ..rates import Rate, params_for
from .mesh import Mesh


def _through_host(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) == "gloo"


def _halo_exchange_right(block: torch.Tensor, halo: int,
                         mesh: Mesh) -> torch.Tensor:
    """Append the first `halo` samples of the right time neighbour's
    block. block: (..., n_local); the last time block appends zeros."""
    n_local = block.shape[-1]
    if halo > n_local:
        raise ValueError(f"the halo of {halo} samples is longer than the "
                         f"block of {n_local} samples")
    c, t = mesh.coords
    n_time = mesh.shape[1]
    head = block[..., :halo].contiguous()
    recv = torch.zeros_like(head)
    if mesh.group is not None and n_time > 1:
        host = _through_host(mesh)
        send_buf = head.cpu() if host else head
        recv_buf = torch.zeros_like(send_buf)
        # both point-to-point ops posted together: my head to my left
        # neighbour, my halo from my right one
        ops = []
        if t > 0:
            ops.append(dist.P2POp(dist.isend, send_buf, mesh.ranks[c][t - 1],
                                  group=mesh.group))
        if t < n_time - 1:
            ops.append(dist.P2POp(dist.irecv, recv_buf, mesh.ranks[c][t + 1],
                                  group=mesh.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        recv = recv_buf.to(block.device)
    return torch.cat([block, recv], dim=-1)


def _all_gather_slots(local: dict, mesh: Mesh) -> dict:
    """Each rank's (C_loc, k, ...) tensors -> the global (C, T * k, ...)
    layout, on every rank (one all-gather of all keys as int32)."""
    if mesh.group is None:
        return local
    c_loc = next(iter(local.values())).shape[0]
    flat = torch.cat([v.reshape(c_loc, -1).to(torch.int32)
                      for v in local.values()], dim=-1)
    if _through_host(mesh):
        flat = flat.cpu()
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, flat, group=mesh.group)

    def block(rank):
        return parts[dist.get_group_rank(mesh.group, rank)].to(mesh.device)

    grid = torch.cat([torch.cat([block(r) for r in row], dim=-1)
                      for row in mesh.ranks], dim=0)
    n_time = mesh.shape[1]
    grid = grid.reshape(grid.shape[0], n_time, -1)   # (C, T, W)
    out, col = {}, 0
    for key, v in local.items():
        width = v[0].numel()
        part = grid[..., col:col + width].reshape(
            grid.shape[0], n_time, *v.shape[1:])
        out[key] = part.reshape(grid.shape[0], n_time * v.shape[1],
                                *v.shape[2:]).to(v.dtype)
        col += width
    return out


def _sharded(streams, mesh: Mesh, halo: int, receive, keys) -> dict:
    """This rank's block (re, im), extended by the halo, through
    receive((re, im)); the ownership rule applied (a slot counts only if
    its start lies in the rank's own block; starts become global, -1
    where not owned), `keys` of the receive passed through, and the
    result gathered into the global layout."""
    re, im = streams
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"expected (re, im) blocks of one (C_loc, n_local) "
                         f"shape, got {tuple(re.shape)} and "
                         f"{tuple(im.shape)}")
    if mesh.size > 1 and mesh.group is None:
        raise RuntimeError(f"a mesh of {mesh.size} ranks needs its process "
                           f"group (torch.distributed initialised)")
    n_local, t = re.shape[-1], mesh.coords[1]
    ext = _halo_exchange_right(
        torch.stack([re, im]).to(mesh.device), halo, mesh)
    out = receive((ext[0], ext[1]))
    owned = out["starts"] < n_local
    local = {"starts": torch.where(owned, out["starts"] + t * n_local,
                                   -1).to(torch.int32),
             **{k: out[k] & owned for k in ("valid", "crc_ok", "header_ok")},
             **{k: out[k] for k in keys}}
    return _all_gather_slots(local, mesh)


def sharded_receive(streams, rate: Rate, length: int, mesh: Mesh,
                    max_frames_per_block: int,
                    params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Detect and decode the frames of a known (rate, length) across a
    (channel, time)-sharded capture.

    streams: this rank's planar (re, im) block, each (C_loc, n_local).
    Returns, on every rank, per-slot tensors in the global layout (C,
    T * max_frames_per_block, ...): starts (global; -1 where not owned),
    valid, crc_ok, header_ok, payload (..., length).
    """
    # a frame starting at the last owned sample needs frame_len - 1 more;
    # detection also needs the LTS search and 63 samples of correlation
    halo = params_for(rate).frame_samples(length) + params.lts_search + 64
    return _sharded(streams, mesh, halo,
                    lambda ext: frontend.receive_capture_p(
                        ext, rate, length, max_frames_per_block, params),
                    ("payload",))


def sharded_receive_dynamic(streams, rates: tuple[Rate, ...],
                            max_length: int, mesh: Mesh,
                            max_frames_per_block: int,
                            params: ChainParams = DEFAULT_PARAMS) -> dict:
    """Any-rate, header-driven detect and decode across a sharded capture:
    every frame's rate and length come from its SIGNAL header
    (models/frontend.receive_capture_anyrate_p), with the ownership rule
    and halo of sharded_receive, the halo sized for the slowest rate at
    max_length.

    Returns what sharded_receive returns (payload (..., max_length)) and
    rate_field, hdr_length per slot, and detect_dropped (C, T): the
    detection events each block lost to the blocked extractor's cap.
    """
    rates = tuple(rates)
    halo = max(params_for(r).frame_samples(max_length)
               for r in rates) + params.lts_search + 64

    def receive(ext):
        out = frontend.receive_capture_anyrate_p(
            ext, rates, max_length, max_frames_per_block, params)
        return {**out, "detect_dropped": out["detect_dropped"][:, None]}

    return _sharded(streams, mesh, halo, receive,
                    ("rate_field", "hdr_length", "payload", "detect_dropped"))
