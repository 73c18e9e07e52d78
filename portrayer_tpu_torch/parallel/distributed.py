"""Multi-process runtime: one process per device, joined by
``torch.distributed`` (counterpart of ``portrayer_tpu/parallel/distributed.py``).

The JAX package forms its multi-host runtime with
``jax.distributed.initialize`` and a mesh over every chip of the job; each
process feeds only its addressable shard of the ray grid, and the psum
places the full framebuffer on every chip.  Here every rank is a process:
``initialize`` joins the process group (torchrun's environment by
default), ``global_mesh`` spans its ranks, ``make_global_rays`` builds
only this rank's rows, and after the all-reduce every rank holds the
finished framebuffer (``fetch_replicated`` reads it to the host).

``initialize()`` without configuration is a no-op;
``initialize(num_processes=1)`` forms a one-rank group for a single
process (it lasts until ``torch.distributed.destroy_process_group``).
On one card, NCCL refuses two ranks; ranks that share a card join with
``backend="gloo"``, which all-reduces CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import rng
from ..camera import Camera
from .sharding import RAY_AXIS, _pixel_uv, make_mesh, trace_sharded


def _backend_for(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None) -> bool:
    """Join (or form) the process group of the job.  Returns True when more
    than one process is in it after the call.

    The arguments default to torchrun's environment (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK); with none of it set and none given,
    the call is a no-op.  `coordinator_address` is "host:port" or an
    init URL ("tcp://...", "file://..."); without one, num_processes=1
    forms a one-rank group on an in-process store.  A CUDA `device`
    without an index is the card of LOCAL_RANK (else process_id modulo
    the cards); it becomes the current device.  `backend` defaults to
    NCCL for the card and gloo for the CPU.  The group lasts until the
    caller's ``torch.distributed.destroy_process_group()``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None and num_processes == 1 and process_id in (None, 0):
        process_id = 0
    elif coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs a coordinator address, the number of processes "
                         "and this process's id (or torchrun's environment)")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(env.get(
                "LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(device)
    if coordinator_address is None:
        where = {"store": dist.HashStore()}
    elif "://" in coordinator_address:
        where = {"init_method": coordinator_address}
    else:
        where = {"init_method": f"tcp://{coordinator_address}"}
    dist.init_process_group(backend or _backend_for(device), world_size=num_processes,
                            rank=process_id, **where)
    return dist.get_world_size() > 1


def global_mesh(axis_name: str = RAY_AXIS, device="cuda") -> DeviceMesh:
    """1-D mesh over every rank of the job."""
    return make_mesh(None, axis_name, device)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card of a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_global_rays(mesh: DeviceMesh, make_shard, R: int, device=None):
    """This rank's block of a ray grid of R rows split over the mesh.

    `make_shard(lo, hi)` returns a tuple of arrays or tensors: rows
    [lo, hi) of each ray feature (origins, directions, ...).  It is called
    once, for this rank's block only, so the whole grid never exists on
    one rank.  Returns the tuple as tensors on `device` (default: the
    rank's device), for ``trace_sharded(..., local=True)``."""
    n, r = mesh.size(), mesh.get_local_rank()
    if R % n:
        raise ValueError("pad the rays to a multiple of the mesh size")
    per = R // n
    device = _mesh_device(mesh) if device is None else device
    return tuple(torch.as_tensor(x, device=device) for x in make_shard(r * per, (r + 1) * per))


def fetch_replicated(x) -> np.ndarray:
    """A tensor that every rank holds alike (the all-reduced framebuffer),
    read to host numpy."""
    return x.detach().cpu().numpy()


def frame_rays(cam: Camera, spp: int, key, lo: int, hi: int, dtype, device):
    """Rows [lo, hi) of the jittered (pixel x sample) ray grid of a frame
    of cam's size at spp samples a pixel, as render_frame_distributed
    builds them: (o, d, pixel ids, throughput).  The block's jitter is
    ``uniform(fold_in(fold_in(key, 0), lo), (hi - lo, 2))`` in float32; the
    pixel centre plus jitter is formed in float64 and cast to `dtype`.
    Rows past the frame carry zero throughput and a pixel id clamped into
    the frame (where the JAX package's scatter drops it)."""
    width = int(cam.width)
    n_pixels = width * int(cam.height)
    ids = torch.arange(lo, hi, device=device)
    pixn = ids // spp
    live = (ids < n_pixels * spp).to(dtype)
    sub = rng.uniform(rng.fold_in(rng.fold_in(key, 0), lo), (hi - lo, 2), device)
    sub = sub.to(torch.float64)
    px = (pixn % width).to(torch.float64)
    py = (pixn // width).to(torch.float64)
    o, d = cam.rays_at((px + sub[:, 0]).to(dtype), (py + sub[:, 1]).to(dtype))
    return o, d, torch.clamp(pixn, max=n_pixels - 1).to(torch.int32), live


def render_frame_distributed(mesh: DeviceMesh, st, camera, size, background, cfg,
                             key=None) -> np.ndarray:
    """Whole-frame render over the mesh, each rank building only its block
    of the jittered (pixel x sample) ray grid (``frame_rays``); the
    multi-process form of ``render_tiles_sharded``.  The grid is padded to
    a multiple of the mesh size and traced keyed ``fold_in(key, 1)``.
    Call it on every rank; each returns the linear image [H,W,3] (numpy,
    float64)."""
    width, height = size
    dev, dt = cfg.device, cfg.dtype
    cam = Camera(camera, (width, height), dev, dt)
    spp = cfg.resolved_samples()
    P_ = width * height
    R0 = P_ * spp
    R = R0 + ((-R0) % mesh.size())
    key = rng.PRNGKey(cfg.seed) if key is None else key
    o, d, pix, w0 = make_global_rays(
        mesh, lambda lo, hi: frame_rays(cam, spp, key, lo, hi, dt, dev), R, device=dev)
    bg = background(_pixel_uv(width, height, dt, dev)).to(dt)
    acc = trace_sharded(mesh, rng.fold_in(key, 1), o, d, pix, bg, P_, st, cfg, w0=w0,
                        local=True)
    img = fetch_replicated(acc).astype(np.float64)
    return img.reshape(height, width, 3) / spp
