"""Process groups and meshes for runs over several devices. Counterpart:
``tpugs/dist/mesh.py`` (``make_mesh`` :26-46, ``pad_cameras`` :49-61).

tpugs builds a ``jax.sharding.Mesh`` over the devices of one program. The
port runs one process (rank) per device on ``torch.distributed``: NCCL
between CUDA ranks, gloo between CPU ranks. The backend follows the device,
CUDA by default, and a CUDA mesh never falls back to gloo or the CPU: a
failed NCCL start or collective raises. ``make_mesh`` lays the ranks out
row-major over the named axes, as tpugs' ``np.reshape`` lays out its
devices: at ("cam", "gauss") = (2, 2), ranks 0 and 1 share a camera shard
and split the Gaussians between them.

Start the default group with ``init_ranks`` (torchrun's environment, or a
``file://`` store with an explicit rank and world size), or for one
process with ``single_rank_group``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpugs_torch.core.device import DeviceLike, resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# A collective that one rank never enters fails after this long instead of
# hanging the run.
COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _backend(dev: torch.device) -> str:
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev} (cuda or cpu)")
    return BACKENDS[dev.type]


def init_ranks(
    device: DeviceLike = "cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> torch.device:
    """Start the default group of this rank: NCCL for ``device`` "cuda",
    gloo for "cpu". ``init_method`` None reads torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); a
    ``file://`` store needs ``rank`` and ``world_size`` (default: the
    environment's RANK and WORLD_SIZE, else 0 and 1). A CUDA rank takes card
    LOCAL_RANK (else rank modulo the cards) and binds the group to it, so
    that NCCL starts now and a failure raises here. Returns the rank's
    device."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if dist.is_initialized():
        raise RuntimeError("the default process group is already started")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    device_id = None
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = device_id = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=COLLECTIVE_TIMEOUT,
                            device_id=device_id)
    return dev


@contextlib.contextmanager
def single_rank_group(device: DeviceLike = "cuda"):
    """A default group of one rank in this process, on a ``file://`` store
    in a temporary directory; destroyed on exit. Yields the device."""
    with tempfile.TemporaryDirectory() as td:
        dev = init_ranks(device, f"file://{os.path.join(td, 'store')}", 0, 1)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("cam", "gauss"),
    device: DeviceLike = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` over the default group's ranks,
    ``arange(world).reshape(axis_sizes)``. Default: every rank on the first
    axis ("cam"), the others of size 1. Raises if the sizes do not multiply
    to the world size, or if the default group's backend is not the
    device's (gloo for "cpu", NCCL for "cuda")."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_ranks first")
    if dist.get_backend() != backend:
        raise RuntimeError(f"the default group runs {dist.get_backend()}; a {dev.type} mesh "
                           f"needs {backend}")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {tuple(axis_sizes)} != {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(axis_sizes)),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh's row-major order (tpugs' sharding
    over all axes at once, ``P(all_axes)``)."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()), tuple(mesh.mesh.shape)))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's tensors: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block(x: torch.Tensor, index: int, parts: int) -> torch.Tensor:
    """Rows ``[index * n/parts, (index + 1) * n/parts)`` of ``x``; ``parts``
    must divide its length."""
    n = x.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    k = n // parts
    return x[index * k:(index + 1) * k]


def pad_cameras(viewmats: torch.Tensor, Ks: torch.Tensor, multiple: int):
    """Pad the camera axis to a multiple of ``multiple`` (the mesh size):
    (viewmats, Ks, weights), the pads identity viewmats with camera 0's K
    and weight 0."""
    c = viewmats.shape[0]
    pad = (-c) % multiple
    w = torch.cat([torch.ones(c), torch.zeros(pad)]).to(viewmats.device)
    if pad:
        eye = torch.eye(4, dtype=viewmats.dtype, device=viewmats.device)
        viewmats = torch.cat([viewmats, eye.expand(pad, 4, 4)])
        Ks = torch.cat([Ks, Ks[:1].expand(pad, 3, 3)])
    return viewmats, Ks, w
