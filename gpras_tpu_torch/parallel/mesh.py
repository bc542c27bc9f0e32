"""Mesh construction over the process group, and the collectives the
distributed layer issues on a mesh's axes.

Port of ``gpras_tpu/parallel/mesh.py``. The JAX mesh of devices becomes a
``DeviceMesh`` over the ranks of the initialized default process group;
``shard_map``'s named-axis collectives become ``torch.distributed`` calls
on the process group of one mesh axis (``psum`` over several axes is one
``all_reduce`` per axis). None of these helpers is differentiable: the
distributed losses issue them inside their own backward passes
(``torch.autograd.Function``), never under autograd.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Tensor = torch.Tensor


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = ("i",)) -> DeviceMesh:
    """A ``DeviceMesh`` over the first prod(shape) ranks of the default
    process group, which must be initialized (``torchrun``, or
    ``torch.distributed.init_process_group``).

    Default: a 1-D mesh over every rank with axis "i". Pass ``shape`` for
    2-D or 3-D layouts (e.g. (4, 2) with ("i", "j")). Under NCCL each rank
    works on ``cuda:{LOCAL_RANK}`` (the rank modulo the visible cards when
    ``LOCAL_RANK`` is unset), which this call makes the current device;
    under gloo on the CPU. Every rank must call it, also a rank outside a
    mesh smaller than the world (its ``get_coordinate()`` is None, and it
    takes no part in the mesh's collectives)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group: "
                           "launch under torchrun, or call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"Mesh shape {shape} needs {n} devices, have {world}")
    if len(axis_names) != len(shape):
        raise ValueError(f"Mesh shape {shape} needs {len(shape)} axis names, "
                         f"got {axis_names}")
    device_type = "cpu"
    if dist.get_backend() == "nccl":
        device_type = "cuda"
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the current card under NCCL, else
    the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _shape(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size}, the reference's ``mesh.shape`` mapping."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _psum(t: Tensor, mesh: DeviceMesh, axes: str | tuple[str, ...]) -> Tensor:
    """The sum of ``t`` over the ranks of ``axes`` (one all-reduce per axis,
    in place when ``t`` is contiguous; the result is identical on every rank
    of those axes)."""
    t = t.contiguous()
    for axis in (axes,) if isinstance(axes, str) else axes:
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def _psum_all(tensors: list[Tensor], mesh: DeviceMesh,
              axes: str | tuple[str, ...]) -> list[Tensor]:
    """Each of ``tensors`` summed over ``axes``, all of them in one
    all-reduce per axis."""
    flat = _psum(torch.cat([t.reshape(-1) for t in tensors]), mesh, axes)
    return [part.reshape(t.shape)
            for part, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def _pmax(t: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t


def _bcast(t: Tensor, mesh: DeviceMesh, axis: str, owner: int) -> Tensor:
    """The copy of ``t`` held by the rank at coordinate ``owner`` along
    ``axis`` (the reference's masked psum), written into ``t`` when it is
    contiguous; the other ranks pass a buffer of its shape."""
    t = t.contiguous()
    group = mesh.get_group(axis)
    dist.broadcast(t, src=dist.get_process_group_ranks(group)[owner], group=group)
    return t


def _all_gather(t: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    """The blocks of ``t`` of every rank along ``axis``, concatenated along
    dim 0 in coordinate order (``all_gather(..., tiled=True)``)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts)
