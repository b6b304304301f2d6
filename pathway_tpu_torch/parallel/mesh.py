"""Mesh construction over ``torch.distributed``: port of ``pathway_tpu/parallel/mesh.py``.

Where the JAX package lays a ``Mesh`` over the devices it sees, the port lays a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default process group (one
rank, one card), with the JAX axis names (``"seq"``, ``"data"``, ``"model"``). A function that
takes a ``mesh, axis`` pair reaches the axis' process group through ``mesh.get_group(axis)``.
The default group must exist first: :func:`pathway_tpu_torch.parallel.distributed.init_from_env`
creates it, also for a single process.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import resolve_device

__all__ = ["make_mesh", "data_model_mesh"]


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call pathway_tpu_torch.parallel.distributed.init_from_env() "
            "(or torch.distributed.init_process_group) before building a mesh"
        )
    return dist.get_world_size()


def make_mesh(axes: dict[str, int] | None = None, *,
              device: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of the default group with the given axis sizes (default: one
    ``"data"`` axis over all of them). Raises when the sizes do not cover the ranks."""
    dev = resolve_device(device)
    world = _world()
    if axes is None:
        axes = {"data": world}
    sizes = list(axes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"axes {axes} do not cover {world} processes")
    return init_device_mesh(dev.type, tuple(sizes), mesh_dim_names=tuple(axes))


def data_model_mesh(n_devices: int | None = None, *, device: str = "cuda") -> DeviceMesh:
    """2D (data, model) mesh: model axis 2 when the count allows, else pure data parallel. Unlike
    the JAX version, which may take the first ``n_devices`` devices, the mesh spans every rank, so
    ``n_devices`` must be the world size."""
    world = _world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n}, world size {world}")
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh({"data": n // model, "model": model}, device=device)
