"""Multi-process initialisation: port of ``pathway_tpu/parallel/distributed.py``.

The same ``PATHWAY_*`` environment that bootstraps ``jax.distributed`` in the JAX package
bootstraps ``torch.distributed`` here: NCCL between cards, gloo between CPU processes. One
difference: JAX needs no group for a single process, but a torch ``DeviceMesh`` needs one, so a
single process still gets a group, of world size 1 over an in-memory store.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from .mesh import make_mesh

__all__ = ["init_from_env", "global_mesh"]


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Copy of the worker-layout fields of ``pathway_tpu/internals/config.py`` (lines 130-132:
    ``processes``, ``process_id``, ``first_port``) with their environment and defaults."""

    processes: int = dataclasses.field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    process_id: int = dataclasses.field(
        default_factory=lambda: _env_int("PATHWAY_PROCESS_ID", 0))
    first_port: int = dataclasses.field(
        default_factory=lambda: _env_int("PATHWAY_FIRST_PORT", 10000))


def init_from_env(coordinator_host: str = "127.0.0.1", *, device: str = "cuda",
                  backend: str | None = None) -> None:
    """Initialise the default process group from ``PATHWAY_PROCESSES``, ``PATHWAY_PROCESS_ID``,
    ``PATHWAY_FIRST_PORT`` and ``PATHWAY_COORDINATOR`` (idempotent). The backend is NCCL for
    ``device="cuda"`` (each process takes card ``process_id`` modulo the cards it sees) and gloo
    for ``"cpu"``, unless ``backend`` names one: processes that share a card cannot be ranks of
    one NCCL communicator, and ``parallel/meshcomm.py::MultiHostMeshComm`` asks for gloo to
    learn the placement first. With more than one process the rendezvous is at
    ``PATHWAY_COORDINATOR``, by default ``coordinator_host:first_port + 1000``; a single process
    gets a group of world size 1 over an in-memory store."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    layout = _Layout()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(layout.process_id % torch.cuda.device_count())
    if layout.processes <= 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return
    coordinator = os.environ.get(
        "PATHWAY_COORDINATOR", f"{coordinator_host}:{layout.first_port + 1000}"
    )
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=layout.process_id, world_size=layout.processes)


def global_mesh(axes: dict[str, int] | None = None, *, device: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of every participating process."""
    init_from_env(device=device)
    return make_mesh(axes, device=device)
