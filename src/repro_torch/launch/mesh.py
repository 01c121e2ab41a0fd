"""Device meshes (port of ``repro.launch.mesh``) on ``torch.distributed``'s
``DeviceMesh``. Functions, not module constants, so importing this module
touches no process group.

A mesh is laid over the ranks of the default process group, rank r at
position r of the row-major shape. When no group exists, the constructor
starts a one-rank gloo group on an in-process ``HashStore``, so nothing
reaches the network; a multi-rank caller starts its own group first
(``init_process_group`` with a ``FileStore`` or a ``tcp://localhost``
address, its rank and world size). Gloo takes CUDA tensors for
``all_reduce`` and ``broadcast``, the two collectives the port's sharded
fleet issues, so several ranks can share one card.

Like every entry point of the port, a mesh is on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def world_size() -> int:
    """Ranks of the default process group (1 when none exists yet)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_process_group():
    """The default process group, started as a one-rank gloo group on an
    in-process HashStore when none exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def mesh_over(shape, axis_names, *, device=None):
    """A DeviceMesh of ``shape`` named ``axis_names`` over the first
    prod(shape) ranks. Raises ValueError when the world holds fewer ranks,
    as the reference's reshape of too few devices does."""
    from torch.distributed.device_mesh import DeviceMesh
    device = resolve_device(device)
    n = math.prod(shape)
    if world_size() < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world "
                         f"holds {world_size()}")
    ensure_process_group()
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_over(shape, axes, device=device)


def make_smoke_mesh(*, device=None):
    """1-rank mesh with the production axis names: smoke runs on one card
    or the CPU."""
    return mesh_over((1, 1), ("data", "model"), device=device)


def make_fleet_mesh(n_devices: int | None = None, *, device=None):
    """1-D mesh over the flow axis ("flows", ``repro_torch.sharding.fleet``)
    over the first ``n_devices`` ranks (all of them by default): each rank
    holds a slice of the F axis of the fleet and topology pytrees. On one
    rank every flow sharding is a replication, so the same code path runs
    everywhere."""
    n = world_size() if n_devices is None else n_devices
    return mesh_over((n,), ("flows",), device=device)
