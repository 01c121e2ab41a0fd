"""Elastic scaling (port of ``repro.runtime.elastic``): checkpoints are
addressed by tree path, not by layout, so a state saved on one mesh
restores onto another: grow or shrink the 'data' axis and continue. What
changes is only the placements each leaf is distributed with.

A state moves through its full tensors: each DTensor leaf is assembled
(``full_tensor``), then split onto the new mesh (``distribute_tensor``).
Every rank of the world calls ``reshard_state`` alike. A plain tensor is
taken to be held alike by every rank, so it is split with no collective;
a DTensor's full tensor is read where its mesh holds it, and ranks of the
new mesh outside the old one receive it from the new mesh's first rank.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import mesh_over, world_size


def elastic_shape(n_devices: int, model_axis=None):
    """The (data, model) shape ``elastic_mesh`` lays over ``n_devices``
    ranks: model = ``model_axis`` or min(16, n), lowered until it
    divides."""
    n = n_devices
    model = model_axis or min(16, n)
    while n % model:
        model -= 1
    return n // model, model


def elastic_mesh(n_devices=None, *, model_axis=None, device=None):
    """Largest (data, model) mesh over the available ranks (or the first
    ``n_devices``); ``model_axis`` defaults to min(16, n)."""
    return mesh_over(elastic_shape(n_devices or world_size(), model_axis),
                     ("data", "model"), device=device)


def _ranks(mesh):
    return set(mesh.mesh.flatten().tolist())


def relayout(x, mesh, placements):
    """Tensor or DTensor ``x`` as a DTensor on ``mesh`` with
    ``placements``, through its full tensor (module docstring)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    src = None
    if isinstance(x, DTensor):
        old = x.device_mesh
        if not _ranks(mesh) <= _ranks(old):
            src = 0   # the new mesh's first rank holds it
        if old.get_coordinate() is not None:
            x = full_tensor(x)
        else:         # filled by the new mesh's first rank
            x = torch.empty(x.shape, dtype=x.dtype, device=mesh.device_type)
    return distribute_tensor(x, mesh, list(placements), src_data_rank=src)


def full_tensor(x):
    """The full tensor of a DTensor (its local tensor on a one-rank mesh,
    where no collective is needed); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if x.device_mesh.size() == 1:
        return x.to_local()
    return x.full_tensor()


def reshard_state(state, cfg, new_mesh, *, fsdp_over_pod=False):
    """Re-lay a train state ``{"params", "opt": {"m", "v", "step"}}`` onto
    ``new_mesh`` with the arch's sharding rules: params and the AdamW
    moments through ``param_specs`` + ``to_shardings``, the step
    replicated. This is the elastic re-mesh restore path."""
    from repro_torch.sharding import param_specs, to_shardings
    pspecs = param_specs(cfg, state["params"], new_mesh,
                         fsdp_over_pod=fsdp_over_pod)
    spec = {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "step": ()}}
    return apply_shardings(state, to_shardings(new_mesh, spec))


def apply_shardings(tree, shardings):
    """Every leaf of ``tree`` re-laid with its ``Sharding`` (a tree of the
    same structure)."""
    if isinstance(tree, dict):
        return {k: apply_shardings(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [apply_shardings(v, s) for v, s in zip(tree, shardings)]
    return relayout(tree, shardings.mesh, shardings.placements)
