"""Logical sharding rules (port of ``repro.sharding.rules``): parameter,
optimizer, cache and batch trees -> specs, and specs -> DTensor placements.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (that dim split over their product), the
torch-free twin of a ``PartitionSpec``. The trees are the port's: the train
state's ``{name: tensor}`` parameters (``layers.3.attn.wq.w``), nested dicts
and lists of tensors for caches and batches. The reference stacks a
stack's layers on leading dims and gives them None; the port holds one
tensor per layer, so its spec is the reference's with those Nones dropped,
and a rule is matched on the reference's key path
(``convert.reference_name``).

Profiles
  'dp'      replicate params, shard the batch only.
  'fsdp'    shard each parameter's largest divisible dim over 'data'
            (ZeRO-3 style); vocab dims over 'model'.
  'tp'      the name table over 'model' only.
  'fsdp_tp' name table: d_model dims over 'data' (FSDP), head/ffn/vocab
            dims over 'model' (TP); MoE experts over 'model' when the expert
            count divides it (EP), else each expert's d_ff (TP).

Every rule is guarded by divisibility: a dim that does not divide its axis
is replicated. The 'pod' axis of the multi-pod mesh carries data
parallelism: params and optimizer replicate across pods and the batch
splits over ('pod', 'data'); ``fsdp_over_pod=True`` folds 'pod' into the
FSDP axis.

The rules read only the mesh's axis names and sizes: a ``DeviceMesh``
(``mesh_dim_names``, ``shape``) or any object with a ``shape`` dict and
``axis_names``, such as the reference tests' stub mesh.
"""

from __future__ import annotations

from typing import NamedTuple


class _Axes(NamedTuple):
    shape: dict
    axis_names: tuple


def _axes(mesh) -> _Axes:
    """The mesh's axis sizes by name, from a DeviceMesh or a stub."""
    if isinstance(mesh, _Axes):
        return mesh
    if isinstance(mesh.shape, dict):
        return _Axes(dict(mesh.shape), tuple(mesh.axis_names))
    names = tuple(mesh.mesh_dim_names)
    return _Axes(dict(zip(names, mesh.shape)), names)


def _spec(dims):
    """A spec with each one-name tuple written as the name, as
    ``PartitionSpec`` writes it."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in dims)


def _map_with_names(fn, tree, prefix=()):
    """``fn(names, leaf)`` over a tree of dicts and lists, ``names`` the
    reference's key path of the leaf (layer indices of a stack dropped);
    the spec it returns is normalized (``_spec``)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_names(fn, v, prefix + (str(i),))
                for i, v in enumerate(tree)]
    from repro_torch.convert import reference_name
    return _spec(fn(reference_name(".".join(prefix)).split("."), tree))


def batch_axes_for(mesh):
    return ("pod", "data") if "pod" in _axes(mesh).axis_names else ("data",)


def _axis_size(mesh, axes):
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= mesh.shape[a]
    return size


def _div(n, mesh, axis):
    return axis is None or n % _axis_size(mesh, axis) == 0


def _guard(spec_dims, shape, mesh):
    return tuple(ax if (ax is not None and _div(dim, mesh, ax)) else None
                 for dim, ax in zip(shape, spec_dims))


def _fsdp_spec(shape, mesh, fsdp_axis):
    """Shard the largest divisible dim over the FSDP axis."""
    if not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] >= 2 and _div(shape[i], mesh, fsdp_axis):
            return tuple(fsdp_axis if j == i else None
                         for j in range(len(shape)))
    return (None,) * len(shape)


def _tp_table(cfg, names, shape, mesh, fsdp_axis):
    """fsdp_tp rules. ``names`` = the key path; match on parent/leaf."""
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    d, m = fsdp_axis, "model"

    if leaf == "embed":
        return (m, d)
    if parent == "lm_head":
        return (d, m)
    # attention projections
    if parent in ("wq", "wuq"):
        return (d, m) if leaf == "w" else (m,)
    if parent in ("wk", "wv"):
        want = ((d, m) if cfg.n_kv_heads
                and cfg.n_kv_heads % mesh.shape["model"] == 0 else (d, None))
        return want if leaf == "w" else (None,)
    if parent == "wo":
        return (m, d) if leaf == "w" else (None,)
    if parent in ("wdq", "wdkv"):
        return (d, None) if leaf == "w" else (None,)
    if leaf in ("wuk", "wuv"):
        return (None, m, None)
    # FFN
    if parent in ("gate", "up", "in_proj"):
        return (d, m) if leaf == "w" else (m,)
    if parent == "down":
        return (m, d) if leaf == "w" else (None,)
    if parent == "out_proj":
        return (m, d) if leaf == "w" else (None,)
    # MoE experts: (E, d_model, d_ff) / (E, d_ff, d_model)
    if parent == "experts":
        mode = getattr(cfg, "moe_expert_sharding", "auto")
        ep = cfg.n_experts % mesh.shape["model"] == 0 and mode != "tp"
        if leaf in ("gate", "up"):
            return (m, d, None) if ep else (None, d, m)
        if leaf == "down":
            return (m, None, d) if ep else (None, m, d)
    if parent == "router":
        return (None, None)
    if leaf in ("conv_w", "conv_b"):
        return (None, m) if leaf == "conv_w" else (m,)
    return None  # fall through to the fsdp heuristic


def param_specs(cfg, params_tree, mesh, *, fsdp_over_pod=False):
    """Spec tree for the parameters (or same-structured gradients or AdamW
    moments): ``{name: tensor}`` -> ``{name: spec}``."""
    mesh = _axes(mesh)
    fsdp_axis = (("pod", "data") if fsdp_over_pod
                 and "pod" in mesh.axis_names else "data")

    def spec(names, leaf):
        base = tuple(leaf.shape)
        dims = None
        if cfg.sharding_profile == "dp":
            dims = (None,) * len(base)
        elif cfg.sharding_profile == "fsdp_tp":
            dims = _tp_table(cfg, names, base, mesh, fsdp_axis)
        elif cfg.sharding_profile == "tp":
            dims = _tp_table(cfg, names, base, mesh, None)
        elif cfg.sharding_profile == "fsdp":
            # vocab dims still shard over the (otherwise idle) model axis
            if names[-1] == "embed":
                dims = ("model", None)
            elif len(names) >= 2 and names[-2] == "lm_head":
                dims = (None, "model") if names[-1] == "w" else ("model",)
        if dims is None or len(dims) != len(base):
            dims = _fsdp_spec(base, mesh, fsdp_axis)
        return _guard(dims, base, mesh)

    return _map_with_names(spec, params_tree)


def opt_specs(cfg, opt_tree, params_spec, mesh):
    """AdamW's m and v follow the parameter specs; the step is
    replicated."""
    return {"m": params_spec, "v": params_spec, "step": ()}


def batch_specs(cfg, batch_tree, mesh):
    """Every batch leaf split over the batch axes on its leading dim (when
    divisible); M-RoPE's (3, B, S) positions on their second."""
    mesh = _axes(mesh)
    baxes = batch_axes_for(mesh)

    def spec(names, leaf):
        if names[-1] == "positions_thw":  # (3, B, S)
            return (None, baxes, None)
        dims = [baxes] + [None] * (leaf.ndim - 1)
        if leaf.shape[0] % _axis_size(mesh, baxes) != 0:
            dims[0] = None
        return tuple(dims)

    return _map_with_names(spec, batch_tree)


def cache_specs(cfg, cache_tree, mesh):
    """KV / SSM cache sharding: the batch dim over (pod, data); kv-head or
    state-head dims over 'model' when divisible."""
    mesh = _axes(mesh)
    baxes = batch_axes_for(mesh)
    model = mesh.shape["model"]

    def spec(names, leaf):
        base = tuple(leaf.shape)
        leafname = names[-1]
        dims = [None] * len(base)
        # batch is dim 0 of every cache leaf
        if base and base[0] % _axis_size(mesh, baxes) == 0:
            dims[0] = baxes
        if leafname in ("k", "v", "cross_k", "cross_v") and len(base) == 4:
            if base[2] % model == 0:
                dims[2] = "model"
            elif dims[0] is None and base[1] % model == 0:
                dims[1] = "model"  # long-context batch-1: the cache length
        if leafname == "ssm" and len(base) == 4 and base[1] % model == 0:
            dims[1] = "model"  # (B, H, P, N)
        if leafname == "conv" and len(base) == 3 and base[2] % model == 0:
            dims[2] = "model"  # (B, W-1, ch)
        if (leafname == "ckv" and len(base) == 3 and dims[0] is None
                and base[1] % model == 0):
            dims[1] = "model"  # MLA long-context batch-1
        return tuple(dims)

    return _map_with_names(spec, cache_tree)


class Sharding(NamedTuple):
    """A DeviceMesh and the DTensor placements of one tensor on it, one per
    mesh dim (the port's ``NamedSharding``)."""

    mesh: object
    placements: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return all(p.is_replicate() for p in self.placements)


def placements_for(mesh, spec):
    """DTensor placements of ``spec`` on ``mesh``: a mesh dim named at
    tensor dim d (alone or in a tuple) gets ``Shard(d)``; every other mesh
    dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or isinstance(ax, tuple) and name in ax]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """The spec tree as a tree of ``Sharding``s on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [to_shardings(mesh, v) for v in spec_tree]
    return Sharding(mesh, placements_for(mesh, spec_tree))
