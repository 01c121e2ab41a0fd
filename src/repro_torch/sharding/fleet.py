"""Sharded fleets (port of ``repro.sharding.fleet``): the flow axis of the
fleet and topology pytrees split across the ranks of a ``DeviceMesh``.

The reference lets GSPMD partition a jitted fleet step once its inputs
carry NamedShardings on F. The port does that work by hand. The
``shard_*`` functions return the pytrees with ``DTensor`` leaves, so the
sharding travels with the arrays, and a fleet or topology entry point given
such leaves (``flow_sharded``, on the functions of ``core.fleet`` and
``core.topology``) runs in a flow scope:

- per-flow work (the integration, the observation, the per-flow reward
  terms, the policy applied per flow) runs on the rank's own rows;
- every reduction over F is one ``flow_all_reduce`` over the mesh's
  "flows" group;
- the contention solve assembles its full-F operands (``flow_gather``),
  solves the whole fleet on every rank and keeps the rank's rows, so K3
  sees the unsharded operands, as the reference's ``pallas_call`` does
  under GSPMD;
- the compact path (``max_active`` < F) assembles the whole call and runs
  it unsharded on every rank, keeping the rank's rows of the result.

The outputs come back as DTensors sharded the same way. The only
collective is ``all_reduce`` (a gather is the all-reduce of a zero-filled
full buffer, which is exact); gloo takes it on CUDA tensors, so several
ranks can share one card. ``FLOW_COLLECTIVES`` counts the calls and bytes.

Divisibility guard (the reference's contract): a fleet whose F does not
divide the mesh's flow axis, or a mesh of one rank on that axis, is
replicated, and a call on it runs the unsharded program bit for bit, with
no collective. Batched pytrees (leading env axes) shard the same way: the
flow dim is counted from the right.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import sys
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import Sharding, _axes

FLOW_AXIS = "flows"

# every flow_all_reduce: calls and bytes reduced (a phase reads the change)
FLOW_COLLECTIVES = {"calls": 0, "bytes": 0}


def flow_sharding(mesh, ndim: int, flow_dim, n_flows: int) -> Sharding:
    """The placements splitting dimension ``flow_dim`` (negative = from the
    right) of an ndim-rank tensor over the mesh's ``FLOW_AXIS``
    (``Shard`` there, ``Replicate`` on every other mesh dim): replicated
    when the mesh has no flow axis, the axis holds one rank, or
    ``n_flows`` does not divide it."""
    from torch.distributed.tensor import Replicate, Shard
    size = _axes(mesh).shape.get(FLOW_AXIS, 1)
    split = flow_dim is not None and size > 1 and n_flows % size == 0
    return Sharding(mesh, tuple(
        Shard(flow_dim % ndim) if split and name == FLOW_AXIS
        else Replicate() for name in _axes(mesh).axis_names))


def distribute(x, mesh, placements):
    """``x``, the full tensor, held alike on every rank, as a DTensor with
    ``placements``: each rank keeps its own slice, with no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def _put(x, mesh, flow_dim, n_flows):
    if x is None:
        return None
    return distribute(x, mesh, flow_sharding(mesh, x.ndim, flow_dim,
                                             n_flows).placements)


def shard_flow_schedule(flows, mesh):
    """FlowSchedule with the F (last) axis of every window sharded,
    activity and fault down windows alike; None down windows stay None."""
    F = flows.n_flows
    return type(flows)(t_start=_put(flows.t_start, mesh, -1, F),
                       t_end=_put(flows.t_end, mesh, -1, F),
                       down_start=_put(flows.down_start, mesh, -1, F),
                       down_end=_put(flows.down_end, mesh, -1, F))


def shard_flow_objectives(objectives, mesh):
    """FlowObjective with every (..., F) leaf sharded; None stays None."""
    if objectives is None:
        return None
    F = objectives.n_flows
    return type(objectives)(**{
        f: _put(getattr(objectives, f), mesh, -1, F)
        for f in objectives._fields})


def shard_path_spec(paths, mesh):
    """PathSpec with the F axis (second-to-last of onpath) sharded; the
    route-bin width is replicated."""
    F = paths.n_flows
    return type(paths)(onpath=_put(paths.onpath, mesh, -2, F),
                       bin_seconds=_put(paths.bin_seconds, mesh, None, F))


# per-flow leaves of a FleetState/TopologyState and their flow dims
STATE_DIMS = {"buffers": -2, "threads": -2, "throughputs": -2,
              "prev_throughputs": -2, "delivered": -1, "t": None}


def shard_fleet_state(state, mesh):
    """FleetState/TopologyState with every per-flow leaf sharded on its F
    axis (buffers/threads/throughputs at -2, delivered at -1); the shared
    clock ``t`` is replicated."""
    F = state.threads.shape[-2]
    return type(state)(**{f: _put(getattr(state, f), mesh, STATE_DIMS[f], F)
                          for f in state._fields})


# ---------------------------------------------------------------------------
# The flow scope: one rank's slice of a sharded fleet
# ---------------------------------------------------------------------------


class FlowShard(NamedTuple):
    """This rank's part of a fleet of ``n_flows`` flows split ``size`` ways
    over ``group``: rows [start, start + n_local) of every flow axis."""

    group: object
    size: int
    rank: int
    n_flows: int

    @property
    def n_local(self) -> int:
        return self.n_flows // self.size

    @property
    def start(self) -> int:
        return self.rank * self.n_local


_SCOPES = threading.local()   # each thread's stack of flow scopes


def _stack():
    if not hasattr(_SCOPES, "stack"):
        _SCOPES.stack = []
    return _SCOPES.stack


def current():
    """The FlowShard of this thread's innermost flow scope, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def flow_scope(shard):
    """Run the body on ``shard``'s rows (None: the unsharded program, also
    inside an outer scope)."""
    stack = _stack()
    stack.append(shard)
    try:
        yield shard
    finally:
        stack.pop()


def local_flows(n_flows: int) -> int:
    """The rows of an ``n_flows`` fleet this rank holds."""
    shard = current()
    return n_flows if shard is None else shard.n_local


def global_flows(n_local: int) -> int:
    """The fleet size of which this rank holds ``n_local`` rows."""
    shard = current()
    return n_local if shard is None else shard.n_flows


def flow_rows(x, dim):
    """This rank's rows of the full-F tensor ``x`` along ``dim``."""
    shard = current()
    if shard is None or x is None:
        return x
    return x.narrow(dim, shard.start, shard.n_local)


def flow_all_reduce(*xs):
    """The sums of ``xs`` over the ranks of the flow scope, in one
    ``all_reduce`` of a packed buffer (the tensors unchanged outside a
    scope). One tensor in, one out; several in, a list out."""
    shard = current()
    if shard is None:
        return xs[0] if len(xs) == 1 else list(xs)
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1:
        raise TypeError(f"flow_all_reduce packs one dtype, got {dtypes}")
    buf = torch.cat([x.detach().reshape(-1) for x in xs])
    dist.all_reduce(buf, group=shard.group)
    FLOW_COLLECTIVES["calls"] += 1
    FLOW_COLLECTIVES["bytes"] += buf.numel() * buf.element_size()
    out = [part.view(x.shape) for part, x in
           zip(torch.split(buf, [x.numel() for x in xs]), xs)]
    return out[0] if len(xs) == 1 else out


def flow_gather(*pairs):
    """Full-F tensors from this rank's rows: a list, one for each of
    ``pairs`` of (local rows, flow dim). Each rank writes its rows into a
    zero-filled full buffer and one ``flow_all_reduce`` sums them, which is
    exact. Outside a scope the tensors come back unchanged."""
    shard = current()
    if shard is None or not pairs:
        return [x for x, _ in pairs]
    full = []
    for x, dim in pairs:
        shape = list(x.shape)
        shape[dim] = shard.n_flows
        buf = x.new_zeros(shape)
        buf.narrow(dim, shard.start, shard.n_local).copy_(x)
        full.append(buf)
    summed = flow_all_reduce(*full)
    return [summed] if len(full) == 1 else summed


# ---------------------------------------------------------------------------
# Entry points on DTensor pytrees
# ---------------------------------------------------------------------------

# the flow dim of each per-flow argument of the fleet and topology entry
# points: an int (or None) for a tensor or every field of a NamedTuple, a
# dict for per-field dims
ARG_DIMS = {"state": STATE_DIMS, "actions": -2, "buffers": -2,
            "threads": -2, "flows": -1, "objectives": -1,
            "paths": {"onpath": -2, "bin_seconds": None}}


def _dtensor_cls():
    """DTensor, once ``torch.distributed.tensor`` is loaded (no DTensor can
    exist before), else None."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _is_struct(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(x, dims, fn):
    """``fn(leaf, dim)`` over a tensor or a NamedTuple of tensors."""
    if x is None:
        return None
    if _is_struct(x):
        return type(x)(**{f: _map(getattr(x, f), dims.get(f) if isinstance(
            dims, dict) else dims, fn) for f in x._fields})
    if isinstance(x, (tuple, list)):
        ds = dims if isinstance(dims, (tuple, list)) else (dims,) * len(x)
        return type(x)(_map(v, d, fn) for v, d in zip(x, ds))
    return fn(x, dims)


def _leaves(x):
    if _is_struct(x) or isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def _flow_dim(leaf):
    """The tensor dim a DTensor splits over the flows mesh dim, or None."""
    names = leaf.device_mesh.mesh_dim_names or ()
    if FLOW_AXIS not in names:
        return None
    p = leaf.placements[names.index(FLOW_AXIS)]
    return p.dim if p.is_shard() else None


def scope_of(tree):
    """The FlowShard of the first DTensor leaf of ``tree`` split over the
    flows axis, or None (no DTensor, or every one replicated)."""
    cls = _dtensor_cls()
    if cls is None:
        return None
    for leaf in _leaves(tree):
        if isinstance(leaf, cls) and _flow_dim(leaf) is not None:
            mesh = leaf.device_mesh
            return FlowShard(group=mesh.get_group(FLOW_AXIS),
                             size=_axes(mesh).shape[FLOW_AXIS],
                             rank=mesh.get_local_rank(FLOW_AXIS),
                             n_flows=leaf.shape[_flow_dim(leaf)])
    return None


def to_local(tree):
    """``tree`` with every DTensor leaf replaced by its local tensor."""
    cls = _dtensor_cls()
    if cls is None:
        return tree
    return _map(tree, None, lambda x, _: x.to_local() if isinstance(x, cls)
                else x)


def _first_dtensor(values):
    cls = _dtensor_cls()
    if cls is None:
        return None
    return next((x for v in values for x in _leaves(v)
                 if isinstance(x, cls)), None)


def _assemble(arguments):
    """The call's arguments with every per-flow tensor at full F, in one
    gather."""
    found = []

    def collect(x, d):
        if d is not None:
            found.append((x, d))
        return x

    per_flow = {k: v for k, v in arguments.items() if k in ARG_DIMS}
    for k, v in per_flow.items():
        _map(v, ARG_DIMS[k], collect)
    full = iter(flow_gather(*found))
    return {**arguments, **{k: _map(v, ARG_DIMS[k], lambda x, d: x
                                    if d is None else next(full))
                            for k, v in per_flow.items()}}


def flow_sharded(out_dims):
    """Decorator of a fleet or topology entry point whose per-flow
    arguments (``ARG_DIMS``) may be DTensors; ``out_dims`` gives the flow
    dim of each output (a dict for a state, None for a replicated one).

    - DTensor arguments: the call runs in the flow scope they carry on the
      local rows (a plain full-F tensor among them is sliced to this
      rank's rows), or unsharded when they are replicated, and the outputs
      come back as DTensors on the same mesh.
    - Inside a flow scope with ``max_active`` below the fleet's F: the
      call is assembled to full F, run unsharded on every rank, and this
      rank's rows of the outputs are kept.
    - Otherwise the function itself."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            flowed = [v for k, v in bound.arguments.items() if k in ARG_DIMS]
            leaf = _first_dtensor(flowed)
            if leaf is not None:
                return _on_dtensors(wrapper, bound, leaf, out_dims)
            shard = current()
            max_active = bound.arguments.get("max_active")
            if (shard is not None and max_active is not None
                    and max_active < shard.n_flows):
                full = _assemble(bound.arguments)
                with flow_scope(None):
                    out = fn(**full)
                return _map(out, out_dims, lambda x, d: x if d is None
                            else flow_rows(x, d))
            return fn(*args, **kwargs)

        return wrapper
    return deco


def _on_dtensors(wrapper, bound, leaf, out_dims):
    """Run ``wrapper`` on the local tensors of DTensor arguments, in their
    flow scope, and wrap its outputs as DTensors on the same mesh."""
    from torch.distributed.tensor import Replicate
    cls = _dtensor_cls()
    mesh = leaf.device_mesh
    shard = scope_of([v for k, v in bound.arguments.items()
                      if k in ARG_DIMS])

    def local(x, d):
        if isinstance(x, cls):
            return x.to_local()
        if shard is not None and d is not None and x.shape[d] == shard.n_flows:
            return x.narrow(d, shard.start, shard.n_local)
        return x

    arguments = {k: _map(v, ARG_DIMS[k], local) if k in ARG_DIMS else v
                 for k, v in bound.arguments.items()}
    with flow_scope(shard):
        out = wrapper(**arguments)

    def wrap(x, d):
        placements = ([Replicate()] * mesh.ndim if shard is None or d is None
                      else flow_sharding(mesh, x.ndim, d,
                                         shard.n_flows).placements)
        return cls.from_local(x, mesh, placements, run_check=False)

    return _map(out, out_dims, wrap)


def full_flows(x, dim):
    """The full tensor of a DTensor split over the flows axis, assembled
    with ``flow_gather`` (gloo's all_gather takes no CUDA tensor); a
    replicated DTensor's local tensor; a plain tensor as it is."""
    cls = _dtensor_cls()
    if cls is None or not isinstance(x, cls):
        return x
    with flow_scope(scope_of(x)):
        return flow_gather((x.to_local(), dim))[0]
