"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture x input-shape) cell on the production meshes, prove memory
and sharding coherence, and extract the roofline terms (FLOPs, bytes,
collective bytes) per device.

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices. The port has no compiler to ask: it runs the step once,
eagerly, on DTensors over a fake world of 256 or 512 ranks (the ``"fake"``
process-group backend of ``torch.testing._internal.distributed.fake_pg``,
which moves nothing and touches no network), with every leaf a ``meta``
tensor (shape and dtype, no storage). Each rank's program is rank 0's, as
in the reference's SPMD module, so the ops that rank 0 dispatches on its
local shards are the per-device counts (``hlo_analysis.analyze_ops``).
``lower_s`` is the trace's seconds; ``compile_s`` is 0, since nothing is
compiled.

A cell:
  * world: a fake world of 256 or 512 ranks, started only when no default
    process group exists and torn down after; a real group raises.
    ``make_production_mesh`` lays a DeviceMesh over it. The mesh's device
    type is "cuda" (recorded in the cell): the fake backend sets up no
    device for it, and it issues the collectives the card's backend has
    (a "cpu" mesh turns each all-to-all into an all-gather);
  * specs: ``param_specs``, ``batch_specs`` and ``cache_specs``, placed by
    ``placements_for``; leaves: meta DTensors, ``DTensor.from_local`` of
    each rank's meta shard;
  * steps: ``make_train_step``, ``make_prefill_step`` (the ssm and
    hybrid prefills with the plain scan the reference's runs, not K5) or
    ``make_serve_step``, run once under ``implicit_replication()`` (the
    model's own plain tensors, rope tables and masks, join the DTensors as
    replicated) and recorded by the ``hlo_analysis`` recorder;
    ``ShardingFallbacks`` does what GSPMD does where DTensor has no
    strategy, each counted in the cell; an op with no sharding strategy at
    all fails the cell with its name (``op``);
  * analytic terms: ``state_bytes_per_device`` by the reference's
    ``_tree_bytes_per_device`` formula, ``model_flops`` and the parameter
    counts from ``cfg.param_counts()``;
  * ``memory_analysis``: the local bytes of the step's arguments and
    outputs, and the peak of live meta bytes during the step (the
    recorder follows every storage the step's ops create);
  * ``cost_analysis_flops_unweighted``: ``FlopCounterMode``'s total, an
    independent count of the step's FLOPs at the DTensors' global shapes
    (each product once, however the mesh replicates it).

Importing this module sets nothing and starts no process group. The dry
run traces the config's ``attn_backend`` ('chunked' by default); a config
under 'pallas' (K4, a CUDA kernel with no meta route) is refused with an
error that names ROADMAP.md, as the reference's CLI never runs one.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all \
      --multi-pod both --out-dir runs/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import time
import traceback
from functools import partial

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (SHAPES, get_config, input_specs,
                                 list_archs, shape_supported)
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (cache_shape, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      state_shape, structure)
from repro_torch.nn.ssd import ssd_chunked
from repro_torch.sharding.rules import (batch_specs, cache_specs,
                                        param_specs, placements_for)

MESH_DEVICE = "cuda"

# Beyond-paper optimized configuration (the reference's §Perf winners,
# applied per arch for the optimized sweep): triangular block attention
# everywhere; TP-only sharding for the small SSM/hybrid models; mixtral
# stays on 'chunked'.
OPTIMIZED_OVERRIDES = {
    "*": dict(attn_backend="chunked_tri"),
    "mamba2-1.3b": dict(sharding_profile="tp"),
    "zamba2-1.2b": dict(sharding_profile="tp"),
    "mixtral-8x22b": dict(attn_backend="chunked"),
}


def optimized_config(arch):
    over = dict(OPTIMIZED_OVERRIDES.get("*", {}))
    over.update(OPTIMIZED_OVERRIDES.get(arch, {}))
    return get_config(arch).replace(**over)


@contextlib.contextmanager
def fake_world(n):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for the body; an existing fake group of at least ``n`` ranks is
    reused. Raises RuntimeError when a real group exists."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the dry run needs a fake world, and a real process group "
                f"({dist.get_backend()!r}, {dist.get_world_size()} ranks) "
                "is running: call it in a process without one")
        if dist.get_world_size() < n:
            raise RuntimeError(f"the fake world holds "
                               f"{dist.get_world_size()} ranks; {n} needed")
        yield
        return
    # importing fake_pg registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shard_factor(mesh_shape, spec):
    shard = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                shard *= mesh_shape[a]
    return shard


def _pairs(tree, specs):
    """(leaf, spec) pairs of a tree of dicts and lists and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)) and not _is_spec(specs):
        for t, s in zip(tree, specs):
            yield from _pairs(t, s)
    else:
        yield tree, specs


def _is_spec(s):
    return isinstance(s, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in s)


def tree_bytes_per_device(tree, specs, mesh_shape):
    """The reference's ``_tree_bytes_per_device``: each leaf's bytes over
    the product of the mesh axes its spec names."""
    return sum(t.numel() * t.element_size() / _shard_factor(mesh_shape, s)
               for t, s in _pairs(tree, specs))


def _mesh_shape(mesh):
    """Axis sizes by name, of a DeviceMesh or of a stub with a ``shape``
    dict (the sharding rules take either)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _train_specs(pspecs):
    return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                      "step": ()}}


def state_bytes_per_device(cfg, kind, batch, cache_len, mesh, *,
                           fsdp_over_pod=False):
    """The state's bytes on each device, the reference's formula: the
    train state (parameters and AdamW moments), or the parameters and the
    serving cache of ``batch`` x ``cache_len``. ``mesh``: a DeviceMesh or
    a stub with axis sizes."""
    shape = _mesh_shape(mesh)
    struct = state_shape(cfg)
    pspecs = param_specs(cfg, struct["params"], mesh,
                         fsdp_over_pod=fsdp_over_pod)
    if kind == "train":
        return tree_bytes_per_device(struct, _train_specs(pspecs), shape)
    cstruct = cache_shape(cfg, batch, cache_len)
    return (tree_bytes_per_device(struct["params"], pspecs, shape)
            + tree_bytes_per_device(cstruct, cache_specs(cfg, cstruct, mesh),
                                    shape))


def _distribute(tree, specs, mesh):
    """The tree with every meta leaf a DTensor on ``mesh``: each rank's
    local meta shard, placed as its spec says."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute(v, s, mesh) for v, s in zip(tree, specs)]
    placements = placements_for(mesh, specs)
    local = list(tree.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
    shard = torch.empty(local, dtype=tree.dtype, device="meta")
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def _module_with(cfg, params):
    """The model's meta module with the DTensor ``params`` bound in place
    of its parameters."""
    holder = structure(cfg)
    for n, t in params.items():
        mod_name, _, attr = n.rpartition(".")
        setattr(holder.get_submodule(mod_name), attr, torch.nn.Parameter(t))
    return holder


def _names(module):
    return {m: n or type(m).__name__ for n, m in module.named_modules()}


def _leaves(tree):
    """The tensors of a tree of dicts, lists, tuples and modules (a
    module's parameters)."""
    from torch.utils._pytree import tree_flatten
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(p.data for p in x.parameters())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _local_bytes(tensors):
    """The bytes of each distinct local storage (a DTensor's shard)."""
    seen = {}
    for t in tensors:
        st = getattr(t, "_local_tensor", t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


_NO_STRATEGY = re.compile(
    r"Operator (\S+) does not have a sharding strategy"
    r"|Sharding propagation failed for ([\w.]+)")


def unsupported_op(exc):
    """The op named by DTensor's error when it cannot shard an op, or
    None."""
    m = _NO_STRATEGY.search(str(exc))
    return (m.group(1) or m.group(2)) if m else None


def _is_unit_strided(p):
    return (type(p).__name__ == "_StridedShard"
            and getattr(p, "split_factor", None) == 1)


def _plain_shards(x):
    """``x`` with each ``_StridedShard`` of split factor 1 written as the
    ``Shard`` it is (a view that merges a dim split over every rank of its
    mesh dims leaves one); the local shard is the same tensor. DTensor
    plans a redistribution of a strided shard by a search over the states
    of the whole mesh, which on the 3-D multi-pod mesh costs up to a
    minute an op."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or not any(
            _is_unit_strided(p) for p in x.placements):
        return x
    placements = [Shard(p.dim) if _is_unit_strided(p) else p
                  for p in x.placements]
    return DTensor.from_local(x._local_tensor, x.device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _pending(x):
    """Whether ``x`` is a DTensor holding a pending sum."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and any(p.is_partial()
                                          for p in x.placements)


def _out_of_place(func):
    """The out-of-place overload of an in-place aten op (``index_put_`` ->
    ``index_put``), or None."""
    name = func._schema.name.split("::")[-1]
    if not name.endswith("_") or name.startswith("_"):
        return None
    packet = getattr(torch.ops.aten, name[:-1], None)
    return getattr(packet, func._overloadname, None) if packet else None


class ShardingFallbacks(TorchDispatchMode):
    """What GSPMD does where DTensor has no strategy for the sharding at
    hand (DTensor's strategies differ between torch releases), for the
    cases the model code meets; each is counted (``counts``) and every
    redistribution runs under the recorder below, so its collectives are
    counted too:

    * every pending sum an op leaves (``Partial`` from a contraction over
      a split dim, ``_MaskPartial`` from a gather or embedding lookup
      along one) is all-reduced at once (``pending_reductions``), the plan
      of tensor parallelism without sequence parallelism that GSPMD
      follows for these specs; left pending, DTensor turns some into
      reduce-scatters over the sequence, and a masked sum keeps a mask
      that fits no reshaped result and cannot be compared on meta;
    * an op DTensor cannot shard with a pending sum among its args, or
      whose strategy would move a shard back into one, runs after those
      sums are reduced (``partial_reductions``);
    * a view that splits a sharded dim into factors the sharding does not
      divide (a (B, S, 64) projection split 16 ways, viewed as
      (B, S, 4, 16); tokens split over both mesh axes, viewed back as
      (B, S, d)) is retried with the mesh dims that shard a dim past the
      shapes' common prefix replicated one at a time, the innermost
      first, until it runs, as GSPMD reshards around a reshape
      (``reshards``);
    * a slot write (``scatter_``) that DTensor cannot run in place runs on
      the local shard, index and values split as the cache is (a batch of
      one splits its slots: GSPMD's dynamic-update-slice on a split dim
      writes on the rank that holds the slot; ``local_writes``; on the
      meta device no index is read);
    * any other in-place op DTensor cannot run in place runs through its
      out-of-place strategy, resharded to the input's placements
      (``in_place_rewrites``; meta only).
    """

    _VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}

    def __init__(self):
        super().__init__()
        self.reshards = self.local_writes = 0
        self.pending_reductions = self.in_place_rewrites = 0
        self.partial_reductions = 0

    def counts(self):
        """How often each fallback ran."""
        return {k: getattr(self, k) for k in (
            "reshards", "local_writes", "pending_reductions",
            "in_place_rewrites", "partial_reductions")}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        args = tuple([_plain_shards(a) for a in x] if isinstance(x, list)
                     else _plain_shards(x) for x in args)
        if not isinstance(args[0], DTensor):
            return self._reduce_pending(func, func(*args, **kwargs))
        try:
            return self._reduce_pending(func, func(*args, **kwargs))
        except (RuntimeError, NotImplementedError) as e:
            if ("P(sum) not supported" in str(e)
                    or "Sharding propagation failed" in str(e)) and any(
                        _pending(a) for a in args):
                return self._reduce_partials(e, func, args, kwargs)
            if func in self._VIEWS:
                return self._reshard_view(e, func, args, kwargs)
            if func == torch.ops.aten.scatter_.src:
                return self._local_write(e, *args)
            if _out_of_place(func) is not None:
                return self._in_place(e, func, args, kwargs)
            raise

    def _reduce_pending(self, func, out):
        """``out`` with its pending sums all-reduced; an in-place op's
        result is its input, returned as it is."""
        from torch.distributed.tensor import Replicate
        if func._schema.is_mutable:
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(self._reduce_pending(func, o) for o in out)
        if not _pending(out):
            return out
        self.pending_reductions += 1
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])

    def _reduce_partials(self, first, func, args, kwargs):
        """``func`` after its args' pending sums are all-reduced."""
        from torch.distributed.tensor import Replicate
        out, reduced = [], 0
        for a in args:
            if _pending(a):
                a = a.redistribute(a.device_mesh, [
                    Replicate() if p.is_partial() else p
                    for p in a.placements])
                reduced += 1
            out.append(a)
        if not reduced:
            raise first
        self.partial_reductions += reduced
        return self._reduce_pending(func, func(*out, **kwargs))

    def _reshard_view(self, first, func, args, kwargs):
        from torch.distributed.tensor import Replicate, Shard
        x, shape = args[0], list(args[1])
        common = 0
        while (common < min(x.ndim, len(shape))
               and x.shape[common] == shape[common]):
            common += 1
        placements = list(x.placements)
        for i in reversed(range(len(placements))):
            p = placements[i]
            if not (isinstance(p, Shard) and p.dim >= common):
                continue
            placements[i] = Replicate()
            self.reshards += 1
            y = x.redistribute(x.device_mesh, placements)
            try:
                return func(y, *args[1:], **kwargs)
            except RuntimeError:
                continue
        raise first

    def _local_write(self, first, x, dim, index, src):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if x.device.type != "meta":
            raise first
        # index and src split like x along every dim but the slot dim
        placements = [Replicate() if isinstance(p, Shard) and p.dim == dim
                      else p for p in x.placements]
        local = []
        for t in (index, src):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, x.device_mesh,
                                       [Replicate()] * x.device_mesh.ndim,
                                       run_check=False)
            local.append(t.redistribute(x.device_mesh,
                                        placements)._local_tensor)
        self.local_writes += 1
        x._local_tensor.scatter_(dim, *local)
        return x

    def _in_place(self, first, func, args, kwargs):
        """``func``'s out-of-place form, resharded to ``self``'s placements,
        as ``self``'s new local shard."""
        x = args[0]
        if x.device.type != "meta":
            raise first
        out = _out_of_place(func)(*args, **kwargs)
        if tuple(out.placements) != tuple(x.placements):
            out = out.redistribute(x.device_mesh, x.placements)
        self.in_place_rewrites += 1
        x._local_tensor = out._local_tensor
        return x


def _register_missing_strategies():
    """A sharding strategy for ``aten.flip`` (which ``cumsum``'s backward
    runs), which older torch releases lack: the flip is local on every
    dim it does not reverse. Registered only where DTensor has none."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    if any(flip in getattr(prop, attr, {}) for attr in (
            "op_strategy_funcs", "op_single_dim_strategy_funcs",
            "op_to_rules")):
        return

    @register_sharding(flip)
    def flip_strategy(x, dims):
        flipped = {d % len(x.shape) for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(len(x.shape))
            if d not in flipped]


def trace_step(cfg, kind, batch_struct, mesh, *, cache_len=None,
               fsdp_over_pod=False):
    """Trace one step of ``kind`` ("train", "prefill" or "decode") on
    ``mesh`` with meta DTensor leaves. ``batch_struct``: the step's meta
    inputs (``input_specs``); ``cache_len``: the serving cache's length.
    Returns the per-device ``HloStats``, the state's bytes per device,
    the FlopCounterMode total and the ``memory_analysis`` dict."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    _register_missing_strategies()
    if cfg.attn_backend == "pallas":
        raise NotImplementedError(
            "the dry run has no meta route for attn_backend='pallas' (K4 is "
            "a CUDA kernel); trace 'chunked' as the reference's CLI does "
            "(see ROADMAP.md)")
    struct = state_shape(cfg)
    pspecs = param_specs(cfg, struct["params"], mesh,
                         fsdp_over_pod=fsdp_over_pod)
    batch = _distribute(batch_struct, batch_specs(cfg, batch_struct, mesh),
                        mesh)
    B = batch_struct["tokens"].shape[0]
    state_bytes = state_bytes_per_device(cfg, kind, B, cache_len, mesh,
                                         fsdp_over_pod=fsdp_over_pod)
    if kind == "train":
        step = make_train_step(cfg)
        args = (_distribute(struct, _train_specs(pspecs), mesh), batch)
        names = _names(step.module)
    else:
        cstruct = cache_shape(cfg, B, cache_len)
        cspecs = cache_specs(cfg, cstruct, mesh)
        params = _module_with(cfg, _distribute(struct["params"], pspecs,
                                               mesh))
        cache = _distribute(cstruct, cspecs, mesh)
        names = _names(params)
        if kind == "prefill":
            ssd_fn = (partial(ssd_chunked, bf16=cfg.ssd_bf16)
                      if cfg.family in ("ssm", "hybrid") else None)
            step = make_prefill_step(cfg, ssd_fn=ssd_fn)
            args = (params, batch, cache)
        else:
            step, args = make_serve_step(cfg), (params, cache,
                                                batch["tokens"])
    leaves = _leaves(args)
    rec = hlo.OpRecorder(names)
    rec.watch(leaves)
    flops = FlopCounterMode(display=False)
    fallbacks = ShardingFallbacks()
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    with grad, implicit_replication(), rec, fallbacks, flops:
        out = step(*args)
    return rec.stats, state_bytes, flops.get_total_flops(), {
        "argument_size_in_bytes": _local_bytes(leaves),
        "output_size_in_bytes": _local_bytes(_leaves(out)),
        "peak_live_bytes": rec.peak_bytes,
    }, fallbacks


def lower_cell(arch, shape_id, *, multi_pod, fsdp_over_pod=False,
               cfg_override=None):
    """Build shardings and trace one cell on a fake world. Returns the
    result dict (the reference's keys)."""
    cfg = cfg_override or get_config(arch)
    mesh_tag = "multi" if multi_pod else "single"
    ok, reason = shape_supported(cfg, shape_id)
    if not ok:
        return {"arch": arch, "shape": shape_id, "mesh": mesh_tag,
                "status": "skip", "reason": reason}
    spec = SHAPES[shape_id]
    kind, B, S = spec["kind"], spec["batch"], spec["seq"]
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=MESH_DEVICE)
        t0 = time.time()
        st, state_bytes, fc_flops, mem, fallbacks = trace_step(
            cfg, kind, input_specs(cfg, shape_id), mesh, cache_len=S,
            fsdp_over_pod=fsdp_over_pod)
        t_lower = time.time() - t0
    return cell_result(cfg, arch=arch, shape_id=shape_id, mesh=mesh_tag,
                       chips=chips, kind=kind, batch=B, seq=S, stats=st,
                       state_bytes=state_bytes, fc_flops=fc_flops, mem=mem,
                       fallbacks=fallbacks, lower_s=t_lower)


def cell_result(cfg, *, arch, shape_id, mesh, chips, kind, batch, seq,
                stats, state_bytes, fc_flops, mem, fallbacks, lower_s):
    """The reference's result dict of one traced cell: the per-device
    counts scaled to global (x chips) for the roofline formulas."""
    st = stats
    hlo_flops = st.flops * chips
    hlo_bytes = st.bytes_accessed * chips
    coll_total = st.collective_bytes * chips
    total_p, active_p = cfg.param_counts()
    tokens = batch * seq if kind in ("train", "prefill") else batch
    model_flops = (6 if kind == "train" else 2) * active_p * tokens
    terms = hlo.roofline_terms(hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
                               coll_bytes=coll_total, chips=chips)
    return {
        "arch": arch, "shape": shape_id, "mesh": mesh,
        "status": "ok", "chips": chips,
        "kind": kind, "batch": batch, "seq": seq,
        "lower_s": round(lower_s, 2), "compile_s": 0.0,
        "hlo_flops": hlo_flops, "hlo_bytes": hlo_bytes,
        "collective_bytes": coll_total,
        "collective_by_kind": {k: v * chips
                               for k, v in st.coll_by_kind.items()},
        "collective_counts": st.coll_counts,
        "dot_count": st.dot_count,
        "bytes_by_op": {k: v * chips for k, v in sorted(
            st.bytes_by_op.items(), key=lambda kv: -kv[1])[:10]},
        "bytes_top_sites": {k: v * chips
                            for k, v in st.top_bytes(10).items()},
        "cost_analysis_flops_unweighted": float(fc_flops),
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / hlo_flops) if hlo_flops
        else None,
        "state_bytes_per_device": state_bytes,
        "memory_analysis": mem,
        **terms,
        "params_total": total_p, "params_active": active_p,
        "mesh_device_type": MESH_DEVICE,
        "sharding_fallbacks": fallbacks.counts(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper §Perf winners per arch")
    ap.add_argument("--out-dir", default="runs/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.multi_pod]

    os.makedirs(args.out_dir, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape_id in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_id}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached", flush=True)
                    continue
                try:
                    res = lower_cell(arch, shape_id, multi_pod=mp,
                                     fsdp_over_pod=args.fsdp_over_pod,
                                     cfg_override=(optimized_config(arch)
                                                   if args.optimized
                                                   else None))
                except Exception as e:
                    res = {"arch": arch, "shape": shape_id,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e),
                           "op": unsupported_op(e),
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                status = res["status"]
                extra = ""
                if status == "ok":
                    extra = (f" compile={res['compile_s']}s "
                             f"flops={res['hlo_flops']:.3g}"
                             f" coll={res['collective_bytes']:.3g}B "
                             f"dom={res['dominant']}")
                elif status == "error":
                    extra = " " + res["error"][:200]
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
