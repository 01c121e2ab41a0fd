"""Roofline terms of a step from the aten ops it dispatches (port of
``repro.launch.hlo_analysis``).

The reference parses the HLO text of a compiled, SPMD-partitioned program.
The port runs eagerly and has no HLO: ``analyze_ops(fn, *args)`` runs the
step once under ``OpRecorder``, a ``TorchDispatchMode``, and counts the
aten ops it dispatches. On DTensor arguments the recorder lets DTensor
run first (it returns NotImplemented for a DTensor-level op), so what it
counts are the ops each rank runs on its local shards and the
``_c10d_functional`` collectives that the redistributions issue: every
number is PER DEVICE, as the reference's SPMD module is the per-device
program. The ops DTensor runs on FakeTensors to propagate shardings are
not counted.

  * FLOPs = sum over the matmul family (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, which ``einsum``, ``matmul`` and ``linear`` decompose to)
    of 2 * prod(result dims) * prod(contracted dims). Nothing else counts:
    the reference counts ``dot`` only.
  * bytes = 2 * the bytes of each materialized result (a read and a write).
    View ops and allocations are left out (the reference's ``_VIEW_OPS``).
    An update of a slice (``index_put``, ``copy_`` into a view,
    ``scatter``, ``index_add``) counts the update's bytes, the reference's
    dynamic-update-slice rule.
  * collective bytes = the result bytes of each all-gather, all-reduce,
    reduce-scatter (times its group size, so it reflects the wire
    traffic), and all-to-all, coalesced forms included; a collective over
    a group of one rank moves nothing and is not counted.
  * ``dot_count`` counts the matmuls executed. The reference counts each
    static ``dot`` of the program once, so a layer that it scans counts
    once there and once per layer here.
  * ``bytes_by_meta`` is keyed by module path and op (``layers.3.attn.wq/
    mm``; ``Global`` outside any module call), from
    ``torch.utils.module_tracker.ModuleTracker``, in place of the HLO
    op-name tail.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}
# results that move no bytes of their own: views, aliases and allocations
_NO_TRAFFIC = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
               "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd"}
# slice updates: (op name, index of the argument whose bytes are written)
_UPDATES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "copy_": 0, "scatter": 3, "scatter_": 3, "scatter_add": 3,
            "scatter_add_": 3, "index_add": 3, "index_add_": 3,
            "slice_scatter": 1, "select_scatter": 1}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                      "c10d_functional", "_dtensor")
# DTensor's all-to-all of one split dim for another (NCCL's alltoall)
_COLLECTIVES["shard_dim_alltoall"] = "all-to-all"


def _group_size(args):
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _nbytes(t):
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors of an op's result: a tensor, or a tuple or list of
    them (and of other values)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def matmul_flops(func, args, out):
    """2 * prod(result) * prod(contracted) of one matmul-family op."""
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2 * out.numel() * a.shape[-1]


@dataclass
class HloStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)
    dot_count: int = 0
    bytes_by_op: dict = field(default_factory=dict)     # op -> bytes (rw)
    bytes_by_meta: dict = field(default_factory=dict)   # module/op -> bytes

    def top_bytes(self, n=10):
        return dict(sorted(self.bytes_by_meta.items(),
                           key=lambda kv: -kv[1])[:n])


class OpRecorder(TorchDispatchMode):
    """Counts the ops dispatched under it into ``self.stats``
    (``HloStats``), per device as the module docstring says. ``names``
    maps modules to their paths for ``bytes_by_meta``.

    It also follows the storages that the ops create, and those passed to
    ``watch``: ``live_bytes`` are the bytes of the ones still referenced,
    ``peak_bytes`` the most that were at once (a storage is freed when its
    last tensor goes)."""

    def __init__(self, names=None):
        super().__init__()
        from torch.utils.module_tracker import ModuleTracker
        from torch.utils.weak import WeakIdKeyDictionary
        self.stats = HloStats()
        self.live_bytes = self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self.tracker = ModuleTracker()
        known = getattr(self.tracker, "_known_modules", None)
        if known is not None and names:
            for mod, name in names.items():
                known[mod] = name

    def __enter__(self):
        self.tracker.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.tracker.__exit__(*exc)

    def watch(self, tensors):
        """Count these tensors' storages as live (a DTensor's local
        shard)."""
        for t in tensors:
            self._hold(getattr(t, "_local_tensor", t))

    def _hold(self, t):
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live_bytes -= n

    def _where(self):
        parents = [p for p in self.tracker.parents if p != "Global"]
        return max(parents, key=len) if parents else "Global"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor run; count its local ops
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out              # sharding propagation, not execution
        self._count(func, args, out, outs)
        for t in outs:
            self._hold(t)
        return out

    def _count(self, func, args, out, outs):
        st = self.stats
        name = func._overloadpacket.__name__
        ns = func.namespace
        if func in _MATMULS:
            st.flops += matmul_flops(func, args, out)
            st.dot_count += 1
        if (ns in _FUNCOL_NAMESPACES and name in _COLLECTIVES
                and _group_size(args) > 1):   # a group of one moves nothing
            kind = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in outs)
            if kind == "reduce-scatter":
                b *= _group_size(args)
            st.collective_bytes += b
            st.coll_by_kind[kind] = st.coll_by_kind.get(kind, 0) + b
            st.coll_counts[kind] = st.coll_counts.get(kind, 0) + 1
        if func.is_view or name in _NO_TRAFFIC or not outs:
            return
        if name in _UPDATES:
            upd = args[_UPDATES[name]]   # copy_: the destination view
            b = 2 * _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
        else:
            b = 2 * sum(_nbytes(t) for t in outs)
        if not b:
            return
        st.bytes_accessed += b
        st.bytes_by_op[name] = st.bytes_by_op.get(name, 0) + b
        key = f"{self._where()}/{name}"
        st.bytes_by_meta[key] = st.bytes_by_meta.get(key, 0) + b


def analyze_ops(fn, *args, names=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an ``OpRecorder``; returns
    (its ``HloStats``, fn's result)."""
    rec = OpRecorder(names)
    with rec:
        out = fn(*args, **kwargs)
    return rec.stats, out


# ---------------------------------------------------------------------------
# Roofline terms: one NVIDIA H100 80GB HBM3 (SXM5) per rank, at the power
# limit `nvidia-smi --query-gpu=name,power.limit` prints for the card the
# port is measured on: "NVIDIA H100 80GB HBM3, 700.00 W".
# ---------------------------------------------------------------------------

# NVIDIA H100 80GB HBM3, 700.00 W: dense bf16 tensor-core peak, FLOP/s
# (NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, without sparsity).
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bandwidth, bytes/s (the same
# datasheet, SXM5 column).
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700.00 W: one 400 Gb/s NDR InfiniBand NIC per GPU
# (a DGX H100 node: 8 GPUs, 8 ConnectX-7 ports), bytes/s. A 16 x 16 mesh
# spans 32 nodes of 8, so the hop between nodes sets the pace of its
# collectives. The figure happens to equal the reference's per-link ICI
# number; it is the NIC's, not a TPU's.
LINK_BW = 50e9


def roofline_terms(*, hlo_flops, hlo_bytes, coll_bytes, chips):
    """Terms in seconds. Inputs are GLOBAL (sum over chips) quantities."""
    compute_s = hlo_flops / (chips * PEAK_FLOPS)
    memory_s = hlo_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {**terms, "dominant": dom.replace("_s", ""),
            "roofline_step_s": step_s}
