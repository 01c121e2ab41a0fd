"""The port's dry run (``repro_torch.launch.dryrun``) against the reference:
``cache_shape`` leaf for leaf at SMOKE size, ``state_bytes_per_device``
exactly at full width on both production meshes for every kind, and
``lower_cell`` itself on SMOKE configs of one arch per family.

The reference's numbers come from a subprocess that imports
``repro.launch.dryrun``, which sets ``XLA_FLAGS`` to 512 host devices at
import; it uses ``jax.eval_shape`` only and compiles nothing. The port's
cells run in subprocesses too, each with its own fake world, so no test
process holds a process group."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.configs import get_smoke_config as j_smoke
from repro.launch.steps import cache_shape as j_cache_shape

from repro_torch.configs import (SHAPES, get_config, get_smoke_config,
                                 list_archs, shape_supported)
from repro_torch.convert import flatten_tree
from repro_torch.launch import dryrun
from repro_torch.launch.steps import cache_shape, state_shape

SRC = Path(__file__).resolve().parents[1] / "src"
ENV = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}


def _indexed(tree):
    """Lists as dicts keyed by index, so ``flatten_tree`` walks them."""
    if isinstance(tree, list):
        return {str(i): _indexed(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _indexed(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("arch", list_archs())
def test_cache_shape_equals_the_reference(arch):
    """Every reference leaf (a stack's layers on leading dims) is the
    port's per-layer leaves stacked: as many leaves as the stack dims
    hold, each of the remaining shape, the same dtype."""
    ref = flatten_tree(j_cache_shape(j_smoke(arch), 2, 48))
    got = flatten_tree(_indexed(cache_shape(get_smoke_config(arch), 2, 48)))
    assert all(t.device.type == "meta" for t in got.values())
    groups = {}
    for name, t in got.items():
        key = ".".join(p for p in name.split(".") if not p.isdigit())
        groups.setdefault(key, []).append(t)
    assert set(groups) == set(ref), (sorted(groups), sorted(ref))
    for key, leaf in ref.items():
        ts = groups[key]
        shape = tuple(ts[0].shape)
        assert all(tuple(t.shape) == shape for t in ts), key
        stack = tuple(leaf.shape[:len(leaf.shape) - len(shape)])
        assert tuple(leaf.shape[len(stack):]) == shape, key
        n = 1
        for d in stack:
            n *= d
        assert n == len(ts), key
        assert {str(t.dtype).split(".")[-1] for t in ts} == {
            leaf.dtype.name}, key


REFERENCE_STATE_BYTES = textwrap.dedent("""
    import json
    from repro.launch import dryrun as d   # sets XLA_FLAGS first
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import (SHAPES, get_config, list_archs,
                               shape_supported)
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import cache_shape, state_shape
    from repro.models import get_model
    from repro.sharding import cache_specs, param_specs
    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in list_archs():
            cfg = get_config(arch)
            pspecs = param_specs(cfg, jax.eval_shape(
                lambda: get_model(cfg).init(jax.random.PRNGKey(0))), mesh)
            st = state_shape(cfg)
            for shape_id, spec in SHAPES.items():
                if not shape_supported(cfg, shape_id)[0]:
                    continue
                B, S = spec["batch"], spec["seq"]
                if spec["kind"] == "train":
                    b = d._tree_bytes_per_device(st, {
                        "params": pspecs,
                        "opt": {"m": pspecs, "v": pspecs, "step": P()}},
                        mesh)
                else:
                    c = cache_shape(cfg, B, S)
                    b = (d._tree_bytes_per_device(st["params"], pspecs,
                                                  mesh)
                         + d._tree_bytes_per_device(
                             c, cache_specs(cfg, c, mesh), mesh))
                out[f"{arch}|{shape_id}|{mp}"] = b
    print(json.dumps(out))
""")


class _Mesh:
    """The production mesh's axis sizes, which is all the rules read."""

    def __init__(self, multi_pod):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def test_state_bytes_per_device_equal_the_reference():
    """All ten archs at full width, both production meshes, every kind
    each supports: the port's ``state_bytes_per_device`` is the
    reference's ``_tree_bytes_per_device`` of the same state, exactly."""
    out = subprocess.run([sys.executable, "-c", REFERENCE_STATE_BYTES],
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    n = 0
    for mp in (False, True):
        mesh = _Mesh(mp)
        for arch in list_archs():
            cfg = get_config(arch)
            for shape_id, spec in SHAPES.items():
                if not shape_supported(cfg, shape_id)[0]:
                    continue
                got = dryrun.state_bytes_per_device(
                    cfg, spec["kind"], spec["batch"], spec["seq"], mesh)
                assert got == ref[f"{arch}|{shape_id}|{mp}"], (
                    arch, shape_id, mp, got)
                n += 1
    assert n == len(ref) == 2 * 33   # 3 kinds each, long_500k for 3


CELLS = textwrap.dedent("""
    import json, sys, warnings, logging
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    out = {}
    for cell in sys.argv[1:]:
        arch, shape, mesh = cell.split("|")
        out[cell] = dryrun.lower_cell(
            arch, shape, multi_pod=mesh == "multi",
            cfg_override=get_smoke_config(arch))
    print(json.dumps(out, default=str))
""")
# one arch per family at train_4k and decode_32k on the single-pod mesh,
# smollm also on the multi-pod one; four processes, about even (zamba2's
# SMOKE scan of 16-token chunks makes its train cell the longest)
CELL_GROUPS = [
    ["zamba2-1.2b|train_4k|single", "zamba2-1.2b|decode_32k|single"],
    ["smollm-135m|train_4k|single", "smollm-135m|decode_32k|single",
     "smollm-135m|train_4k|multi", "smollm-135m|decode_32k|multi",
     "mamba2-1.3b|decode_32k|single"],
    ["mixtral-8x22b|train_4k|single", "mixtral-8x22b|decode_32k|single",
     "mamba2-1.3b|train_4k|single", "deepseek-v2-236b|train_4k|single",
     "deepseek-v2-236b|decode_32k|single"],
    ["qwen2-vl-72b|train_4k|single", "qwen2-vl-72b|decode_32k|single",
     "seamless-m4t-large-v2|train_4k|single",
     "seamless-m4t-large-v2|decode_32k|single"],
]


@pytest.fixture(scope="module")
def cells():
    procs = [subprocess.Popen([sys.executable, "-c", CELLS, *group],
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for group in CELL_GROUPS]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


# the reference's result keys (src/repro/launch/dryrun.py:205-226)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "status", "chips", "kind", "batch", "seq",
    "lower_s", "compile_s", "hlo_flops", "hlo_bytes", "collective_bytes",
    "collective_by_kind", "collective_counts", "dot_count", "bytes_by_op",
    "bytes_top_sites", "cost_analysis_flops_unweighted", "model_flops",
    "useful_flops_ratio", "state_bytes_per_device", "memory_analysis",
    "compute_s", "memory_s", "collective_s", "dominant", "roofline_step_s",
    "params_total", "params_active"}


def test_every_cell_ends_ok_with_the_references_keys(cells):
    assert len(cells) == sum(map(len, CELL_GROUPS))
    for name, r in cells.items():
        assert r["status"] == "ok", (name, r)
        assert REFERENCE_KEYS <= set(r), REFERENCE_KEYS - set(r)
        assert r["chips"] == (512 if name.endswith("multi") else 256)
        assert r["mesh_device_type"] == "cuda"
        assert r["compile_s"] == 0 and r["lower_s"] > 0
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
        assert r["roofline_step_s"] == max(r["compute_s"], r["memory_s"],
                                           r["collective_s"])
        mem = r["memory_analysis"]
        assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"] > 0


def _smollm_train_flops_per_device(cfg, B, S, data=16, model=16):
    """The step's matmul FLOPs on one device, derived from the specs of
    SMOKE smollm (d_model 72, 3 heads of 24, 1 kv head, d_ff 192, vocab
    512, 'full' attention, no remat): the batch splits over "data" only;
    of the weights only the vocab dims and the feed-forward's d_ff split
    over "model" (72 and the heads do not divide 16). A train step is the
    forward and twice its matmuls backward."""
    N = B * S
    d, hd, H, kv, ff, V = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_ff, cfg.vocab_padded)
    proj = 2 * N * d * (2 * H * hd + 2 * kv * hd) / data
    attn = 2 * 2 * B * H * S * S * hd / data
    ffn = 3 * 2 * N * d * ff / (data * model)
    logits = 2 * N * d * V / (data * model)
    return 3 * (cfg.n_layers * (proj + attn + ffn) + logits)


def test_smollm_counts_match_its_specs(cells):
    cfg = get_smoke_config("smollm-135m")
    r = cells["smollm-135m|train_4k|single"]
    per_device = r["hlo_flops"] / r["chips"]
    assert per_device == pytest.approx(
        _smollm_train_flops_per_device(cfg, 256, 4096), rel=0.01)
    # FSDP gathers every split parameter in full at least once
    struct = state_shape(cfg)["params"]
    from repro_torch.sharding.rules import param_specs
    specs = param_specs(cfg, struct, _Mesh(False))
    split = sum(t.numel() * t.element_size() for n, t in struct.items()
                if any(a is not None for a in specs[n]))
    assert split > 0
    assert r["collective_by_kind"]["all-gather"] / r["chips"] >= split
    # the multi-pod mesh halves each device's share of the batch
    m = cells["smollm-135m|train_4k|multi"]
    assert m["hlo_flops"] / m["chips"] == pytest.approx(per_device / 2,
                                                        rel=0.01)


def test_a_one_by_one_mesh_moves_no_bytes():
    """On a 1 x 1 mesh every collective is over a group of one: nothing
    is counted, and the FLOPs are the unsharded step's."""
    from repro_torch.configs import input_specs
    from repro_torch.launch.hlo_analysis import analyze_ops
    from repro_torch.launch.mesh import mesh_over
    from repro_torch.launch.steps import make_train_step
    cfg = get_smoke_config("smollm-135m")
    batch = input_specs(cfg, "train_4k", scale=64)
    with dryrun.fake_world(1):
        mesh = mesh_over((1, 1), ("data", "model"), device="cuda")
        st, state_bytes, fc, mem, _ = dryrun.trace_step(cfg, "train", batch,
                                                        mesh)
    assert not dist.is_initialized()
    assert st.collective_bytes == 0 and st.coll_counts == {}
    plain = analyze_ops(make_train_step(cfg), state_shape(cfg), batch)[0]
    assert st.flops == plain.flops == fc
    assert state_bytes == dryrun.state_bytes_per_device(
        cfg, "train", 4, 64, mesh)


@pytest.mark.parametrize("ranks,device", [(1, "cpu"), (4, "meta")],
                         ids=["one_rank_values", "four_ranks_meta"])
def test_an_argmax_over_a_sharded_vocab_runs_replicated(ranks, device):
    """The fallback for an argmax DTensor cannot run over a sharded dim
    (torch 2.11's, over the vocab split on "model"), called directly: the
    reduced dim is replicated, the result is the unsharded argmax (values
    on one rank, the shape and placements on a fake 4-rank world's meta
    tensors), counted once under ``reshards``; over a dim that is not
    sharded the op's own error stands."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import mesh_over
    argmax = torch.ops.aten.argmax.default
    logits = torch.randn((2, 3, 64), generator=torch.Generator().manual_seed(0))
    with dryrun.fake_world(ranks):
        mesh = mesh_over((1, ranks), ("data", "model"), device="cpu")
        local = logits.chunk(ranks, dim=2)[0].to(device)
        x = DTensor.from_local(local, mesh, [Replicate(), Shard(2)],
                               shape=logits.shape, stride=logits.stride())
        mode = dryrun.ShardingFallbacks()
        stand_in = RuntimeError("the op's own error")
        out = mode._reshard_reduced_dim(stand_in, argmax, (x, -1), {})
        assert mode.counts() == {**dict.fromkeys(mode.counts(), 0),
                                 "reshards": 1}
        assert out.shape == (2, 3) and all(
            isinstance(p, Replicate) for p in out.placements)
        if device == "cpu":
            assert torch.equal(out.full_tensor(), logits.argmax(-1))
        with pytest.raises(RuntimeError, match="own error"):
            mode._reshard_reduced_dim(stand_in, argmax, (x, 0), {})
        assert mode.reshards == 1
    assert not dist.is_initialized()


def test_a_pallas_config_is_refused_and_the_world_torn_down():
    cfg = get_smoke_config("smollm-135m").replace(attn_backend="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dryrun.lower_cell("smollm-135m", "decode_32k", multi_pod=False,
                          cfg_override=cfg)
    assert not dist.is_initialized()


def test_a_real_process_group_is_refused():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="real process group"):
            dryrun.lower_cell("smollm-135m", "decode_32k", multi_pod=False,
                              cfg_override=get_smoke_config("smollm-135m"))
    finally:
        dist.destroy_process_group()


def test_unsupported_long_context_cells_skip():
    r = dryrun.lower_cell("smollm-135m", "long_500k", multi_pod=False)
    assert r["status"] == "skip" and "long_500k" in r["reason"]


def test_the_cli_writes_each_cell_once_and_fails_on_errors(tmp_path,
                                                          monkeypatch):
    """``main`` writes one JSON per cell, skips a cell already written,
    and exits with SystemExit when a cell fails (here a 'pallas' config
    through ``--optimized``'s hook)."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    args = ["--arch", "mamba2-1.3b", "--shape", "decode_32k",
            "--multi-pod", "single", "--out-dir", str(tmp_path)]
    dryrun.main(args)
    path = tmp_path / "mamba2-1.3b__decode_32k__single.json"
    first = json.loads(path.read_text())
    assert first["status"] == "ok" and first["arch"] == "mamba2-1.3b"
    dryrun.main(args)     # cached: not traced again
    assert json.loads(path.read_text()) == first
    monkeypatch.setattr(dryrun, "optimized_config", lambda arch: (
        get_smoke_config(arch).replace(attn_backend="pallas")))
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--multi-pod", "single", "--optimized", "--out-dir",
                     str(tmp_path)])
    err = json.loads((tmp_path / "smollm-135m__decode_32k__single.json")
                     .read_text())
    assert err["status"] == "error" and "ROADMAP.md" in err["error"]
    assert not dist.is_initialized()
