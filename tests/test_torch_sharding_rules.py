"""The port's sharding rules (``repro_torch.sharding.rules``), meshes
(``launch/mesh.py``) and elastic shapes (``runtime/elastic.py``) against
``repro.sharding`` on the reference tests' stub meshes
(``tests/test_sharding_rules.py:17-23``: the production (16, 16) and
(2, 16, 16) shapes, no devices needed).

The port holds one tensor per layer where the reference stacks a stack's
layers on leading dims, so the port's spec is the reference's with those
leading Nones dropped; the rules are matched on the reference's key path
(``convert.reference_name``). Parameter shapes on both sides come with no
storage: ``jax.eval_shape`` of the reference's init, the port's
``launch.steps.state_shape`` on the meta device.

The multi-rank checks of ``reshard_state`` and ``load_checkpoint(
shardings=)`` share the 4-rank spawn of ``test_torch_sharding_fleet.py``.
No test asserts a wall-clock time."""

import functools
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
import jax

torch.set_num_threads(2)

from repro.configs.registry import get_config as j_get_config, list_archs
from repro.configs.shapes import input_specs as j_input_specs
from repro.launch.steps import cache_shape as j_cache_shape
from repro.models import get_model as j_get_model
from repro.sharding import (batch_specs as j_batch_specs,
                            cache_specs as j_cache_specs,
                            param_specs as j_param_specs)

from repro_torch.configs import get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.convert import flatten_tree, reference_name
from repro_torch.launch.mesh import (make_production_mesh, make_smoke_mesh,
                                     world_size)
from repro_torch.launch.steps import state_shape
from repro_torch.models import get_model
from repro_torch.runtime import elastic_mesh
from repro_torch.runtime.elastic import elastic_shape
from repro_torch.sharding import (batch_axes_for, batch_specs, cache_specs,
                                  opt_specs, param_specs, to_shardings)
from repro_torch.sharding.rules import placements_for


def fake_mesh(multi_pod=False):
    """The reference tests' stub mesh."""
    if multi_pod:
        return SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                               axis_names=("pod", "data", "model"), size=512)
    return SimpleNamespace(shape={"data": 16, "model": 16},
                           axis_names=("data", "model"), size=256)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """A real 1x1 mesh starts a one-rank gloo group in this process; it is
    torn down after the module."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: j_get_model(cfg).init(
        jax.random.PRNGKey(0)))


def _flat_specs(tree):
    """Nested reference specs -> {"a.b": tuple}."""
    return {k: tuple(v) for k, v in flatten_tree(jax.tree.map(
        lambda s: s, tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))).items()}


def _dropped(ref, n_dims):
    """The reference spec with its leading stack dims dropped, after
    checking they are None."""
    lead = len(ref) - n_dims
    assert all(x is None for x in ref[:lead]), ref
    return ref[lead:]


@pytest.mark.parametrize("fsdp_over_pod", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch, multi_pod, fsdp_over_pod):
    """Every parameter of every arch's full config: the port's spec is the
    reference's with the stack dims dropped, on both production meshes,
    with and without ``fsdp_over_pod``; AdamW's moments follow it."""
    mesh = fake_mesh(multi_pod)
    ref = _flat_specs(j_param_specs(j_get_config(arch), _j_params(arch),
                                    mesh, fsdp_over_pod=fsdp_over_pod))
    state = state_shape(get_config(arch))
    got = param_specs(get_config(arch), state["params"], mesh,
                      fsdp_over_pod=fsdp_over_pod)
    assert got.keys() == state["params"].keys()
    n_sharded = 0
    for name, leaf in state["params"].items():
        assert got[name] == _dropped(ref[reference_name(name)], leaf.ndim), \
            name
        n_sharded += any(x is not None for x in got[name])
    assert n_sharded > 0
    opt = opt_specs(get_config(arch), state["opt"], got, mesh)
    assert opt["m"] is got and opt["v"] is got and opt["step"] == ()


def test_moe_expert_sharding_modes():
    """tests/test_sharding_rules.py's EP/TP choice: deepseek-v2's 160
    experts shard the expert dim, mixtral's 8 each expert's d_ff."""
    mesh = fake_mesh(False)
    for arch, ep in (("deepseek-v2-236b", True), ("mixtral-8x22b", False)):
        cfg = get_config(arch)
        specs = param_specs(cfg, state_shape(cfg)["params"], mesh)
        gate = specs[f"layers.{cfg.n_dense_layers}.ffn.experts.gate"
                     if cfg.n_dense_layers else "layers.0.ffn.experts.gate"]
        if ep:
            assert gate[0] == "model", gate
        else:
            assert gate[0] is None and gate[2] == "model", gate


def test_fsdp_profile_covers_nondivisible_heads():
    """smollm's 9 heads do not divide 16: the 'fsdp' profile shards every
    big matrix on 'data' and the vocab on 'model'."""
    cfg = get_config("smollm-135m")
    assert cfg.sharding_profile == "fsdp"
    specs = param_specs(cfg, state_shape(cfg)["params"], fake_mesh(False))
    assert specs["embed.embed"] == ("model", None)
    assert "data" in specs["layers.0.attn.wq.w"]


def test_batch_and_cache_specs_cases():
    """tests/test_sharding_rules.py:100-124: deepseek-7b on the multi-pod
    mesh, the batch split over ('pod', 'data'), the KV cache's batch dim
    too and its 32 kv heads over 'model' (the port's cache leaf has no
    stack dim: (B, S, H, D))."""
    cfg = get_config("deepseek-7b")
    mesh = fake_mesh(True)
    bs = batch_specs(cfg, input_specs(cfg, "train_4k"), mesh)
    assert bs["tokens"][0] == ("pod", "data")
    cache = get_model(cfg).init_cache(128, 1024, device="meta")
    cs = cache_specs(cfg, cache, mesh)
    kspec = cs["layers"][0]["k"]
    assert kspec[0] == ("pod", "data")
    assert kspec[2] == "model"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_equal_the_reference(arch, multi_pod):
    """Every arch's train_4k and decode batches (input_specs) on both
    meshes."""
    mesh = fake_mesh(multi_pod)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape_id in ("train_4k", "decode_32k"):
        ref = _flat_specs(j_batch_specs(jcfg, j_input_specs(jcfg, shape_id),
                                        mesh))
        got = batch_specs(cfg, input_specs(cfg, shape_id), mesh)
        assert got == ref, (arch, shape_id)


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", ["deepseek-7b", "mixtral-8x22b",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "deepseek-v2-236b", "chatglm3-6b"])
def test_cache_specs_equal_the_reference(arch, batch):
    """Serving caches (batch 128, and the long-context batch of 1 whose
    cache length or latent takes 'model') on the multi-pod mesh: every
    port cache leaf's spec is the reference's leaf's with the stack dims
    dropped (list indices of the port's per-layer caches ignored)."""
    mesh = fake_mesh(True)
    cfg = get_config(arch)
    ref = _flat_specs(j_cache_specs(j_get_config(arch), j_cache_shape(
        j_get_config(arch), batch, 1024), mesh))
    cache = get_model(cfg).init_cache(batch, 1024, device="meta")
    got = flatten_tree(_indexed(cache_specs(cfg, cache, mesh)))
    leaves = flatten_tree(_indexed(cache))
    compared = 0
    for name, spec in got.items():
        key = ".".join(p for p in name.split(".") if not p.isdigit())
        if key in ref:
            assert spec == _dropped(ref[key], leaves[name].ndim), name
            compared += 1
    assert compared >= len(leaves) // 2


def _indexed(tree):
    """Lists as dicts keyed by index, so ``flatten_tree`` walks them."""
    if isinstance(tree, list):
        return {str(i): _indexed(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _indexed(v) for k, v in tree.items()}
    return tree


def test_batch_axes_for_both_meshes():
    assert batch_axes_for(fake_mesh(False)) == ("data",)
    assert batch_axes_for(fake_mesh(True)) == ("pod", "data")


def test_to_shardings_placements():
    """A mesh dim named at tensor dim d, alone or in a tuple, gets
    Shard(d); every other mesh dim Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    pod = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements_for(pod, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements_for(pod, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert placements_for(pod, ()) == (Replicate(),) * 3
    mesh = make_smoke_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    sh = to_shardings(mesh, {"a": ("data", None), "b": [(None, "model")],
                             "step": ()})
    assert sh["a"].mesh is mesh
    assert sh["a"].placements == (Shard(0), Replicate())
    assert sh["b"][0].placements == (Replicate(), Shard(1))
    assert sh["step"].placements == (Replicate(), Replicate())


@pytest.mark.parametrize("n, model_axis, want", [
    (1, None, (1, 1)), (8, None, (1, 8)), (32, None, (2, 16)),
    (24, None, (2, 12)), (8, 2, (4, 2)), (6, 4, (2, 3)), (256, None,
                                                         (16, 16))])
def test_elastic_shape_arithmetic(n, model_axis, want):
    """The reference's arithmetic: model = model_axis or min(16, n),
    lowered until it divides n."""
    assert elastic_shape(n, model_axis) == want


def test_elastic_mesh_on_one_rank_matches_the_reference():
    from repro.runtime.elastic import elastic_mesh as j_elastic_mesh
    mesh = elastic_mesh(1, device="cpu")
    assert tuple(mesh.shape) == j_elastic_mesh(1).devices.shape == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_on_a_small_world(multi_pod):
    """(16, 16) and (2, 16, 16) need 256 and 512 ranks: a smaller world
    raises, as the reference's reshape of too few devices does."""
    assert world_size() < 256
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
