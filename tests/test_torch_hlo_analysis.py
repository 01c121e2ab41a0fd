"""The port's roofline analysis (``repro_torch.launch.hlo_analysis``):
``analyze_ops`` against closed-form counts on small programs (a matmul
chain, a Python loop of matmuls, slice updates, collectives on a fake
4-rank world), the H100 roofline constants, and the per-device FLOPs of
every family's train, prefill and decode step at SMOKE size against the
reference's ``analyze_hlo`` of the compiled XLA program on one device.

Bytes are reported, not held against the reference: XLA fuses elementwise
work and the port runs eagerly."""

from functools import partial
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke, input_specs as j_inputs
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as jsteps

from repro_torch.configs import get_smoke_config, input_specs
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import steps
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import mesh_over
from repro_torch.nn.ssd import ssd_chunked

F32 = 4


def test_matmul_chain_closed_form():
    a, b, c = torch.ones(8, 16), torch.ones(16, 32), torch.ones(32, 4)
    st, out = hlo.analyze_ops(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert out.shape == (8, 4)
    assert st.flops == 2 * 8 * 32 * 16 + 2 * 8 * 4 * 32
    assert st.dot_count == 2
    assert st.bytes_accessed == 2 * (8 * 32 + 8 * 4) * F32
    assert st.bytes_by_op == {"mm": st.bytes_accessed}
    assert st.collective_bytes == 0 and st.coll_counts == {}


def test_python_loop_of_seven_matmuls_counts_each():
    """A loop counts once per executed matmul (the reference counts a
    scanned body's ``dot`` once, weighted by its trip count)."""
    def seven(x, w):
        for _ in range(7):
            x = x @ w
        return x

    st, _ = hlo.analyze_ops(seven, torch.ones(4, 8), torch.ones(8, 8))
    assert st.flops == 7 * 2 * 4 * 8 * 8
    assert st.dot_count == 7
    assert st.bytes_accessed == 7 * 2 * 4 * 8 * F32


def test_einsum_and_linear_decompose_into_counted_matmuls():
    q, k = torch.ones(2, 5, 3, 4), torch.ones(2, 6, 3, 4)
    st, _ = hlo.analyze_ops(
        lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k), q, k)
    assert st.flops == 2 * (2 * 3 * 5 * 6) * 4
    w, bias = torch.ones(7, 4), torch.ones(7)
    st, _ = hlo.analyze_ops(torch.nn.functional.linear, torch.ones(3, 4), w,
                            bias)
    assert st.flops == 2 * 3 * 7 * 4 and st.dot_count == 1


def test_slice_updates_count_the_update():
    """A write into a slice counts the update's bytes (the reference's
    dynamic-update-slice rule), not the whole buffer's."""
    buf = torch.zeros(64, 16)

    def write(buf, upd):
        buf[3:5] = upd
        return buf

    st, _ = hlo.analyze_ops(write, buf, torch.ones(2, 16))
    assert st.bytes_accessed == 2 * (2 * 16) * F32
    assert st.bytes_by_op == {"copy_": 2 * 2 * 16 * F32}

    def put(buf, idx, vals):
        buf.index_put_((idx,), vals, accumulate=True)
        return buf

    st, _ = hlo.analyze_ops(put, torch.zeros(64, 16),
                            torch.tensor([1, 9, 33]), torch.ones(3, 16))
    assert st.bytes_by_op["index_put_"] == 2 * 3 * 16 * F32

    def scatter(buf, idx, vals):
        return buf.scatter_(1, idx, vals)

    st, _ = hlo.analyze_ops(scatter, torch.zeros(4, 64, 2),
                            torch.zeros(4, 1, 2, dtype=torch.long),
                            torch.ones(4, 1, 2))
    assert st.bytes_by_op == {"scatter_": 2 * 4 * 2 * F32}


def test_views_and_allocations_move_no_bytes():
    x = torch.ones(4, 6)
    st, _ = hlo.analyze_ops(
        lambda x: (x.view(6, 4)[1:5].t().unsqueeze(0),
                   torch.empty(1000)), x)
    assert st.bytes_accessed == 0 and st.flops == 0
    st, _ = hlo.analyze_ops(lambda x: x.t().reshape(24), x)   # a copy
    assert st.bytes_by_op == {"clone": 2 * 24 * F32}


def test_collectives_on_a_fake_four_rank_world():
    """Per device: the local shard's matmul, the all-gather's result
    bytes, a reduce-scatter's result bytes times its group size, and an
    all-reduce's result bytes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with fake_world(4):
        mesh = mesh_over((4,), ("data",), device="cuda")
        x = DTensor.from_local(torch.empty(2, 16, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        w = DTensor.from_local(torch.empty(16, 4, device="meta"), mesh,
                               [Replicate()], run_check=False)
        st, y = hlo.analyze_ops(lambda x, w: x @ w, x, w)
        assert y.shape == (8, 4) and y.placements == (Shard(0),)
        assert st.flops == 2 * 2 * 4 * 16 and st.collective_bytes == 0

        st, full = hlo.analyze_ops(
            lambda x: x.redistribute(mesh, [Replicate()]), x)
        assert full.to_local().shape == (8, 16)
        assert st.coll_counts == {"all-gather": 1}
        assert st.coll_by_kind == {"all-gather": 8 * 16 * F32}

        p = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               [Partial()], run_check=False)
        st, _ = hlo.analyze_ops(
            lambda p: p.redistribute(mesh, [Shard(0)]), p)
        assert st.coll_counts == {"reduce-scatter": 1}
        assert st.coll_by_kind == {"reduce-scatter": 4 * (2 * 16) * F32}
        st, _ = hlo.analyze_ops(
            lambda p: p.redistribute(mesh, [Replicate()]), p)
        assert st.coll_by_kind == {"all-reduce": 8 * 16 * F32}
    assert not torch.distributed.is_initialized()


def test_roofline_terms_use_the_h100_constants():
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.LINK_BW) == (989e12, 3.35e12,
                                                         50e9)
    t = hlo.roofline_terms(hlo_flops=2 * 989e12, hlo_bytes=3.35e12,
                           coll_bytes=50e9, chips=2)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "compute" and t["roofline_step_s"] == t[
        "compute_s"]
    src = Path(hlo.__file__).read_text()
    lines = src.splitlines()
    for const in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        i = next(n for n, ln in enumerate(lines) if ln.startswith(const))
        comment = "\n".join(lines[max(0, i - 6):i])
        assert "NVIDIA H100 80GB HBM3, 700.00 W" in comment, const
    assert "v5e" not in src and "197e12" not in src


FAMILIES = ["smollm-135m", "mixtral-8x22b", "mamba2-1.3b", "zamba2-1.2b",
            "qwen2-vl-72b", "deepseek-v2-236b", "seamless-m4t-large-v2"]
SCALE = 64    # train (4, 64), prefill (1, 512), decode (2, 1) over 64 slots


def _chunked(cfg):
    return (cfg.replace(attn_backend="chunked")
            if cfg.attn_backend == "pallas" else cfg)


def _reference_flops(arch, kind, shape):
    cfg = _chunked(j_smoke(arch))
    b = j_inputs(cfg, shape, scale=SCALE)
    st = jsteps.state_shape(cfg)
    B, S = b["tokens"].shape
    if kind == "train":
        lowered = jax.jit(jsteps.make_train_step(cfg)).lower(st, b)
    elif kind == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(cfg)).lower(
            st["params"], b, jsteps.cache_shape(cfg, B, S))
    else:
        lowered = jax.jit(jsteps.make_serve_step(cfg)).lower(
            st["params"], jsteps.cache_shape(cfg, B, 64), b["tokens"])
    return jhlo.analyze_hlo(lowered.compile().as_text()).flops


def _port_flops(arch, kind, shape):
    """The port's step on meta tensors (the dry run's ops on one
    device); the SSM prefills take the plain scan the reference runs."""
    cfg = _chunked(get_smoke_config(arch))
    b = input_specs(cfg, shape, scale=SCALE)
    B, S = b["tokens"].shape
    if kind == "train":
        return hlo.analyze_ops(steps.make_train_step(cfg),
                               steps.state_shape(cfg), b)[0].flops
    params = steps.structure(cfg)
    with torch.no_grad():
        if kind == "prefill":
            fn = (partial(ssd_chunked, bf16=cfg.ssd_bf16)
                  if cfg.family in ("ssm", "hybrid") else None)
            step = steps.make_prefill_step(cfg, ssd_fn=fn)
            return hlo.analyze_ops(step, params, b, steps.cache_shape(
                cfg, B, S))[0].flops
        return hlo.analyze_ops(steps.make_serve_step(cfg), params,
                               steps.cache_shape(cfg, B, 64),
                               b["tokens"])[0].flops


@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_equal_the_references_analyze_hlo(arch):
    """Per-device FLOPs of train, prefill and decode within 1% of the
    reference's trip-weighted count on one device (the 'pallas' configs
    traced under 'chunked', as the dry run does)."""
    for kind, shape in (("train", "train_4k"), ("prefill", "prefill_32k"),
                        ("decode", "decode_32k")):
        ref = _reference_flops(arch, kind, shape)
        got = _port_flops(arch, kind, shape)
        assert ref > 0 and got == pytest.approx(ref, rel=0.01), (kind, got,
                                                                 ref)
