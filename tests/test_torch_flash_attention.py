"""The port's flash attention (K4, ``kernels/flash_attention``) against the
JAX package.

On the CPU the wrapper runs its plain version (``ref.py``); it is held
against the reference's Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) over the reference's own shape grid and
a few shapes of the port's path: float32 within 1e-5 (the same float32
products summed in another order, outputs of order 1), bf16 within 2e-2
(both compute in float32 and round the output to bf16 once, so they may
differ by one bf16 ulp, 1.6e-2 at magnitudes up to 4). The CUDA kernel is
compared with the plain version in the ``cuda``-marked test, which needs a
card."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import flash_attention as jax_flash

from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import attention_reference

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

FA_CASES = [
    # B, S, Hq, Hkv, D, window, blk_q, blk_k (the JAX kernel's blocks)
    (2, 128, 4, 2, 32, None, 32, 32),
    (1, 96, 3, 1, 16, None, 32, 32),
    (2, 128, 4, 4, 32, 48, 32, 32),    # sliding window
    (1, 130, 2, 2, 16, None, 64, 32),  # non-divisible seq (padding path)
    (1, 64, 8, 8, 64, None, 64, 64),   # single kv block
    (1, 100, 3, 1, 64, None, 64, 64),  # smollm's heads, ragged S
    (1, 150, 4, 2, 32, 40, 64, 64),    # window and ragged S
]


def operands(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, Hq, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,bq,bk", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel(B, S, Hq, Hkv, D, win, bq, bk,
                                        dtype):
    q, k, v = operands(B, S, Hq, Hkv, D, seed=S * 7 + D)
    jd = getattr(jnp, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=True, window=win, blk_q=bq,
                     blk_k=bk, interpret=True)
    td = getattr(torch, dtype)
    # the reference rounds its inputs to bf16 the same way (nearest even)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    before = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, window=win)
    assert ops.flash_attention.launches == before  # the CPU launches nothing
    assert got.dtype == td and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=TOL[dtype])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in operands(1, 8, 4, 2, 16, 0))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                            v[:, :, :1].repeat(1, 1, 3, 1))  # 3 !| 4
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :4])
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)


# the main path's shapes at small S, both dtypes (each its own route), a
# window, D = 128, ragged S with each, and a window narrower than a warp's
# 16 rows
CUDA_SHAPES = [dict(B=2, S=256, Hq=9, Hkv=3, D=64, window=None),
               dict(B=1, S=200, Hq=9, Hkv=3, D=64, window=None),
               dict(B=1, S=300, Hq=4, Hkv=2, D=64, window=70),
               dict(B=1, S=192, Hq=8, Hkv=2, D=128, window=None),
               dict(B=1, S=1000, Hq=9, Hkv=3, D=64, window=None),
               dict(B=1, S=700, Hq=4, Hkv=1, D=128, window=100),
               dict(B=2, S=130, Hq=2, Hkv=2, D=64, window=5),
               # the wgmma route's paths: granite's 48 q heads over one kv
               # head at D = 128 (pairs of heads share each kv tile), 8
               # over 1, and a window whose edge falls inside a 128-key tile
               dict(B=1, S=320, Hq=48, Hkv=1, D=128, window=None),
               dict(B=2, S=384, Hq=8, Hkv=1, D=64, window=None),
               dict(B=1, S=640, Hq=4, Hkv=2, D=128, window=200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"S{s['S']}D{s['D']}w{s['window']}"
                              for s in CUDA_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(td).cuda() for x in operands(
        shape["B"], shape["S"], shape["Hq"], shape["Hkv"], shape["D"],
        seed=shape["S"]))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=shape["window"])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = attention_reference(q, k, v, window=shape["window"])
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


# causal=False: the reference's kernel in interpret mode where it takes the
# shape without padding keys (Skv at most its 512-key block, or a multiple
# of it), S != Skv as in a cross-attention
NONCAUSAL_CASES = [
    # B, S, Skv, Hq, Hkv, D, blk_q, blk_k (the JAX kernel's blocks)
    (2, 64, 96, 4, 2, 16, 32, 32),
    (1, 100, 40, 3, 1, 24, 64, 40),     # ragged S, SMOKE smollm's heads
    (2, 64, 16, 4, 4, 16, 64, 16),      # seamless's cross shape, SMOKE
    (1, 48, 1024, 2, 1, 32, 48, 512),   # Skv a multiple of the block
    (1, 130, 256, 2, 2, 64, 64, 256),
]


@pytest.mark.parametrize("B,S,Skv,Hq,Hkv,D,bq,bk", NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_matches_interpret_kernel(B, S, Skv, Hq, Hkv, D, bq, bk,
                                             dtype):
    rng = np.random.default_rng(S + Skv + D)
    q, k, v = (rng.normal(0, 1, (B, n, h, D)).astype(np.float32)
               for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=False, blk_q=bq, blk_k=bk,
                     interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(x).to(td)
                                for x in (q, k, v)), causal=False)
    assert got.dtype == td and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=TOL[dtype])


def test_non_causal_at_a_ragged_kv_length_matches_the_oracle():
    """Skv = 600 is neither below the reference kernel's 512-key block nor
    a multiple of it: that kernel pads k and v with zero keys, which take
    part in its non-causal softmax (R8). The port masks keys past Skv, as
    the reference's oracle ``attention_reference(causal=False)`` does."""
    from repro.kernels.flash_attention.ref import attention_reference as jref
    rng = np.random.default_rng(600)
    q = rng.normal(0, 1, (1, 16, 2, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, 600, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=False), np.float32)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL["float32"])
    padded = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False,
                                  interpret=True), np.float32)
    assert np.abs(padded - want).max() > 1e-3   # R8, as the reference is


def test_non_causal_refuses_a_window():
    q, k, v = (torch.from_numpy(x) for x in operands(1, 8, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="R9"):
        ops.flash_attention(q, k, v, causal=False, window=4)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False),
        attention_reference(q, k, v, causal=False), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,good,bad", [
    ("bfloat16", (8, 16, 24, 64, 72, 80, 96, 120, 128, 136, 192, 248, 256),
     (4, 12, 130, 264, 272)),
    ("float32", (4, 12, 16, 24, 64, 68, 100, 128, 132, 200, 252, 256),
     (2, 6, 258, 260, 384))])
def test_head_dim_domain(dtype, good, bad):
    td = getattr(torch, dtype)
    for D in good:
        kernel.check_head_dim(D, td)
    for D in bad:
        with pytest.raises(ValueError):
            kernel.check_head_dim(D, td)


# the domain on the card: head dims 8-128 at each padded instance (SMOKE's
# 16 and 24, phi-2's 80 and phi-3-mini's 96), causal and not, Skv != S and
# ragged, GQA
CUDA_DOMAIN_SHAPES = [
    dict(B=2, S=64, Skv=64, Hq=3, Hkv=1, D=24, causal=True, window=None),
    dict(B=2, S=64, Skv=64, Hq=6, Hkv=1, D=16, causal=True, window=None),
    dict(B=1, S=200, Skv=200, Hq=4, Hkv=2, D=8, causal=True, window=None),
    dict(B=1, S=300, Skv=300, Hq=9, Hkv=3, D=80, causal=True, window=None),
    dict(B=1, S=256, Skv=256, Hq=4, Hkv=4, D=96, causal=True, window=100),
    dict(B=1, S=130, Skv=130, Hq=2, Hkv=1, D=120, causal=True, window=None),
    dict(B=1, S=64, Skv=64, Hq=4, Hkv=2, D=16, causal=True, window=16),
    dict(B=2, S=256, Skv=64, Hq=4, Hkv=4, D=64, causal=False, window=None),
    dict(B=1, S=130, Skv=600, Hq=4, Hkv=4, D=64, causal=False, window=None),
    dict(B=1, S=64, Skv=100, Hq=3, Hkv=1, D=24, causal=False, window=None),
    dict(B=1, S=300, Skv=77, Hq=8, Hkv=2, D=128, causal=False, window=None),
    dict(B=1, S=50, Skv=300, Hq=2, Hkv=2, D=96, causal=False, window=None),
    # the 256-column instance (64-key tiles in bf16): gemma's D = 256 with
    # its GQA 2:1 and a window edge inside a tile, D = 136 through it with
    # zero columns, non-causal; head dims off the step, padded by the
    # wrapper (12 and 100 in bf16, 6 in both)
    dict(B=1, S=300, Skv=300, Hq=4, Hkv=2, D=256, causal=True, window=None),
    dict(B=1, S=700, Skv=700, Hq=4, Hkv=2, D=256, causal=True, window=200),
    dict(B=2, S=130, Skv=130, Hq=2, Hkv=2, D=136, causal=True, window=None),
    dict(B=1, S=100, Skv=260, Hq=4, Hkv=2, D=256, causal=False, window=None),
    dict(B=1, S=200, Skv=200, Hq=4, Hkv=2, D=12, causal=True, window=None),
    dict(B=1, S=150, Skv=150, Hq=9, Hkv=3, D=100, causal=True, window=50),
    dict(B=1, S=64, Skv=64, Hq=2, Hkv=1, D=6, causal=True, window=None)]


# head dims 136 to 256 (gemma's 256, the 256-column instance's columns past
# 136 read as zeros): the plain version against the reference's kernel in
# interpret mode, GQA 2:1, causal, a window and non-causal
WIDE_CASES = [
    # B, S, Skv, Hq, Hkv, D, window, causal, blk_q, blk_k
    (1, 96, 96, 4, 2, 256, None, True, 32, 32),
    (1, 128, 128, 4, 2, 256, 40, True, 64, 64),
    (1, 64, 96, 4, 2, 256, None, False, 64, 96),
    (1, 96, 96, 4, 2, 136, None, True, 32, 32),
    (1, 128, 128, 4, 2, 136, 40, True, 64, 64),
    (1, 64, 96, 4, 2, 136, None, False, 64, 96),
]


@pytest.mark.parametrize("B,S,Skv,Hq,Hkv,D,win,causal,bq,bk", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_dims_match_interpret_kernel(B, S, Skv, Hq, Hkv, D, win,
                                               causal, bq, bk, dtype):
    rng = np.random.default_rng(S + Skv + D)
    q, k, v = (rng.normal(0, 1, (B, n, h, D)).astype(np.float32)
               for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=causal, window=win,
                     blk_q=bq, blk_k=bk, interpret=True)
    kernel.check_head_dim(D, td)
    got = ops.flash_attention(*(torch.from_numpy(x).to(td)
                                for x in (q, k, v)), causal=causal,
                              window=win)
    assert got.dtype == td and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=TOL[dtype])


# head dims off the kernel's step: the wrapper's zero columns (as it adds
# them on CUDA), the plain version at the scale of the true D, and the
# slice, against the reference's kernel at the true D
PADDED_CASES = [
    # B, S, Hq, Hkv, D, window, dtype, padded D
    (1, 96, 4, 2, 12, None, "bfloat16", 16),
    (1, 130, 9, 3, 100, 48, "bfloat16", 104),
    (2, 64, 4, 2, 6, None, "float32", 8),
    (1, 96, 4, 2, 6, 20, "bfloat16", 8),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,dtype,Dp", PADDED_CASES)
def test_padded_head_dims_match_interpret_kernel(B, S, Hq, Hkv, D, win,
                                                 dtype, Dp):
    q, k, v = operands(B, S, Hq, Hkv, D, seed=S + D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=True, window=win, blk_q=32,
                     blk_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    qp, kp, vp = ops.pad_head_dim(tq, tk, tv)
    assert qp.shape[3] == kp.shape[3] == vp.shape[3] == Dp
    kernel.check_head_dim(Dp, td)
    with pytest.raises(ValueError):
        kernel.check_head_dim(D, td)
    assert torch.equal(qp[..., :D], tq) and not qp[..., D:].any()
    out = attention_reference(qp, kp, vp, window=win,
                              scale=1.0 / np.sqrt(D))
    assert not out[..., D:].any()   # zero columns of v: zero outputs
    got = out[..., :D]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=TOL[dtype])
    # the plain path of the wrapper at the true D agrees
    torch.testing.assert_close(got.float(), ops.flash_attention(
        tq, tk, tv, window=win).float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype,D", [("bfloat16", 264), ("float32", 260)])
def test_kernel_refuses_head_dims_past_the_widest_instance(dtype, D):
    with pytest.raises(ValueError, match="up to 256"):
        kernel.check_head_dim(D, getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_DOMAIN_SHAPES,
                         ids=[f"S{s['S']}kv{s['Skv']}D{s['D']}"
                              f"{'c' if s['causal'] else 'n'}w{s['window']}"
                              for s in CUDA_DOMAIN_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_over_its_domain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    td = getattr(torch, dtype)
    rng = np.random.default_rng(shape["S"] + shape["D"])
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (shape["B"], n, h,
                                                  shape["D"]))
                                .astype(np.float32)).to(td).cuda()
               for n, h in ((shape["S"], shape["Hq"]),
                            (shape["Skv"], shape["Hkv"]),
                            (shape["Skv"], shape["Hkv"])))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape["causal"],
                              window=shape["window"])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = attention_reference(q, k, v, causal=shape["causal"],
                               window=shape["window"])
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_refuses_head_dims_off_its_domain():
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    for dtype, D in ((torch.bfloat16, 257), (torch.bfloat16, 264),
                     (torch.float32, 258), (torch.float32, 260)):
        q = torch.zeros((1, 16, 2, D), dtype=dtype, device="cuda")
        before = ops.flash_attention.launches
        with pytest.raises(ValueError):
            ops.flash_attention(q, q, q)
        assert ops.flash_attention.launches == before
