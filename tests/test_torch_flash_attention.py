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

from repro_torch.kernels.flash_attention import ops
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
