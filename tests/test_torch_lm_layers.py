"""The port's language-model layers (``nn/layers.py``: rmsnorm, embedding,
the tied read-out, swiglu; ``nn/rotary.py``: the standard rope) against
the JAX package on the same NumPy-seeded inputs.

Tolerances: float32 within 1e-5 (the same float32 operations, reductions
in another order); in bf16 a layer's output may differ by one bf16 ulp
where the two frameworks round intermediate values at other places
(2^-7 relative, 7.8e-3), and the swiglu's three bf16 matrix products by a
few ulps (3e-2 relative at outputs of order 1). The read-out's logits are
float32 from bf16 operands in both, so they agree to float32 accuracy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(1)

from repro.nn import layers as jl
from repro.nn import rotary as jr

from repro_torch.nn import layers as tl
from repro_torch.nn import rotary as tr

DTYPES = ["float32", "bfloat16"]


def _both(x, dtype):
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(x, np.float32)).to(
                getattr(torch, dtype)))


def _close(got, want, *, rtol, atol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.normal(0, 2, (3, 5, 72)), dtype)
    js, ts = _both(rng.uniform(0.5, 1.5, (72,)), dtype)
    want = jl.rmsnorm({"scale": js}, jx, eps=1e-6)
    got = tl.rmsnorm(ts, tx, eps=1e-6)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 7.8e-3
    _close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_and_tied_logits(dtype):
    rng = np.random.default_rng(1)
    je, te = _both(rng.normal(0, 0.1, (64, 24)), dtype)
    tokens = rng.integers(0, 64, (2, 7)).astype(np.int32)
    want = jl.embedding({"embed": je}, jnp.asarray(tokens))
    got = tl.embedding(te, torch.from_numpy(tokens).long())
    _close(got, want, rtol=0, atol=0)
    jx, tx = _both(rng.normal(0, 1, (2, 7, 24)), dtype)
    want = jl.embedding_logits({"embed": je}, jx)
    got = tl.embedding_logits(te, tx)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    d, f = 24, 40
    w = {n: _both(rng.normal(0, 1 / np.sqrt(a), (a, b)), dtype)
         for n, (a, b) in (("gate", (d, f)), ("up", (d, f)),
                           ("down", (f, d)))}
    jx, tx = _both(rng.normal(0, 1, (3, 6, d)), dtype)
    want = jl.swiglu({n: {"w": w[n][0]} for n in w}, jx)
    got = tl.swiglu(w["gate"][1], w["up"][1], w["down"][1], tx)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(3)
    B, S, Hq, Hk, D = 2, 9, 3, 1, 24
    jq, tq = _both(rng.normal(0, 1, (B, S, Hq, D)), dtype)
    jk, tk = _both(rng.normal(0, 1, (B, S, Hk, D)), dtype)
    pos = rng.integers(0, 2000, (B, S)).astype(np.int32)
    np.testing.assert_allclose(
        tr.rope_frequencies(D, theta=theta).numpy(),
        np.asarray(jr.rope_frequencies(D, theta=theta)), rtol=1e-6)
    wq, wk = jr.apply_rope(jq, jk, jnp.asarray(pos), theta=theta)
    gq, gk = tr.apply_rope(tq, tk, torch.from_numpy(pos), theta=theta)
    assert gq.dtype == tq.dtype and gk.dtype == tk.dtype
    tol = 1e-5 if dtype == "float32" else 7.8e-3
    _close(gq, wq, rtol=tol, atol=tol)
    _close(gk, wk, rtol=tol, atol=tol)
