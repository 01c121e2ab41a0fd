"""The port's capacity-dispatch MoE (``repro_torch.nn.moe``) against the JAX
package's ``repro.nn.moe``: the same float32 parameters (the reference's
``moe_init`` tree carried across by name) and the same NumPy-drawn tokens,
top_k 1 and 2, the routing weights normalized or not, and a capacity
factor of 1.25 (tokens drop) or E/k (none do). Outputs agree within 1e-5
and the load-balancing loss within 1e-6: the same float32 products summed
in another order, with every token in the same slot, since the slots
follow from exact integer ranks."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)

from repro.nn import moe as jmoe

from repro_torch import convert
from repro_torch.nn import moe

E, D, FF = 4, 32, 48
B, S = 2, 24


def _setup(n_shared=0, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, E, n_shared=n_shared,
                       dtype=jnp.float32)
    tp = moe.MoE(D, FF, E, n_shared=n_shared, dtype=torch.float32)
    tp.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in
                        convert.flatten_tree(
                            jax.tree.map(np.asarray, jp)).items()},
                       strict=True)
    rng = np.random.default_rng(seed + 7)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    # lean every token toward expert 0 so that a capacity factor of 1.25
    # overflows it
    w0 = np.asarray(jp["router"]["w"])[:, 0]
    x += 1.5 * w0 / np.linalg.norm(w0)
    return jp, tp, x.astype(np.float32)


def _dropped(x, tp, top_k, capacity_factor):
    """How many (token, choice) pairs overflow their expert's capacity."""
    xf = torch.from_numpy(x).reshape(-1, D)
    _, top_idx = torch.topk(torch.softmax(xf @ tp.router.w, -1), top_k)
    C = math.ceil(xf.shape[0] * top_k / E * capacity_factor)
    counts = torch.bincount(top_idx.reshape(-1), minlength=E)
    return int(torch.clamp_min(counts - C, 0).sum())


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("capacity", ["1.25", "E/k"])
def test_moe_apply_matches_the_reference(top_k, normalize, capacity):
    jp, tp, x = _setup()
    cf = 1.25 if capacity == "1.25" else E / top_k
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf,
                              normalize_weights=normalize)
    with torch.inference_mode():
        ty, taux = moe.moe_apply(tp, torch.from_numpy(x), top_k=top_k,
                                 capacity_factor=cf,
                                 normalize_weights=normalize)
        dense = moe.moe_apply_dense_reference(tp, torch.from_numpy(x),
                                              top_k=top_k,
                                              normalize_weights=normalize)
    assert ty.shape == (B, S, D) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    dropped = _dropped(x, tp, top_k, cf)
    if capacity == "1.25":   # the capacity is binding, and the drops show
        assert dropped > 0
        assert not torch.allclose(ty, dense, rtol=0, atol=1e-3)
    else:                    # nothing drops: the dispatch is the dense oracle
        assert dropped == 0
        torch.testing.assert_close(ty, dense, rtol=0, atol=1e-5)


def test_dense_reference_matches_the_reference_with_shared_experts():
    jp, tp, x = _setup(n_shared=1, seed=1)
    jy = jmoe.moe_apply_dense_reference(jp, jnp.asarray(x), top_k=2)
    jcap, _ = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2,
                             capacity_factor=E / 2)
    with torch.inference_mode():
        ty = moe.moe_apply_dense_reference(tp, torch.from_numpy(x), top_k=2)
        tcap, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                                capacity_factor=E / 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcap.numpy(), np.asarray(jcap), rtol=0,
                               atol=1e-5)


def test_bf16_experts_keep_the_input_dtype_and_a_float32_router():
    tp = moe.MoE(D, FF, E, generator=torch.Generator().manual_seed(0))
    assert tp.router.w.dtype == torch.float32
    assert tp.experts.gate.dtype == torch.bfloat16
    assert tuple(tp.experts.gate.shape) == (E, D, FF)
    assert tuple(tp.experts.down.shape) == (E, FF, D)
    x = torch.randn((B, S, D), generator=torch.Generator().manual_seed(1))
    y, aux = moe.moe_apply(tp, x.to(torch.bfloat16), top_k=2)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
