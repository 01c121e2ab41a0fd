"""The port's sim_step kernels (K1 ``sim_interval_batch``, K2
``sim_step_batch``) against the JAX package.

On the CPU the wrappers run their plain versions (``ref.py``); those are
held against the reference's buffer dynamics: K1 against the vmapped
``repro.core.simulator._scan_substeps`` (the definition the Pallas kernel
was written to match, 1e-5), K2 against ``repro.kernels.sim_step.ref.
sim_step_reference`` at its own 1e-4. The CUDA kernel itself is compared
with the plain version in the ``cuda``-marked test, which needs a card.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core.simulator import _scan_substeps
from repro.kernels.sim_step.ref import sim_step_reference as jax_sim_step_ref

from repro_torch.kernels.sim_step import ops
from repro_torch.kernels.sim_step.ref import (sim_interval_reference,
                                              sim_step_reference)


def _inputs(E, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (E, 2)).astype(np.float32),
            rng.uniform(0.1, 3, (E, S, 3)).astype(np.float32),
            rng.uniform(0.5, 4, (E, 2)).astype(np.float32))


@pytest.mark.parametrize("E,S", [(1, 50), (8, 10), (5, 37), (16, 50)])
def test_sim_interval_plain_matches_scan_substeps(E, S):
    bufs, rates, cap = _inputs(E, S, seed=E * 100 + S)
    dt = np.float32(1.0) / np.float32(S)
    ref_b, ref_m = jax.vmap(_scan_substeps, in_axes=(0, 0, 0, None))(
        jnp.asarray(bufs), jnp.asarray(rates), jnp.asarray(cap),
        jnp.float32(dt))
    before = ops.sim_interval_batch.launches
    got_b, got_m = ops.sim_interval_batch(
        torch.from_numpy(bufs), torch.from_numpy(rates) * torch.tensor(dt),
        torch.from_numpy(cap))
    assert ops.sim_interval_batch.launches == before  # CPU: no launch
    assert got_b.shape == (E, 2) and got_m.shape == (E, 3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), atol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=1e-5)


@pytest.mark.parametrize("E,substeps", [(8, 10), (96, 25)])
def test_sim_step_plain_matches_reference(E, substeps):
    rng = np.random.default_rng(E)
    bufs = rng.uniform(0, 1, (E, 2)).astype(np.float32)
    rate = rng.uniform(0.1, 3, (E, 3)).astype(np.float32)
    cap = rng.uniform(1, 4, (E, 2)).astype(np.float32)
    rb, rm = jax_sim_step_ref(jnp.asarray(bufs), jnp.asarray(rate),
                              jnp.asarray(cap), substeps=substeps)
    before = ops.sim_step_batch.launches
    b2, mv = ops.sim_step_batch(torch.from_numpy(bufs),
                                torch.from_numpy(rate),
                                torch.from_numpy(cap), substeps=substeps)
    assert ops.sim_step_batch.launches == before
    np.testing.assert_allclose(b2.numpy(), np.asarray(rb), atol=1e-4)
    np.testing.assert_allclose(mv.numpy(), np.asarray(rm), atol=1e-4)


def test_sim_step_is_sim_interval_with_constant_rates():
    """K2 is K1 with the rate held over every substep: the plain versions
    agree bitwise, which is what lets one CUDA kernel serve both."""
    bufs, rates, cap = _inputs(6, 20, seed=3)
    rate = torch.from_numpy(rates[:, 0])
    b2, m2 = ops.sim_step_batch(torch.from_numpy(bufs), rate,
                                torch.from_numpy(cap), substeps=20,
                                duration=2.0)
    b1, m1 = sim_interval_reference(
        torch.from_numpy(bufs), (rate * (2.0 / 20))[:, None].expand(-1, 20, -1),
        torch.from_numpy(cap))
    assert torch.equal(b1, b2) and torch.equal(m1, m2)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    bufs, rates, cap = (torch.from_numpy(a) for a in _inputs(4, 5, seed=1))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.sim_interval_batch(bufs.double(), rates, cap)
    else:
        with pytest.raises(ValueError):
            ops.sim_interval_batch(bufs, rates, cap[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [7, 50, 333])
@pytest.mark.parametrize("E", [1, 32, 129, 1000, 16384])
def test_cuda_kernel_matches_plain_version(E, S):
    """Bitwise, at ragged env blocks (E not a multiple of 32) and ragged
    rate chunks (S not a multiple of 8, a row of S * 12 bytes not 16-byte
    aligned), for both forms of the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    bufs, rates, cap = (torch.from_numpy(a).cuda()
                        for a in _inputs(E, S, seed=E + S))
    rates = rates * 0.02
    before = ops.sim_interval_batch.launches
    got = ops.sim_interval_batch(bufs, rates, cap)
    torch.cuda.synchronize()
    assert ops.sim_interval_batch.launches == before + 1
    want = sim_interval_reference(bufs, rates, cap)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    b2, m2 = ops.sim_step_batch(bufs, rates[:, 0] / 0.02, cap, substeps=S)
    torch.cuda.synchronize()
    for g, w in zip((b2, m2), sim_step_reference(bufs, rates[:, 0] / 0.02,
                                                 cap, substeps=S)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
