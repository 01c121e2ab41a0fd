"""The port's contention solve (K3, ``kernels/contention``) against the JAX
package.

On the CPU the wrapper runs its plain version (``ref.py``); it is held
against the reference's ``contention_rates_reference`` and against the
reference's Pallas kernel in interpret mode, env by env, at the
reference's own tolerance for this kernel (2e-5: the sums over flows are
reassociated, float32 noise around rates of order 1). The CUDA kernel is
compared with the plain version in the ``cuda``-marked tests, which need a
card."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.kernels.contention.ops import contention_rates as jax_kernel
from repro.kernels.contention.ref import contention_rates_reference as jax_ref

from repro_torch.kernels.contention import ops
from repro_torch.kernels.contention.ref import contention_rates_reference

ATOL = 2e-5


def operands(seed, *, E=2, S=4, F=5, L=2):
    """The reference kernel test's operand distribution with an env axis:
    threads, activity, routes, per-link conditions, floors and caps (half
    the flows uncapped)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        threads=f32(rng.integers(1, 30, (E, F, 3))),
        act=f32(rng.integers(0, 2, (E, S, F))),
        onpath=f32(rng.integers(0, 2, (E, S, F, L))),
        tpt=f32(rng.uniform(0.02, 0.5, (E, S, L, 3))),
        bw=f32(rng.uniform(0.1, 2.0, (E, S, L, 3))),
        floor=f32(rng.uniform(0.0, 1.5, (E, F))),
        cap=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                         rng.uniform(0.05, 1.5, (E, F)))))


def _port(x, device="cpu", objectives=True, rounds=0):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    fl, cp = (t["floor"], t["cap"]) if objectives else (None, None)
    return ops.contention_rates(t["threads"], t["act"], t["onpath"],
                                t["tpt"], t["bw"], fl, cp, rounds=rounds)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("rounds", [0, 5])
def test_plain_matches_reference_and_interpret_kernel(seed, rounds):
    x = operands(seed)
    for objectives in (False, True):
        before = ops.contention_rates.launches
        got = _port(x, objectives=objectives, rounds=rounds).numpy()
        assert ops.contention_rates.launches == before  # CPU: no launch
        assert got.shape == (2, 4, 5, 3)
        for e in range(2):
            args = [jnp.asarray(x[k][e]) for k in
                    ("threads", "act", "onpath", "tpt", "bw")]
            fl, cp = ((jnp.asarray(x["floor"][e]), jnp.asarray(x["cap"][e]))
                      if objectives else (None, None))
            want = np.asarray(jax_ref(*args, fl, cp, rounds=rounds))
            interp = np.asarray(jax_kernel(*args, fl, cp, rounds=rounds))
            np.testing.assert_allclose(got[e], want, atol=ATOL, rtol=0)
            np.testing.assert_allclose(got[e], interp, atol=ATOL, rtol=0)


def test_one_of_floor_and_cap_fills_the_other_with_its_default():
    x = operands(7)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    both = ops.contention_rates(t["threads"], t["act"], t["onpath"],
                                t["tpt"], t["bw"], t["floor"],
                                torch.full_like(t["cap"], float("inf")),
                                rounds=3)
    only = ops.contention_rates(t["threads"], t["act"], t["onpath"],
                                t["tpt"], t["bw"], t["floor"], rounds=3)
    assert torch.equal(both, only)


def test_inactive_and_pathless_flows_move_exactly_nothing():
    x = operands(3)
    x["act"][:, :, 0] = 0.0        # flow 0 never active
    x["onpath"][:, :, 1] = 0.0     # flow 1 routed over no link
    for objectives in (False, True):
        got = _port(x, objectives=objectives, rounds=2)
        assert torch.all(got[:, :, :2] == 0.0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rounds"])
def test_wrapper_rejects_inputs_the_kernel_does_not_take(bad):
    t = {k: torch.from_numpy(v) for k, v in operands(1).items()}
    args = [t[k] for k in ("threads", "act", "onpath", "tpt", "bw")]
    if bad == "dtype":
        args[0] = args[0].double()
        with pytest.raises(TypeError):
            ops.contention_rates(*args)
    elif bad == "shape":
        args[3] = args[3][:, :, :1]
        with pytest.raises(ValueError):
            ops.contention_rates(*args)
    else:
        with pytest.raises(ValueError):
            ops.contention_rates(*args, rounds=-1)


# the shapes chip_smoke.py runs: the fleet's training batch, the scale-out
# fleet dense and compact, and a topology-shaped solve with water-filling
CUDA_SHAPES = [dict(E=16, S=50, F=4, L=1, rounds=0),
               dict(E=1, S=50, F=4096, L=1, rounds=0),
               dict(E=1, S=50, F=256, L=1, rounds=0),
               dict(E=4, S=50, F=8, L=3, rounds=8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"E{s['E']}F{s['F']}L{s['L']}"
                              for s in CUDA_SHAPES])
def test_cuda_kernel_matches_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    x = operands(shape["F"], E=shape["E"], S=shape["S"], F=shape["F"],
                 L=shape["L"])
    if shape["L"] == 1:
        x["onpath"][:] = 1.0
    _hold_cuda_kernel(x, shape["rounds"])


def _hold_cuda_kernel(x, rounds):
    """Both solves (objectives off and on): one launch each, within ATOL of
    the plain version, and a second launch with the same bits."""
    for objectives in (False, True):
        before = ops.contention_rates.launches
        got = _port(x, "cuda", objectives, rounds)
        again = _port(x, "cuda", objectives, rounds)
        torch.cuda.synchronize()
        assert ops.contention_rates.launches == before + 2
        assert torch.equal(got, again)
        t = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
        want = contention_rates_reference(
            t["threads"], t["act"], t["onpath"], t["tpt"], t["bw"],
            t["floor"] if objectives else None,
            t["cap"] if objectives else None, rounds=rounds)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# the edges of the kernel's layouts: one flow (a lane group of one), the
# first flow count past a lane group (a block), 257 flows (one block of 256
# threads, 2 flows a thread, at 3 links); 2 and 3 links; water-filling with
# rounds = F
EDGE_SHAPES = [dict(E=2, S=6, F=F, L=L) for F in (1, 33, 257)
               for L in (2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=[f"F{s['F']}L{s['L']}" for s in EDGE_SHAPES])
def test_cuda_kernel_matches_plain_version_at_the_edges(shape):
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    x = operands(shape["F"] + shape["L"], E=shape["E"], S=shape["S"],
                 F=shape["F"], L=shape["L"])
    _hold_cuda_kernel(x, shape["F"])


# flow counts that take a cluster of 2, 4 and 8 blocks with objectives (600
# at 3 links, 600 and 2048 at 4), and past what a cluster of 8 holds on chip
# (2100 at 4 links, 16385 at 1 link), where each thread walks its flows
LARGE_SHAPES = [dict(E=1, S=3, F=600, L=3), dict(E=1, S=3, F=600, L=4),
                dict(E=1, S=2, F=2048, L=4), dict(E=1, S=2, F=2100, L=4),
                dict(E=1, S=2, F=16385, L=1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LARGE_SHAPES,
                         ids=[f"F{s['F']}L{s['L']}" for s in LARGE_SHAPES])
def test_cuda_kernel_matches_plain_version_in_clusters(shape):
    """No floors and caps below a fair share, so 6 water-fill rounds move
    spill."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    F, L = shape["F"], shape["L"]
    x = operands(F + L, E=shape["E"], S=shape["S"], F=F, L=L)
    if L == 1:
        x["onpath"][:] = 1.0
    rng = np.random.default_rng(F)
    x["floor"][:] = 0.0
    x["cap"] = np.where(np.isfinite(x["cap"]),
                        rng.uniform(0.2, 2.0, x["cap"].shape) / F,
                        np.inf).astype(np.float32)
    _hold_cuda_kernel(x, 6)
