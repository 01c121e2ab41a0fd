"""The port's schedule, utility and batched simulator against the JAX
package, on the CPU (the sim_step wrapper's plain version).

Where JAX vmaps a per-env function over E envs, the port takes the env axis
directly; both get the same numpy inputs. Tolerance 1e-5 (the reference's
own for simulator-backend agreement, tests/test_unified_env.py)."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import schedule as jsched
from repro.core import simulator as jsim
from repro.core.exploration import explore as jax_explore

from repro_torch.core import schedule as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core.exploration import explore as torch_explore

# the packages export a function named ``utility`` beside the module
jutil = importlib.import_module("repro.core.utility")
tutil = importlib.import_module("repro_torch.core.utility")

TPT, BW, CAP = [0.2, 0.05, 0.2], [2.0, 2.0, 2.0], [0.5, 0.5]
# a 2-bin schedule whose boundary sits at t = 2.0: intervals starting at
# 1.5 cross it at an exact float32 substep time
TABLE_TPT = np.asarray([[0.2, 0.05, 0.2], [0.1, 0.02, 0.1]], np.float32)
TABLE_BW = np.asarray([[2.0, 2.0, 2.0], [1.5, 0.5, 2.0]], np.float32)
T0 = np.asarray([0.0, 1.0, 1.5, 2.0, 2.5, 3.9], np.float32)


def _params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


def _tables(E):
    jt = jsched.make_table(TABLE_TPT, TABLE_BW, bin_seconds=2.0)
    jb = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape),
                                jt)
    tt = tsched.stack_tables([tsched.make_table(TABLE_TPT, TABLE_BW, 2.0,
                                                device="cpu")] * E)
    return jb, tt


def _threads(E, seed=0):
    return np.random.default_rng(seed).integers(1, 30, (E, 3)).astype(
        np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("scheduled", [False, True])
def test_sim_interval_matches_vmapped_reference(scheduled):
    jp, tp = _params()
    E = len(T0)
    jtab, ttab = _tables(E) if scheduled else (None, None)
    threads = _threads(E)
    bufs_j = jnp.zeros((E, 2))
    bufs_t = torch.zeros((E, 2))
    t_j, t_t = jnp.asarray(T0), torch.from_numpy(T0)
    for _ in range(3):
        bufs_j, tps_j = jax.vmap(
            lambda b, n, t, tab: jsim.sim_interval(jp, b, n, t, table=tab),
            in_axes=(0, 0, 0, 0 if scheduled else None))(
                bufs_j, jnp.asarray(threads), t_j, jtab)
        bufs_t, tps_t = tsim.sim_interval(tp, bufs_t,
                                          torch.from_numpy(threads), t_t,
                                          table=ttab)
        _close(bufs_t, bufs_j)
        _close(tps_t, tps_j)
        t_j, t_t = t_j + 1.0, t_t + 1.0


def test_substep_bin_index_flips_exactly_where_the_reference_does():
    jp, tp = _params()
    E = len(T0)
    jtab, ttab = _tables(E)
    threads = _threads(E, seed=1)
    ref = jax.vmap(lambda tab, n, t: jsim._substep_rates(jp, tab, n, t, 50))(
        jtab, jnp.asarray(threads), jnp.asarray(T0))
    got = tsim._substep_rates(tp, ttab, torch.from_numpy(threads),
                              torch.from_numpy(T0), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("spec", [tsim.DEFAULT_OBS, tsim.CONTEXT_OBS],
                         ids=["default", "context"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_reset_step_observe_match_vmapped_reference(spec, scheduled):
    jspec = jsim.ObservationSpec(context=spec.context)
    jp, tp = _params()
    E = len(T0)
    jtab, ttab = _tables(E) if scheduled else (None, None)
    keys = jax.random.split(jax.random.PRNGKey(4), E)
    t0 = T0 if scheduled else np.zeros(E, np.float32)
    tab_axis = 0 if scheduled else None
    js = jax.vmap(lambda k, t, tab: jsim.env_reset(jp, k, t, table=tab,
                                                   spec=jspec),
                  in_axes=(0, 0, tab_axis))(keys, jnp.asarray(t0), jtab)
    ts = tsim.env_reset(tp, E, torch.from_numpy(t0), table=ttab,
                        threads=torch.from_numpy(np.array(js.threads)))
    for a, b in zip(ts, js):
        _close(a, b)
    _close(tsim.observe(tp, ts, table=ttab, spec=spec),
           jax.vmap(lambda s, tab: jsim.observe(jp, s, table=tab, spec=jspec),
                    in_axes=(0, tab_axis))(js, jtab))
    rng = np.random.default_rng(7)
    for _ in range(4):
        # whole numbers + 0.3: no action within rounding distance of .5
        act = (rng.integers(-2, 60, (E, 3)) + 0.3).astype(np.float32)
        js, jobs, jrew = jax.vmap(
            lambda s, a, tab: jsim.env_step(jp, s, a, table=tab, spec=jspec),
            in_axes=(0, 0, tab_axis))(js, jnp.asarray(act), jtab)
        ts, tobs, trew = tsim.env_step(tp, ts, torch.from_numpy(act),
                                       table=ttab, spec=spec)
        for a, b in zip(ts, js):
            _close(a, b)
        _close(tobs, jobs)
        _close(trew, jrew)
        assert tobs.shape == (E, spec.frame_dim)


def test_round_half_to_even_and_clamp_match():
    jp, tp = _params()
    act = np.asarray([[0.5, 1.5, 2.5], [60.0, -3.0, 49.5]], np.float32)
    jthreads = jnp.clip(jnp.round(jnp.asarray(act)), 1.0, jp.n_max)
    ts = tsim.env_reset(tp, 2, threads=torch.ones(2, 3))
    ts, _, _ = tsim.env_step(tp, ts, torch.from_numpy(act))
    np.testing.assert_array_equal(ts.threads.numpy(), np.asarray(jthreads))


def test_simenv_exploration_matches_reference():
    jp, tp = _params()
    jenv = jsim.SimEnv(jp, seed=0)
    jenv.reset()
    tenv = tsim.SimEnv(tp, seed=0)
    tenv.reset(threads=torch.from_numpy(np.array(jenv.state.threads)))
    jex = jax_explore(jenv.probe, n_samples=25, n_max=50, seed=3)
    tex = torch_explore(tenv.probe, n_samples=25, n_max=50, seed=3)
    _close(tex.bandwidth, jex.bandwidth)
    _close(tex.tpt, jex.tpt)
    np.testing.assert_allclose(tex.r_max, jex.r_max, rtol=1e-5)
    # n* = b / TPT lands on whole numbers here, where ceil() turns a 1-ulp
    # difference into a whole thread: compare the real-valued n*
    np.testing.assert_allclose(tex.n_star, jex.n_star, rtol=1e-5)


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.make_table(TABLE_TPT, TABLE_BW)
    assert tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP,
                                device="cpu").tpt.device.type == "cpu"


def test_schedule_helpers_match_reference():
    jt = jsched.make_table(TABLE_TPT, TABLE_BW, bin_seconds=2.0)
    tt = tsched.make_table(TABLE_TPT, TABLE_BW, 2.0, device="cpu")
    for t in (-1.0, 0.0, 1.99, 2.0, 3.5, 100.0):
        for a, b in zip(tsched.schedule_at(tt, t), jsched.schedule_at(jt, t)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tsched.peak_bw(tt).numpy(),
                                  np.asarray(jsched.peak_bw(jt)))
    np.testing.assert_array_equal(
        tsched.bottleneck_trace(tt, 12.0).numpy(),
        np.asarray(jsched.bottleneck_trace(jt, 12.0)))
    batch = tsched.stack_tables([tt, tt])
    assert batch.tpt.shape == (2, 2, 3) and batch.bin_seconds.shape == (2,)
    tpt, bw = tsched.schedule_at(batch, torch.tensor([0.5, 2.5]))
    np.testing.assert_array_equal(tpt.numpy(), TABLE_TPT)
    np.testing.assert_array_equal(tsched.peak_bw(batch).numpy(), [2.0, 2.0])
    const = tsched.constant_table(TPT, BW, device="cpu")
    assert const.tpt.shape == (1, 3)
    with pytest.raises(ValueError):
        tsched.make_table(TABLE_TPT, TABLE_BW[:1], device="cpu")


def test_utility_functions_match_reference():
    rng = np.random.default_rng(2)
    tps = rng.uniform(0, 2, (5, 3)).astype(np.float32)
    n = rng.integers(1, 40, (5, 3)).astype(np.float32)
    _close(tutil.utility(torch.from_numpy(tps), torch.from_numpy(n)),
           jutil.utility(tps, n), atol=1e-6)
    _close(tutil.stage_utility(torch.from_numpy(tps), torch.from_numpy(n)),
           jutil.stage_utility(tps, n), atol=1e-6)
    _close(tutil.flow_utility(torch.from_numpy(tps), torch.from_numpy(n),
                              weight=[1, 2, 3, 4, 5]),
           jutil.flow_utility(tps, n, weight=[1, 2, 3, 4, 5]), atol=1e-5)
    np.testing.assert_allclose(tutil.r_max(1.0, [13, 7.2, 5]),
                               jutil.r_max(1.0, [13, 7.2, 5]), rtol=1e-6)
    demand = np.asarray([10.0, np.inf, 5.0, 8.0], np.float32)
    deadline = np.asarray([20.0, 30.0, np.inf, 3.0], np.float32)
    delivered = np.asarray([2.0, 1.0, 1.0, 9.0], np.float32)
    need_j = jutil.needed_rate(demand, delivered, deadline, 4.0)
    need_t = tutil.needed_rate(demand, torch.from_numpy(delivered),
                               deadline, 4.0)
    np.testing.assert_array_equal(need_t.numpy(), np.asarray(need_j))
    np.testing.assert_array_equal(
        tutil.needed_rate_np(demand, delivered, deadline, 4.0),
        np.asarray(need_j))
    good = np.asarray([0.1, 0.5, 3.0, 0.0], np.float32)
    _close(tutil.deadline_penalty(torch.from_numpy(good), need_t, scale=2.0),
           jutil.deadline_penalty(good, need_j, scale=2.0), atol=1e-6)
