"""The port's fleet core (``repro_torch.core.fleet``) against the JAX
package's, env by env, on NumPy-made inputs.

The interval solve and integration (dense and compact ``max_active``,
with and without objectives) are held to the reference's
``fleet_interval(backend="jnp")`` at 1e-5, the sim-kernel tolerance of the
reference's own tests; observations and rewards of ``fleet_step`` at 1e-5.
The reference's initial threads come from its key stream and are handed
to the port's ``fleet_reset``. The exact-zero claims (inactive flows move
nothing, padding leaves the reward alone, F=1 is the single-flow
simulator) are pinned exactly where the reference pins them exactly."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import fleet as jf, simulator as jsim
from repro.core.schedule import make_table as jax_make_table

from repro_torch.core import fleet as tf, simulator as tsim
from repro_torch.core.schedule import make_table, stack_tables

E, F, T, BIN, S = 3, 12, 4, 2.0, 10
TPT, BW, CAP = [0.2, 0.15, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]


def world(seed):
    """Per-env condition tables, staggered activity windows (at most a few
    flows live at once), threads, buffers, start times and objectives."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    ts = np.sort(rng.uniform(0.0, 14.0, (E, F)), axis=1)
    w = dict(
        tpt=f32(rng.uniform(0.05, 0.3, (E, T, 3))),
        bw=f32(rng.uniform(0.5, 1.5, (E, T, 3))),
        t_start=f32(ts), t_end=f32(ts + rng.uniform(1.0, 2.5, (E, F))),
        threads=f32(rng.integers(1, 30, (E, F, 3))),
        buffers=f32(rng.uniform(0.0, 1.0, (E, F, 2))),
        t0=f32(rng.uniform(0.0, 12.0, E)),
        weight=f32(rng.choice([1.0, 2.0, 4.0], (E, F))),
        deadline=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                              rng.uniform(3.0, 12.0, (E, F)))),
        demand=f32(rng.uniform(0.5, 4.0, (E, F))),
        rate_floor=f32(rng.uniform(0.0, 0.3, (E, F))),
        rate_cap=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                              rng.uniform(0.05, 1.0, (E, F)))))
    return w


def params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


def port_world(w, objectives, device="cpu"):
    tab = stack_tables([make_table(w["tpt"][e], w["bw"][e], BIN,
                                   device=device) for e in range(E)])
    to = lambda k: torch.from_numpy(w[k]).to(device)
    flows = tf.FlowSchedule(to("t_start"), to("t_end"))
    objs = (tf.FlowObjective(*(to(k) for k in tf.FlowObjective._fields))
            if objectives else None)
    return tab, flows, objs


def ref_world(w, e, objectives):
    tab = jax_make_table(w["tpt"][e], w["bw"][e], BIN)
    flows = jf.make_flow_schedule(w["t_start"][e], w["t_end"][e])
    objs = (jf.make_flow_objective(**{k: w[k][e]
                                      for k in jf.FlowObjective._fields})
            if objectives else None)
    return tab, flows, objs


def compact_bound(w, jparams):
    flows = jf.FlowSchedule(jnp.asarray(w["t_start"]),
                            jnp.asarray(w["t_end"]))
    A = jf.flow_bucket(jf.max_concurrent_flows(
        flows, window=float(jparams.duration)))
    assert A < F, "the world must leave the compact path something to drop"
    return A


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "sparse"])
def test_fleet_interval_matches_reference(seed, compact):
    w = world(seed)
    jp, tp = params()
    A = compact_bound(w, jp) if compact else None
    for objectives in (False, True):
        tab, flows, objs = port_world(w, objectives)
        bufs, tps = tf.fleet_interval(
            tp, torch.from_numpy(w["buffers"]), torch.from_numpy(w["threads"]),
            torch.from_numpy(w["t0"]), flows=flows, table=tab, substeps=S,
            objectives=objs, max_active=A)
        for e in range(E):
            jtab, jflows, jobjs = ref_world(w, e, objectives)
            rb, rt = jf.fleet_interval(
                jp, jnp.asarray(w["buffers"][e]),
                jnp.asarray(w["threads"][e]), w["t0"][e], flows=jflows,
                table=jtab, substeps=S, backend="jnp", objectives=jobjs,
                max_active=A)
            np.testing.assert_allclose(bufs[e].numpy(), np.asarray(rb),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(tps[e].numpy(), np.asarray(rt),
                                       atol=1e-5, rtol=0)


def test_plain_dense_solve_is_the_kernel_path_on_the_one_link_embedding():
    """``_fleet_substep_rates`` (the plain dense solve) and
    ``_solve_fleet_rates`` (the gathers, then K3's plain version with
    onpath all ones) agree; both match the reference's dense solve."""
    w = world(4)
    jp, tp = params()
    for objectives in (False, True):
        tab, flows, objs = port_world(w, objectives)
        args = (tp, tab, torch.from_numpy(w["threads"]), flows,
                torch.from_numpy(w["t0"]), S, objs)
        dense = tf._fleet_substep_rates(*args)
        kern = tf._solve_fleet_rates(*args)
        assert dense.shape == (E, S, F, 3)
        np.testing.assert_allclose(kern.numpy(), dense.numpy(), atol=1e-6,
                                   rtol=0)
        for e in range(E):
            jtab, jflows, jobjs = ref_world(w, e, objectives)
            want = jf._fleet_substep_rates(
                jp, jtab, jnp.asarray(w["threads"][e]), jflows,
                jnp.float32(w["t0"][e]), S, jobjs)
            np.testing.assert_allclose(dense[e].numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_one_flow_is_the_single_flow_simulator():
    w = world(5)
    _, tp = params()
    tab, _, _ = port_world(w, False)
    one = tf.always_on(1, device="cpu")
    flows = tf.FlowSchedule(one.t_start.expand(E, 1),
                            one.t_end.expand(E, 1))
    bufs, tps = tf.fleet_interval(
        tp, torch.from_numpy(w["buffers"][:, :1]),
        torch.from_numpy(w["threads"][:, :1]), torch.from_numpy(w["t0"]),
        flows=flows, table=tab, substeps=S)
    sb, st = tsim.sim_interval(tp, torch.from_numpy(w["buffers"][:, 0]),
                               torch.from_numpy(w["threads"][:, 0]),
                               torch.from_numpy(w["t0"]), table=tab,
                               substeps=S)
    assert torch.equal(bufs[:, 0], sb) and torch.equal(tps[:, 0], st)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_all_inactive_interval_moves_exactly_nothing(seed, device):
    """Dense, compact and (on the card) the kernels' path alike."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    w = world(seed)
    tp = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                              device=device)
    w["t_start"][:] = w["t0"][:, None] + float(tp.duration) + 1.0
    w["t_end"][:] = np.inf
    buffers = torch.from_numpy(w["buffers"]).to(device)
    for A in (None, F - 1):
        for objectives in (False, True):
            tab, flows, objs = port_world(w, objectives, device)
            bufs, tps = tf.fleet_interval(
                tp, buffers, torch.from_numpy(w["threads"]).to(device),
                torch.from_numpy(w["t0"]).to(device), flows=flows,
                table=tab, substeps=S, objectives=objs, max_active=A)
            assert tps.max() == 0.0, (A, objectives)
            assert torch.equal(bufs, buffers), (A, objectives)


def _reference_steps(w, e, jp, objectives, A, actions, spec, key):
    jtab, jflows, jobjs = ref_world(w, e, objectives)
    st = jf.fleet_reset(jp, key, F, w["t0"][e], flows=jflows, table=jtab,
                        substeps=S, spec=spec, objectives=jobjs,
                        max_active=A)
    obs0 = jf.fleet_observe(jp, st, flows=jflows, table=jtab, spec=spec,
                            objectives=jobjs, max_active=A)
    st, obs, rew = jf.fleet_step(
        jp, st, jnp.asarray(actions[e]), flows=jflows, table=jtab,
        substeps=S, spec=spec, fairness_coef=0.5, objectives=jobjs,
        deadline_coef=1.3, max_active=A)
    return obs0, st, obs, rew


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("objectives", [False, True],
                         ids=["no_objectives", "objectives"])
def test_reset_observe_step_and_reward_match_reference(compact, objectives):
    w = world(6)
    jp, tp = params()
    A = compact_bound(w, jp) if compact else None
    rng = np.random.default_rng(60)
    # integer + 0.3: no action near a .5 rounding tie
    actions = (rng.integers(1, 40, (E, F, 3)) + 0.3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), E)
    threads0 = np.stack([np.asarray(jax.random.randint(k, (F, 3), 1, 16))
                         for k in keys]).astype(np.float32)
    spec = jsim.OBJECTIVE_OBS
    tspec = tsim.OBJECTIVE_OBS
    tab, flows, objs = port_world(w, objectives)
    st = tf.fleet_reset(tp, E, F, torch.from_numpy(w["t0"]), flows=flows,
                        table=tab, substeps=S, objectives=objs,
                        max_active=A, threads=torch.from_numpy(threads0))
    obs0 = tf.fleet_observe(tp, st, flows=flows, table=tab, spec=tspec,
                            objectives=objs, max_active=A)
    st, obs, rew = tf.fleet_step(
        tp, st, torch.from_numpy(actions), flows=flows, table=tab,
        substeps=S, spec=tspec, fairness_coef=0.5, objectives=objs,
        deadline_coef=1.3, max_active=A)
    assert obs.shape == (E, F, tspec.frame_dim) and rew.shape == (E,)
    for e in range(E):
        jobs0, jst, jobs, jrew = _reference_steps(w, e, jp, objectives, A,
                                                  actions, spec, keys[e])
        for got, want in ((obs0[e], jobs0), (obs[e], jobs),
                          (st.buffers[e], jst.buffers),
                          (st.throughputs[e], jst.throughputs),
                          (st.delivered[e], jst.delivered)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
        assert float(st.t[e]) == float(jst.t)
        np.testing.assert_allclose(float(rew[e]), float(jrew), atol=1e-5,
                                   rtol=0)


def test_compact_path_equals_dense_path():
    w = world(7)
    jp, tp = params()
    A = compact_bound(w, jp)
    tab, flows, objs = port_world(w, True)
    acts = torch.full((E, F, 3), 9.0)
    out = []
    for ma in (None, A):
        st = tf.fleet_reset(tp, E, F, torch.from_numpy(w["t0"]), flows=flows,
                            table=tab, substeps=S, objectives=objs,
                            max_active=ma,
                            threads=torch.from_numpy(w["threads"]))
        out.append(tf.fleet_step(tp, st, acts, flows=flows, table=tab,
                                 substeps=S, spec=tsim.OBJECTIVE_OBS,
                                 fairness_coef=0.5, objectives=objs,
                                 max_active=ma))
    (d_st, _, d_rew), (s_st, _, s_rew) = out
    np.testing.assert_allclose(s_st.throughputs.numpy(),
                               d_st.throughputs.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(s_rew.numpy(), d_rew.numpy(), atol=1e-5,
                               rtol=0)


def test_padding_to_the_bucket_leaves_the_reward_unchanged():
    w = world(8)
    _, tp = params()
    tab, flows, objs = port_world(w, True)
    n_to = tf.flow_bucket(F + 1)
    pad = n_to - F
    pflows = tf.pad_flow_schedule(flows, n_to)
    pobjs = tf.pad_flow_objectives(objs, n_to)
    threads = torch.from_numpy(w["threads"])
    pthreads = torch.cat([threads, torch.full((E, pad, 3), 5.0)], dim=1)
    acts = torch.from_numpy(w["threads"]) + 0.3
    pacts = torch.cat([acts, torch.full((E, pad, 3), 7.3)], dim=1)
    out = []
    for fl, ob, th, ac in ((flows, objs, threads, acts),
                           (pflows, pobjs, pthreads, pacts)):
        st = tf.fleet_reset(tp, E, fl.n_flows, torch.from_numpy(w["t0"]),
                            flows=fl, table=tab, substeps=S, objectives=ob,
                            threads=th)
        out.append(tf.fleet_step(tp, st, ac, flows=fl, table=tab,
                                 substeps=S, spec=tsim.OBJECTIVE_OBS,
                                 fairness_coef=0.5, objectives=ob))
    (st, obs, rew), (pst, pobs, prew) = out
    assert pobs.shape == (E, n_to, tsim.OBJECTIVE_OBS.frame_dim)
    assert torch.all(pst.throughputs[:, F:] == 0.0)
    np.testing.assert_allclose(prew.numpy(), rew.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pobs[:, :F, :13].numpy(),
                               obs[:, :, :13].numpy(), atol=1e-6, rtol=0)


def test_jain_index_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.uniform(0.0, 1.0, (5, 7)).astype(np.float32)
    act = (rng.random((5, 7)) < 0.6).astype(np.float32)
    wts = rng.choice([1.0, 2.0, 4.0], (5, 7)).astype(np.float32)
    x[0] = 0.0                      # all-zero fleet scores 1.0
    act[1] = 0.0                    # empty fleet scores 1.0
    got = tf.jain_index(torch.from_numpy(x), torch.from_numpy(act),
                        weights=torch.from_numpy(wts)).numpy()
    plain = tf.jain_index(torch.from_numpy(x)).numpy()
    for e in range(5):
        np.testing.assert_allclose(got[e], float(jf.jain_index(
            x[e], act[e], weights=wts[e])), atol=1e-6, rtol=0)
        np.testing.assert_allclose(plain[e], float(jf.jain_index(x[e])),
                                   atol=1e-6, rtol=0)
    assert got[0] == 1.0 and got[1] == 1.0


def test_achievable_and_objective_features_match_reference():
    w = world(10)
    jp, tp = params()
    tab, flows, objs = port_world(w, True)
    t = torch.from_numpy(w["t0"])
    ach = tf.fleet_achievable(tp, tab, flows, t)
    delivered = torch.from_numpy(w["demand"] * 0.3)
    bw_ref = torch.full((E,), 1.3)
    feats = tf.objective_features(objs, t, delivered, bw_ref=bw_ref,
                                  duration=tp.duration)
    for e in range(E):
        jtab, jflows, jobjs = ref_world(w, e, True)
        np.testing.assert_allclose(
            float(ach[e]), float(jf.fleet_achievable(jp, jtab, jflows,
                                                     w["t0"][e])),
            atol=1e-6, rtol=0)
        want = jf.objective_features(jobjs, w["t0"][e],
                                     jnp.asarray(delivered[e].numpy()),
                                     bw_ref=1.3, duration=jp.duration)
        np.testing.assert_allclose(feats[e].numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            tf.objective_features_np(jobjs, w["t0"][e],
                                     delivered[e].numpy(), bw_ref=1.3),
            np.asarray(want), atol=1e-6, rtol=0)


def test_max_concurrent_flows_and_bucket_match_reference():
    w = world(11)
    ref = jf.FlowSchedule(jnp.asarray(w["t_start"]), jnp.asarray(w["t_end"]))
    port = tf.FlowSchedule(torch.from_numpy(w["t_start"]),
                           torch.from_numpy(w["t_end"]))
    for window in (0.0, 1.0, 3.0):
        assert (tf.max_concurrent_flows(port, window=window)
                == jf.max_concurrent_flows(ref, window=window))
    assert [tf.flow_bucket(n) for n in (0, 1, 3, 4, 5, 257)] == \
        [jf.flow_bucket(n) for n in (0, 1, 3, 4, 5, 257)]
