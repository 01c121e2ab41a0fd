"""The topology's compact-active-set path (``max_active < F``) of the port
against the JAX package's compact path and against the port's own dense
path, on NumPy-made inputs from fixed seeds.

These are the port's counterparts of ``tests/test_fleet_scaleout.py``'s
topology cases: the compact interval, step and observation equal the dense
ones on both sides and the port equals the reference, within 1e-6 without
finite caps (float32 reassociation of the flow sums over A instead of F
flows) and 1e-5 with caps (the reference's compact path runs the sorted
water-fill, the port K3's A spill rounds, whose fixed point it is).
``_sorted_water_fill`` is held to the reference's and to K3's plain round
loop (bitwise without finite caps). A compact interval in which no flow is
active moves exactly nothing. One topology episode batch with
``max_active < F`` is held against the reference's on copied params and
explicit noise at the rollout tolerance of ``test_torch_topology_ppo``.

Every world is drawn from a fixed NumPy seed; the reference's initial
threads and action noise come from fixed JAX keys."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import fleet as jf, simulator as jsim, topology as jt
from repro.core import ppo as jppo

from repro_torch.convert import params_from_jax
from repro_torch.core import fleet as tf, simulator as tsim, topology as tt
from repro_torch.core import ppo as tppo
from repro_torch.kernels.contention.ref import contention_rates_reference
from repro_torch.optim import adamw_init

from test_torch_fleet_ppo import assert_clear_of_rounding_ties, _close

E, F, S, BIN = 2, 12, 10, 0.5
TPT, BW, CAP = [0.2, 0.15, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]
# per-link scales of the one schedule the graph is built from, as in
# tests/test_fleet_scaleout.py (tpt x1, x0.8, ...; bw x1, x1.2, ...)
TPT_SCALE, BW_SCALE = (1.0, 0.8, 0.6), (1.0, 1.2, 1.4)


def tol(caps):
    return 1e-5 if caps else 1e-6


def params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


def world(seed, n_links, *, n_envs=E, n_flows=F, n_bins=2, bin_s=BIN,
          span=5.0, dur=(0.5, 2.5)):
    """Per-env graphs of ``n_links`` links scaled from one 3-stage schedule,
    two route bins (every flow on a link, flow 0 pathless in bin 1),
    staggered activity windows, threads, buffers, clocks and objectives:
    tiers, half the deadlines and demands finite, small floors and half
    the caps finite below a fair share of a link, so the spill rounds move
    bandwidth."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    base_t = rng.uniform(0.05, 0.3, (n_envs, n_bins, 3))
    base_b = rng.uniform(0.5, 1.5, (n_envs, n_bins, 3))
    link = np.arange(n_links)
    onpath = f32(rng.integers(0, 2, (n_envs, 2, n_flows, n_links)))
    onpath[..., rng.integers(0, n_links, n_flows)[:, None] == link] = 1.0
    onpath[:, 1, 0] = 0.0
    ts = rng.uniform(0.0, span, (n_envs, n_flows))
    shape = (n_envs, n_flows)
    return dict(
        tpt=f32(base_t[:, None] * np.asarray(TPT_SCALE)[link, None, None]),
        bw=f32(base_b[:, None] * np.asarray(BW_SCALE)[link, None, None]),
        bin_seconds=f32(np.full(n_envs, bin_s)),
        onpath=onpath, route_bin=f32(rng.uniform(1.0, 4.0, n_envs)),
        t_start=f32(ts), t_end=f32(ts + rng.uniform(*dur, shape)),
        threads=f32(rng.integers(1, 30, shape + (3,))),
        buffers=f32(rng.uniform(0.0, 0.5, shape + (2,))),
        t0=f32(rng.uniform(1.5, 3.5, n_envs)),
        weight=f32(rng.choice([1.0, 2.0, 4.0], shape)),
        deadline=f32(np.where(rng.random(shape) < 0.5, np.inf,
                              rng.uniform(1.0, 8.0, shape))),
        demand=f32(np.where(rng.random(shape) < 0.5, np.inf,
                            rng.uniform(0.5, 4.0, shape))),
        rate_floor=f32(rng.uniform(0.0, 0.1, shape)),
        rate_cap=f32(np.where(rng.random(shape) < 0.5, np.inf,
                              rng.uniform(0.02, 0.3, shape))))


def no_caps(w):
    return dict(w, rate_cap=np.full_like(w["rate_cap"], np.inf))


def port_world(w, objectives=True):
    t = lambda k: torch.from_numpy(w[k])
    graph = tt.LinkGraph(t("tpt"), t("bw"), t("bin_seconds"))
    paths = tt.PathSpec(t("onpath"), t("route_bin"))
    flows = tf.FlowSchedule(t("t_start"), t("t_end"))
    objs = (tf.FlowObjective(*(t(k) for k in tf.FlowObjective._fields))
            if objectives else None)
    return dict(graph=graph, paths=paths, flows=flows, objectives=objs)


def reference_env(w, e, objectives=True):
    return dict(
        graph=jt.make_link_graph(w["tpt"][e], w["bw"][e],
                                 w["bin_seconds"][e]),
        paths=jt.make_path_spec(w["onpath"][e], w["route_bin"][e]),
        flows=jf.make_flow_schedule(w["t_start"][e], w["t_end"][e]),
        objectives=(jf.FlowObjective(*(jnp.asarray(w[k][e]) for k in
                                       jf.FlowObjective._fields))
                    if objectives else None))


def bound(w, duration):
    """The tightest ``max_active``: the most flows any one interval's
    window can touch (``max_concurrent_flows``), below F in every world
    here."""
    A = tf.max_concurrent_flows(
        tf.FlowSchedule(w["t_start"], w["t_end"]), window=duration)
    assert A < w["t_start"].shape[1]
    return A


def hits(w, t, duration):
    """(E, F) the flows whose window intersects [t, t + duration)."""
    return ((w["t_start"] < (t + duration)[:, None])
            & (w["t_end"] > t[:, None]))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# The interval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("caps", [False, True], ids=["floors", "caps"])
def test_compact_interval_matches_dense_and_reference(seed, caps):
    """tests/test_fleet_scaleout.py:132's counterpart: compact == dense on
    the port and on the reference, and the port's compact interval == the
    reference's, env by env; flows outside the window keep their buffers
    and move exactly nothing."""
    jp, tp = params()
    L = 2 + seed % 2
    w = world(seed, L)
    w = w if caps else no_caps(w)
    A = bound(w, 1.0)
    pw = port_world(w)
    t0 = torch.from_numpy(w["t0"])
    bufs, threads = (torch.from_numpy(w[k]) for k in ("buffers", "threads"))
    dense = tt.topology_interval(tp, bufs, threads, t0, substeps=S, **pw)
    comp = tt.topology_interval(tp, bufs, threads, t0, substeps=S,
                                max_active=A, **pw)
    for c, d in zip(comp, dense):
        close(c, d, tol(caps))
    out = ~hits(w, w["t0"], 1.0)
    assert out.any()
    assert float(comp[1].numpy()[out].max()) == 0.0
    assert np.array_equal(comp[0].numpy()[out], w["buffers"][out])
    for e in range(E):
        ref = reference_env(w, e)
        args = (jp, jnp.asarray(w["buffers"][e]), jnp.asarray(w["threads"][e]),
                float(w["t0"][e]))
        r_comp = jt.topology_interval(*args, substeps=S, max_active=A, **ref)
        r_dense = jt.topology_interval(*args, substeps=S, **ref)
        for c, rc, rd in zip(comp, r_comp, r_dense):
            close(rc, rd, tol(caps))
            close(c[e], rc, tol(caps))


def test_compact_interval_pads_like_the_reference():
    """The reference test's own layout: two never-active, pathless padded
    flows and ``max_active = F``; the padded rows move nothing."""
    _, tp = params()
    w = world(7, 3)
    pw = port_world(w)
    t0 = torch.from_numpy(w["t0"])
    bufs, threads = (torch.from_numpy(w[k]) for k in ("buffers", "threads"))
    dense = tt.topology_interval(tp, bufs, threads, t0, substeps=S, **pw)
    padded = dict(graph=pw["graph"],
                  paths=tt.pad_path_spec(pw["paths"], F + 2),
                  flows=tf.pad_flow_schedule(pw["flows"], F + 2),
                  objectives=tf.pad_flow_objectives(pw["objectives"], F + 2))
    got = tt.topology_interval(
        tp, torch.cat([bufs, torch.zeros(E, 2, 2)], dim=1),
        torch.cat([threads, torch.ones(E, 2, 3)], dim=1), t0, substeps=S,
        max_active=F, **padded)
    for g, d in zip(got, dense):
        close(g[:, :F], d, 1e-5)
        assert float(g[:, F:].abs().max()) == 0.0


@pytest.mark.parametrize("seed", range(2))
def test_compact_interval_with_no_active_flow_moves_zero_bytes(seed):
    """tests/test_fleet_scaleout.py:194's counterpart for the topology: an
    interval no flow's window intersects moves EXACTLY zero bytes on the
    compact path (an empty gather) as on the dense one, objectives and
    caps included."""
    _, tp = params()
    w = world(seed, 3)
    late = float(tp.duration) + 1.0
    w = dict(w, t_start=np.full_like(w["t_start"], late),
             t_end=np.full_like(w["t_end"], np.inf))
    bufs, threads = (torch.from_numpy(w[k]) for k in ("buffers", "threads"))
    for objectives in (False, True):
        pw = port_world(w, objectives)
        for ma in (None, F - 1):
            got_b, got_t = tt.topology_interval(
                tp, bufs, threads, torch.zeros(E), substeps=S,
                max_active=ma, **pw)
            assert float(got_t.abs().max()) == 0.0, (objectives, ma)
            assert torch.equal(got_b, bufs), (objectives, ma)


# ---------------------------------------------------------------------------
# The water-fill's fixed point
# ---------------------------------------------------------------------------


def k3_operands(w, tp, n_flows=None):
    """K3's operands of one interval of the world at its clocks (the
    topology solve's gathers), floors and caps included."""
    pw = port_world(w)
    t0 = torch.from_numpy(w["t0"])
    ts, tpt, bw = tt._link_conditions(tp, pw["graph"], t0, S)
    return (torch.from_numpy(w["threads"]), tf.active_at(pw["flows"], ts),
            tt.routes_at(pw["paths"], ts), tpt, bw,
            pw["objectives"].rate_floor, pw["objectives"].rate_cap)


@pytest.mark.parametrize("seed", range(3))
def test_sorted_water_fill_matches_reference_and_round_loop(seed):
    """tests/test_fleet_scaleout.py:171's counterpart: the port's
    ``_sorted_water_fill`` equals the reference's on the same operands,
    and the solve with it equals K3's plain round loop with rounds = F
    (1e-5) and the reference's sorted solve; with no finite cap both fills
    are exact no-ops, bit for bit."""
    jp, tp = params()
    w = world(seed, 2 + seed % 2)
    args = k3_operands(w, tp)
    seen = []

    def fill(*a):
        seen.append(a)
        return tt._sorted_water_fill(*a)

    got = contention_rates_reference(*args, fill=fill)
    alloc, headroom, eff, lam0 = seen[0]
    for e in range(E):
        want = jt._sorted_water_fill(*(jnp.asarray(x[e].numpy()) for x in
                                       (alloc, headroom, eff, lam0)))
        close(tt._sorted_water_fill(alloc, headroom, eff, lam0)[e], want,
              1e-6)
    loop = contention_rates_reference(*args, rounds=F)
    still = contention_rates_reference(*args, rounds=0)
    assert float((loop - still).abs().max()) > 1e-3   # the rounds spilled
    close(got, loop, 1e-5)
    for e in range(E):
        ref = reference_env(w, e)
        want = jt._topology_substep_rates(
            jp, ref["graph"], ref["paths"], jnp.asarray(w["threads"][e]),
            ref["flows"], jnp.float32(w["t0"][e]), S, ref["objectives"],
            water_fill="sorted")
        close(got[e], want, 1e-5)
    free = list(args)
    free[6] = torch.full_like(args[6], float("inf"))
    assert torch.equal(
        contention_rates_reference(*free, fill=tt._sorted_water_fill),
        contention_rates_reference(*free, rounds=F))


# ---------------------------------------------------------------------------
# Observation, reset and step
# ---------------------------------------------------------------------------


def reference_threads(seed, n_envs=E, n_flows=F):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)
    threads = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (n_flows, 3), 1, 16))(keys),
        np.float32)
    return torch.from_numpy(threads), keys


def reference_state(state, e):
    return jf.FleetState(*(jnp.asarray(x[e].numpy()) for x in state))


@pytest.mark.parametrize("seed", range(3))
def test_compact_observe_rows_match_dense_and_reference(seed):
    """topology_observe(max_active=): the rows of the flows whose window
    intersects [t, t + duration) within 1e-6 of the dense observation
    (fleet, objective and topology blocks), every other row EXACTLY zero,
    and the port's compact rows equal to the reference's."""
    jp, tp = params()
    w = world(seed + 10, 2 + seed % 2)
    A = bound(w, 1.0)
    pw = port_world(w)
    threads, keys = reference_threads(seed)
    state = tt.topology_reset(tp, E, F, torch.from_numpy(w["t0"]),
                              substeps=S, threads=threads, **pw)
    spec = tsim.ObservationSpec(context=True, fleet=True, objectives=True,
                                topology=True)
    dense = tt.topology_observe(tp, state, spec=spec, **pw).numpy()
    comp = tt.topology_observe(tp, state, spec=spec, max_active=A,
                               **pw).numpy()
    hit = hits(w, state.t.numpy(), 1.0)
    assert hit.any() and not hit.all()
    close(comp[hit], dense[hit], 1e-6)
    assert np.abs(comp[~hit]).max() == 0.0
    jspec = jsim.ObservationSpec(**spec._asdict())
    for e in range(E):
        want = jt.topology_observe(jp, reference_state(state, e), spec=jspec,
                                   max_active=A, **reference_env(w, e))
        close(comp[e], want, 1e-6)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("caps", [False, True], ids=["floors", "caps"])
def test_compact_step_matches_dense_and_reference(seed, caps):
    """tests/test_fleet_scaleout.py:594's counterpart: reset and three
    steps with ``max_active`` (the reward scored on the interval's gather,
    the topology block rebuilt from the compact set) against the dense
    steps (state within the interval tolerance, reward within 1e-5, the
    gathered observation rows within 2e-6 and the rest exactly zero) and
    against the reference's compact reset and steps."""
    jp, tp = params()
    w = world(seed + 20, 3)
    w = w if caps else no_caps(w)
    A = bound(w, 1.0)
    pw = port_world(w)
    spec = tsim.ObservationSpec(context=True, fleet=True, objectives=True,
                                topology=True)
    jspec = jsim.ObservationSpec(**spec._asdict())
    threads, keys = reference_threads(seed)
    t0 = torch.full((E,), 0.5)
    kw = dict(substeps=S, **pw)
    comp = tt.topology_reset(tp, E, F, t0, threads=threads, max_active=A,
                             **kw)
    dense = tt.topology_reset(tp, E, F, t0, threads=threads, **kw)
    refs = [reference_env(w, e) for e in range(E)]
    jstates = [jt.topology_reset(jp, keys[e], F, 0.5, substeps=S,
                                 max_active=A, **refs[e]) for e in range(E)]
    rng = np.random.default_rng(seed)
    for _ in range(3):
        acts = torch.from_numpy(
            rng.uniform(1.0, 30.0, (E, F, 3)).astype(np.float32))
        step = dict(spec=spec, fairness_coef=0.3, **kw)
        comp, c_obs, c_rew = tt.topology_step(tp, comp, acts, max_active=A,
                                              **step)
        dense, d_obs, d_rew = tt.topology_step(tp, dense, acts, **step)
        for c, d in zip(comp, dense):
            close(c, d, tol(caps))
        np.testing.assert_allclose(c_rew.numpy(), d_rew.numpy(), rtol=1e-5,
                                   atol=1e-5)
        hit = hits(w, comp.t.numpy(), 1.0)
        close(c_obs.numpy()[hit], d_obs.numpy()[hit], max(2e-6, tol(caps)))
        assert np.abs(c_obs.numpy()[~hit]).max(initial=0.0) == 0.0
        for e in range(E):
            jstates[e], j_obs, j_rew = jt.topology_step(
                jp, jstates[e], jnp.asarray(acts[e].numpy()), substeps=S,
                spec=jspec, fairness_coef=0.3, max_active=A, **refs[e])
            for c, j in zip(comp, jstates[e]):
                close(c[e], j, tol(caps))
            np.testing.assert_allclose(float(c_rew[e]), float(j_rew),
                                       rtol=1e-5, atol=1e-5)
            close(c_obs[e], j_obs, max(2e-6, tol(caps)))


# ---------------------------------------------------------------------------
# One topology PPO episode batch with max_active < F
# ---------------------------------------------------------------------------

PPO_E, PPO_F, PPO_M, PPO_T = 3, 8, 6, 12


def ppo_worlds(seed=5):
    """A topology training world of PPO_F flows over 3 links and PPO_T
    one-second bins whose concurrency stays below PPO_F, objectives with
    floors and finite caps; the reference's and the port's."""
    w = world(seed, 3, n_envs=PPO_E, n_flows=PPO_F, n_bins=PPO_T, bin_s=1.0,
              span=9.0, dur=(1.0, 3.0))
    A = bound(w, 1.0)
    jtopo = jt.Topology(
        jt.LinkGraph(jnp.asarray(w["tpt"]), jnp.asarray(w["bw"]),
                     jnp.asarray(w["bin_seconds"])),
        jt.PathSpec(jnp.asarray(w["onpath"]), jnp.asarray(w["route_bin"])))
    jflows = jf.FlowSchedule(jnp.asarray(w["t_start"]),
                             jnp.asarray(w["t_end"]))
    jobjs = jf.FlowObjective(*(jnp.asarray(w[k])
                               for k in jf.FlowObjective._fields))
    pw = port_world(w)
    ttopo = tt.Topology(pw["graph"], pw["paths"])
    return A, (jtopo, jflows, jobjs), (ttopo, pw["flows"], pw["objectives"])


def ppo_draws(keys):
    """The reference topology rollout's draws for each env key: initial
    threads (E, F, 3), the start-time uniform (E,), noise (M, E, F, 3)."""
    def one(k):
        k_reset, k_t0, k_steps = jax.random.split(k, 3)
        noise = jax.vmap(lambda km: jax.random.normal(km, (PPO_F, 3)))(
            jax.random.split(k_steps, PPO_M))
        return (jax.random.randint(k_reset, (PPO_F, 3), 1, 16),
                jax.random.uniform(k_t0, ()), noise)
    threads, u, noise = jax.jit(jax.vmap(one))(keys)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return t(threads), t(u), t(noise).transpose(0, 1).contiguous()


def test_compact_topology_episode_matches_reference():
    """One topology episode batch (rollout, shared returns, one update's
    loss) with ``max_active < F`` over floors and finite caps, against the
    reference's jitted compact episode on copied params and the
    reference's own draws: the rollout, rewards and loss within 1e-5. (A
    compact rollout is not the dense one: a flow outside the observation
    window sees a zero row, so its next action, and the thread count the
    next observation shows, differ from the dense run's.)"""
    A, ref_world, (ttopo, tflows, tobjs) = ppo_worlds()
    jcfg = jppo.PPOConfig(policy="mlp", obs_spec=jsim.TOPOLOGY_OBS,
                          action_scale=12.5, n_envs=PPO_E,
                          max_steps=PPO_M, n_flows=PPO_F, fairness_coef=0.5,
                          ppo_epochs=1, max_active=A)
    tcfg = tppo.PPOConfig(policy="mlp", obs_spec=tsim.TOPOLOGY_OBS,
                          action_scale=12.5, n_envs=PPO_E, max_steps=PPO_M,
                          n_flows=PPO_F, fairness_coef=0.5, ppo_epochs=1,
                          max_active=A, device="cpu")
    jenv, tenv = params()
    state = jax.jit(lambda k: jppo.init_agent(k, jcfg))(
        jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(106)
    ref_fn = jppo._make_episode_fn(jenv, jcfg, randomize_t0=True,
                                   topology=True)
    _, ref_rew, ref_loss = ref_fn(state, None, ref_world[1], ref_world[2],
                                  ref_world[0], key)
    keys = jax.random.split(jax.random.split(key)[0], PPO_E)
    spec = jppo.effective_obs_spec(jcfg)
    ref_roll = jax.jit(jax.vmap(lambda tp, fl, ob, k: jppo._rollout_topology(
        state["params"]["policy"], jenv, tp, fl, ob, k, M=PPO_M, substeps=50,
        spec=spec, backend="jnp", randomize_t0=True, policy="mlp",
        n_flows=PPO_F, fairness_coef=0.5, deadline_coef=1.0,
        max_active=A)))(*ref_world, keys)
    assert_clear_of_rounding_ties(ref_roll[1])
    threads0, t0_draw, noise = ppo_draws(keys)
    draws = dict(threads0=threads0, t0_draw=t0_draw, noise=noise)
    agent = params_from_jax(state["params"], device="cpu")
    roll = dict(n_envs=PPO_E, n_flows=PPO_F, M=PPO_M, substeps=50,
                spec=tppo.effective_obs_spec(tcfg), randomize_t0=True,
                policy="mlp", fairness_coef=0.5, deadline_coef=1.0, **draws)
    got = tppo._rollout_topology(agent["policy"], tenv, ttopo, tflows,
                                 tobjs, max_active=A, **roll)
    for g, r in zip(got, ref_roll):
        _close(g, r)
    train_state = {"params": agent,
                   "opt": adamw_init(dict(agent.named_parameters()))}
    fn = tppo._make_episode_fn(tenv, tcfg, randomize_t0=True)
    _, rew, loss = fn(train_state, None, flows=tflows, objectives=tobjs,
                      topology=ttopo, **draws)
    _close(rew, ref_rew)
    _close(loss, ref_loss)


@pytest.mark.cuda
def test_cuda_compact_step_matches_the_cpu():
    """On a card: reset and three compact steps (K3 on A flows with floors,
    finite caps and A spill rounds, K1 on E*A rows) against the same steps
    on the CPU through the kernels' plain versions, within 1e-5; each
    compact step launches K3 and K1 once."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    from repro_torch.kernels.contention import ops as k3_ops
    from repro_torch.kernels.sim_step import ops as k1_ops
    w = world(30, 3)
    A = bound(w, 1.0)
    spec = tsim.ObservationSpec(context=True, fleet=True, objectives=True,
                                topology=True)
    threads, _ = reference_threads(0)
    rng = np.random.default_rng(30)
    acts = [torch.from_numpy(rng.uniform(1.0, 30.0, (E, F, 3))
                             .astype(np.float32)) for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        tp = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                  device=dev)
        pw = {k: type(v)(*(None if x is None else x.to(dev) for x in v))
              for k, v in port_world(w).items()}
        k3_ops.contention_rates.launches = 0
        k1_ops.sim_interval_batch.launches = 0
        st = tt.topology_reset(tp, E, F, torch.full((E,), 0.5, device=dev),
                               substeps=S, threads=threads.to(dev),
                               max_active=A, **pw)
        rows = []
        for a in acts:
            st, obs, rew = tt.topology_step(tp, st, a.to(dev), substeps=S,
                                            spec=spec, fairness_coef=0.3,
                                            max_active=A, **pw)
            rows.append([x.cpu() for x in (*st, obs, rew)])
        out[dev] = rows
        if dev == "cuda":
            assert k3_ops.contention_rates.launches == 4
            assert k1_ops.sim_interval_batch.launches == 4
    for got, want in zip(out["cuda"], out["cpu"]):
        for g, x in zip(got, want):
            close(g, x, 1e-5)
