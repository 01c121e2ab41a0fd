"""The port's topology PPO against the JAX package's: the batched topology
rollout, the topology episode (rollout + shared-return batch shaping +
loss), and tiny ``train_ppo`` runs over topology workloads.

Threefry cannot be reproduced in torch, so every random draw of the
reference rollout (initial threads, start times, action noise) is taken
from the reference's own key stream and handed to the port. Each case
asserts that no pre-rounding action lies within 1e-3 of a .5 rounding
tie. Tolerances: 1e-5 on rollouts and losses (the sim-kernel tolerance)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import ppo as jppo, simulator as jsim, fleet as jf
from repro.core import topology as jt

from repro_torch.convert import params_from_jax
from repro_torch.core import ppo as tppo, simulator as tsim, fleet as tf
from repro_torch.core import topology as tt
from repro_torch.optim import adamw_init
from repro_torch.scenarios import sample_topology_batch

from test_torch_fleet_ppo import (assert_clear_of_rounding_ties, _close,
                                  fleet_draws)

# E, F and M are the fleet file's, whose ``fleet_draws`` makes the draws
E, F, L, T, M = 3, 4, 3, 12, 6
TPT, BW, CAP = [0.2, 0.15, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]


def configs(policy, spec, **kw):
    jcfg = jppo.PPOConfig(policy=policy, obs_spec=spec, action_scale=12.5,
                          n_envs=E, max_steps=M, n_flows=F,
                          fairness_coef=0.5, ppo_epochs=1, **kw)
    tcfg = tppo.PPOConfig(policy=policy, obs_spec=tsim.ObservationSpec(
        **spec._asdict()), action_scale=12.5, n_envs=E, max_steps=M,
        n_flows=F, fairness_coef=0.5, ppo_epochs=1, device="cpu", **kw)
    return jcfg, tcfg


def env_params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


def worlds(objectives):
    """(reference topology, flows, objectives batched over E; the port's):
    per-env graphs of L links over T one-second bins, two route bins."""
    rng = np.random.default_rng(12)
    f32 = lambda a: np.asarray(a, np.float32)
    tpt = f32(rng.uniform(0.05, 0.3, (E, L, T, 3)))
    bw = f32(rng.uniform(0.5, 1.5, (E, L, T, 3)))
    onpath = f32(rng.random((E, 2, F, L)) < 0.6)
    onpath[:, :, :, 0] = 1.0
    route_bin = f32(rng.uniform(3.0, 9.0, E))
    ts = np.sort(rng.uniform(0.0, 6.0, (E, F)), axis=1).astype(np.float32)
    ts[:, 0] = 0.0
    te = f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                      ts + rng.uniform(2.0, 6.0, (E, F))))
    obj = dict(weight=rng.choice([1.0, 2.0, 4.0], (E, F)),
               deadline=np.where(rng.random((E, F)) < 0.5, np.inf,
                                 rng.uniform(4.0, 12.0, (E, F))),
               demand=rng.uniform(1.0, 4.0, (E, F)),
               rate_floor=rng.uniform(0.0, 0.2, (E, F)),
               rate_cap=np.where(rng.random((E, F)) < 0.5, np.inf,
                                 rng.uniform(0.1, 0.8, (E, F))))
    obj = {k: f32(v) for k, v in obj.items()}
    jtopo = jt.Topology(
        jt.LinkGraph(jnp.asarray(tpt), jnp.asarray(bw), jnp.ones(E)),
        jt.PathSpec(jnp.asarray(onpath), jnp.asarray(route_bin)))
    ttopo = tt.Topology(
        tt.LinkGraph(torch.from_numpy(tpt), torch.from_numpy(bw),
                     torch.ones(E)),
        tt.PathSpec(torch.from_numpy(onpath), torch.from_numpy(route_bin)))
    jflows = jf.FlowSchedule(jnp.asarray(ts), jnp.asarray(te))
    tflows = tf.FlowSchedule(torch.from_numpy(ts), torch.from_numpy(te))
    jobjs = tobjs = None
    if objectives:
        jobjs = jf.FlowObjective(*(jnp.asarray(obj[k])
                                   for k in jf.FlowObjective._fields))
        tobjs = tf.FlowObjective(*(torch.from_numpy(obj[k])
                                   for k in tf.FlowObjective._fields))
    return (jtopo, jflows, jobjs), (ttopo, tflows, tobjs)


# (policy, spec, objectives, gae lambda, params seed, key seed); the key
# seeds keep every action off a .5 tie
CASES = [("mlp", jsim.TOPOLOGY_OBS, False, 1.0, 0, 1),
         ("gru", jsim.TOPOLOGY_OBS, True, 0.95, 1, 1),
         ("stacked", jsim.FLEET_OBS, False, 1.0, 2, 7)]


def _reference_rollout(jp, jenv, jcfg, ref_world, keys):
    jtopo, jflows, jobjs = ref_world
    spec = jppo.effective_obs_spec(jcfg)
    return jax.jit(jax.vmap(lambda tp, fl, ob, k: jppo._rollout_topology(
        jp["policy"], jenv, tp, fl, ob, k, M=M, substeps=50, spec=spec,
        backend="jnp", randomize_t0=True, policy=jcfg.policy, n_flows=F,
        fairness_coef=jcfg.fairness_coef,
        deadline_coef=jcfg.deadline_coef)))(jtopo, jflows, jobjs, keys)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rollout_topology_matches_reference(case):
    policy, spec, objectives, lam, seed, key_seed = case
    jcfg, tcfg = configs(policy, spec, gae_lambda=lam)
    jenv, tenv = env_params()
    jp = jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(
        jax.random.PRNGKey(seed))
    tp = params_from_jax(jp, device="cpu")
    ref_world, port_world = worlds(objectives)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), E)
    ref = _reference_rollout(jp, jenv, jcfg, ref_world, keys)
    threads0, t0_draw, noise = fleet_draws(keys, True)
    ttopo, tflows, tobjs = port_world
    got = tppo._rollout_topology(
        tp["policy"], tenv, ttopo, tflows, tobjs, n_envs=E, n_flows=F, M=M,
        substeps=50, spec=tppo.effective_obs_spec(tcfg), randomize_t0=True,
        policy=policy, fairness_coef=0.5, deadline_coef=1.0,
        threads0=threads0, t0_draw=t0_draw, noise=noise)
    assert_clear_of_rounding_ties(ref[1])
    assert got[0].shape == (E, M, F, tppo.effective_obs_spec(tcfg).dim)
    assert got[2].shape == (E, M)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_topology_episode_loss_matches_reference(case):
    """One topology episode batch with one update: the rollout, the shared
    return broadcast over flows (or GAE on per-flow baselines), the batch
    shaping and the loss on the pre-update params, against the reference's
    jitted topology episode."""
    policy, spec, objectives, lam, seed, key_seed = case
    jcfg, tcfg = configs(policy, spec, gae_lambda=lam)
    jenv, tenv = env_params()
    state = jax.jit(lambda k: jppo.init_agent(k, jcfg))(
        jax.random.PRNGKey(seed))
    ref_world, port_world = worlds(objectives)
    key = jax.random.PRNGKey(100 + key_seed)
    ref_fn = jppo._make_episode_fn(jenv, jcfg, randomize_t0=True,
                                   topology=True)  # the reference's flag
    _, ref_rew, ref_loss = ref_fn(state, None, ref_world[1], ref_world[2],
                                  ref_world[0], key)
    keys = jax.random.split(jax.random.split(key)[0], E)
    ref_roll = _reference_rollout(state["params"], jenv, jcfg, ref_world,
                                  keys)
    assert_clear_of_rounding_ties(ref_roll[1])
    threads0, t0_draw, noise = fleet_draws(keys, True)
    params = params_from_jax(state["params"], device="cpu")
    train_state = {"params": params,
                   "opt": adamw_init(dict(params.named_parameters()))}
    fn = tppo._make_episode_fn(tenv, tcfg, randomize_t0=True)
    ttopo, tflows, tobjs = port_world
    _, rew, loss = fn(train_state, None, flows=tflows, objectives=tobjs,
                      topology=ttopo, threads0=threads0, t0_draw=t0_draw,
                      noise=noise)
    _close(rew, ref_rew)
    _close(loss, ref_loss)


@pytest.mark.parametrize("policy", ["mlp", "stacked", "gru"])
def test_tiny_topology_train_ppo_runs_and_counts_episodes(policy):
    _, tenv = env_params()
    seen = []

    def draw(rnd):
        seen.append(rnd)
        return sample_topology_batch(2, 3, n_links=2, seed=rnd,
                                     horizon=20.0, device="cpu")

    cfg = tppo.PPOConfig(max_episodes=6, n_envs=2, n_flows=3, max_steps=4,
                         action_scale=12.5, obs_spec=tsim.TOPOLOGY_OBS,
                         fairness_coef=0.5, policy=policy,
                         pad_flows=policy == "mlp",
                         param_selection="batch_mean", device="cpu")
    res = tppo.train_ppo(tenv, cfg, resample=draw)
    assert seen == [0, 1, 2] and res.episodes == 6
    assert len(res.history) == 6 and np.all(np.isfinite(res.history))


def test_train_ppo_takes_one_topology_workload_and_refuses_compact():
    _, tenv = env_params()
    wl = sample_topology_batch(2, 2, n_links=3, seed=4, horizon=20.0,
                               objective_mix=True, device="cpu")
    cfg = tppo.PPOConfig(max_episodes=4, n_envs=2, n_flows=2, max_steps=3,
                         action_scale=12.5, obs_spec=tsim.TOPOLOGY_OBS,
                         device="cpu")
    res = tppo.train_ppo(tenv, cfg, workload=wl)
    assert res.episodes == 4 and np.isfinite(res.best_reward)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tppo.train_ppo(tenv, tppo.PPOConfig(
            max_episodes=2, n_envs=2, n_flows=2, max_steps=2, max_active=1,
            obs_spec=tsim.TOPOLOGY_OBS, device="cpu"), workload=wl)
