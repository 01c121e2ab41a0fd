"""The port's fleet PPO against the JAX package's: the batched fleet
rollout, the multi-flow episode (rollout + batch shaping + loss), the loss
and gradients on fleet-shaped batches, and a tiny fleet ``train_ppo`` run.

Threefry cannot be reproduced in torch, so every random draw of the
reference rollout (initial threads, start times, action noise) is taken
from the reference's own key stream and handed to the port. Each case
asserts that no pre-rounding action lies within 1e-3 of a .5 rounding
tie, so a 1-ulp difference cannot flip a thread count. Tolerances: 1e-5
on rollouts, losses and gradients (the sim-kernel tolerance)."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import ppo as jppo, simulator as jsim, fleet as jf
from repro.core.schedule import make_table as jax_make_table

from repro_torch.convert import params_from_jax, flatten_tree
from repro_torch.core import ppo as tppo, simulator as tsim, fleet as tf
from repro_torch.core.schedule import make_table, stack_tables
from repro_torch.optim import adamw_init
from repro_torch.scenarios import sample_fleet_batch

E, F, M = 3, 4, 6
TPT, BW, CAP = [0.2, 0.15, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]
SCHED_TPT = np.asarray([[0.2, 0.15, 0.2], [0.1, 0.15, 0.2],
                        [0.2, 0.05, 0.1]], np.float32)
SCHED_BW = np.asarray([[1.0, 1.0, 1.0], [0.6, 1.0, 1.0],
                       [1.0, 0.5, 0.8]], np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=1e-5)


def assert_clear_of_rounding_ties(act, margin=1e-3):
    frac = np.abs(np.asarray(act) - np.floor(np.asarray(act)) - 0.5)
    assert frac.min() > margin, (
        f"an action lies {frac.min():.2e} from a .5 rounding tie: pick "
        "another seed")


def fleet_draws(keys, randomize_t0):
    """The reference fleet rollout's draws for each env key: initial
    threads (E, F, 3), the start-time uniform (E,), noise (M, E, F, 3)."""
    threads, u, noise = _draws(keys, randomize_t0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return (t(threads), t(u) if randomize_t0 else None,
            t(noise).transpose(0, 1).contiguous())


@partial(jax.jit, static_argnums=(1,))
def _draws(keys, randomize_t0):
    def one(k):
        if randomize_t0:
            k_reset, k_t0, k_steps = jax.random.split(k, 3)
            u = jax.random.uniform(k_t0, ())
        else:
            k_reset, k_steps = jax.random.split(k)
            u = jnp.zeros(())
        noise = jax.vmap(lambda km: jax.random.normal(km, (F, 3)))(
            jax.random.split(k_steps, M))
        return jax.random.randint(k_reset, (F, 3), 1, 16), u, noise
    return jax.vmap(one)(keys)


def configs(policy, spec, **kw):
    jcfg = jppo.PPOConfig(policy=policy, obs_spec=spec, action_scale=12.5,
                          n_envs=E, max_steps=M, n_flows=F,
                          fairness_coef=0.5, ppo_epochs=1, **kw)
    tcfg = tppo.PPOConfig(policy=policy, obs_spec=tsim.ObservationSpec(
        **spec._asdict()), action_scale=12.5, n_envs=E, max_steps=M,
        n_flows=F, fairness_coef=0.5, ppo_epochs=1, device="cpu", **kw)
    return jcfg, tcfg


def worlds(scheduled, objectives):
    """(reference tables, flows, objectives batched over E; the port's)."""
    rng = np.random.default_rng(11)
    ts = np.sort(rng.uniform(0.0, 8.0, (E, F)), axis=1).astype(np.float32)
    ts[:, 0] = 0.0
    te = np.where(rng.random((E, F)) < 0.5, np.inf,
                  ts + rng.uniform(2.0, 6.0, (E, F))).astype(np.float32)
    obj = dict(weight=rng.choice([1.0, 2.0, 4.0], (E, F)),
               deadline=np.where(rng.random((E, F)) < 0.5, np.inf,
                                 rng.uniform(4.0, 12.0, (E, F))),
               demand=rng.uniform(1.0, 4.0, (E, F)),
               rate_floor=rng.uniform(0.0, 0.2, (E, F)),
               rate_cap=np.where(rng.random((E, F)) < 0.5, np.inf,
                                 rng.uniform(0.1, 0.8, (E, F))))
    obj = {k: v.astype(np.float32) for k, v in obj.items()}
    if scheduled:
        jtab = jax_make_table(SCHED_TPT, SCHED_BW, bin_seconds=5.0)
        ttabs = stack_tables([make_table(SCHED_TPT, SCHED_BW, 5.0,
                                         device="cpu")] * E)
    else:
        jtab = jsim.constant_table(jnp.asarray(TPT), jnp.asarray(BW), 1.0)
        ttabs = None
    jtabs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape), jtab)
    jflows = jf.FlowSchedule(jnp.asarray(ts), jnp.asarray(te))
    tflows = tf.FlowSchedule(torch.from_numpy(ts), torch.from_numpy(te))
    jobjs = tobjs = None
    if objectives:
        jobjs = jf.FlowObjective(*(jnp.asarray(obj[k])
                                   for k in jf.FlowObjective._fields))
        tobjs = tf.FlowObjective(*(torch.from_numpy(obj[k])
                                   for k in tf.FlowObjective._fields))
    return (jtabs, jflows, jobjs), (ttabs, tflows, tobjs)


def env_params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


# (policy, spec, scheduled, objectives, max_active, gae lambda, params
# seed, key seed); the key seeds keep every action off a .5 tie
CASES = [("mlp", jsim.FLEET_OBS, False, False, None, 1.0, 0, 3),
         ("gru", jsim.OBJECTIVE_OBS, True, True, None, 0.95, 1, 5),
         ("stacked", jsim.FLEET_OBS, True, False, 2, 1.0, 2, 7)]


def _reference_rollout(jp, jenv, jcfg, ref_world, keys, scheduled):
    jtabs, jflows, jobjs = ref_world
    spec = jppo.effective_obs_spec(jcfg)
    return jax.jit(jax.vmap(lambda tab, fl, ob, k: jppo._rollout_fleet(
        jp["policy"], jenv, tab, fl, ob, k, M=M, substeps=50, spec=spec,
        backend="jnp", randomize_t0=scheduled, policy=jcfg.policy,
        n_flows=F, fairness_coef=jcfg.fairness_coef,
        deadline_coef=jcfg.deadline_coef, max_active=jcfg.max_active)))(
        jtabs, jflows, jobjs, keys)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rollout_fleet_matches_reference(case):
    policy, spec, scheduled, objectives, A, lam, seed, key_seed = case
    jcfg, tcfg = configs(policy, spec, max_active=A, gae_lambda=lam)
    jenv, tenv = env_params()
    jp = jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(
        jax.random.PRNGKey(seed))
    tp = params_from_jax(jp, device="cpu")
    ref_world, port_world = worlds(scheduled, objectives)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), E)
    ref = _reference_rollout(jp, jenv, jcfg, ref_world, keys, scheduled)
    threads0, t0_draw, noise = fleet_draws(keys, scheduled)
    ttabs, tflows, tobjs = port_world
    got = tppo._rollout_fleet(
        tp["policy"], tenv, ttabs, tflows, tobjs, n_envs=E, n_flows=F, M=M,
        substeps=50, spec=tppo.effective_obs_spec(tcfg),
        randomize_t0=scheduled, policy=policy, fairness_coef=0.5,
        deadline_coef=1.0, max_active=A, threads0=threads0,
        t0_draw=t0_draw, noise=noise)
    assert_clear_of_rounding_ties(ref[1])
    assert got[0].shape == (E, M, F, tppo.effective_obs_spec(tcfg).dim)
    assert got[2].shape == (E, M)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_multi_flow_episode_loss_matches_reference(case):
    """One episode batch with one update: the rollout, the shared return
    broadcast over flows (or GAE on per-flow baselines), the batch shaping
    (per (env, flow) sequences for the GRU) and the loss on the pre-update
    params, against the reference's jitted episode."""
    policy, spec, scheduled, objectives, A, lam, seed, key_seed = case
    jcfg, tcfg = configs(policy, spec, max_active=A, gae_lambda=lam)
    jenv, tenv = env_params()
    state = jax.jit(lambda k: jppo.init_agent(k, jcfg))(
        jax.random.PRNGKey(seed))
    ref_world, port_world = worlds(scheduled, objectives)
    key = jax.random.PRNGKey(100 + key_seed)
    ref_fn = jppo._make_episode_fn(jenv, jcfg, randomize_t0=scheduled)
    _, ref_rew, ref_loss = ref_fn(state, ref_world[0], ref_world[1],
                                  ref_world[2], None, key)
    keys = jax.random.split(jax.random.split(key)[0], E)
    ref_roll = _reference_rollout(state["params"], jenv, jcfg, ref_world,
                                  keys, scheduled)
    assert_clear_of_rounding_ties(ref_roll[1])
    threads0, t0_draw, noise = fleet_draws(keys, scheduled)
    params = params_from_jax(state["params"], device="cpu")
    train_state = {"params": params,
                   "opt": adamw_init(dict(params.named_parameters()))}
    fn = tppo._make_episode_fn(tenv, tcfg, randomize_t0=scheduled)
    ttabs, tflows, tobjs = port_world
    _, rew, loss = fn(train_state, ttabs, flows=tflows, objectives=tobjs,
                      threads0=threads0, t0_draw=t0_draw, noise=noise)
    _close(rew, ref_rew)
    _close(loss, ref_loss)


@pytest.mark.parametrize("policy", ["mlp", "gru"])
def test_loss_and_gradients_on_a_fleet_batch_match(policy):
    """The losses and their gradients on a multi-flow batch made from a
    reference fleet rollout: (E*M*F) samples for the mlp, (E*F) sequences
    of M steps for the GRU."""
    jcfg, tcfg = configs(policy, jsim.FLEET_OBS)
    jenv, _ = env_params()
    jp = jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(
        jax.random.PRNGKey(21))
    ref_world, _ = worlds(False, False)
    keys = jax.random.split(jax.random.PRNGKey(22), E)
    obs, act, _, logp = (np.asarray(x) for x in _reference_rollout(
        jp, jenv, jcfg, ref_world, keys, False))
    rng = np.random.default_rng(23)
    ret = rng.normal(5.0, 2.0, logp.shape).astype(np.float32)
    logp_old = (logp + rng.uniform(-0.4, 0.4, logp.shape)).astype(np.float32)
    D = obs.shape[-1]
    if policy == "gru":
        seq = lambda x: np.swapaxes(x, 1, 2).reshape((E * F, M)
                                                     + x.shape[3:])
        batch = (seq(obs), seq(act), seq(ret), seq(logp_old))
    else:
        batch = (obs.reshape(-1, D), act.reshape(-1, 3), ret.reshape(-1),
                 logp_old.reshape(-1))
    loss_fn = jppo._loss_recurrent if policy == "gru" else jppo._loss
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, jcfg), has_aux=True))(
            jp, tuple(jnp.asarray(x) for x in batch))
    tp = params_from_jax(jp, device="cpu")
    tloss = tppo._loss_recurrent if policy == "gru" else tppo._loss
    tl, taux = tloss(tp, tuple(torch.from_numpy(np.array(x))
                               for x in batch), tcfg)
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()))
    _close(tl.detach(), jl)
    for k in ("actor", "critic", "entropy"):
        _close(taux[k].detach(), jaux[k])
    jflat = flatten_tree(jg)
    for n, g in zip(named, grads):
        _close(g, jflat[n])


def test_tiny_fleet_train_ppo_runs_and_counts_episodes():
    _, tenv = env_params()
    seen = []

    def draw(rnd):
        seen.append(rnd)
        return sample_fleet_batch(2, 3, seed=rnd, horizon=20.0,
                                  objective_mix=True, device="cpu")

    cfg = tppo.PPOConfig(max_episodes=6, n_envs=2, n_flows=3, max_steps=4,
                         action_scale=12.5, obs_spec=tsim.OBJECTIVE_OBS,
                         fairness_coef=0.5, pad_flows=True, max_active=2,
                         param_selection="batch_mean", device="cpu")
    res = tppo.train_ppo(tenv, cfg, workload=draw(0), resample=draw)
    assert seen == [0, 1, 2] and res.episodes == 6
    assert len(res.history) == 6 and np.all(np.isfinite(res.history))
    static = tppo.train_ppo(tenv, tppo.PPOConfig(
        max_episodes=4, n_envs=2, n_flows=3, max_steps=3, policy="gru",
        action_scale=12.5, obs_spec=tsim.FLEET_OBS, device="cpu"))
    assert static.episodes == 4 and np.isfinite(static.best_reward)
