"""The port's PPO pieces against the JAX package: the losses and their
gradients on a fixed batch (1e-5), the discounted and GAE returns, and the
batched rollout for the mlp, stacked and gru policies.

Threefry cannot be reproduced in torch, so the rollout's random draws
(initial threads, episode start times, per-step action noise) are taken in
the test from the reference's own key stream — the splits of
``repro.core.ppo._rollout`` — and handed to the port explicitly. Each case
uses a seed for which no pre-rounding action lies within 1e-3 of a .5
rounding boundary, and asserts it, so a 1-ulp difference cannot flip a
thread count."""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import ppo as jppo, simulator as jsim, networks as jnets
from repro.core.schedule import make_table as jax_make_table

from repro_torch.convert import params_from_jax, flatten_tree
from repro_torch.core import ppo as tppo, simulator as tsim
from repro_torch.core import networks as tnets
from repro_torch.core.schedule import make_table, stack_tables

TPT, BW, CAP = [0.08, 0.16, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]
SCHED_TPT = np.asarray([[0.08, 0.16, 0.2], [0.05, 0.16, 0.1],
                        [0.08, 0.04, 0.2]], np.float32)
SCHED_BW = np.asarray([[1.0, 1.0, 1.0], [0.6, 1.0, 1.0],
                       [1.0, 0.5, 0.8]], np.float32)


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def reference_draws(keys, M, randomize_t0):
    """The reference rollout's draws for each env key: initial threads
    (E, 3), the start-time uniform (E,) when randomized, noise (M, E, 3)."""
    threads, u, noise = _draws(keys, M, randomize_t0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return (t(threads), t(u) if randomize_t0 else None,
            t(noise).transpose(0, 1).contiguous())


@partial(jax.jit, static_argnums=(1, 2))
def _draws(keys, M, randomize_t0):
    def one(k):
        if randomize_t0:
            k_reset, k_t0, k_steps = jax.random.split(k, 3)
            u = jax.random.uniform(k_t0, ())
        else:
            k_reset, k_steps = jax.random.split(k)
            u = jnp.zeros(())
        noise = jax.vmap(lambda km: jax.random.normal(km, (3,)))(
            jax.random.split(k_steps, M))
        return jax.random.randint(k_reset, (3,), 1, 16), u, noise
    return jax.vmap(one)(keys)


def assert_clear_of_rounding_ties(act, margin=1e-3):
    frac = np.abs(np.asarray(act) - np.floor(np.asarray(act)) - 0.5)
    assert frac.min() > margin, (
        f"an action lies {frac.min():.2e} from a .5 rounding tie: pick "
        "another seed")


def _configs(policy, obs_spec=jsim.DEFAULT_OBS):
    jcfg = jppo.PPOConfig(policy=policy, obs_spec=obs_spec, action_scale=10.0,
                          n_envs=4, max_steps=10)
    tcfg = tppo.PPOConfig(policy=policy, obs_spec=tsim.ObservationSpec(
        **obs_spec._asdict()), action_scale=10.0, n_envs=4, max_steps=10,
        device="cpu")
    return jcfg, tcfg


def _jax_init(key, jcfg):
    return jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(key)


# (policy, obs spec, scheduled, params seed, rollout key seed); the key
# seeds keep every action >= 1e-2 from a .5 tie
ROLLOUTS = [("mlp", jsim.DEFAULT_OBS, False, 0, 103),
            ("stacked", jsim.CONTEXT_OBS, True, 1, 105),
            ("gru", jsim.CONTEXT_OBS, False, 2, 101)]


@pytest.mark.parametrize("policy,spec,scheduled,seed,key_seed", ROLLOUTS,
                         ids=[r[0] for r in ROLLOUTS])
def test_rollout_matches_reference(policy, spec, scheduled, seed, key_seed):
    E, M = 4, 10
    jcfg, tcfg = _configs(policy, spec)
    jp = _jax_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jp, device="cpu")
    jenv = jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40)
    tenv = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40,
                                device="cpu")
    if scheduled:
        jtab = jax_make_table(SCHED_TPT, SCHED_BW, bin_seconds=5.0)
        ttabs = stack_tables([make_table(SCHED_TPT, SCHED_BW, 5.0,
                                         device="cpu")] * E)
    else:
        jtab = jsim.constant_table(jenv.tpt, jenv.bw, jenv.duration)
        ttabs = None
    jtabs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape), jtab)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), E)
    spec_eff = jppo.effective_obs_spec(jcfg)
    ref = jax.jit(jax.vmap(lambda tab, k: jppo._rollout(
        jp["policy"], jenv, tab, k, M=M, substeps=50, spec=spec_eff,
        backend="jnp", randomize_t0=scheduled, policy=policy)))(jtabs, keys)
    threads0, t0_draw, noise = reference_draws(keys, M, scheduled)
    got = tppo._rollout(tp["policy"], tenv, ttabs, n_envs=E, M=M,
                        substeps=50, spec=tppo.effective_obs_spec(tcfg),
                        randomize_t0=scheduled, policy=policy,
                        threads0=threads0, t0_draw=t0_draw, noise=noise)
    assert_clear_of_rounding_ties(ref[1])
    assert got[0].shape == (E, M, spec_eff.dim)
    for g, r in zip(got, ref):
        _close(g, r)


def _loss_batch(jp, jcfg, recurrent, seed=3):
    rng = np.random.default_rng(seed)
    D = jppo.effective_obs_spec(jcfg).dim
    shape = (4, 10) if recurrent else (40,)
    obs = rng.uniform(0, 1, shape + (D,)).astype(np.float32)
    act = rng.uniform(1, 20, shape + (3,)).astype(np.float32)
    ret = rng.normal(5, 2, shape).astype(np.float32)
    # logp_old off the current policy's logp by up to +-0.4, so the
    # surrogate's clip is active for some samples and not for others
    if recurrent:
        def one(o, a):
            def stepfn(h, xs):
                h, m, s = jnets.rnn_policy_apply(jp["policy"], h, xs[0])
                return h, jnets.gaussian_logp(m, s, xs[1])
            return jax.lax.scan(stepfn, jnets.rnn_carry(jp["policy"]),
                                (o, a))[1]
        logp = jax.vmap(one)(jnp.asarray(obs), jnp.asarray(act))
    else:
        m, s = jnets.policy_apply(jp["policy"], jnp.asarray(obs))
        logp = jnets.gaussian_logp(m, s, jnp.asarray(act))
    logp_old = (np.asarray(logp) + rng.uniform(-0.4, 0.4, shape)).astype(
        np.float32)
    return obs, act, ret, logp_old


@pytest.mark.parametrize("policy", ["mlp", "gru"])
def test_loss_and_gradients_match(policy):
    jcfg, tcfg = _configs(policy, jsim.CONTEXT_OBS)
    jp = _jax_init(jax.random.PRNGKey(7), jcfg)
    recurrent = policy == "gru"
    batch = _loss_batch(jp, jcfg, recurrent)
    loss_fn = jppo._loss_recurrent if recurrent else jppo._loss
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, jcfg), has_aux=True))(
            jp, tuple(jnp.asarray(x) for x in batch))
    tp = params_from_jax(jp, device="cpu")
    tloss = tppo._loss_recurrent if recurrent else tppo._loss
    tl, taux = tloss(tp, tuple(torch.from_numpy(x) for x in batch), tcfg)
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()))
    _close(tl.detach(), jl)
    for k in ("actor", "critic", "entropy"):
        _close(taux[k].detach(), jaux[k])
    jflat = flatten_tree(jg)
    for n, g in zip(named, grads):
        _close(g, jflat[n])


def test_returns_match_reference():
    rng = np.random.default_rng(4)
    rew = rng.normal(2, 1, (5, 10)).astype(np.float32)
    val = rng.normal(1, 1, (5, 10)).astype(np.float32)
    _close(tppo._returns(torch.from_numpy(rew), 0.99),
           jax.vmap(jppo._returns, in_axes=(0, None))(jnp.asarray(rew), 0.99))
    _close(tppo._gae_returns(torch.from_numpy(rew), torch.from_numpy(val),
                             0.99, 0.95),
           jax.vmap(lambda r, v: jppo._gae_returns(r, v, 0.99, 0.95))(
               jnp.asarray(rew), jnp.asarray(val)))


def test_unported_regimes_refuse():
    """``train_ppo(mesh=)`` raised NotImplementedError until the sharding
    slice of the port; a one-rank fleet mesh now runs one round equal to
    ``mesh=None`` bit for bit (every flow sharding on one rank is a
    replication)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fleet_mesh
    tenv = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, device="cpu")
    cfg = tppo.PPOConfig(n_flows=4, n_envs=2, max_episodes=2, max_steps=3,
                         device="cpu")
    started = not dist.is_initialized()
    try:
        res = tppo.train_ppo(tenv, cfg,
                             mesh=make_fleet_mesh(1, device="cpu"))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    alone = tppo.train_ppo(tenv, cfg)
    assert res.episodes == alone.episodes == 2
    assert res.history == alone.history
    for (n, p), q in zip(res.params.named_parameters(),
                         alone.params.parameters()):
        assert torch.equal(p, q), n
    # the fleet, topology and fault axes are ported: such a workload is
    # accepted
    wl = tppo.Workload(flows=object(), objectives=object(),
                       topology=object())
    assert wl.faults is None
    assert not tppo.Workload(faults=[None]).has_faults


def test_train_ppo_static_runs_and_counts_episodes():
    tenv = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40,
                                device="cpu")
    res = tppo.train_ppo(tenv, tppo.PPOConfig(
        max_episodes=16, n_envs=8, action_scale=10.0, device="cpu"),
        r_max=2.57)
    assert res.episodes == 16 and len(res.history) == 16
    assert res.best_reward == max(res.history)
    assert isinstance(res.params["policy"], tnets.PolicyNet)


def test_train_ppo_resamples_tables_each_round():
    tenv = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40,
                                device="cpu")
    seen = []

    def resample(rnd):
        seen.append(rnd)
        scale = 1.0 + 0.1 * rnd
        return tppo.Workload(tables=stack_tables(
            [make_table(SCHED_TPT * scale, SCHED_BW, 5.0, device="cpu")] * 4))

    res = tppo.train_ppo(tenv, tppo.PPOConfig(
        max_episodes=12, n_envs=4, policy="stacked", action_scale=10.0,
        param_selection="batch_mean", device="cpu"), resample=resample)
    assert seen == [0, 1, 2] and res.episodes == 12
