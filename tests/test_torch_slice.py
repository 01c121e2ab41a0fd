"""The slice as a whole: one single-flow PPO episode batch (rollout of 4
envs + 4 AdamW updates) of the port against the JAX package's jitted
episode function, from the same converted initial parameters and the same
random draws (taken from the reference's key stream), then the production
controller's actions from the updated parameters. Rewards and parameters
at 1e-4.

Two knife-edges are kept out by the choice of seed, and asserted: no
pre-rounding action within 1e-3 of a .5 tie (a flipped thread count), and
no ReLU input in the policy within 1e-5 of zero (a unit that flips on or
off between the two programs turns a near-zero gradient into a zero one,
and AdamW's first steps move such an element by about lr either way)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import ppo as jppo, simulator as jsim, networks as jnets
from repro.core.controller import AutoMDTController as JaxController
from repro.optim import adamw_init as jax_adamw_init

from repro_torch.convert import (params_from_jax, params_to_jax,
                                 adamw_state_to_jax, flatten_tree)
from repro_torch.core import ppo as tppo, simulator as tsim
from repro_torch.core.controller import AutoMDTController
from repro_torch.nn.layers import LayerNorm
from repro_torch.optim import adamw_init

from test_torch_controller import recorded_observations
from test_torch_ppo import reference_draws, assert_clear_of_rounding_ties

TPT, BW, CAP = [0.08, 0.16, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]
E, M = 4, 10


def _narrow_agent(key, policy, hidden=64):
    """The reference's agent at a narrow width (the test's size)."""
    kp, kv = jax.random.split(key)
    if policy == "gru":
        return {"policy": jnets.rnn_policy_init(kp, hidden=hidden,
                                                action_scale=10.0),
                "value": jnets.rnn_value_init(kv, hidden=hidden)}
    return {"policy": jnets.policy_init(kp, hidden=hidden, action_scale=10.0),
            "value": jnets.value_init(kv, hidden=hidden)}


# (policy, params seed, episode key seed)
CASES = [("mlp", 0, 12), ("gru", 1, 12)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def episode(request):
    """One episode batch through both packages: (policy, key seed, JAX
    train state, JAX rewards, port train state, port rewards)."""
    policy, seed, key_seed = request.param
    jcfg = jppo.PPOConfig(policy=policy, n_envs=E, max_steps=M,
                          action_scale=10.0)
    tcfg = tppo.PPOConfig(policy=policy, n_envs=E, max_steps=M,
                          action_scale=10.0, device="cpu")
    jenv = jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40)
    tenv = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=40,
                                device="cpu")
    jp = jax.jit(lambda k: _narrow_agent(k, policy))(jax.random.PRNGKey(seed))
    tables = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape),
        jsim.constant_table(jenv.tpt, jenv.bw, jenv.duration))
    key = jax.random.PRNGKey(key_seed)
    jstate, jrew, _ = jppo._make_episode_fn(jenv, jcfg, randomize_t0=False)(
        {"params": jp, "opt": jax.jit(jax_adamw_init)(jp)}, tables, None,
        None, None, key)

    k_roll, _ = jax.random.split(key)
    threads0, _, noise = reference_draws(jax.random.split(k_roll, E), M,
                                         False)
    tp = params_from_jax(jp, device="cpu")
    spec = tppo.effective_obs_spec(tcfg)
    act = tppo._rollout(tp["policy"], tenv, None, n_envs=E, M=M,
                        substeps=50, spec=spec, randomize_t0=False,
                        policy=policy, threads0=threads0, noise=noise)[1]
    assert_clear_of_rounding_ties(act)
    relu_inputs = []   # the policy's LayerNorm outputs feed its ReLUs
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: relu_inputs.append(
            float(out.detach().abs().min())))
        for m in tp["policy"].modules() if isinstance(m, LayerNorm)]
    tstate, trew, _ = tppo._make_episode_fn(tenv, tcfg, randomize_t0=False)(
        {"params": tp, "opt": adamw_init(dict(tp.named_parameters()))},
        None, threads0=threads0, noise=noise)
    for h in hooks:
        h.remove()
    assert min(relu_inputs, default=1.0) > 1e-5
    return policy, key_seed, jstate, jrew, tstate, trew


def test_episode_rewards_match_reference(episode):
    *_, jrew, _, trew = episode
    assert trew.shape == (E,)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4,
                               rtol=0)


def test_updated_params_match_reference(episode):
    _, _, jstate, _, tstate, _ = episode
    jflat = flatten_tree(jstate["params"])
    tflat = flatten_tree(params_to_jax(tstate["params"]))
    assert jflat.keys() == tflat.keys()
    for n in jflat:
        np.testing.assert_allclose(tflat[n], np.asarray(jflat[n]), atol=1e-4,
                                   rtol=0, err_msg=n)
    assert int(adamw_state_to_jax(tstate["opt"])["step"]) == 4


def test_controller_from_updated_params_matches_reference(episode):
    policy, key_seed, jstate, _, tstate, _ = episode
    kw = dict(n_max=32, bw_ref=12e6, deterministic=True, policy=policy)
    jctl = JaxController(jstate["params"]["policy"], **kw)
    tctl = AutoMDTController(tstate["params"]["policy"], device="cpu", **kw)
    for obs in recorded_observations(8, key_seed):
        assert tctl.step(obs) == jctl.step(obs)
