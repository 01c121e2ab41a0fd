"""The port's AutoMDTController against the JAX package's on a recorded
sequence of engine observe() dicts: deterministic mlp, frame-stacked (K=4)
and gru policies from the same parameters. The frames must be identical
and the thread allocations equal.

The mean head's weights are scaled up so the allocations vary over the
sequence; the test asserts that no pre-rounding action lies within 1e-3 of
a .5 tie, so a 1-ulp difference cannot flip a thread count."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import networks as jnets, simulator as jsim
from repro.core.controller import AutoMDTController as JaxController

from repro_torch.convert import params_from_jax
from repro_torch.core import simulator as tsim
from repro_torch.core.controller import AutoMDTController
from repro_torch.core.networks import PolicyNet

N_MAX = 32


def recorded_observations(n, seed):
    """A sequence of observe() dicts as a live engine reports them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "threads": [int(x) for x in rng.integers(1, N_MAX + 1, 3)],
            "throughputs": [float(x) for x in rng.uniform(0, 12e6, 3)],
            "sender_free": float(rng.uniform(0, 4e6)),
            "receiver_free": float(rng.uniform(0, 4e6)),
            "sender_capacity": 4e6,
            "receiver_capacity": 4e6,
        })
    return out


# (policy, spec, bw_ref, params seed)
CASES = [("mlp", jsim.DEFAULT_OBS, 10e6, 0),
         ("stacked", jsim.HistorySpec(4), None, 1),
         ("gru", jsim.CONTEXT_OBS, None, 2)]


@pytest.mark.parametrize("policy,spec,bw_ref,seed", CASES,
                         ids=[c[0] for c in CASES])
def test_controller_frames_and_actions_match_reference(policy, spec, bw_ref,
                                                       seed):
    obs_dim = spec.dim
    key = jax.random.PRNGKey(seed)
    if policy == "gru":
        jp = jax.jit(lambda k: jnets.rnn_policy_init(
            k, obs_dim=obs_dim, action_scale=10.0))(key)
    else:
        jp = jax.jit(lambda k: jnets.policy_init(
            k, obs_dim=obs_dim, action_scale=10.0))(key)
    jp["mean"]["w"] = jp["mean"]["w"] * 60.0
    tp = params_from_jax({"policy": jp, "value": _value_stub(obs_dim,
                                                             policy)},
                         device="cpu")["policy"]
    kw = dict(n_max=N_MAX, bw_ref=bw_ref, deterministic=True, obs_spec=spec,
              policy=policy)
    jctl = JaxController(jp, **kw)
    tctl = AutoMDTController(tp, **{**kw, "obs_spec": tsim.ObservationSpec(
        **spec._asdict())}, device="cpu")
    # the controller's mean, before rounding, from the reference's network
    apply = (jax.jit(jnets.rnn_policy_apply) if policy == "gru"
             else jax.jit(jnets.policy_apply))
    carry = jnets.rnn_carry(jp, (1,)) if policy == "gru" else None
    observations = recorded_observations(12, seed)
    for obs in observations:
        jvec = jctl._obs_vector(obs)
        tvec = tctl._obs_vector(obs)
        np.testing.assert_array_equal(tvec, jvec)
        if policy == "gru":
            carry, mean, _ = apply(jp, carry, jnp.asarray(jvec)[None])
        else:
            mean, _ = apply(jp, jnp.asarray(jvec)[None])
        mean = np.asarray(mean)
        assert np.abs(mean - np.floor(mean) - 0.5).min() > 1e-3
        ja = jctl._policy._action(jvec[None])
        ta = tctl._policy._action(tvec[None])
        np.testing.assert_array_equal(ta, ja)
    assert tctl.n_dispatch == len(observations)
    # and through the public step(), from a reset
    jctl.reset()
    tctl.reset()
    steps = [(tctl.step(o), jctl.step(o)) for o in observations]
    assert all(t == j for t, j in steps)
    assert len({s[0] for s in steps}) > 1  # the allocations do move


def _value_stub(obs_dim, policy):
    key = jax.random.PRNGKey(99)
    if policy == "gru":
        return jax.jit(lambda k: jnets.rnn_value_init(k, obs_dim=obs_dim))(key)
    return jax.jit(lambda k: jnets.value_init(k, obs_dim=obs_dim))(key)


def test_stochastic_controller_samples_on_the_device_and_clamps():
    tp = PolicyNet(obs_dim=8, generator=torch.Generator().manual_seed(0))
    ctl = AutoMDTController(tp, n_max=N_MAX, deterministic=False, seed=3,
                            device="cpu")
    acts = [ctl.step(o) for o in recorded_observations(20, 5)]
    flat = np.asarray(acts)
    assert flat.min() >= 1 and flat.max() <= N_MAX
    assert len(set(acts)) > 1 and ctl.n_dispatch == 20


def test_controller_leaves_the_callers_policy_module_alone():
    tp = PolicyNet(obs_dim=8, generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    ctl = AutoMDTController(tp, n_max=N_MAX, device="cpu")
    held = ctl._policy.params
    assert held is not tp
    with torch.no_grad():
        for p in held.parameters():
            p.add_(1.0)
    for n, p in tp.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.cuda
def test_controller_on_the_card_leaves_a_cpu_policy_on_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card")
    tp = PolicyNet(obs_dim=8, generator=torch.Generator().manual_seed(0))
    ctl = AutoMDTController(tp, n_max=N_MAX, device="cuda")
    assert all(p.device.type == "cpu" for p in tp.parameters())
    assert all(p.is_cuda for p in ctl._policy.params.parameters())
    assert ctl.step(recorded_observations(1, 0)[0]) is not None


def test_online_adaptation_is_refused():
    tp = PolicyNet(obs_dim=8)
    with pytest.raises(NotImplementedError):
        AutoMDTController(tp, online=object(), device="cpu")
