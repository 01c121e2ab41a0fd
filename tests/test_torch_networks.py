"""The port's networks, layers, AdamW and parameter conversion against the
JAX package: the same parameters (carried across by ``repro_torch.convert``)
and the same numpy inputs through both. Forward passes at 1e-5, one AdamW
update at 1e-6."""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import networks as jnets
from repro.nn.layers import layernorm as jax_layernorm
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update

from repro_torch.convert import (params_from_jax, params_to_jax,
                                 adamw_state_from_jax, adamw_state_to_jax,
                                 flatten_tree)
from repro_torch.core import networks as tnets
from repro_torch.nn.layers import layernorm
from repro_torch.optim import adamw_init, adamw_update


@lru_cache(maxsize=None)
def _jax_agent(obs_dim, *, gru=False, seed=0):
    return _jax_agent_init(jax.random.PRNGKey(seed), obs_dim, gru)


@partial(jax.jit, static_argnums=(1, 2))
def _jax_agent_init(key, obs_dim, gru):
    kp, kv = jax.random.split(key)
    if gru:
        return {"policy": jnets.rnn_policy_init(kp, obs_dim=obs_dim,
                                                action_scale=10.0),
                "value": jnets.rnn_value_init(kv, obs_dim=obs_dim)}
    return {"policy": jnets.policy_init(kp, obs_dim=obs_dim,
                                        action_scale=10.0),
            "value": jnets.value_init(kv, obs_dim=obs_dim)}


def _obs(n, d, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(
        np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("obs_dim", [8, 13])
def test_policy_and_value_forward_match(obs_dim):
    jp = _jax_agent(obs_dim)
    tp = params_from_jax(jp, device="cpu")
    obs = _obs(16, obs_dim)
    jm, js = jax.jit(jnets.policy_apply)(jp["policy"], jnp.asarray(obs))
    with torch.no_grad():
        tm, ts = tp["policy"](torch.from_numpy(obs))
        tv = tp["value"](torch.from_numpy(obs))
    _close(tm, jm)
    _close(ts, js)
    _close(tv, jax.jit(jnets.value_apply)(jp["value"], jnp.asarray(obs)))
    act = (np.asarray(jm) + 1.3).astype(np.float32)
    _close(tnets.gaussian_logp(tm, ts, torch.from_numpy(act)),
           jnets.gaussian_logp(jm, js, jnp.asarray(act)))
    _close(tnets.gaussian_entropy(ts), jnets.gaussian_entropy(js))


def test_recurrent_forward_matches_over_a_sequence():
    jp = _jax_agent(8, gru=True)
    tp = params_from_jax(jp, device="cpu")
    assert isinstance(tp["policy"], tnets.RNNPolicyNet)
    jh = jnets.rnn_carry(jp["policy"], (4,))
    jhv = jnets.rnn_carry(jp["value"], (4,))
    th = tnets.rnn_carry(tp["policy"], (4,))
    thv = tnets.rnn_carry(tp["value"], (4,))
    pol, val = jax.jit(jnets.rnn_policy_apply), jax.jit(jnets.rnn_value_apply)
    for step in range(3):
        obs = _obs(4, 8, seed=step)
        jh, jm, js = pol(jp["policy"], jh, jnp.asarray(obs))
        jhv, jv = val(jp["value"], jhv, jnp.asarray(obs))
        with torch.no_grad():
            th, tm, ts = tp["policy"](th, torch.from_numpy(obs))
            thv, tv = tp["value"](thv, torch.from_numpy(obs))
        for a, b in ((th, jh), (tm, jm), (ts, js), (thv, jhv), (tv, jv)):
            _close(a, b)


def test_layernorm_uses_population_variance():
    x = _obs(5, 32) * 7.0
    scale = np.linspace(0.5, 1.5, 32).astype(np.float32)
    bias = np.linspace(-1, 1, 32).astype(np.float32)
    ref = jax_layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x))
    got = layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                    torch.from_numpy(x))
    _close(got, ref)


def test_layernorm_accumulates_in_float32_or_float64():
    """bf16 and float32 inputs accumulate in float32, float64 inputs in
    float64: within 1e-13 of the population-variance formula in NumPy
    float64."""
    x = _obs(5, 32).astype(np.float64) * 7.0
    scale = np.linspace(0.5, 1.5, 32)
    bias = np.linspace(-1, 1, 32)
    mu = x.mean(-1, keepdims=True)
    want = ((x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True)
                               + 1e-5) * scale + bias)
    got = layernorm(*(torch.from_numpy(a) for a in (scale, bias, x)))
    assert got.dtype == torch.float64
    _close(got, want, atol=1e-13)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    sb, bb = torch.from_numpy(scale).float(), torch.from_numpy(bias).float()
    assert torch.equal(layernorm(sb, bb, xb),
                       layernorm(sb, bb, xb.float()).to(torch.bfloat16))


def test_adamw_float64_moments_run_the_step_in_float64():
    """float64 moments make the whole step float64: two steps within
    1e-15 of the reference's formulas in NumPy float64, and within
    float32 rounding of the float32 step."""
    rng = np.random.default_rng(7)
    shapes = {"a.w": (6, 4), "a.b": (4,), "b": ()}
    p0 = {n: rng.normal(0, 1, s) for n, s in shapes.items()}
    g = {n: rng.normal(0, 0.5, s) for n, s in shapes.items()}
    lr, b1, b2, eps, wd, clip = 3e-4, 0.9, 0.95, 1e-8, 0.1, 0.5

    def numpy_steps(p, n_steps):
        m = {n: np.zeros_like(x) for n, x in p.items()}
        v = {n: np.zeros_like(x) for n, x in p.items()}
        norm = np.sqrt(sum((x ** 2).sum() for x in g.values()))
        k = min(1.0, clip / max(norm, 1e-9))
        for t in range(1, n_steps + 1):
            for n in p:
                gc = g[n] * k
                m[n] = b1 * m[n] + (1 - b1) * gc
                v[n] = b2 * v[n] + (1 - b2) * gc ** 2
                mh, vh = m[n] / (1 - b1 ** t), v[n] / (1 - b2 ** t)
                p[n] = p[n] - lr * (mh / (np.sqrt(vh) + eps) + wd * p[n])
        return p

    want = numpy_steps(dict(p0), 2)
    for dtype, atol in ((torch.float64, 1e-15), (torch.float32, 1e-6)):
        params = {n: torch.tensor(x, dtype=dtype) for n, x in p0.items()}
        grads = {n: torch.tensor(x, dtype=dtype) for n, x in g.items()}
        opt = adamw_init(params)
        opt = {"m": {n: t.to(dtype) for n, t in opt["m"].items()},
               "v": {n: t.to(dtype) for n, t in opt["v"].items()},
               "step": opt["step"]}
        for _ in range(2):
            params, opt, _ = adamw_update(params, grads, opt, lr=lr,
                                          weight_decay=wd,
                                          max_grad_norm=clip)
        for n, t in params.items():
            assert t.dtype == dtype
            _close(t, want[n], atol=atol)


@pytest.mark.parametrize("weight_decay,max_grad_norm", [(0.0, 0.5),
                                                        (0.1, 1e3)])
def test_one_adamw_update_matches(weight_decay, max_grad_norm):
    """The second AdamW step from the same params, grads and state (so the
    bias corrections and moments are exercised), clipping on and off."""
    jp = _jax_agent(8)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, 0.3, p.shape), jnp.float32), jp)
    step = jax.jit(partial(jax_adamw_update, lr=3e-4,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm))
    jp1, jopt1, _ = step(jp, grads, jax_adamw_init(jp))
    jp2, jopt2, jmet = step(jp1, grads, jopt1)
    named = {n: p.detach() for n, p in
             params_from_jax(jp1, device="cpu").named_parameters()}
    tgrads = {n: torch.from_numpy(np.array(g))
              for n, g in flatten_tree(grads).items()}
    new, topt, tmet = adamw_update(
        named, tgrads, adamw_state_from_jax(jopt1, device="cpu"), lr=3e-4,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    jflat = flatten_tree(jp2)
    for n, t in new.items():
        _close(t, jflat[n], atol=1e-6)
    np.testing.assert_allclose(tmet["grad_norm"], jmet["grad_norm"],
                               rtol=1e-6)
    back = adamw_state_to_jax(topt)
    assert int(back["step"]) == int(jopt2["step"]) == 2
    for key in ("m", "v"):
        ref = flatten_tree(jopt2[key])
        for n, m in flatten_tree(back[key]).items():
            _close(m, ref[n], atol=1e-6)


def test_conversion_round_trips_and_init_matches_reference_layout():
    jp = _jax_agent(13, gru=True)
    back = params_to_jax(params_from_jax(jp, device="cpu"))
    jflat, bflat = flatten_tree(jp), flatten_tree(back)
    assert jflat.keys() == bflat.keys()
    for n in jflat:
        np.testing.assert_array_equal(bflat[n], np.asarray(jflat[n]))
    # a fresh port agent has the reference's names and shapes
    fresh = {n: tuple(p.shape) for n, p in torch.nn.ModuleDict({
        "policy": tnets.PolicyNet(obs_dim=8, action_scale=10.0),
        "value": tnets.ValueNet(obs_dim=8)}).named_parameters()}
    ref = {n: tuple(np.shape(v)) for n, v in flatten_tree(_jax_agent(8)).items()}
    assert fresh == ref
    opt = adamw_init({n: torch.zeros(s) for n, s in fresh.items()})
    assert int(opt["step"]) == 0 and opt["m"].keys() == fresh.keys()
