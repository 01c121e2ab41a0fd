"""The port's fleet evaluation harness (``scenarios/evaluate.py``) against
the JAX package's on the same scenario, arrival schedule and actors.

``run_fleet_in_dynamic_sim`` draws the initial threads from its seed; the
reference draws them from ``jax.random.PRNGKey(seed)``, so the test hands
the reference's draw to the port's ``fleet_reset``. Then every step goes
through the contention solve, the buffer integration and the actor on
both sides: the shared FleetPolicy (deterministic, parameters converted
from the reference's), static Globus and seeded Marlin controllers per
flow. Thread histories must be equal; goodput, utilization and Jain agree
to 1e-5 (float32 reassociation in the solve's sums). The policy's mean
head is scaled so the allocations move."""

import numpy as np
import pytest
import torch
import jax

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import networks as jnets, simulator as jsim
from repro.core.controller import FleetPolicy as JaxFleetPolicy
from repro.core.globus import GlobusController as JaxGlobus
from repro.core.marlin import MarlinOptimizer as JaxMarlin
from repro.scenarios import (ScenarioSpec as JaxSpec,
                             arrival_schedule as jax_arrivals,
                             run_fleet_in_dynamic_sim as jax_run)
from repro.core.fleet import make_flow_objective as jax_objective

from repro_torch.convert import params_from_jax
from repro_torch.core import simulator as tsim, GlobusController
from repro_torch.core import MarlinOptimizer
from repro_torch.core.controller import FleetPolicy
from repro_torch.core.fleet import make_flow_objective
from repro_torch.scenarios import (ScenarioSpec, arrival_schedule,
                                   run_fleet_in_dynamic_sim, evaluate)

N_MAX, F, HORIZON, SEED = 50, 4, 16.0, 7
TPT, BW = (0.2, 0.15, 0.2), (1.0, 1.0, 1.0)
OBJ = dict(weight=[4.0, 1.0, 2.0, 1.0], deadline=[8.0, np.inf, 12.0, np.inf],
           demand=[2.0, np.inf, 3.0, np.inf],
           rate_floor=[0.1, 0.0, 0.05, 0.0])


@pytest.fixture
def reference_threads(monkeypatch):
    """Hand the reference's initial-thread draw to the port's reset."""
    draw = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED), (F, 3),
                                         1, 16), np.float32)
    real = evaluate.fleet_reset

    def reset(*args, generator=None, **kw):
        return real(*args, threads=torch.from_numpy(draw)[None], **kw)

    monkeypatch.setattr(evaluate, "fleet_reset", reset)


def _policies(spec_j, seed):
    jp = jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=spec_j.dim, action_scale=N_MAX / 4))(
            jax.random.PRNGKey(seed))
    jp["mean"]["w"] = jp["mean"]["w"] * 20.0
    jv = jax.jit(lambda k: jnets.value_init(k, obs_dim=spec_j.dim))(
        jax.random.PRNGKey(99))
    tp = params_from_jax({"policy": jp, "value": jv}, device="cpu")
    spec_t = tsim.ObservationSpec(**spec_j._asdict())
    return (JaxFleetPolicy(jp, n_max=N_MAX, deterministic=True,
                           obs_spec=spec_j),
            FleetPolicy(tp["policy"], n_max=N_MAX, deterministic=True,
                        obs_spec=spec_t, device="cpu"))


def _actors(kind, spec_j, seed):
    if kind == "fleet":
        return _policies(spec_j, seed)
    if kind == "static":
        return ([JaxGlobus() for _ in range(F)],
                [GlobusController() for _ in range(F)])
    return ([JaxMarlin(n_max=N_MAX, seed=f) for f in range(F)],
            [MarlinOptimizer(n_max=N_MAX, seed=f) for f in range(F)])


CASES = [("fleet", "staggered_start", False, 0),
         ("fleet", "flash_crowd", True, 1),
         ("static", "poisson_arrivals", False, 2),
         ("marlin", "staggered_start", True, 3)]


@pytest.mark.parametrize("kind,arrival,objectives,seed", CASES,
                         ids=[f"{c[0]}-{c[1]}-obj{int(c[2])}" for c in CASES])
def test_fleet_evaluation_matches_reference(reference_threads, kind, arrival,
                                            objectives, seed):
    spec_j = jsim.OBJECTIVE_OBS if objectives else jsim.FLEET_OBS
    jenv = jsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=N_MAX)
    tenv = tsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=N_MAX, device="cpu")
    kw = dict(family="static", seed=11, horizon=HORIZON, base_tpt=TPT,
              base_bw=BW)
    jactor, tactor = _actors(kind, spec_j, seed)
    jobj = jax_objective(**OBJ) if objectives else None
    tobj = make_flow_objective(**OBJ, device="cpu") if objectives else None
    want = jax_run(JaxSpec(**kw), jax_arrivals(arrival, F, horizon=HORIZON,
                                               seed=11),
                   jenv, jactor, seed=SEED, arrival=arrival, objectives=jobj)
    got = run_fleet_in_dynamic_sim(
        ScenarioSpec(**kw), arrival_schedule(arrival, F, horizon=HORIZON,
                                             seed=11, device="cpu"),
        tenv, tactor, seed=SEED, arrival=arrival, objectives=tobj)
    assert got.controller == want.controller
    np.testing.assert_array_equal(got.threads, want.threads)
    np.testing.assert_allclose(got.goodput, want.goodput, atol=1e-5, rtol=0)
    for name in ("utilization", "jain", "delivered", "mean_active",
                 "weighted_utilization"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    assert (got.deadline_hits, got.deadline_total) == (want.deadline_hits,
                                                       want.deadline_total)
    if kind == "fleet":
        # the allocations moved, so the comparison saw the policy act
        assert len({tuple(t) for t in got.threads.reshape(-1, 3)}) > 1
