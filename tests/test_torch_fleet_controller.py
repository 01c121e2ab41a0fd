"""The port's FleetController against the JAX package's on recorded
batched engine observations: the (F, frame_dim) frames with the cross-flow
(FLEET_OBS) and objective (OBJECTIVE_OBS) blocks at 1e-6 (the NumPy
objective block's float32 tanh may differ in the last bit), and the
deterministic actions equal from the same parameters. The mean head is
scaled up so the allocations move; each step asserts that no pre-rounding
action inside (1, n_max) lies within 1e-3 of a .5 tie. The live loop is
driven over stand-in engines: termination, masking of finished flows and
the heartbeat health check."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import networks as jnets, simulator as jsim
from repro.core.controller import FleetController as JaxFleetController
from repro.core.fleet import make_flow_objective as jax_objective

from repro_torch.convert import params_from_jax
from repro_torch.core import simulator as tsim
from repro_torch.core.controller import FleetController
from repro_torch.core.fleet import make_flow_objective
from repro_torch.core.networks import PolicyNet
from repro_torch.runtime import HeartbeatRegistry

N_MAX, F = 32, 5


def recorded_batches(n, seed):
    """Batched observe() arrays as a SharedLink reports them."""
    rng = np.random.default_rng(seed)
    return [{"threads": rng.integers(1, N_MAX + 1, (F, 3)).astype(float),
             "throughputs": rng.uniform(0, 12e6, (F, 3)),
             "sender_free": rng.uniform(0, 4e6, F),
             "receiver_free": rng.uniform(0, 4e6, F),
             "sender_capacity": np.full(F, 4e6),
             "receiver_capacity": np.full(F, 4e6)} for _ in range(n)]


OBJ = dict(weight=[4.0, 2.0, 1.0, 1.0, 2.0],
           deadline=[30.0, np.inf, 12.0, np.inf, 50.0],
           demand=[2e8, np.inf, 5e7, np.inf, 4e8])

# (spec, bw_ref, objectives, params seed)
CASES = [(jsim.FLEET_OBS, 12e6, False, 0),
         (jsim.FLEET_OBS, None, False, 1),
         (jsim.OBJECTIVE_OBS, None, True, 2),
         (jsim.OBJECTIVE_OBS, 10e6, False, 3)]


@pytest.mark.parametrize("spec,bw_ref,objectives,seed", CASES,
                         ids=["fleet_bw", "fleet_running", "objectives",
                              "objectives_default"])
def test_frames_and_actions_match_reference(spec, bw_ref, objectives, seed):
    obs_dim = spec.dim
    jp = jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=obs_dim, action_scale=10.0))(jax.random.PRNGKey(seed))
    jp["mean"]["w"] = jp["mean"]["w"] * 60.0
    jv = jax.jit(lambda k: jnets.value_init(k, obs_dim=obs_dim))(
        jax.random.PRNGKey(99))
    tp = params_from_jax({"policy": jp, "value": jv}, device="cpu")
    kw = dict(n_flows=F, n_max=N_MAX, bw_ref=bw_ref, deterministic=True)
    jctl = JaxFleetController(
        jp, obs_spec=spec,
        objectives=jax_objective(**OBJ) if objectives else None, **kw)
    tctl = FleetController(
        tp["policy"], obs_spec=tsim.ObservationSpec(**spec._asdict()),
        objectives=(make_flow_objective(**OBJ, device="cpu")
                    if objectives else None), device="cpu", **kw)
    rng = np.random.default_rng(seed)
    apply = jax.jit(jnets.policy_apply)
    moved = set()
    for i, obs in enumerate(recorded_batches(8, seed)):
        active = (rng.random(F) < 0.8).astype(float)
        t, delivered = 2.0 * i, rng.uniform(0, 1e8, F)
        jfr = jctl.frames_arrays(obs, active, t=t, delivered=delivered)
        tfr = tctl.frames_arrays(obs, active, t=t, delivered=delivered)
        assert tfr.shape == (F, spec.frame_dim) and tfr.dtype == np.float32
        np.testing.assert_allclose(tfr, jfr, atol=1e-6, rtol=0)
        mean = np.asarray(apply(jp, jnp.asarray(jfr))[0])
        # a tie outside (1, n_max) is clamped away either way
        mean = mean[(mean > 1.0) & (mean < N_MAX)]
        assert np.abs(mean - np.floor(mean) - 0.5).min(initial=1.0) > 1e-3
        ja = jctl.fleet_policy.act(jfr)
        ta = tctl.fleet_policy.act(jfr)
        np.testing.assert_array_equal(ta, ja)
        moved.add(ta.tobytes())
    assert len(moved) > 1 and tctl.fleet_policy.n_dispatch == 8


def test_unported_options_are_refused():
    tp = PolicyNet(obs_dim=tsim.FLEET_OBS.dim)
    with pytest.raises(NotImplementedError):
        FleetController(tp, n_flows=2, obs_spec=tsim.TOPOLOGY_OBS,
                        device="cpu")


class StandInEngine:
    """The engine surface FleetController.run drives: a flow that moves
    ``rate`` bytes per observe until ``total``, or stalls."""

    def __init__(self, rate, total):
        self.rate, self.total, self.moved = rate, total, 0
        self.threads = (1, 1, 1)
        self.alive = True
        self.steered = 0

    def observe_at(self, now):
        self.moved = min(self.moved + self.rate, self.total)
        tps = [float(self.rate)] * 3
        return {"threads": list(self.threads), "throughputs": tps,
                "sender_free": 1e6, "receiver_free": 1e6,
                "sender_capacity": 2e6, "receiver_capacity": 2e6}

    def set_concurrency(self, n):
        self.threads = n
        self.steered += 1

    def bytes_written(self):
        return self.moved

    def done(self):
        return self.moved >= self.total


def test_run_steers_until_done_and_masks_dead_flows():
    tp = PolicyNet(obs_dim=tsim.FLEET_OBS.dim,
                   generator=torch.Generator().manual_seed(0))
    ctl = FleetController(tp, n_flows=3, n_max=N_MAX, bw_ref=1e6,
                          obs_spec=tsim.FLEET_OBS, device="cpu")
    # the slow flow needs 50 intervals (0.5 s), ten times dead_after, so the
    # stalled flow is declared dead long before the run ends
    fast, slow, stalled = (StandInEngine(5e5, 2e6), StandInEngine(2e4, 2e6),
                           StandInEngine(0.0, 1e6))
    registry = HeartbeatRegistry()
    registry.beat("flowctl", 0, 0.0)     # a foreign worker is ignored
    trace = ctl.run([fast, slow, stalled], interval=0.01, max_steps=200,
                    registry=registry, dead_after=0.05)
    assert fast.done() and slow.done() and not stalled.done()
    assert len(trace) < 200              # ended when the live flows were done
    assert stalled.steered < slow.steered  # the stalled flow was masked
    assert set(registry.snapshot()) == {"flowctl", "flow0", "flow1",
                                        "flow2"}
    assert all(len(row[1]) == 3 for row in trace)
