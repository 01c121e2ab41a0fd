"""The port's online adaptation layer against the JAX package's.

``core/online.py`` is a copy (pinned in ``test_torch_isolation.COPIES``);
these tests hold what surrounds it: the controllers' ``online=`` wiring on
recorded engine observations (frames bitwise equal on both sides, so the
actions and the whole adapter state must be equal), the online feedback
hook of ``run_fleet_in_dynamic_sim`` on a small version of bench_faults'
faulted world (goodput within 1e-5; thread histories, arms, residuals and
the rails' discrete state exactly), and a live ``FleetController`` with
the online head on a real ``SharedLink`` (marked slow, as the reference's
twin is).

Ties. The head picks arms by an argmax of UCB scores, and the sim-side
frames agree only to float32 rounding, so a near-tie could flip an arm.
Every UCB decision of the reference run is recorded, and the gap between
its two best arms must be either exactly 0 (the two arms' models are still
both untrained, which both sides see exactly) or above UCB_MARGIN = 1e-4.
The frozen policy's pre-rounding actions are held 1e-3 clear of .5 ties as
in the other controller tests."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import networks as jnets, simulator as jsim
from repro.core import online as jonline
from repro.core.controller import (AutoMDTController as JaxController,
                                   FleetController as JaxFleetController)
from repro.core.fleet import make_flow_objective as jax_objective
import repro.scenarios as jsc

from repro_torch.convert import params_from_jax
from repro_torch.core import simulator as tsim
from repro_torch.core import online as tonline
from repro_torch.core.controller import AutoMDTController, FleetController
from repro_torch.core.fleet import make_flow_objective
import repro_torch.scenarios as tsc

from test_torch_controller import recorded_observations, _value_stub
from test_torch_fleet_controller import recorded_batches
from test_torch_fleet_eval import _policies, reference_threads  # noqa: F401
import test_torch_fleet_eval as fe

pytestmark = pytest.mark.online

UCB_MARGIN = 1e-4
# bench_online.py's online layer
ONLINE = dict(step=3.0, max_residual=32.0, buffer=192, explore=0.5,
              beta=0.35, warmup=2, fallback=-0.6, re_engage=-0.1,
              cooldown=2)


def _configs(**kw):
    cfg = {**ONLINE, **kw}
    return jonline.OnlineConfig(**cfg), tonline.OnlineConfig(**cfg)


def _adapter_state(ad):
    """The adapter's state: its discrete part (held exactly) and its float
    part (held exactly on bitwise-equal frames, within 1e-5 on the sim)."""
    exact = dict(mode=ad.mode, n_fallbacks=ad.n_fallbacks, fed=ad._fed,
                 off_steps=ad._off_steps, residual=ad.residual.tolist(),
                 n_buffer=0 if ad.buffer is None else len(ad.buffer))
    floats = dict(advantage=ad.advantage, frozen_ref=ad._frozen_ref,
                  r_scale=ad._r_scale)
    if ad.buffer is not None:
        frames, residuals, arms, rewards = ad.buffer.view()
        exact.update(arms=arms.tolist(), residuals=residuals.tolist())
        floats.update(rewards=rewards, frames=frames)
    return exact, floats


def _same_state(got, want, atol=0.0):
    (ge, gf), (we, wf) = _adapter_state(got), _adapter_state(want)
    assert ge == we
    for k in wf:
        if wf[k] is None:
            assert gf[k] is None, k
        else:
            np.testing.assert_allclose(gf[k], wf[k], atol=atol, rtol=0,
                                       err_msg=k)


@pytest.fixture
def ucb_gaps(monkeypatch):
    """Every UCB decision of the REFERENCE head: the gap between the best
    and second-best arm of each (flow, stage)."""
    gaps = []
    real = jonline.ResidualBandit.choose

    def choose(self, frames, residuals):
        for s in range(3):
            x = self._ctx(frames, residuals, s)
            q = np.stack([x @ self._w[s, a] + self.cfg.explore * np.sqrt(
                np.maximum(np.einsum("fd,dk,fk->f", x, self._Ainv[s, a], x),
                           0.0)) for a in range(3)], axis=-1)
            top = np.sort(q, axis=-1)
            gaps.append(top[:, -1] - top[:, -2])
        return real(self, frames, residuals)

    monkeypatch.setattr(jonline.ResidualBandit, "choose", choose)
    return gaps


def assert_clear_of_ucb_ties(gaps):
    gaps = np.concatenate(gaps)
    assert gaps.size, "the head never chose an arm"
    live = gaps[gaps != 0.0]
    assert live.size and live.min() > UCB_MARGIN, (
        f"a UCB decision lies {live.min():.2e} from a tie: pick another "
        "seed")


def _sim_units(observations):
    """Recorded engine observations with throughputs scaled to sim units
    (about 0-1.2), where the realized reward is O(1) like the sim's and
    the head's arms separate."""
    return [{**o, "throughputs": np.asarray(o["throughputs"]) * 1e-7}
            for o in observations]


def test_realized_reward_and_config_match_reference():
    rng = np.random.default_rng(0)
    tps, n = rng.uniform(0, 1, (5, 3)), rng.integers(1, 40, (5, 3))
    w = rng.choice([1.0, 2.0, 4.0], 5)
    np.testing.assert_array_equal(
        tonline.realized_reward(tps, n, weights=w),
        jonline.realized_reward(tps, n, weights=w))
    with pytest.raises(ValueError):
        tonline.OnlineConfig(fallback=0.0, re_engage=-0.1)
    with pytest.raises(ValueError):
        tonline.OnlineConfig(warmup=0)


# (params seed, UCB exploration, dither probability): UCB alone, and UCB
# with the seeded epsilon dither
AUTO_CASES = [(0, 3.0, 0.0), (4, 0.5, 0.3)]


@pytest.mark.parametrize("seed,explore,epsilon", AUTO_CASES,
                         ids=["ucb", "dither"])
def test_automdt_controller_online_matches_reference(seed, explore, epsilon,
                                                     ucb_gaps):
    spec = jsim.CONTEXT_OBS
    jp = jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=spec.dim, action_scale=10.0))(jax.random.PRNGKey(seed))
    jp["mean"]["w"] = jp["mean"]["w"] * 60.0
    tp = params_from_jax({"policy": jp, "value": _value_stub(spec.dim,
                                                             "mlp")},
                         device="cpu")["policy"]
    jcfg, tcfg = _configs(warmup=1, step=2.0, explore=explore,
                          epsilon=epsilon)
    kw = dict(n_max=32, bw_ref=None, deterministic=True)
    jctl = JaxController(jp, obs_spec=spec, online=jcfg, **kw)
    tctl = AutoMDTController(tp, obs_spec=tsim.ObservationSpec(
        **spec._asdict()), online=tcfg, device="cpu", **kw)
    observations = _sim_units(recorded_observations(16, seed + 10))
    # the frozen actions, from a controller of their own, clear of ties
    frozen = JaxController(jp, obs_spec=spec, **kw)
    apply = jax.jit(jnets.policy_apply)
    for obs in observations:
        jvec = frozen._obs_vector(obs)
        mean = np.asarray(apply(jp, jnp.asarray(jvec)[None])[0])
        mean = mean[(mean > 1.0) & (mean < 32)]
        assert np.abs(mean - np.floor(mean) - 0.5).min(initial=1.0) > 1e-3
    moved = 0.0
    for obs in observations:
        assert tctl.step(obs) == jctl.step(obs)
        _same_state(tctl._online, jctl._online)
        moved += np.abs(tctl._online.residual).sum()
    assert moved > 0.0 and tctl._online.n_fallbacks > 0
    assert_clear_of_ucb_ties(ucb_gaps)


@pytest.mark.parametrize("weights", [False, True])
def test_fleet_controller_online_matches_reference(weights, ucb_gaps):
    spec = jsim.FLEET_OBS
    F, n_max = 5, 32
    jp = jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=spec.dim, action_scale=10.0))(jax.random.PRNGKey(7))
    jp["mean"]["w"] = jp["mean"]["w"] * 60.0
    tp = params_from_jax({"policy": jp, "value": _value_stub(spec.dim,
                                                             "mlp")},
                         device="cpu")["policy"]
    w = [4.0, 2.0, 1.0, 1.0, 2.0]
    jcfg, tcfg = _configs(warmup=1, step=2.0, explore=0.5)
    kw = dict(n_flows=F, n_max=n_max, bw_ref=1.2, deterministic=True)
    jctl = JaxFleetController(jp, obs_spec=spec, online=jcfg,
                              objectives=(jax_objective(weight=w)
                                          if weights else None), **kw)
    tctl = FleetController(tp, obs_spec=tsim.ObservationSpec(
        **spec._asdict()), online=tcfg, device="cpu",
        objectives=(make_flow_objective(weight=w, device="cpu")
                    if weights else None), **kw)
    # the frozen actions, from a controller of their own, clear of ties
    frozen = JaxFleetController(jp, obs_spec=spec, **kw)
    apply = jax.jit(jnets.policy_apply)
    rng = np.random.default_rng(3)
    moved = 0.0
    for obs in _sim_units(recorded_batches(14, 21)):
        active = (rng.random(F) < 0.8).astype(float)
        frames = frozen.frames_arrays(obs, active)
        mean = np.asarray(apply(jp, jnp.asarray(frames))[0])
        mean = mean[(mean > 1.0) & (mean < n_max)]
        assert np.abs(mean - np.floor(mean) - 0.5).min(initial=1.0) > 1e-3
        ja = jctl.step_arrays(obs, active)
        ta = tctl.step_arrays(obs, active)
        np.testing.assert_array_equal(ta, ja)
        _same_state(tctl._online, jctl._online)
        moved += np.abs(tctl._online.residual).sum()
    assert moved > 0.0 and tctl._online.mode != "warmup"
    assert_clear_of_ucb_ties(ucb_gaps)


def test_online_none_keeps_the_frozen_program():
    """online=None gives bitwise the actions of a controller built without
    the argument, and the online head moves them once engaged."""
    spec = tsim.FLEET_OBS
    tp = params_from_jax({"policy": jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=spec.dim, action_scale=10.0))(jax.random.PRNGKey(2)),
        "value": _value_stub(spec.dim, "mlp")}, device="cpu")["policy"]
    kw = dict(n_flows=5, n_max=32, bw_ref=1.2, obs_spec=spec,
              device="cpu")
    plain, none = FleetController(tp, **kw), FleetController(tp, online=None,
                                                             **kw)
    online = FleetController(tp, online=tonline.OnlineConfig(
        warmup=1, explore=0.5), **kw)
    assert none._online is None
    differs = False
    for obs in _sim_units(recorded_batches(8, 5)):
        a = plain.step_arrays(obs)
        np.testing.assert_array_equal(none.step_arrays(obs), a)
        differs |= not np.array_equal(online.step_arrays(obs), a)
    assert differs


# ---------------------------------------------------------------------------
# The sim-side hook: run_fleet_in_dynamic_sim on a faulted world
# ---------------------------------------------------------------------------

HORIZON, F = 16.0, fe.F
TPT, BW = (0.08, 0.05, 0.08), (1.0, 1.0, 1.0)


class _Faulted:
    """A ScenarioSpec-shaped object handing back a fault-compiled table
    (bench_faults' ``_FaultedSpec``)."""

    def __init__(self, table):
        self.name, self.horizon, self._table = "faulted", HORIZON, table

    def table(self, *, device=None):
        return self._table if device is None else type(self._table)(
            *(x.to(device) for x in self._table))


def _eval_world(pkg, **device):
    """bench_faults' eval_world at HORIZON and F flows: a kill of the last
    flow at 0.25 h, a stage-1 hang over 0.45-0.55 h, the restart at
    0.65 h."""
    base = pkg.ScenarioSpec(family="static", seed=11, horizon=HORIZON,
                            base_tpt=TPT, base_bw=BW)
    flows = pkg.arrival_schedule("always_on", F, horizon=HORIZON, seed=11,
                                 **device)
    spec = pkg.FaultSpec(name="bench", events=[
        pkg.FaultEvent(kind="kill_flow", t=0.25 * HORIZON, flow=F - 1),
        pkg.FaultEvent(kind="stage_hang", t=0.45 * HORIZON,
                       until=0.55 * HORIZON, stage=1),
        pkg.FaultEvent(kind="restart_flow", t=0.65 * HORIZON, flow=F - 1)])
    table = pkg.apply_faults_to_table(spec, base.table(**device))
    return _Faulted(table), pkg.apply_faults_to_flows(spec, flows)


@pytest.mark.parametrize("online,seed", [(False, 0), (True, 0), (True, 3)],
                         ids=["frozen", "online-0", "online-3"])
def test_fleet_eval_on_a_faulted_world_with_the_online_hook(
        reference_threads, ucb_gaps, online, seed):
    jenv = jsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=fe.N_MAX)
    tenv = tsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=fe.N_MAX, device="cpu")
    jactor, tactor = _policies(jsim.FLEET_OBS, seed)
    if online:
        jcfg, tcfg = _configs()
        jactor = jonline.OnlineFleetPolicy(jactor, jcfg, n_flows=F)
        tactor = tonline.OnlineFleetPolicy(tactor, tcfg, n_flows=F)
    jspec, jflows = _eval_world(jsc)
    tspec, tflows = _eval_world(tsc, device="cpu")
    assert tflows.down_start is not None
    want = jsc.run_fleet_in_dynamic_sim(jspec, jflows, jenv, jactor,
                                        seed=fe.SEED, label="x")
    got = tsc.run_fleet_in_dynamic_sim(tspec, tflows, tenv, tactor,
                                       seed=fe.SEED, label="x")
    np.testing.assert_array_equal(got.threads, want.threads)
    np.testing.assert_allclose(got.goodput, want.goodput, atol=1e-5, rtol=0)
    for name in ("utilization", "jain", "delivered", "mean_active"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    # the killed flow moved nothing while it was down
    down = slice(int(0.25 * HORIZON), int(0.65 * HORIZON) - 1)
    assert np.all(got.goodput[down, F - 1] == 0.0)
    if online:
        _same_state(tactor.adapter, jactor.adapter, atol=1e-5)
        assert tactor.adapter._fed == got.goodput.shape[0]
        assert tactor.adapter.mode != "warmup"
        assert_clear_of_ucb_ties(ucb_gaps)


# ---------------------------------------------------------------------------
# Live: the online head on a real SharedLink fleet
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_online_fleet_controller_adapts_on_a_live_shared_link():
    """The reference's live loop (tests/test_online.py, marked slow as it
    is) on the port's modules: FleetController(online=...) drives real
    engines on a SharedLink; the adapter settles every interval after the
    first, records live transitions, leaves warmup, and every applied
    action lies in [1, n_max]."""
    from repro_torch.core.networks import PolicyNet
    from repro_torch.transfer import SharedLink, SyntheticSource, ChecksumSink
    MB = 1 << 20
    n_flows, n_max = 2, 16
    link = SharedLink(aggregate_bps=(None, 4 * MB, None))
    for f in range(n_flows):
        link.attach(SyntheticSource(1 << 40, chunk_bytes=64 * 1024, seed=f),
                    ChecksumSink(), initial_concurrency=(2, 2, 2),
                    n_max=n_max, metric_interval=0.1)
    params = PolicyNet(obs_dim=tsim.FLEET_OBS.dim, hidden=16,
                       action_scale=n_max / 4,
                       generator=torch.Generator().manual_seed(0))
    cfg = tonline.OnlineConfig(warmup=1, step=2.0, max_residual=8.0,
                               explore=0.5)
    ctrl = FleetController(params, n_flows=n_flows, n_max=n_max,
                           bw_ref=4.0 * MB, obs_spec=tsim.FLEET_OBS,
                           deterministic=True, interval=0.25, online=cfg,
                           device="cpu")
    try:
        trace = ctrl.run(link, interval=0.25, max_steps=8)
    finally:
        link.close()
    assert len(trace) == 8
    ad = ctrl._online
    assert ad._fed >= 7
    assert len(ad.buffer) > 0
    assert ad.mode in ("on", "off")
    for _, threads, _ in trace:
        for n3 in threads:
            assert all(1 <= n <= n_max for n in n3), threads
