"""The port's single-flow scenario evaluation against the JAX package's:
``run_in_dynamic_sim`` with the agent and each baseline,
``evaluate_scenario`` (agent, static, exploration-only), the copied
event-driven oracle, and the ScenarioDriver's live replay.

The port draws initial threads from a ``torch.Generator``; the reference
from its key stream, so the tests hand the reference's draws to the
port's ``env_reset`` and to the exploration probe's ``SimEnv``. Thread
histories must be equal, the scores agree within 1e-5 (float32
reassociation in the sim's plain version against XLA's), convergence
steps and completion times exactly.

R4 (``ROADMAP.md``) stands as a strict xfail: the dense simulator against
the event-driven oracle on the example that ``--hypothesis-seed=2`` draws
for the reference's ``test_dense_sim_matches_event_oracle``, where the two
models differ by 0.0770 against the test's tolerance of 0.0551."""

import time

import numpy as np
import pytest
import torch
import jax

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro import scenarios as jsc
from repro.core import networks as jnets, simulator as jsim
from repro.core.controller import AutoMDTController as JaxController
from repro.core.globus import GlobusController as JaxGlobus
from repro.core.marlin import MarlinOptimizer as JaxMarlin
from repro.core.simref import EventSimulator as JaxEventSimulator

from repro_torch import scenarios as tsc
from repro_torch.convert import params_from_jax
from repro_torch.core import (simulator as tsim, GlobusController,
                              MarlinOptimizer, AutoMDTController,
                              EventSimulator, make_env_params, SimEnv,
                              TopologyController, PPOConfig, train_ppo)
from repro_torch.core.networks import PolicyNet
from repro_torch.scenarios import evaluate

N_MAX, HORIZON, SEED = 50, 16.0, 7
TPT, BW = (0.2, 0.15, 0.2), (1.0, 1.0, 1.0)
# the transfer size lies off the multiples of the families' 1.0 Gbit/s
# plateau, so float32 reassociation cannot move the completion step
TOTAL_GBIT = 4.3


def _reference_draw(key):
    return torch.from_numpy(np.asarray(
        jax.random.randint(key, (3,), 1, 16), np.float32))


@pytest.fixture
def reference_threads(monkeypatch):
    """Hand the reference's draws to the port: ``env_reset``'s initial
    threads (key ``PRNGKey(seed)``) and the exploration probe's first
    reset (the first split of ``PRNGKey(seed)``, as the reference's
    SimEnv draws it)."""
    real_reset = evaluate.env_reset

    def env_reset(*args, generator=None, **kw):
        return real_reset(*args, threads=_reference_draw(
            jax.random.PRNGKey(SEED))[None], **kw)

    class RefSimEnv(SimEnv):
        def reset(self, threads=None):
            if threads is None and self.state is None:
                threads = _reference_draw(jax.random.split(
                    jax.random.PRNGKey(SEED))[1])
            return super().reset(threads)

    monkeypatch.setattr(evaluate, "env_reset", env_reset)
    monkeypatch.setattr(evaluate, "SimEnv", RefSimEnv)


def _agents(seed):
    """The same deterministic context-obs agent in both packages, its mean
    head scaled so the allocations move."""
    spec = jsim.CONTEXT_OBS
    jp = jax.jit(lambda k: jnets.policy_init(
        k, obs_dim=spec.dim, action_scale=N_MAX / 4))(jax.random.PRNGKey(seed))
    jp["mean"]["w"] = jp["mean"]["w"] * 20.0
    jv = jax.jit(lambda k: jnets.value_init(k, obs_dim=spec.dim))(
        jax.random.PRNGKey(99))
    tp = params_from_jax({"policy": jp, "value": jv}, device="cpu")
    kw = dict(n_max=N_MAX, bw_ref=float(max(BW)), deterministic=True)
    return (JaxController(jp, obs_spec=spec, **kw),
            AutoMDTController(tp["policy"], obs_spec=tsim.CONTEXT_OBS,
                              device="cpu", **kw))


def _controllers(kind, seed):
    if kind == "automdt":
        return _agents(seed)
    if kind == "static":
        return JaxGlobus(), GlobusController()
    if kind == "exploration_only":
        return (jsc.evaluate.StaticController([5, 9, 4]),
                tsc.StaticController([5, 9, 4]))
    return JaxMarlin(n_max=N_MAX, seed=seed), MarlinOptimizer(n_max=N_MAX,
                                                              seed=seed)


def _spec(pkg, family):
    return pkg.ScenarioSpec(family=family, seed=11, horizon=HORIZON,
                            base_tpt=TPT, base_bw=BW)


def _hold(got, want):
    assert (got.scenario, got.controller) == (want.scenario, want.controller)
    np.testing.assert_array_equal(got.threads, want.threads)
    np.testing.assert_allclose(got.tput, want.tput, atol=1e-5, rtol=0)
    for name in ("utilization", "mean_utility", "delivered"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    assert got.convergence_steps == want.convergence_steps
    assert got.completion_s == want.completion_s


FAMILIES = ("step", "bursty", "diurnal", "random_walk")
CASES = [(fam, kind, i) for i, fam in enumerate(FAMILIES)
         for kind in ("automdt", "static", "exploration_only", "marlin")]


@pytest.mark.parametrize("family,kind,seed", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_run_in_dynamic_sim_matches_reference(reference_threads, family,
                                              kind, seed):
    jctl, tctl = _controllers(kind, seed)
    jspec, tspec = _spec(jsc, family), _spec(tsc, family)
    kw = dict(seed=SEED, total_gbit=TOTAL_GBIT, label=kind)
    want = jsc.run_in_dynamic_sim(jspec, jsc.default_params(jspec), jctl,
                                  **kw)
    got = tsc.run_in_dynamic_sim(
        tspec, tsc.default_params(tspec, device="cpu"), tctl, **kw)
    _hold(got, want)
    if kind == "automdt":
        assert len({tuple(t) for t in got.threads}) > 1


@pytest.mark.parametrize("family", ["static", "square_wave", "brownout"])
def test_evaluate_scenario_matches_reference(reference_threads, family):
    """The agent against both frozen-world baselines: the exploration
    probe's n*, then each run."""
    jctl, tctl = _agents(3)
    jspec, tspec = _spec(jsc, family), _spec(tsc, family)
    want = jsc.evaluate_scenario(jspec, jctl, seed=SEED,
                                 total_gbit=TOTAL_GBIT)
    got = tsc.evaluate_scenario(tspec, tctl, seed=SEED,
                                total_gbit=TOTAL_GBIT, device="cpu")
    assert list(got) == list(want) == ["automdt", "static",
                                       "exploration_only"]
    for label in want:
        _hold(got[label], want[label])


def test_exploration_baseline_probes_the_opening_conditions(
        reference_threads):
    spec = _spec(tsc, "step")
    params = tsc.default_params(spec, device="cpu")
    ctrl, ex = tsc.exploration_baseline(spec, params, n_samples=40, seed=SEED)
    jspec = _spec(jsc, "step")
    jctrl, jex = jsc.exploration_baseline(jspec, jsc.default_params(jspec),
                                          n_samples=40, seed=SEED)
    np.testing.assert_array_equal(ctrl.update(None), jctrl.update(None))
    np.testing.assert_allclose(ex.bandwidth, jex.bandwidth, atol=1e-6)
    np.testing.assert_allclose(ex.tpt, jex.tpt, atol=1e-6)


def test_entry_points_need_a_device_or_cuda():
    """Without CUDA the new path's entry points refuse rather than fall
    back, unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is CUDA")
    spec = _spec(tsc, "step")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.default_params(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.TopologySpec(family="link_failover").compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.evaluate_scenario(spec, GlobusController())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.sample_topology_batch(2, 2)
    net = PolicyNet(obs_dim=tsim.TOPOLOGY_OBS.dim)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopologyController(net, n_flows=1, paths=np.ones((1, 2)),
                           link_bw_ref=[1.0, 1.0],
                           obs_spec=tsim.TOPOLOGY_OBS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ppo(make_env_params(tpt=TPT, bw=BW, cap=[2.0, 2.0],
                                  device="cpu"),
                  PPOConfig(n_flows=2, obs_spec=tsim.TOPOLOGY_OBS),
                  workload=tsc.sample_topology_batch(1, 2, device="cpu"))


@pytest.mark.parametrize("scheduled", [False, True])
def test_event_oracle_copy_runs_the_reference_program(scheduled):
    """The port's EventSimulator (a copy) gives the reference's numbers,
    with a port ScheduleTable where the reference takes its own."""
    kw = dict(tpt=[0.3, 0.2, 0.25], bandwidth=[1.0, 0.5, 1.0],
              buffer_capacity=[2.0, 2.0], chunk=0.01)
    tpt = np.asarray([[0.3, 0.2, 0.25], [0.1, 0.2, 0.25]], np.float32)
    bw = np.asarray([[1.0, 0.5, 1.0], [1.0, 0.3, 1.0]], np.float32)
    port = EventSimulator(**kw, schedule=(
        tsc.make_table(tpt, bw, 2.0, device="cpu") if scheduled else None))
    ref = JaxEventSimulator(**kw, schedule=(
        jsc.make_table(tpt, bw, 2.0) if scheduled else None))
    for threads in ([2, 3, 4], [5, 1, 2], [3, 3, 3], [1, 8, 2]):
        (r_port, i_port), (r_ref, i_ref) = (port.get_utility(threads),
                                            ref.get_utility(threads))
        assert i_port == i_ref
        assert r_port == pytest.approx(r_ref, rel=1e-6)


def _steady(tpt, bw, cap, threads, seconds=6):
    """The reference test's measurement (``tests/test_simulator.py``), on
    the port: cumulative steady-state rates of the copied event oracle and
    of the dense simulator (one env on the CPU)."""
    ev = EventSimulator(tpt=tpt, bandwidth=bw, buffer_capacity=cap,
                        chunk=min(tpt) / 32)
    warmup = 6
    acc_ev = np.zeros(3)
    wall = 0.0
    for i in range(warmup + seconds):
        _, info = ev.get_utility(threads)
        if i >= warmup:
            acc_ev += np.asarray(info["moved"])
            wall += max(info["finish"])
    p = make_env_params(tpt=tpt, bw=bw, cap=cap, device="cpu")
    bufs = torch.zeros((1, 2))
    acc_d = np.zeros(3)
    n = torch.tensor([threads], dtype=torch.float32)
    for i in range(warmup + seconds):
        bufs, tps = tsim.sim_interval(p, bufs, n, torch.zeros(1))
        if i >= warmup:
            acc_d += tps[0].numpy()
    return acc_ev / max(wall, 1e-9), acc_d / seconds


# three of the reference property test's draws under --hypothesis-seed=2
# that sit inside its domain and tolerance: (tpt, bw, threads)
ORACLE_CASES = [
    ((0.08693729066664774, 0.25555637014447946, 0.36102508402169875),
     (0.9843781181657983, 0.5339871160401681, 1.0908077145710804),
     (26, 5, 25)),
    ((0.2580265046399967, 0.16955111865843756, 0.49239667681021815),
     (1.823493517148803, 1.4211388895129606, 2.563539648964611), (9, 6, 23)),
    ((0.15323562446831998, 0.10752574863225786, 0.17149794949744443),
     (1.5, 0.6796608194348952, 2.9983227561406154), (17, 4, 27))]


def _hold_oracle(tpt, bw, threads):
    """The reference test's claim (``tests/test_simulator.py:54-67``):
    inside its domain, the steady delivered rate of the dense simulator
    is within max(0.15 * bottleneck, 0.03) of the event oracle's."""
    rates = sorted(min(n * t, b) for n, t, b in zip(threads, tpt, bw))
    assert rates[0] < 0.8 * rates[1]   # inside the test's domain
    oracle, dense = _steady(list(tpt), list(bw), [2.0, 2.0], list(threads))
    tol = max(0.15 * rates[0], 0.03)
    assert abs(oracle[2] - dense[2]) <= tol, (oracle, dense)


@pytest.mark.parametrize("tpt,bw,threads", ORACLE_CASES,
                         ids=["a", "b", "c"])
def test_dense_sim_matches_event_oracle_on_fixed_inputs(tpt, bw, threads):
    _hold_oracle(tpt, bw, threads)


# R4's example: the one falsifying draw of the reference's property test
# under --hypothesis-seed=2 (the shrinker's smaller example fails by less)
R4_TPT = (0.24493825392641547, 0.22458493493183174, 0.18352142234294316)
R4_BW = (1.0242654977232086, 0.5, 1.1735121711838747)
R4_THREADS = (3, 27, 2)


@pytest.mark.xfail(strict=True, reason=(
    "R4 (ROADMAP.md): the dense fluid simulator and the event-driven "
    "oracle differ by 0.0770 on this example, past the property test's "
    "tolerance of 0.0551"))
def test_dense_sim_matches_event_oracle_on_the_r4_example():
    _hold_oracle(R4_TPT, R4_BW, R4_THREADS)


def _live_engine(MB):
    from repro_torch.transfer import (TransferEngine, SyntheticSource,
                                      ChecksumSink, StageThrottle)
    src = SyntheticSource(256 * MB, chunk_bytes=128 * 1024)
    return TransferEngine(
        src, ChecksumSink(), sender_buf=4 * MB, receiver_buf=4 * MB,
        throttles=(StageThrottle(), StageThrottle(), StageThrottle()),
        initial_concurrency=(3, 3, 3), metric_interval=0.2)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["step", "bursty"])
def test_scenario_driver_replays_against_the_live_engine(family):
    """The reference test's replay (its durations and bounds, and its
    ``slow`` mark: wall-clock threads): the spec that drives the simulator
    retunes a real TransferEngine."""
    MB = 1 << 20
    spec = tsc.ScenarioSpec(family=family, seed=2, horizon=10.0)
    eng = _live_engine(MB)
    with tsc.ScenarioDriver(eng, spec.table(device="cpu"),
                            bytes_per_unit=8 * MB, time_scale=20.0) as drv:
        time.sleep(0.5)
        assert drv.sim_time() > 0
        assert drv._applied_idx >= 0
        obs = eng.observe()
    eng.close()
    assert eng.bytes_written() > 0
    assert len(obs["throughputs"]) == 3


@pytest.mark.slow
def test_live_engine_sees_step_change():
    """The reference test's step change on the live pipeline (its
    durations and its 0.6 ratio)."""
    from repro_torch.transfer import (TransferEngine, SyntheticSource,
                                      ChecksumSink, StageThrottle)
    MB = 1 << 20
    spec = tsc.ScenarioSpec(family="step", seed=0, horizon=8.0,
                            params={"stage": 1, "at_frac": 0.5,
                                    "factor": 0.3})
    src = SyntheticSource(512 * MB, chunk_bytes=128 * 1024)
    eng = TransferEngine(
        src, ChecksumSink(), sender_buf=4 * MB, receiver_buf=4 * MB,
        throttles=(StageThrottle(), StageThrottle(), StageThrottle()),
        initial_concurrency=(4, 4, 4), metric_interval=0.2)
    with tsc.ScenarioDriver(eng, spec.table(device="cpu"),
                            bytes_per_unit=8 * MB, time_scale=2.0):
        time.sleep(0.4)
        eng.observe()
        time.sleep(1.2)
        before = eng.observe()["throughputs"][1]
        time.sleep(1.0)
        eng.observe()
        time.sleep(1.2)
        after = eng.observe()["throughputs"][1]
    eng.close()
    assert after < 0.6 * before, (before, after)
