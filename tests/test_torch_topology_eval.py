"""The port's topology scenarios against the JAX package's: the
``TopologySpec`` arrays and ``sample_topology_batch`` draws byte for byte,
``run_topology_in_dynamic_sim`` on the same spec, arrivals and actors, and
a TopologyController steering live engines on a MultiLink through a
failover.

``run_topology_in_dynamic_sim`` draws the initial threads from its seed;
the reference draws them from ``jax.random.PRNGKey(seed)``, so the test
hands the reference's draw to the port's ``topology_reset``. Thread
histories must be equal; goodput, utilization and Jain agree to 1e-5
(float32 reassociation in the solve's sums), ``recovery_s`` to 1e-6. The
policy's mean head is scaled so the allocations move."""

import numpy as np
import pytest
import torch
import jax

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro import scenarios as jsc
from repro.core import networks as jnets, simulator as jsim
from repro.core.controller import FleetPolicy as JaxFleetPolicy
from repro.core.fleet import make_flow_objective as jax_objective
from repro.core.globus import GlobusController as JaxGlobus
from repro.core.marlin import MarlinOptimizer as JaxMarlin

from repro_torch import scenarios as tsc
from repro_torch.convert import params_from_jax
from repro_torch.core import (simulator as tsim, GlobusController,
                              MarlinOptimizer, TopologyController)
from repro_torch.core.controller import FleetPolicy
from repro_torch.core.fleet import make_flow_objective
from repro_torch.scenarios import evaluate

from test_torch_scenarios import _same_bytes

N_MAX, F, L, HORIZON, SEED = 50, 3, 3, 16.0, 7
TPT, BW = (0.2, 0.15, 0.2), (1.0, 1.0, 1.0)
OBJ = dict(weight=[4.0, 1.0, 2.0], rate_floor=[0.05, 0.0, 0.02],
           rate_cap=[np.inf, 0.3, np.inf])


@pytest.fixture
def reference_threads(monkeypatch):
    """Hand the reference's initial-thread draw to the port's reset."""
    draw = np.asarray(jax.random.randint(jax.random.PRNGKey(SEED), (F, 3),
                                         1, 16), np.float32)
    real = evaluate.topology_reset

    def reset(*args, generator=None, **kw):
        return real(*args, threads=torch.from_numpy(draw)[None], **kw)

    monkeypatch.setattr(evaluate, "topology_reset", reset)


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


def _actors(kind, seed):
    if kind == "topology":
        return _policies(jsim.TOPOLOGY_OBS, seed)
    if kind == "fleet_1link":
        return _policies(jsim.FLEET_OBS, seed)
    if kind == "static":
        return ([JaxGlobus() for _ in range(F)],
                [GlobusController() for _ in range(F)])
    return ([JaxMarlin(n_max=N_MAX, seed=f) for f in range(F)],
            [MarlinOptimizer(n_max=N_MAX, seed=f) for f in range(F)])


FAMILIES = ("regional_diurnal", "link_failover", "cross_traffic")
CASES = ([(fam, kind, False, i) for i, fam in enumerate(FAMILIES)
          for kind in ("topology", "fleet_1link", "static")]
         + [("link_failover", "marlin", True, 4),
            ("cross_traffic", "topology", True, 5)])


@pytest.mark.parametrize("family,kind,objectives,seed", CASES,
                         ids=[f"{c[0]}-{c[1]}-obj{int(c[2])}" for c in CASES])
def test_topology_evaluation_matches_reference(reference_threads, family,
                                               kind, objectives, seed):
    jenv = jsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=N_MAX)
    tenv = tsim.make_env_params(tpt=list(TPT), bw=list(BW), cap=[2.0, 2.0],
                                n_max=N_MAX, device="cpu")
    kw = dict(family=family, seed=11, n_links=L, n_flows=F, horizon=HORIZON,
              base_tpt=TPT, base_bw=BW)
    jactor, tactor = _actors(kind, seed)
    jobj = jax_objective(**OBJ) if objectives else None
    tobj = make_flow_objective(**OBJ, device="cpu") if objectives else None
    want = jsc.run_topology_in_dynamic_sim(
        jsc.TopologySpec(**kw), jsc.arrival_schedule(
            "staggered_start", F, horizon=HORIZON, seed=11),
        jenv, jactor, seed=SEED, objectives=jobj)
    got = tsc.run_topology_in_dynamic_sim(
        tsc.TopologySpec(**kw), tsc.arrival_schedule(
            "staggered_start", F, horizon=HORIZON, seed=11, device="cpu"),
        tenv, tactor, seed=SEED, objectives=tobj)
    assert (got.scenario, got.controller) == (want.scenario, want.controller)
    np.testing.assert_array_equal(got.threads, want.threads)
    np.testing.assert_allclose(got.goodput, want.goodput, atol=1e-5, rtol=0)
    for name in ("utilization", "jain", "delivered", "mean_active"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    if want.recovery_s is None:
        assert got.recovery_s is None
    else:
        assert got.recovery_s == pytest.approx(want.recovery_s, abs=1e-6)
    if kind in ("topology", "fleet_1link"):
        assert len({tuple(t) for t in got.threads.reshape(-1, 3)}) > 1


TOPO_CASES = [dict(seed=0), dict(seed=17, objective_mix=True, n_links=3),
              dict(seed=3, families=("link_failover",), pad_flows=True),
              dict(seed=2029, arrival_families=("poisson_arrivals",),
                   horizon=40.0, n_links=1)]


@pytest.mark.parametrize("case", TOPO_CASES,
                         ids=[str(c["seed"]) for c in TOPO_CASES])
def test_sample_topology_batch_is_byte_identical(case):
    n_flows = 3 if case.get("pad_flows") else 4
    got = tsc.sample_topology_batch(5, n_flows, device="cpu", **case)
    want = jsc.sample_topology_batch(5, n_flows, **case)
    for a, b in zip(got.topology.graph, want.topology.graph):
        _same_bytes(a, b)
    for a, b in zip(got.topology.paths, want.topology.paths):
        _same_bytes(a, b)
    for a, b in zip(got.flows, want.flows[:2]):
        _same_bytes(a, b)
    for a, b in zip(got.objectives, want.objectives):
        _same_bytes(a, b)
    assert [s.to_dict() for s in got.specs] == \
        [s.to_dict() for s in want.specs]
    assert got.topology.paths.onpath.shape[-2] == 4   # 3 pads to 4


@pytest.mark.parametrize("family", sorted(jsc.TOPOLOGY_FAMILIES))
def test_topology_spec_arrays_compile_and_json(family):
    kw = dict(family=family, seed=5, n_links=3, n_flows=4, horizon=30.0)
    got, want = tsc.TopologySpec(**kw), jsc.TopologySpec(**kw)
    for a, b in zip(got.arrays(), want.arrays()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    (graph, paths), (jgraph, jpaths) = got.compile(device="cpu"), \
        want.compile()
    for a, b in zip(list(graph) + list(paths), list(jgraph) + list(jpaths)):
        _same_bytes(a, b)
    back = tsc.TopologySpec.from_json(got.to_json())
    assert back.to_dict() == want.to_dict() == got.to_dict()


def test_unported_topology_axes_are_refused():
    with pytest.raises(ValueError):
        tsc.TopologySpec(family="no_such_family")


@pytest.mark.slow
def test_topology_controller_steers_a_multilink_through_a_failover():
    """Live (wall-clock threads, ``slow`` as the reference's
    test_multilink_live_failover_replay): a TopologyController drives three engines on a MultiLink whose
    links replay link_failover's per-link schedules (one ScenarioDriver per
    link); the engines are re-routed at the route bin. Every flow moves
    bytes and the policy acts every interval."""
    from repro_torch.transfer import MultiLink, SyntheticSource, NullSink
    MB = 1 << 20
    unit, scale = 8 * MB, 20.0     # sim Gbit/s -> bytes/s; sim s per wall s
    tspec = tsc.TopologySpec(family="link_failover", seed=11, n_links=L,
                             n_flows=F, horizon=HORIZON)
    tpt, bw, onpath, route_bin = tspec.arrays()
    net = MultiLink(L)
    # the links take their schedules' first bins before any engine runs
    drivers = [tsc.ScenarioDriver(net.link(e),
                                  (tpt[e], bw[e], tspec.bin_seconds),
                                  bytes_per_unit=unit,
                                  time_scale=scale).start()
               for e in range(L)]
    _, policy = _policies(jsim.TOPOLOGY_OBS, 0)
    fail_wall = route_bin / scale
    ctl = TopologyController(
        policy.params, n_flows=F, n_max=8, obs_spec=tsim.TOPOLOGY_OBS,
        paths=tspec.compile(device="cpu")[1]._replace(
            bin_seconds=torch.tensor(fail_wall)),   # the run clock is wall
        link_bw_ref=bw.max(axis=(1, 2)) * unit, bw_ref=unit, interval=0.1,
        device="cpu")
    rerouted = []
    try:
        engines = [net.attach(SyntheticSource(64 * MB, chunk_bytes=64 << 10),
                              NullSink(), path=np.flatnonzero(onpath[0][f]),
                              initial_concurrency=(2, 2, 2), n_max=8)
                   for f in range(F)]

        def on_step(row):
            if row[0] >= fail_wall and not rerouted:
                for f, eng in enumerate(engines):
                    net.reroute(eng, np.flatnonzero(onpath[1][f]))
                rerouted.append(row[0])

        ctl.run(net, interval=0.1, max_steps=10, on_step=on_step)
        moved = net.bytes_written_all()
    finally:
        for d in drivers:
            d.stop()
        net.close()
    assert rerouted and all(b > 0 for b in moved), moved
    assert ctl.fleet_policy.n_dispatch == 10
    assert [net.path_of(e) for e in engines] == [
        tuple(np.flatnonzero(onpath[1][f])) for f in range(F)]
