"""The port's multi-link topology core (``repro_torch.core.topology``)
against the JAX package's, env by env, on NumPy-made inputs.

The rate solve goes through the contention wrapper with ``rounds = F``
(its plain version on the CPU) and is held to the reference's
``_topology_substep_rates`` at 2e-5 with finite caps (float32
reassociation in the flow sums); reset, step, observation and reward at
1e-5, the sim-kernel tolerance. At one link with every flow routed and no
finite cap the topology path is the port's fleet path at atol 0. The
reference tests' own cases (min over path links, work conservation under
caps, empty paths, failover at the route bin, achievable scaling) are held
at their own tolerances, and the live TopologyController's feature rows
against the sim's at 1e-7. The reference's initial threads come from its
key stream and are handed to the port's reset."""

import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from repro.core import fleet as jf, simulator as jsim, topology as jt
from repro.core.controller import TopologyController as JaxTopoController

from repro_torch.core import fleet as tf, simulator as tsim, topology as tt
from repro_torch.core.controller import (FleetController,
                                         TopologyController)
from repro_torch.core.networks import PolicyNet
from repro_torch.core.schedule import make_table, stack_tables, peak_bw
from repro_torch.kernels.contention import ops
from repro_torch.kernels.contention.ref import contention_rates_reference

E, F, L, T, BIN, S = 3, 4, 3, 5, 2.0, 6
TPT, BW, CAP = [0.2, 0.15, 0.2], [1.0, 1.0, 1.0], [2.0, 2.0]


def params():
    return (jsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50),
            tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                                 device="cpu"))


def world(seed):
    """Per-env link graphs, two-bin routes (some flows pathless in a bin),
    activity windows, threads, buffers, start times and objectives with
    half the caps finite."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    onpath = f32(rng.random((E, 2, F, L)) < 0.6)
    onpath[:, :, 0, 0] = 1.0
    onpath[0, 1, 1] = 0.0      # a flow with no path in route bin 1
    ts = rng.uniform(0.0, 4.0, (E, F))
    return dict(
        tpt=f32(rng.uniform(0.05, 0.3, (E, L, T, 3))),
        bw=f32(rng.uniform(0.5, 1.5, (E, L, T, 3))),
        bin_seconds=f32(np.full(E, BIN)),
        onpath=onpath, route_bin=f32(rng.uniform(2.0, 6.0, E)),
        t_start=f32(ts), t_end=f32(ts + rng.uniform(3.0, 8.0, (E, F))),
        threads=f32(rng.integers(1, 30, (E, F, 3))),
        buffers=f32(rng.uniform(0.0, 1.0, (E, F, 2))),
        t0=f32(rng.uniform(0.0, 8.0, E)),
        weight=f32(rng.choice([1.0, 2.0, 4.0], (E, F))),
        deadline=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                              rng.uniform(3.0, 12.0, (E, F)))),
        demand=f32(rng.uniform(0.5, 4.0, (E, F))),
        rate_floor=f32(rng.uniform(0.0, 0.2, (E, F))),
        rate_cap=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                              rng.uniform(0.05, 0.5, (E, F)))))


def reference_env(w, e, objectives):
    """Env ``e`` of the world in the reference's types."""
    graph = jt.make_link_graph(w["tpt"][e], w["bw"][e], w["bin_seconds"][e])
    paths = jt.make_path_spec(w["onpath"][e], w["route_bin"][e])
    flows = jf.make_flow_schedule(w["t_start"][e], w["t_end"][e])
    objs = (jf.FlowObjective(*(jnp.asarray(w[k][e])
                               for k in jf.FlowObjective._fields))
            if objectives else None)
    return graph, paths, flows, objs


def port_world(w, objectives):
    t = lambda k: torch.from_numpy(w[k])
    graph = tt.LinkGraph(t("tpt"), t("bw"), t("bin_seconds"))
    paths = tt.PathSpec(t("onpath"), t("route_bin"))
    flows = tf.FlowSchedule(t("t_start"), t("t_end"))
    objs = (tf.FlowObjective(*(t(k) for k in tf.FlowObjective._fields))
            if objectives else None)
    return graph, paths, flows, objs


def reference_threads(seed, n_envs=E, n_flows=F):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_envs)
    return torch.from_numpy(np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (n_flows, 3), 1, 16))(keys),
        np.float32)), keys


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("objectives", [False, True],
                         ids=["no_objectives", "caps"])
def test_topology_rates_match_reference(seed, objectives):
    jp, tp = params()
    w = world(seed)
    graph, paths, flows, objs = port_world(w, objectives)
    got = tt._solve_topology_rates(tp, graph, paths,
                                   torch.from_numpy(w["threads"]), flows,
                                   torch.from_numpy(w["t0"]), S, objs)
    assert got.shape == (E, S, F, 3)
    for e in range(E):
        jgraph, jpaths, jflows, jobjs = reference_env(w, e, objectives)
        want = jt._topology_substep_rates(
            jp, jgraph, jpaths, jnp.asarray(w["threads"][e]), jflows,
            jnp.asarray(w["t0"][e]), S, jobjs)
        np.testing.assert_allclose(got[e].numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)


def _one_link(seed, objectives):
    """A one-link world with every flow routed and no finite cap: the
    fleet's table and the topology's graph over the same tensors."""
    rng = np.random.default_rng(seed)
    tab = stack_tables([make_table(rng.uniform(0.05, 0.3, (T, 3)),
                                   rng.uniform(0.5, 1.5, (T, 3)), BIN,
                                   device="cpu") for _ in range(E)])
    ts = rng.uniform(0.0, 2.0, (E, F))
    flows = tf.FlowSchedule(torch.tensor(ts, dtype=torch.float32),
                            torch.tensor(ts + rng.uniform(2.0, 9.0, (E, F)),
                                         dtype=torch.float32))
    objs = None
    if objectives:
        objs = tf.FlowObjective(
            *(torch.ones(E, F), torch.full((E, F), np.inf),
              torch.full((E, F), np.inf),
              torch.tensor(rng.uniform(0, 0.4, (E, F)), dtype=torch.float32),
              torch.full((E, F), np.inf)))
    paths = tt.PathSpec(torch.ones(E, 1, F, 1), torch.full((E,), np.inf))
    return tab, tt.single_link_graph(tab), paths, flows, objs


@pytest.mark.parametrize("objectives", [False, True],
                         ids=["no_objectives", "floors"])
def test_one_link_rates_equal_the_fleet_bitwise(objectives):
    _, tp = params()
    rng = np.random.default_rng(4)
    for trial in range(6):
        tab, graph, paths, flows, objs = _one_link(trial, objectives)
        threads = torch.tensor(rng.integers(1, 30, (E, F, 3)),
                               dtype=torch.float32)
        t0 = torch.tensor(rng.uniform(0.0, 6.0, E), dtype=torch.float32)
        want = tf._solve_fleet_rates(tp, tab, threads, flows, t0, S, objs)
        got = tt._solve_topology_rates(tp, graph, paths, threads, flows, t0,
                                       S, objs)
        assert torch.equal(got, want), trial


def test_one_link_chain_equals_the_fleet_bitwise():
    """reset -> steps -> observe through the topology entry points on a
    one-link graph: the fleet chain exactly (state, reward, FLEET_OBS rows,
    the graph peak)."""
    _, tp = params()
    tab, graph, paths, flows, _ = _one_link(9, False)
    threads, _ = reference_threads(3)
    fst = tf.fleet_reset(tp, E, F, flows=flows, table=tab, substeps=S,
                         threads=threads)
    tst = tt.topology_reset(tp, E, F, graph=graph, paths=paths, flows=flows,
                            substeps=S, threads=threads)
    for a, b in zip(fst, tst):
        assert torch.equal(a, b)
    acts = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 30, (4, E, F, 3)).astype(np.float32))
    for i in range(4):
        fst, fobs, frew = tf.fleet_step(tp, fst, acts[i], flows=flows,
                                        table=tab, substeps=S,
                                        spec=tsim.FLEET_OBS,
                                        fairness_coef=0.5)
        tst, tobs, trew = tt.topology_step(tp, tst, acts[i], graph=graph,
                                           paths=paths, flows=flows,
                                           substeps=S, spec=tsim.FLEET_OBS,
                                           fairness_coef=0.5)
        assert torch.equal(frew, trew) and torch.equal(fobs, tobs)
    assert torch.equal(tt.graph_peak_bw(graph), peak_bw(tab))


@pytest.mark.parametrize("spec", ["FLEET_OBS", "TOPOLOGY_OBS"])
@pytest.mark.parametrize("objectives", [False, True],
                         ids=["no_objectives", "objectives"])
def test_reset_step_observe_and_reward_match_reference(spec, objectives):
    jp, tp = params()
    w = world(5)
    graph, paths, flows, objs = port_world(w, objectives)
    threads, keys = reference_threads(5)
    jspec, tspec = getattr(jsim, spec), getattr(tsim, spec)
    acts = np.random.default_rng(6).uniform(0, 30, (3, E, F, 3)).astype(
        np.float32)
    st = tt.topology_reset(tp, E, F, torch.from_numpy(w["t0"]), graph=graph,
                           paths=paths, flows=flows, substeps=S,
                           objectives=objs, threads=threads)
    steps = []
    for i in range(3):
        st, obs, rew = tt.topology_step(tp, st, torch.from_numpy(acts[i]),
                                        graph=graph, paths=paths,
                                        flows=flows, substeps=S, spec=tspec,
                                        fairness_coef=0.5, objectives=objs)
        steps.append((obs, rew))
    for e in range(E):
        jgraph, jpaths, jflows, jobjs = reference_env(w, e, objectives)
        kw = dict(graph=jgraph, paths=jpaths, flows=jflows, substeps=S,
                  objectives=jobjs)
        jst = jt.topology_reset(jp, keys[e], F, w["t0"][e], **kw)
        for i in range(3):
            jst, jobs, jrew = jt.topology_step(
                jp, jst, jnp.asarray(acts[i, e]), spec=jspec,
                fairness_coef=0.5, **kw)
            np.testing.assert_allclose(steps[i][0][e].numpy(),
                                       np.asarray(jobs), atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(steps[i][1][e]), float(jrew),
                                       atol=1e-5, rtol=1e-6)
        for got, want in zip((x[e] for x in st), jst):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)


def test_achievable_routes_and_peaks_match_reference():
    jp, tp = params()
    w = world(7)
    graph, paths, flows, objs = port_world(w, True)
    t = np.asarray([0.5, 3.0, 9.5], np.float32)
    got = tt.topology_achievable(tp, graph, paths, flows, torch.from_numpy(t),
                                 objectives=objs)
    routes = tt.routes_at(paths, torch.from_numpy(t))
    for e in range(E):
        jgraph, jpaths, jflows, jobjs = reference_env(w, e, True)
        want = jt.topology_achievable(jp, jgraph, jpaths, jflows, t[e],
                                      objectives=jobjs)
        np.testing.assert_allclose(float(got[e]), float(want), atol=2e-5)
        np.testing.assert_array_equal(routes[e].numpy(),
                                      np.asarray(jt.routes_at(jpaths, t[e])))
        assert float(tt.graph_peak_bw(graph)[e]) == float(
            jt.graph_peak_bw(jgraph))
        np.testing.assert_array_equal(tt.link_peak_bw(graph)[e].numpy(),
                                      np.asarray(jt.link_peak_bw(jgraph)))


def test_an_infinite_route_bin_is_bin_zero():
    """Static routes have an infinite route bin: floor(t / inf) is bin 0
    in float32 at any finite time, per env and per substep."""
    onpath = torch.stack([torch.eye(2), 1.0 - torch.eye(2)])     # (R=2,F,L)
    one = tt.make_path_spec(onpath, device="cpu")
    batch = tt.stack_path_specs([one, one])
    t = torch.tensor([0.0, 1e30], dtype=torch.float32)
    assert torch.equal(tt.routes_at(batch, t), onpath[[0, 0]])
    assert torch.equal(tt.routes_at(batch, t[:, None].expand(2, 3)),
                       onpath[0].expand(2, 3, 2, 2))


def _graph(tpt, bw, bin_seconds=1.0):
    return tt._batched_topology(tt.Topology(
        tt.make_link_graph(tpt, bw, bin_seconds, device="cpu"),
        tt.make_path_spec(np.zeros((1, 1)), device="cpu"))).graph


def _paths(onpath, bin_seconds=np.inf):
    p = tt.make_path_spec(onpath, bin_seconds, device="cpu")
    return tt.PathSpec(p.onpath[None], p.bin_seconds[None])


def _flows(t_start, t_end):
    return tf.FlowSchedule(torch.tensor([t_start], dtype=torch.float32),
                           torch.tensor([t_end], dtype=torch.float32))


def _always(n):
    return tf._always_on_batch(1, n, torch.device("cpu"))


def _rates(graph, paths, threads, flows, t0, substeps, objs=None):
    _, tp = params()
    return tt._solve_topology_rates(
        tp, graph, paths, torch.tensor(threads, dtype=torch.float32)[None],
        flows, torch.tensor([t0], dtype=torch.float32), substeps,
        objs)[0].numpy()


def test_rate_is_min_over_path_links():
    """A lone flow over a fast and a slow link runs at the slow link's
    rate; over the fast link alone, at the fast rate."""
    graph = _graph(np.full((2, 1, 3), 10.0),
                   [[[4.0, 4.0, 4.0]], [[1.0, 1.0, 1.0]]])
    both = _rates(graph, _paths([[1.0, 1.0]]), np.ones((1, 3)), _always(1),
                  0.0, 1)
    fast = _rates(graph, _paths([[1.0, 0.0]]), np.ones((1, 3)), _always(1),
                  0.0, 1)
    assert np.allclose(both[0, 0], 1.0) and np.allclose(fast[0, 0], 4.0)


def test_work_conserving_under_caps():
    """One capped flow and two uncapped on a saturated link: the capped
    flow's unused share spills to the others and the link moves its full
    capacity (the fleet's solve strands it)."""
    _, tp = params()
    tab = stack_tables([make_table([[10.0] * 3], [[1.0] * 3], 1.0,
                                   device="cpu")])
    objs = tf.FlowObjective(*(x[None] for x in tf.make_flow_objective(
        rate_cap=[0.05, np.inf, np.inf], device="cpu")))
    threads = np.full((3, 3), 10.0)
    topo = _rates(tt.single_link_graph(tab), _paths(np.ones((3, 1))),
                  threads, _always(3), 0.0, 1, objs)[0]
    assert np.allclose(topo.sum(axis=0), 1.0, atol=1e-5)
    assert np.allclose(topo[0], 0.05, atol=1e-6)
    fleet = tf._solve_fleet_rates(
        tp, tab, torch.tensor(threads, dtype=torch.float32)[None],
        _always(3), torch.zeros(1), 1, objs)[0, 0].numpy()
    assert fleet.sum(axis=0).max() < 0.75


def test_empty_path_and_inactive_flows_move_nothing():
    graph = _graph(np.full((2, 1, 3), 10.0), np.full((2, 1, 3), 1.0))
    paths = _paths([[1.0, 0.0], [0.0, 0.0]])   # flow 1 routed nowhere
    flows = _flows([0.0, 0.0], [10.0, 10.0])
    rates = _rates(graph, paths, np.full((2, 3), 5.0), flows, 0.0, 2)
    assert (rates[:, 1] == 0.0).all() and (rates[:, 0] > 0.0).all()
    late = _rates(graph, paths, np.full((2, 3), 5.0), flows, 50.0, 2)
    assert (late == 0.0).all()


def test_failover_routing_moves_rates_at_route_bin():
    bw = np.stack([np.asarray([[2.0] * 3] * 2 + [[0.02] * 3] * 2),
                   np.full((4, 3), 1.0)])
    graph = _graph(np.full((2, 4, 3), 10.0), bw, bin_seconds=5.0)
    paths = _paths([[[1.0, 0.0]], [[0.0, 1.0]]], bin_seconds=10.0)
    assert torch.equal(tt.routes_at(paths, torch.tensor([3.0]))[0],
                       torch.tensor([[1.0, 0.0]]))
    assert torch.equal(tt.routes_at(paths, torch.tensor([12.0]))[0],
                       torch.tensor([[0.0, 1.0]]))
    early = _rates(graph, paths, np.full((1, 3), 10.0), _always(1), 0.0, 1)
    late = _rates(graph, paths, np.full((1, 3), 10.0), _always(1), 19.0, 1)
    assert np.allclose(early[0, 0], 2.0) and np.allclose(late[0, 0], 1.0)


def test_achievable_scales_with_routes():
    _, tp = params()
    graph = _graph(np.full((2, 1, 3), 10.0), np.full((2, 1, 3), 1.0))
    split = _paths([[1.0, 0.0], [0.0, 1.0]])
    shared = _paths([[1.0, 0.0], [1.0, 0.0]])
    t = torch.zeros(1)
    a_split = float(tt.topology_achievable(tp, graph, split, _always(2), t))
    a_shared = float(tt.topology_achievable(tp, graph, shared, _always(2), t))
    assert np.isclose(a_split, 2.0, atol=1e-5)
    assert np.isclose(a_shared, 1.0, atol=1e-5)


def test_topology_features_match_reference():
    rng = np.random.default_rng(8)
    onpath = (rng.random((E, F, L)) < 0.5).astype(np.float32)
    onpath[0, 2] = 0.0
    net = rng.uniform(0.0, 1.0, (E, F)).astype(np.float32)
    act = (rng.random((E, F)) < 0.7).astype(np.float32)
    ref = rng.uniform(0.5, 2.0, (E, L)).astype(np.float32)
    got = tt.topology_features(*(torch.from_numpy(x)
                                 for x in (onpath, net, act, ref)))
    want = jax.vmap(jt.topology_features)(onpath, net, act, ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=0)


def _obs_dict(threads, tps):
    return {"threads": list(np.asarray(threads, float)),
            "throughputs": list(np.asarray(tps, float)),
            "sender_free": CAP[0], "receiver_free": CAP[1],
            "sender_capacity": CAP[0], "receiver_capacity": CAP[1]}


def _net(spec):
    return PolicyNet(obs_dim=spec.dim,
                     generator=torch.Generator().manual_seed(0))


def test_topology_controller_parity_with_sim_features():
    """The live TopologyController appends the sim's topology_features rows
    on top of the FleetController frame (1e-7), and its frames equal the
    reference controller's."""
    onpath = np.asarray([[1.0, 1.0], [0.0, 1.0]])
    link_bw = [1.0, 2.0]
    kw = dict(n_flows=2, n_max=50, bw_ref=2.0, device="cpu")
    ctrl = TopologyController(_net(tsim.TOPOLOGY_OBS), paths=onpath,
                              link_bw_ref=link_bw,
                              obs_spec=tsim.TOPOLOGY_OBS, **kw)
    base_ctrl = FleetController(_net(tsim.FLEET_OBS),
                                obs_spec=tsim.FLEET_OBS, **kw)
    jctrl = JaxTopoController(None, paths=onpath, link_bw_ref=link_bw,
                              n_flows=2, n_max=50, bw_ref=2.0,
                              obs_spec=jsim.TOPOLOGY_OBS)
    obs_list = [_obs_dict([4, 4, 4], [0.5, 0.4, 0.5]),
                _obs_dict([2, 2, 2], [0.3, 0.2, 0.3])]
    frames = ctrl.frames(obs_list, active=[1.0, 1.0])
    assert frames.shape == (2, 19)
    np.testing.assert_array_equal(frames[:, :16],
                                  base_ctrl.frames(obs_list,
                                                   active=[1.0, 1.0]))
    want = tt.topology_features(torch.tensor(onpath, dtype=torch.float32),
                                torch.tensor([0.4, 0.2]), torch.ones(2),
                                torch.tensor(link_bw)).numpy()
    np.testing.assert_allclose(frames[:, 16:], want, atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        frames, jctrl.frames(obs_list, active=[1.0, 1.0]), atol=1e-7,
        rtol=0)
    assert ctrl.frames([], active=[]).shape == (0, 19)


def test_topology_controller_routes_follow_route_bins():
    paths = tt.make_path_spec([[[1.0, 0.0]], [[0.0, 1.0]]], bin_seconds=10.0,
                              device="cpu")
    ctrl = TopologyController(_net(tsim.TOPOLOGY_OBS), paths=paths,
                              link_bw_ref=[1.0, 1.0],
                              n_flows=1, obs_spec=tsim.TOPOLOGY_OBS,
                              device="cpu")
    assert np.array_equal(ctrl.routes(0.0), [[1.0, 0.0]])
    assert np.array_equal(ctrl.routes(25.0), [[0.0, 1.0]])
    with pytest.raises(ValueError):
        TopologyController(_net(tsim.TOPOLOGY_OBS), paths=np.ones((3, 2)),
                           link_bw_ref=[1, 1],
                           n_flows=2, obs_spec=tsim.TOPOLOGY_OBS,
                           device="cpu")


def test_fleet_controller_refuses_a_topology_spec_and_compact_is_refused():
    with pytest.raises(NotImplementedError, match="TopologyController"):
        FleetController(_net(tsim.TOPOLOGY_OBS), n_flows=2,
                        obs_spec=tsim.TOPOLOGY_OBS,
                        device="cpu")
    _, tp = params()
    w = world(3)
    graph, paths, flows, _ = port_world(w, False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tt.topology_reset(tp, E, F, graph=graph, paths=paths, flows=flows,
                          substeps=S, max_active=2)


def test_padding_routes_leaves_the_reward_unchanged():
    """Pathless, never-active padded flows move nothing and score zero."""
    _, tp = params()
    w = world(2)
    graph, paths, flows, _ = port_world(w, False)
    threads, _ = reference_threads(2)
    padded = (tt.pad_path_spec(paths, 8), tf.pad_flow_schedule(flows, 8))
    acts = torch.full((E, F, 3), 7.0)
    runs = []
    for pth, fl, n in ((paths, flows, F), (*padded, 8)):
        th = torch.cat([threads, torch.ones(E, n - F, 3)], dim=1)
        st = tt.topology_reset(tp, E, n, graph=graph, paths=pth, flows=fl,
                               substeps=S, threads=th)
        a = torch.cat([acts, torch.ones(E, n - F, 3)], dim=1)
        st, obs, rew = tt.topology_step(tp, st, a, graph=graph, paths=pth,
                                        flows=fl, substeps=S,
                                        fairness_coef=0.5,
                                        spec=tsim.TOPOLOGY_OBS)
        runs.append((st, obs, rew))
    (st, obs, rew), (pst, pobs, prew) = runs
    torch.testing.assert_close(prew, rew, atol=1e-6, rtol=0)
    # the topology block ignores the padding (the active fraction, column
    # 13, counts the padded fleet by design)
    torch.testing.assert_close(pobs[:, :F, 16:], obs[..., 16:], atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(pst.throughputs[:, :F], st.throughputs,
                               atol=1e-6, rtol=0)
    assert (pst.throughputs[:, F:] == 0.0).all()


@pytest.mark.slow
def test_multilink_live_failover_replay():
    """Live end-to-end (the reference test's durations and bounds): a flow
    over [primary, shared] parks when the primary dies, a reroute to the
    standby unparks it, and a flow sharing only the healthy link keeps
    moving throughout."""
    from repro_torch.transfer import MultiLink, SyntheticSource, NullSink
    MB = 1 << 20
    net = MultiLink(3, aggregate_bps=4 * MB)
    ea = net.attach(SyntheticSource(64 * MB, chunk_bytes=64 << 10),
                    NullSink(), path=[0, 1],
                    initial_concurrency=(4, 4, 4), n_max=8)
    eb = net.attach(SyntheticSource(64 * MB, chunk_bytes=64 << 10),
                    NullSink(), path=[1], initial_concurrency=(4, 4, 4),
                    n_max=8)
    time.sleep(1.0)
    for t in net.links[0]:
        t.set_rates(aggregate_bps=0)
    time.sleep(1.0)
    a0, b0 = ea.bytes_written(), eb.bytes_written()
    time.sleep(1.5)
    assert ea.bytes_written() - a0 < 1 * MB
    assert eb.bytes_written() - b0 > 3 * MB
    net.reroute(ea, [2, 1])
    time.sleep(2.0)
    assert ea.bytes_written() - a0 > 2 * MB
    net.close()


# K3 at the shapes the topology path gives it, rounds = F: training's 16
# envs of 4 flows over 3 links and 50 substeps (bench_topology.py), the
# evaluation's one env, and topology_achievable's one substep with every
# thread count at n_max (the last entry: None draws them)
PATH_SHAPES = [(16, 50, 4, 3, None), (1, 50, 4, 3, None), (1, 1, 4, 3, 50)]


@pytest.mark.cuda
def test_cuda_topology_solve_matches_plain_version():
    """On the card: K3 at each of the topology path's shapes within 2e-5
    of its plain version (objectives off and on, one launch each), and the
    one-link topology solve equal to the fleet's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("cuda: needs a CUDA card and nvcc")
    rng = np.random.default_rng(0)
    c = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device="cuda")
    for Es, Ss, Fs, Ls, n_at in PATH_SHAPES:
        threads = rng.integers(1, 51, (Es, Fs, 3))
        args = [c(threads if n_at is None else np.full_like(threads, n_at)),
                c(rng.random((Es, Ss, Fs)) < 0.8),
                c(rng.integers(0, 2, (Es, Ss, Fs, Ls))),
                c(rng.uniform(0.1, 0.3, (Es, Ss, Ls, 3))),
                c(rng.uniform(0.75, 1.25, (Es, Ss, Ls, 3)))]
        floor = c(rng.uniform(0.0, 0.5, (Es, Fs)))
        cap = c(np.where(rng.random((Es, Fs)) < 0.5, np.inf,
                         rng.uniform(0.05, 1.0, (Es, Fs))))
        for fc in ((None, None), (floor, cap)):
            before = ops.contention_rates.launches
            got = ops.contention_rates(*args, *fc, rounds=Fs)
            torch.cuda.synchronize()
            assert ops.contention_rates.launches == before + 1
            want = contention_rates_reference(*args, *fc, rounds=Fs)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    tp = tsim.make_env_params(tpt=TPT, bw=BW, cap=CAP, n_max=50,
                              device="cuda")
    tab, graph, paths, flows, objs = _one_link(1, True)
    to = lambda x: type(x)(*(None if y is None else y.cuda() for y in x))
    threads = c(rng.integers(1, 30, (E, F, 3)))
    t0 = c(rng.uniform(0.0, 6.0, E))
    want = tf._solve_fleet_rates(tp, to(tab), threads, to(flows), t0, S,
                                 to(objs))
    got = tt._solve_topology_rates(tp, to(graph), to(paths), threads,
                                   to(flows), t0, S, to(objs))
    assert torch.equal(got, want)
