"""The port's fault axis (``scenarios/faults.py``, ``FlowSchedule`` down
windows, ``Workload.compiled()``, the samplers' ``fault_mix``) against the
JAX package's.

Fault specs and every NumPy draw must match byte for byte (the samplers
share the reference's NumPy streams). The compiled edits must match byte
for byte too: the bin edges are Python float64 arithmetic on both sides,
and kill times are cast to float32 before the ``t_end`` minimum as the
reference casts them. A materialized all-inf down window must be an exact
no-op (atol 0) through ``fleet_step`` and ``topology_step``. Rollouts on
faulted worlds agree within 1e-5 (the sim-kernel tolerance), with the
reference's random draws handed to the port and every pre-rounding action
at least 1e-3 from a .5 tie."""

import math
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

# the suite runs several pytest workers on the same cores: one torch thread
# each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

import repro.scenarios as jsc
from repro.core import fleet as jf, topology as jt, ppo as jppo
from repro.core import simulator as jsim
from repro.core.schedule import make_table as jax_make_table

import repro_torch.scenarios as tsc
from repro_torch.convert import params_from_jax
from repro_torch.core import fleet as tf, topology as tt, ppo as tppo
from repro_torch.core import simulator as tsim
from repro_torch.core.schedule import make_table
from repro_torch.core.workload import Workload

import test_torch_fleet_ppo as fp
import test_torch_topology_ppo as tp

pytestmark = pytest.mark.ft

MIX = dict(kill_prob=0.7, restart_prob=0.6, hang_prob=0.6)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).tobytes()


def _same(a, b):
    assert _bytes(a) == _bytes(b)


def _same_schedule(got, want):
    for name in tf.FlowSchedule._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            _same(g, w)


def _pair(events, name="x", seed=0):
    """The same FaultSpec in both packages."""
    return (jsc.FaultSpec(name=name, seed=seed, events=[
                jsc.FaultEvent(**e) for e in events]),
            tsc.FaultSpec(name=name, seed=seed, events=[
                tsc.FaultEvent(**e) for e in events]))


# ---------------------------------------------------------------------------
# FaultEvent / FaultSpec
# ---------------------------------------------------------------------------

BAD_EVENTS = [dict(kind="nope", t=1.0), dict(kind="kill_flow", t=-1.0),
              dict(kind="stage_hang", t=5.0, until=5.0),
              dict(kind="stage_hang", t=1.0, until=2.0, stage=3),
              dict(kind="link_blackout", t=3.0, until=1.0)]
BAD_SPECS = [[dict(kind="kill_flow", t=1.0), dict(kind="kill_flow", t=2.0)],
             [dict(kind="kill_flow", t=5.0),
              dict(kind="restart_flow", t=4.0)],
             [dict(kind="restart_flow", t=4.0, flow=1)],
             [dict(kind="kill_flow", t=1.0), dict(kind="restart_flow", t=2.0),
              dict(kind="restart_flow", t=3.0)]]


@pytest.mark.parametrize("event", BAD_EVENTS, ids=lambda e: e["kind"])
def test_fault_event_validation_matches_reference(event):
    with pytest.raises(ValueError):
        jsc.FaultEvent(**event)
    with pytest.raises(ValueError):
        tsc.FaultEvent(**event)


@pytest.mark.parametrize("events", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_fault_spec_validation_matches_reference(events):
    with pytest.raises(ValueError):
        jsc.FaultSpec(events=events)
    with pytest.raises(ValueError):
        tsc.FaultSpec(events=events)


@pytest.mark.parametrize("seed", [0, 11, 2024])
def test_fault_spec_json_and_outages_match_reference(seed):
    kw = dict(seed=seed, horizon=60.0, n_links=3, kill_prob=0.8,
              restart_prob=0.5, hang_prob=0.7, blackout_prob=0.5)
    want, got = jsc.sample_faults(4, **kw), tsc.sample_faults(4, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    assert tsc.FaultSpec.from_json(got.to_json()) == got
    assert got.outages() == want.outages()
    assert got.name == want.name == f"faults-{seed}"


# ---------------------------------------------------------------------------
# Sampling: byte-identical draws, independent streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 77, 31337])
def test_sample_fault_batch_matches_reference(seed):
    kw = dict(seed=seed, horizon=45.0, n_links=2, fault_prob=0.7,
              blackout_prob=0.4, **MIX)
    want = jsc.sample_fault_batch(9, 3, **kw)
    got = tsc.sample_fault_batch(9, 3, **kw)
    assert [f and f.to_dict() for f in got] == [f and f.to_dict()
                                                for f in want]
    assert None in got and any(f is not None for f in got)


@pytest.mark.parametrize("mix", [True, MIX], ids=["defaults", "bench"])
def test_fleet_sampler_with_faults_matches_and_leaves_other_draws(mix):
    kw = dict(seed=9, horizon=30.0, objective_mix=True, pad_flows=True)
    want = jsc.sample_fleet_batch(5, 3, fault_mix=mix, **kw)
    got = tsc.sample_fleet_batch(5, 3, fault_mix=mix, device="cpu", **kw)
    plain = tsc.sample_fleet_batch(5, 3, device="cpu", **kw)
    assert [f.to_dict() for f in got.faults] == [f.to_dict()
                                                 for f in want.faults]
    assert plain.faults is None and got.has_faults
    # adding the mix leaves the tables, arrivals and objectives as they are
    for a, b in zip(list(got.tables) + list(got.flows) + list(got.objectives),
                    list(plain.tables) + list(plain.flows)
                    + list(plain.objectives)):
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
    # and the compiled world is the reference's, byte for byte
    run, jrun = got.compiled(), want.compiled()
    assert run.faults is None and got.faults is not None   # draw kept
    for a, b in zip(run.tables, jrun.tables):
        _same(a, b)
    _same_schedule(run.flows, jrun.flows)


def test_topology_sampler_with_faults_matches_and_leaves_other_draws():
    mix = dict(MIX, blackout_prob=0.5)
    kw = dict(n_links=3, seed=4, horizon=30.0,
              objective_mix=dict(floor_deadline_frac=0.2))
    want = jsc.sample_topology_batch(6, 4, fault_mix=mix, **kw)
    got = tsc.sample_topology_batch(6, 4, fault_mix=mix, device="cpu", **kw)
    plain = tsc.sample_topology_batch(6, 4, device="cpu", **kw)
    assert [f.to_dict() for f in got.faults] == [f.to_dict()
                                                 for f in want.faults]
    # n_links is defaulted into the mix: blackouts reach links past 0
    links = {e.link for f in got.faults for e in f.events
             if e.kind == "link_blackout"}
    assert links - {0}
    for a, b in zip(list(got.topology.graph) + list(got.topology.paths)
                    + list(got.flows) + list(got.objectives),
                    list(plain.topology.graph) + list(plain.topology.paths)
                    + list(plain.flows) + list(plain.objectives)):
        if a is not None:
            _same(a, b)
    run, jrun = got.compiled(), want.compiled()
    for a, b in zip(run.topology.graph, jrun.topology.graph):
        _same(a, b)
    _same_schedule(run.flows, jrun.flows)
    assert float(run.topology.graph.bw.min()) == 0.0   # a link went dark


# ---------------------------------------------------------------------------
# The edits, one structure at a time
# ---------------------------------------------------------------------------

# T = 6 bins of 2 s (a 12 s horizon); F = 4 flows
EDGE_EVENTS = {
    "hang_on_bin_edges": [dict(kind="stage_hang", t=4.0, until=8.0,
                               stage=1)],
    "hang_past_horizon": [dict(kind="stage_hang", t=7.3, until=100.0,
                               stage=0)],
    "blackout_never_recovers": [dict(kind="link_blackout", t=3.3,
                                     until=math.inf, link=1)],
    "unrecovered_kills": [dict(kind="kill_flow", t=10.3, flow=0),
                          dict(kind="kill_flow", t=0.1, flow=3)],
    "kill_restart_mid_bin": [dict(kind="kill_flow", t=2.7, flow=1),
                             dict(kind="restart_flow", t=5.1, flow=1),
                             dict(kind="stage_hang", t=0.3, until=1.7,
                                  stage=2)],
}


def _edge_inputs():
    rng = np.random.default_rng(3)
    tpt = rng.uniform(0.05, 0.3, (6, 3)).astype(np.float32)
    bw = rng.uniform(0.5, 1.5, (6, 3)).astype(np.float32)
    gtpt = rng.uniform(0.05, 0.3, (2, 6, 3)).astype(np.float32)
    gbw = rng.uniform(0.5, 1.5, (2, 6, 3)).astype(np.float32)
    ts = np.asarray([0.0, 1.5, 2.0, 0.0], np.float32)
    te = np.asarray([np.inf, 11.2, 9.9, np.inf], np.float32)
    return tpt, bw, gtpt, gbw, ts, te


@pytest.mark.parametrize("name", sorted(EDGE_EVENTS))
def test_apply_faults_match_reference_bytes(name):
    jspec, tspec = _pair(EDGE_EVENTS[name])
    tpt, bw, gtpt, gbw, ts, te = _edge_inputs()
    want = jsc.apply_faults_to_table(jspec, jax_make_table(tpt, bw, 2.0))
    got = tsc.apply_faults_to_table(tspec, make_table(tpt, bw, 2.0,
                                                      device="cpu"))
    for a, b in zip(got, want):
        _same(a, b)
    want = jsc.apply_faults_to_graph(jspec, jt.make_link_graph(gtpt, gbw,
                                                               2.0))
    got = tsc.apply_faults_to_graph(tspec, tt.make_link_graph(
        gtpt, gbw, 2.0, device="cpu"))
    for a, b in zip(got, want):
        _same(a, b)
    want = jsc.apply_faults_to_flows(jspec, jf.make_flow_schedule(ts, te))
    got = tsc.apply_faults_to_flows(tspec, tf.make_flow_schedule(
        ts, te, device="cpu"))
    _same_schedule(got, want)


def test_apply_faults_pass_through_and_refuse_like_the_reference():
    tpt, bw, gtpt, gbw, ts, te = _edge_inputs()
    table = make_table(tpt, bw, 2.0, device="cpu")
    flows = tf.make_flow_schedule(ts, te, device="cpu")
    graph = tt.make_link_graph(gtpt, gbw, 2.0, device="cpu")
    _, kill = _pair([dict(kind="kill_flow", t=3.0, flow=0)])
    _, hang = _pair([dict(kind="stage_hang", t=3.0, until=4.0)])
    # an event of the other axis leaves the structure the same object
    assert tsc.apply_faults_to_table(kill, table) is table
    assert tsc.apply_faults_to_graph(kill, graph) is graph
    assert tsc.apply_faults_to_flows(hang, flows) is flows
    assert tsc.apply_faults_to_flows(None, flows) is flows
    # the input is not edited in place
    out = tsc.apply_faults_to_flows(kill, flows)
    assert float(out.t_end[0]) == 3.0 and math.isinf(float(te[0]))
    assert math.isinf(float(flows.t_end[0]))
    for bad, fn, target in (
            ([dict(kind="kill_flow", t=1.0, flow=7)],
             "apply_faults_to_flows", flows),
            ([dict(kind="link_blackout", t=1.0, until=2.0, link=5)],
             "apply_faults_to_graph", graph)):
        jspec, tspec = _pair(bad)
        jtarget = (jf.make_flow_schedule(ts, te) if target is flows
                   else jt.make_link_graph(gtpt, gbw, 2.0))
        with pytest.raises(ValueError):
            getattr(jsc, fn)(jspec, jtarget)
        with pytest.raises(ValueError):
            getattr(tsc, fn)(tspec, target)
    # a second outage on a flow that already carries one is refused
    _, kr = _pair([dict(kind="kill_flow", t=1.0, flow=0),
                   dict(kind="restart_flow", t=2.0, flow=0)])
    with pytest.raises(ValueError):
        tsc.apply_faults_to_flows(kr, tsc.apply_faults_to_flows(kr, flows))


def test_compile_fault_batch_touches_only_faulted_envs():
    wl = tsc.sample_fleet_batch(4, 3, seed=4, horizon=30.0, device="cpu")
    jwl = jsc.sample_fleet_batch(4, 3, seed=4, horizon=30.0)
    events = [dict(kind="kill_flow", t=10.0, flow=0),
              dict(kind="kill_flow", t=4.5, flow=2),
              dict(kind="restart_flow", t=7.25, flow=2),
              dict(kind="stage_hang", t=2.0, until=6.0, stage=0)]
    jspec, tspec = _pair(events)
    copies = tsc.compile_fault_batch.host_copies
    tables, flows, _ = tsc.compile_fault_batch(
        [None, tspec, None, None], tables=wl.tables, flows=wl.flows)
    # one trip to the host and back per edited structure, whatever E is
    assert tsc.compile_fault_batch.host_copies - copies == 4
    jtables, jflows, _ = jsc.compile_fault_batch(
        [None, jspec, None, None], tables=jwl.tables, flows=jwl.flows)
    for a, b in zip(tables, jtables):
        _same(a, b)
    _same_schedule(flows, jflows)
    for i in (0, 2, 3):   # fault-free envs bitwise untouched
        _same(tables.tpt[i], wl.tables.tpt[i])
        _same(tables.bw[i], wl.tables.bw[i])
        _same(flows.t_end[i], wl.flows.t_end[i])
        assert torch.isinf(flows.down_start[i]).all()
    assert float(flows.t_end[1, 0]) == 10.0
    assert float(flows.down_start[1, 2]) == 4.5
    assert (tables.bw[1, 2:6, 0] == 0.0).all()
    # the original batch is not edited in place
    assert (wl.tables.bw[1, 2:6, 0] > 0.0).all()
    # all-None short-circuits: the very same objects come back
    t2, f2, _ = tsc.compile_fault_batch([None] * 4, tables=wl.tables,
                                        flows=wl.flows)
    assert t2 is wl.tables and f2 is wl.flows
    with pytest.raises(ValueError):
        tsc.compile_fault_batch([tspec], tables=wl.tables)


def test_workload_compiled_is_self_without_faults():
    wl = tsc.sample_fleet_batch(2, 2, seed=0, horizon=30.0, device="cpu")
    assert wl.compiled() is wl and not wl.has_faults
    assert not Workload(faults=[None, None]).has_faults
    assert Workload(faults=[None, None]).compiled().faults == [None, None]


# ---------------------------------------------------------------------------
# Down windows through the fleet and topology steps
# ---------------------------------------------------------------------------

def test_active_at_stack_and_pad_match_reference_with_down_windows():
    ts, te = [0.0, 0.0, 1.0], [30.0, 30.0, 9.0]
    ds, de = [5.0, np.inf, 2.5], [9.0, np.inf, 4.0]
    j = jf.make_flow_schedule(ts, te, ds, de)
    t = tf.make_flow_schedule(ts, te, ds, de, device="cpu")
    for when in (0.0, 2.5, 4.0, 5.0, 6.0, 9.0, 10.0):
        _same(tf.active_at(t, torch.tensor(when)), jf.active_at(j, when))
    times = np.asarray([4.0, 6.0, 10.0], np.float32)
    # one fleet: a (S,) time vector; a batch of one: (1, S) times
    tb = tf.stack_flow_schedules([t])
    _same(tf.active_at(tb, torch.from_numpy(times)[None])[0],
          jf.active_at(j, jnp.asarray(times)))
    plain_j, plain_t = (jf.make_flow_schedule(ts, te),
                        tf.make_flow_schedule(ts, te, device="cpu"))
    _same_schedule(tf.stack_flow_schedules([t, plain_t, t]),
                   jf.stack_flow_schedules([j, plain_j, j]))
    assert tf.stack_flow_schedules([plain_t, plain_t]).down_start is None
    _same_schedule(tf.pad_flow_schedule(t, 8), jf.pad_flow_schedule(j, 8))
    _same_schedule(tf.pad_flow_schedule(tb, 4),
                   jf.pad_flow_schedule(jf.stack_flow_schedules([j]), 4))
    with pytest.raises(ValueError):
        tf.make_flow_schedule(ts, te, ds, None, device="cpu")
    assert tf.make_flow_schedule(ts, te, device="cpu").down_start is None


def _materialized(flows):
    inf = torch.full_like(flows.t_start, math.inf)
    return flows._replace(down_start=inf, down_end=inf.clone())


def test_materialized_inf_window_is_an_exact_no_op():
    """fleet_reset/fleet_step and topology_reset/topology_step with an
    all-inf down window give BITWISE the states, observations and rewards
    of the schedule without down fields."""
    _, tenv = fp.env_params()
    wl = tsc.sample_fleet_batch(3, 4, seed=2, horizon=20.0,
                                objective_mix=dict(floor_deadline_frac=0.2),
                                device="cpu")
    rng = np.random.default_rng(0)
    threads = torch.from_numpy(rng.integers(1, 16, (3, 4, 3)).astype(
        np.float32))
    acts = [torch.from_numpy(rng.uniform(0, 40, (3, 4, 3)).astype(
        np.float32)) for _ in range(4)]
    spec = tsim.OBJECTIVE_OBS
    for flows in (wl.flows, _materialized(wl.flows)):
        st = tf.fleet_reset(tenv, 3, 4, t0=torch.tensor([0.0, 3.0, 7.5]),
                            flows=flows, table=wl.tables,
                            objectives=wl.objectives, threads=threads)
        out = [st]
        for a in acts:
            st, obs, rew = tf.fleet_step(tenv, st, a, flows=flows,
                                         table=wl.tables, spec=spec,
                                         objectives=wl.objectives,
                                         fairness_coef=0.5)
            out += [st, obs, rew]
        if flows is wl.flows:
            base = out
    for a, b in zip(base, out):
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            assert torch.equal(x, y)
    twl = tsc.sample_topology_batch(3, 4, n_links=3, seed=2, horizon=20.0,
                                    device="cpu")
    world = dict(graph=twl.topology.graph, paths=twl.topology.paths)
    res = []
    for flows in (twl.flows, _materialized(twl.flows)):
        st = tt.topology_reset(tenv, 3, 4, flows=flows, threads=threads,
                               **world)
        st, obs, rew = tt.topology_step(tenv, st, acts[0], flows=flows,
                                        spec=tsim.TOPOLOGY_OBS, **world)
        res.append((st, obs, rew))
    for x, y in zip(res[0][0] + res[0][1:], res[1][0] + res[1][1:]):
        assert torch.equal(x, y)


def test_down_window_starting_mid_interval_moves_nothing_while_down():
    """A flow down from mid-interval moves nothing in the substeps after
    its down_start and moves again after down_end; at a step whose every
    substep has every flow down, the fleet moves zero bytes."""
    _, tenv = fp.env_params()
    F = 3
    flows = tf.stack_flow_schedules([tf.make_flow_schedule(
        [0.0] * F, [math.inf] * F, [2.4, 1.0, 1.0], [6.6, 5.0, 5.0],
        device="cpu")])
    threads = torch.full((1, F, 3), 8.0)
    tables = tf.ScheduleTable(torch.full((1, 1, 3), 0.2),
                              torch.full((1, 1, 3), 1.0), torch.ones(1))
    st = tf.fleet_reset(tenv, 1, F, flows=flows, table=tables,
                        threads=threads)
    moved = []
    for _ in range(7):
        st, _, _ = tf.fleet_step(tenv, st, threads, flows=flows,
                                 table=tables)
        moved.append(st.throughputs[0, :, 0].clone())
    # t in [1, 2): flows 1, 2 down from 1.0, flow 0 still up
    assert moved[0][1] == 0.0 and moved[0][2] == 0.0 and moved[0][0] > 0.0
    # t in [2, 3): flow 0 goes down at 2.4, mid-interval: a part-interval
    assert 0.0 < moved[1][0] < moved[0][0]
    # t in [3, 4) and [4, 5): every flow down for every substep
    assert torch.equal(moved[2], torch.zeros(F))
    assert torch.equal(moved[3], torch.zeros(F))
    # flows 1, 2 restart at 5.0; flow 0 at 6.6, again mid-interval
    assert moved[4][1] > 0.0 and moved[4][0] == 0.0
    assert moved[6][0] > 0.0


# ---------------------------------------------------------------------------
# Rollouts on faulted worlds against the reference
# ---------------------------------------------------------------------------

FLEET_FAULTS = [
    [dict(kind="kill_flow", t=2.3, flow=1),
     dict(kind="restart_flow", t=4.7, flow=1),
     dict(kind="stage_hang", t=5.0, until=8.5, stage=1)],
    None,
    [dict(kind="kill_flow", t=3.1, flow=2),
     dict(kind="link_blackout", t=0.5, until=4.0)] +
    [dict(kind=k, t=t, flow=f) for f in range(4)
     for k, t in (("kill_flow", 6.5), ("restart_flow", 8.25))
     if f != 2]]


def _fault_pairs(specs):
    j, t = [], []
    for events in specs:
        if events is None:
            j.append(None)
            t.append(None)
        else:
            a, b = _pair(events)
            j.append(a)
            t.append(b)
    return j, t


@pytest.mark.parametrize("policy,key_seed", [("mlp", 3), ("gru", 6)])
def test_rollout_fleet_on_a_faulted_world_matches_reference(policy,
                                                           key_seed):
    spec = jsim.FLEET_OBS if policy == "mlp" else jsim.OBJECTIVE_OBS
    objectives = policy == "gru"
    jcfg, tcfg = fp.configs(policy, spec)
    jenv, tenv = fp.env_params()
    jp = jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(
        jax.random.PRNGKey(key_seed))
    tparams = params_from_jax(jp, device="cpu")
    (jtabs, jflows, jobjs), (ttabs, tflows, tobjs) = fp.worlds(True,
                                                               objectives)
    jfaults, tfaults = _fault_pairs(FLEET_FAULTS)
    jtabs, jflows, _ = jsc.compile_fault_batch(jfaults, tables=jtabs,
                                               flows=jflows)
    ttabs, tflows, _ = tsc.compile_fault_batch(tfaults, tables=ttabs,
                                               flows=tflows)
    _same_schedule(tflows, jflows)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), fp.E)
    ref = fp._reference_rollout(jp, jenv, jcfg, (jtabs, jflows, jobjs),
                                keys, True)
    threads0, t0_draw, noise = fp.fleet_draws(keys, True)
    got = tppo._rollout_fleet(
        tparams["policy"], tenv, ttabs, tflows, tobjs, n_envs=fp.E,
        n_flows=fp.F, M=fp.M, substeps=50,
        spec=tppo.effective_obs_spec(tcfg), randomize_t0=True,
        policy=policy, fairness_coef=0.5, deadline_coef=1.0,
        threads0=threads0, t0_draw=t0_draw, noise=noise)
    fp.assert_clear_of_rounding_ties(ref[1])
    for g, r in zip(got, ref):
        fp._close(g, r)


TOPO_FAULTS = [
    [dict(kind="link_blackout", t=2.0, until=5.5, link=1),
     dict(kind="kill_flow", t=1.3, flow=3),
     dict(kind="restart_flow", t=3.9, flow=3)],
    [dict(kind="stage_hang", t=1.5, until=3.0, stage=2),
     dict(kind="link_blackout", t=0.0, until=math.inf, link=0)],
    [dict(kind="kill_flow", t=2.2, flow=0)]]


@pytest.mark.parametrize("policy,key_seed", [("mlp", 2), ("gru", 1)])
def test_rollout_topology_under_blackouts_and_floors_matches_reference(
        policy, key_seed):
    jcfg, tcfg = tp.configs(policy, jsim.TOPOLOGY_OBS)
    jenv, tenv = tp.env_params()
    jp = jax.jit(lambda k: jppo.init_agent(k, jcfg)["params"])(
        jax.random.PRNGKey(key_seed + 10))
    tparams = params_from_jax(jp, device="cpu")
    (jtopo, jflows, jobjs), (ttopo, tflows, tobjs) = tp.worlds(True)
    jfaults, tfaults = _fault_pairs(TOPO_FAULTS)
    _, jflows, jtopo = jsc.compile_fault_batch(jfaults, flows=jflows,
                                               topology=jtopo)
    _, tflows, ttopo = tsc.compile_fault_batch(tfaults, flows=tflows,
                                               topology=ttopo)
    for a, b in zip(ttopo.graph, jtopo.graph):
        _same(a, b)
    assert float(ttopo.graph.bw[1, 0].max()) == 0.0   # link 0 dark forever
    keys = jax.random.split(jax.random.PRNGKey(key_seed), tp.E)
    ref = tp._reference_rollout(jp, jenv, jcfg, (jtopo, jflows, jobjs), keys)
    threads0, t0_draw, noise = fp.fleet_draws(keys, True)
    got = tppo._rollout_topology(
        tparams["policy"], tenv, ttopo, tflows, tobjs, n_envs=tp.E,
        n_flows=tp.F, M=tp.M, substeps=50,
        spec=tppo.effective_obs_spec(tcfg), randomize_t0=True,
        policy=policy, fairness_coef=0.5, deadline_coef=1.0,
        threads0=threads0, t0_draw=t0_draw, noise=noise)
    fp.assert_clear_of_rounding_ties(ref[1])
    for g, r in zip(got, ref):
        fp._close(g, r)


@pytest.mark.parametrize("topology", [False, True],
                         ids=["fleet", "topology"])
def test_train_ppo_compiles_the_faults_of_every_round(topology,
                                                      monkeypatch):
    _, tenv = fp.env_params()
    seen = []
    real = Workload.compiled

    def compiled(self):
        out = real(self)
        seen.append((self.has_faults, out.faults))
        return out

    monkeypatch.setattr(Workload, "compiled", compiled)

    def draw(rnd):
        kw = dict(seed=rnd, horizon=20.0, device="cpu",
                  fault_mix=dict(MIX, kill_prob=1.0))
        if topology:
            return tsc.sample_topology_batch(
                2, 3, n_links=2, objective_mix=dict(floor_deadline_frac=0.2),
                **kw)
        return tsc.sample_fleet_batch(2, 3, pad_flows=True,
                                      **kw).replace(objectives=None)

    cfg = tppo.PPOConfig(max_episodes=6, n_envs=2, n_flows=3, max_steps=4,
                         action_scale=12.5, fairness_coef=0.5,
                         obs_spec=(tsim.TOPOLOGY_OBS if topology
                                   else tsim.FLEET_OBS),
                         pad_flows=not topology,
                         param_selection="batch_mean", device="cpu")
    res = tppo.train_ppo(tenv, cfg, workload=draw(0), resample=draw)
    assert res.episodes == 6 and np.all(np.isfinite(res.history))
    assert seen == [(True, None)] * 3


# ---------------------------------------------------------------------------
# Live: FaultInjector + CheckpointedFlow
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fault_injector_replays_kill_restart_through_the_ports_engine(
        tmp_path):
    """The reference's live loop (tests/test_recovery.py, marked slow as
    it is) on the port's modules: a FaultSpec's hang, kill and restart
    drive a CheckpointedFlow through FaultInjector with zero loss and zero
    replay, and the sink's digest is that of an uninterrupted run."""
    from repro_torch.transfer import (ChecksumSink, StageThrottle,
                                      RetryPolicy, CheckpointedFlow,
                                      TransferEngine, SyntheticSource)
    chunk = 4 << 10
    total = 32 * chunk

    def throttles():
        return tuple(StageThrottle(48 << 10) for _ in range(3))

    sink = ChecksumSink()
    flow = CheckpointedFlow(total, sink, ckpt_dir=str(tmp_path / "c"),
                            chunk_bytes=chunk, seed=4,
                            engine_kwargs=dict(throttles=throttles(),
                                               retry=RetryPolicy()))
    flow.start()
    _, spec = _pair([dict(kind="stage_hang", t=0.3, until=0.6, stage=1),
                     dict(kind="kill_flow", t=0.8, flow=0),
                     dict(kind="restart_flow", t=1.2, flow=0)], name="live")
    inj = tsc.FaultInjector(flow.engine, spec,
                            on_kill=lambda f: flow.kill(),
                            on_restart=lambda f: flow.restart(), tick=0.02)
    with inj:
        deadline = time.time() + 60.0
        while not flow.done() and time.time() < deadline:
            time.sleep(0.05)
    flow.close()
    assert flow.done()
    assert flow.cursor.replayed == 0
    ref = ChecksumSink()
    eng = TransferEngine(SyntheticSource(total_bytes=total, chunk_bytes=chunk,
                                         seed=4), ref, throttles=throttles())
    deadline = time.time() + 30.0
    while not eng.done() and time.time() < deadline:
        time.sleep(0.02)
    eng.close()
    assert sink.digest == ref.digest
