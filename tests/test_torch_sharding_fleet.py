"""The port's sharded fleets (``repro_torch.sharding.fleet``,
``launch/mesh.py``, ``train_ppo(mesh=)``) against the JAX package.

One rank: the reference's own cases (``tests/test_fleet_scaleout.py``): a
mesh of one rank replicates every flow sharding and the sharded step is the
unsharded one bit for bit; an F that does not divide the mesh stays
replicated; ``train_ppo(mesh=)`` with ``pad_flows`` and ``max_active``.

Several ranks: one spawn of 4 gloo ranks on a FileStore
(``tests/torch_sharding_ranks.py``, which imports no JAX) runs every check
on sub-meshes of 2 and 4 ranks, and this process holds its results against
the reference's unsharded steps, computed here in JAX on the same inputs:
``fleet_step`` on the reference's F = 8 world with floors and caps and
``topology_step`` over 3 links, dense and compact (``max_active`` 4),
within 1e-6 (obs, buffers, throughputs) and 1e-5 (reward); K3's plain solve
on the assembled operands equal bit for bit to the unsharded solve; one PPO
episode batch within 1e-4 of mesh=None; two rounds of ``train_ppo(mesh=)``;
an F of 6 on 4 ranks replicated, bit for bit and with no collective. The
same spawn re-lays SMOKE smollm-135m's train state with ``reshard_state``
(2x1 -> 2x2 -> 2x1) and ``load_checkpoint(shardings=)`` onto 2x2.

No test asserts a wall-clock time."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.core import fleet as jfleet
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.schedule import make_table as j_make_table

from repro_torch.core import ppo as tppo
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import (fleet_reset, fleet_step,
                                    make_flow_schedule, make_flow_objective,
                                    max_concurrent_flows, pad_flow_schedule,
                                    stack_flow_objectives,
                                    stack_flow_schedules)
from repro_torch.core.schedule import make_table, stack_tables
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.sharding import (FLOW_AXIS, flow_sharding,
                                  shard_fleet_state, shard_flow_objectives,
                                  shard_flow_schedule)
from repro_torch.sharding.fleet import FLOW_COLLECTIVES

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
SUBSTEPS = 6
F = 8
RANKS = 4
J_FLEET_SPEC = jsim.ObservationSpec(context=True, fleet=True,
                                    objectives=True)
J_TOPO_SPEC = J_FLEET_SPEC._replace(topology=True)
OBJ_FIELDS = ("weight", "deadline", "demand", "rate_floor", "rate_cap")
STATE_FIELDS = ("buffers", "threads", "throughputs", "t",
                "prev_throughputs", "delivered")


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The one-rank tests start a gloo group in this process (the mesh
    constructors do, when none exists); it is torn down after them."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _jparams():
    return jsim.make_env_params(tpt=[0.2, 0.15, 0.2], bw=[1, 1, 1],
                                cap=[2, 2], n_max=50)


# ---------------------------------------------------------------------------
# One rank: the reference's cases
# ---------------------------------------------------------------------------


def _one_world(seed, n_flows=5):
    """test_fleet_scaleout.py's ``_world``: a 2-bin schedule, windows
    around the interval, mixed finite and inf caps; the port's (E = 1)."""
    rng = np.random.default_rng(seed)
    params = tsim.make_env_params(tpt=[0.2, 0.15, 0.2], bw=[1, 1, 1],
                                  cap=[2, 2], n_max=50, device="cpu")
    table = make_table(rng.uniform(0.02, 0.5, (2, 3)).astype(np.float32),
                       rng.uniform(0.1, 2.0, (2, 3)).astype(np.float32),
                       bin_seconds=0.5, device="cpu")
    t_start = rng.uniform(0.0, 1.5, n_flows)
    flows = make_flow_schedule(t_start,
                               t_start + rng.uniform(0.1, 2.0, n_flows),
                               device="cpu")
    caps = np.where(rng.random(n_flows) < 0.5, np.inf,
                    rng.uniform(0.05, 1.5, n_flows))
    obj = make_flow_objective(weight=rng.choice([1.0, 2.0, 4.0], n_flows),
                              rate_floor=rng.uniform(0.0, 1.5, n_flows),
                              rate_cap=caps, device="cpu")
    return (params, stack_tables([table]), stack_flow_schedules([flows]),
            stack_flow_objectives([obj]))


def test_fleet_mesh_single_device_is_bitwise_noop():
    """test_fleet_scaleout.py:379: on one rank every flow sharding is a
    replication and the sharded step returns the unsharded result bit for
    bit, with no collective."""
    params, table, flows, obj = _one_world(5)
    mesh = make_fleet_mesh(1, device="cpu")
    assert mesh.mesh_dim_names == (FLOW_AXIS,)
    assert flow_sharding(mesh, 2, -1, F).is_fully_replicated
    state = fleet_reset(params, 1, flows.n_flows, flows=flows, table=table,
                        substeps=SUBSTEPS,
                        generator=torch.Generator().manual_seed(0))
    acts = torch.full((1, flows.n_flows, 3), 8.0)
    s2, obs, r = fleet_step(params, state, acts, flows=flows, table=table,
                            substeps=SUBSTEPS, objectives=obj)
    before = dict(FLOW_COLLECTIVES)
    s2s, obss, rs = fleet_step(params, shard_fleet_state(state, mesh), acts,
                               flows=shard_flow_schedule(flows, mesh),
                               table=table, substeps=SUBSTEPS,
                               objectives=shard_flow_objectives(obj, mesh))
    assert FLOW_COLLECTIVES == before
    assert torch.equal(rs.to_local(), r)
    assert torch.equal(obss.to_local(), obs)
    assert torch.equal(s2s.buffers.to_local(), s2.buffers)
    assert obss.placements[0].is_replicate()
    assert shard_flow_objectives(None, mesh) is None


def test_fleet_mesh_indivisible_falls_back_to_replication():
    """test_fleet_scaleout.py:407: an F that the flow axis does not divide
    is replicated; the mesh keeps its one axis."""
    mesh = make_fleet_mesh(1, device="cpu")
    s = flow_sharding(mesh, 2, -1, 7)
    assert s.mesh.mesh_dim_names == ("flows",)
    assert s.is_fully_replicated


def test_train_ppo_scaleout_knobs_smoke():
    """test_fleet_scaleout.py:481: ``pad_flows`` and ``max_active`` with a
    one-rank mesh; and the run equals mesh=None bit for bit."""
    from repro_torch.scenarios import sample_fleet_batch
    params = tsim.make_env_params(tpt=[0.2, 0.15, 0.2], bw=[1, 1, 1],
                                  cap=[2, 2], n_max=50, device="cpu")
    wl = sample_fleet_batch(2, 6, seed=3, objective_mix=True, pad_flows=True,
                            device="cpu")
    assert wl.flows.n_flows == 8
    cfg = tppo.PPOConfig(n_flows=6, n_envs=2, max_episodes=2, max_steps=3,
                         pad_flows=True, max_active=4, log_every=0,
                         device="cpu")
    res = tppo.train_ppo(params, cfg, workload=wl,
                         mesh=make_fleet_mesh(1, device="cpu"))
    alone = tppo.train_ppo(params, cfg, workload=wl)
    assert res.episodes == 2
    assert np.isfinite(res.best_reward)
    assert res.history == alone.history
    for (n, p), q in zip(res.params.named_parameters(),
                         alone.params.parameters()):
        assert torch.equal(p, q), n


def test_the_mesh_constructors_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fleet_mesh(1)


# ---------------------------------------------------------------------------
# Several ranks: one spawn of 4 gloo ranks
# ---------------------------------------------------------------------------


def _reference_worlds():
    """The inputs the ranks read and the reference's unsharded steps on
    them: the dense world is test_fleet_scaleout.py:430-446's F = 8 world
    with floors and caps (random actions); the compact world staggers 8
    windows so that at most 4 meet any interval."""
    params = _jparams()
    rng = np.random.default_rng(0)
    x = {"table_tpt": rng.uniform(0.05, 0.5, (2, 3)).astype("f"),
         "table_bw": rng.uniform(0.5, 2.0, (2, 3)).astype("f")}
    table = j_make_table(x["table_tpt"], x["table_bw"], bin_seconds=0.5)
    ts = rng.uniform(0.0, 1.0, F)
    dense = dict(t_start=ts, t_end=ts + rng.uniform(0.5, 2.0, F),
                 rate_floor=rng.uniform(0, 1, F),
                 rate_cap=np.where(rng.random(F) < 0.5, np.inf, 0.8), t0=0.0)
    ts = np.sort(rng.uniform(0.0, 7.0, F))
    compact = dict(t_start=ts, t_end=ts + rng.uniform(0.3, 1.2, F),
                   rate_floor=rng.uniform(0, 0.5, F),
                   rate_cap=np.where(rng.random(F) < 0.5, np.inf, 0.6),
                   t0=2.5)
    x["graph_tpt"] = rng.uniform(0.05, 0.5, (3, 2, 3)).astype("f")
    x["graph_bw"] = rng.uniform(0.5, 2.0, (3, 2, 3)).astype("f")
    graph = jtopo.make_link_graph(x["graph_tpt"], x["graph_bw"],
                                  bin_seconds=0.5)
    out = {}
    for tag, w in (("dense", dense), ("compact", compact)):
        flows = jfleet.make_flow_schedule(w["t_start"], w["t_end"])
        obj = jfleet.make_flow_objective(
            weight=rng.choice([1.0, 2.0, 4.0], F),
            deadline=np.where(rng.random(F) < 0.5,
                              rng.uniform(1.0, 6.0, F), np.inf),
            demand=np.where(rng.random(F) < 0.5, rng.uniform(0.5, 3.0, F),
                            np.inf),
            rate_floor=w["rate_floor"], rate_cap=w["rate_cap"])
        onpath = (rng.random((F, 3)) < 0.6).astype("f")
        onpath[np.arange(F), rng.integers(0, 3, F)] = 1.0
        paths = jtopo.make_path_spec(onpath)
        state = jfleet.fleet_reset(params, jax.random.PRNGKey(1), F,
                                   w["t0"], flows=flows, table=table,
                                   substeps=SUBSTEPS)
        acts = rng.uniform(0.0, 40.0, (F, 3)).astype("f")
        max_active = 4 if tag == "compact" else None
        for kind, fn, kw in (
                ("fleet", jfleet.fleet_step,
                 dict(table=table, spec=J_FLEET_SPEC)),
                ("topology", jtopo.topology_step,
                 dict(graph=graph, paths=paths, spec=J_TOPO_SPEC))):
            out[(kind, tag)] = fn(params, state, jnp.asarray(acts),
                                  flows=flows, substeps=SUBSTEPS,
                                  fairness_coef=0.5, objectives=obj,
                                  max_active=max_active, **kw)
        x.update({f"{tag}_t_start": np.asarray(w["t_start"], "f"),
                  f"{tag}_t_end": np.asarray(flows.t_end),
                  f"{tag}_onpath": onpath, f"{tag}_acts": acts})
        x.update({f"{tag}_{f}": np.asarray(getattr(obj, f))
                  for f in OBJ_FIELDS})
        x.update({f"{tag}_{f}": np.asarray(getattr(state, f))
                  for f in STATE_FIELDS})
    prng = np.random.default_rng(7)
    x["ppo_threads0"] = prng.integers(1, 16, (2, F, 3)).astype("f")
    x["ppo_t0"] = prng.random(2).astype("f")
    x["ppo_noise"] = prng.normal(size=(3, 2, F, 3)).astype("f")
    return x, out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results (rank -> dict) and the reference's steps."""
    d = tmp_path_factory.mktemp("ranks")
    x, ref = _reference_worlds()
    np.savez(d / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharding_ranks.py"), str(d),
         str(r), str(RANKS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = {r: torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)}
    return res, ref, x


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float32)


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("kind", ["fleet", "topology"])
@pytest.mark.parametrize("tag", ["dense", "compact"])
def test_sharded_step_matches_the_reference(ranks, n_ranks, kind, tag):
    """``fleet_step``/``topology_step`` with the flow axis split over 2 or 4
    ranks (DTensor inputs, DTensor outputs sharded the same way): obs,
    buffers and throughputs within 1e-6 of the reference's unsharded step,
    the reward within 1e-5; every rank holds the same result. The dense
    step issues collectives; the compact one runs assembled."""
    res, ref, _ = ranks
    key = f"m{n_ranks}_{kind}_{tag}"
    j_state, j_obs, j_rew = ref[(kind, tag)]
    state, obs, rew = res[0][key]
    np.testing.assert_allclose(_np(obs)[0], np.asarray(j_obs), atol=1e-6,
                               rtol=0)
    for f in ("buffers", "throughputs"):
        np.testing.assert_allclose(_np(state[f])[0],
                                   np.asarray(getattr(j_state, f)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(state["delivered"])[0],
                               np.asarray(j_state.delivered), atol=1e-6,
                               rtol=0)
    assert abs(float(rew[0]) - float(j_rew)) < 1e-5
    assert res[0][f"{key}_placement"] == "(Shard(dim=1),)"
    for r in range(1, n_ranks):
        assert torch.equal(res[r][key][1], obs)
        assert torch.equal(res[r][key][2], rew)
    assert res[0][f"{key}_calls"] > 0


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_compact_step_is_the_unsharded_one(ranks, n_ranks):
    """The compact path assembles the call and runs it unsharded on every
    rank: the port's sharded compact step equals its unsharded one bit for
    bit, for the fleet and the topology; the world keeps at most 4 flows
    in any interval."""
    res, _, x = ranks
    tag = "compact"
    flows = make_flow_schedule(np.array(x[f"{tag}_t_start"]),
                               np.array(x[f"{tag}_t_end"]),
                               device="cpu")
    assert max_concurrent_flows(flows, window=1.0) <= 4
    for kind in ("fleet", "topology"):
        got = res[0][f"m{n_ranks}_{kind}_{tag}"]
        want = res[0][f"m{n_ranks}_{kind}_{tag}_plain"]
        for f in ("buffers", "throughputs", "delivered"):
            assert torch.equal(got[0][f], want[0][f]), (kind, f)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_contention_solve_on_assembled_operands_is_bitwise(ranks, n_ranks):
    """K3's plain version on the operands each rank assembles to full F,
    the rank's rows kept and gathered: equal bit for bit to the unsharded
    solve, for the fleet's one-link embedding and the topology's 3 links
    with F water-fill rounds."""
    res, _, _ = ranks
    for r in range(n_ranks):
        for kind in ("fleet", "topology"):
            got, want = res[r][f"m{n_ranks}_solve_{kind}"]
            assert torch.equal(got, want), (r, kind)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_episode_batch_matches_mesh_none(ranks, n_ranks):
    """One PPO episode batch (2 envs x 8 flows, 3 steps, 2 updates) with
    the flows split over the ranks, from the same explicit draws: rewards,
    parameters and the loss within 1e-4 of the unsharded batch, the same
    on every rank."""
    res, _, _ = ranks
    out = res[0][f"m{n_ranks}_episode"]
    (rew, params, loss), (rew_s, params_s, loss_s) = (out["plain"],
                                                     out["sharded"])
    np.testing.assert_allclose(_np(rew_s), _np(rew), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss_s), float(loss), atol=1e-4)
    for n in params:
        np.testing.assert_allclose(_np(params_s[n]), _np(params[n]),
                                   atol=1e-4, rtol=0)
    for r in range(1, n_ranks):
        other = res[r][f"m{n_ranks}_episode"]["sharded"]
        assert torch.equal(other[0], rew_s)
        assert all(torch.equal(other[1][n], params_s[n]) for n in params)


def test_train_ppo_mesh_two_rounds(ranks):
    """Two rounds of ``train_ppo(mesh=)`` over 4 ranks on resampled fleet
    workloads (8 flows): the same episodes and, within 1e-4, the rewards
    and best params of mesh=None; every rank returns the same result."""
    res, _, _ = ranks
    (hist, eps, params), (hist_p, eps_p, params_p) = (
        res[0]["m4_train"]["sharded"], res[0]["m4_train"]["plain"])
    assert eps == eps_p == 4
    np.testing.assert_allclose(hist, hist_p, atol=1e-4, rtol=0)
    for n in params:
        np.testing.assert_allclose(_np(params[n]), _np(params_p[n]),
                                   atol=1e-4, rtol=0)
    assert res[0]["m4_train_calls"] > 0
    for r in range(1, RANKS):
        h, _, p = res[r]["m4_train"]["sharded"]
        assert h == hist and all(torch.equal(p[n], params[n])
                                 for n in params)


def test_indivisible_fleet_stays_replicated(ranks):
    """F = 6 on 4 ranks: every flow sharding is a replication, the run is
    the unsharded one bit for bit and no collective is issued."""
    res, _, _ = ranks
    for r in range(RANKS):
        (hist, _, params), (hist_p, _, params_p) = (
            res[r]["indivisible_train"]["sharded"],
            res[r]["indivisible_train"]["plain"])
        assert hist == hist_p
        assert all(torch.equal(params[n], params_p[n]) for n in params)
        assert res[r]["indivisible_train_calls"] == 0


def test_reshard_state_round_trip_is_bitwise(ranks):
    """The reference's test_pipeline_checkpoint_runtime.py:151 over ranks:
    SMOKE smollm-135m's train state re-laid 2x1 -> 2x2 -> 2x1 with
    ``reshard_state`` comes back bit for bit, and the 2x2 layout shards
    leaves (``elastic_mesh(4, model_axis=2)`` is 2 x 2)."""
    res, _, _ = ranks
    for r in range(RANKS):
        assert res[r]["elastic_shape"] == (2, 2)
        assert res[r]["lm_b_equal"] is True
        assert res[r]["lm_sharded_leaves"] > 0
        assert res[r]["lm_c_equal"] is (True if r < 2 else None)


def test_load_checkpoint_with_shardings(ranks):
    """A checkpoint of the state restored with ``load_checkpoint(
    shardings=)`` onto the 2x2 mesh: the step, the values bit for bit and
    the placements of ``reshard_state``'s layout, on every rank."""
    res, _, _ = ranks
    for r in range(RANKS):
        assert res[r]["lm_loaded"] == (1, True, True)


def test_pad_flow_schedule_to_a_mesh_multiple():
    """``pad_flows`` is how a fleet meets the divisibility guard: 6 flows
    padded to 8 split 2 and 4 ways."""
    flows = stack_flow_schedules([make_flow_schedule(
        np.zeros(6), np.full(6, np.inf), device="cpu")])
    padded = pad_flow_schedule(flows, 8)

    class Stub:
        mesh_dim_names = ("flows",)
        shape = (4,)

    assert flow_sharding(Stub, 2, -1, padded.n_flows).placements[0].dim == 1
    assert flow_sharding(Stub, 2, -1, flows.n_flows).is_fully_replicated
