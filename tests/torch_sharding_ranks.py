"""One rank of the port's multi-rank sharding checks, a worker of
``tests/test_torch_sharding_fleet.py``:

    python tests/torch_sharding_ranks.py DIR RANK WORLD

It joins a gloo group on a FileStore in DIR, reads the worlds the test
drew (``DIR/inputs.npz``), runs every check on sub-meshes of 2 and 4 ranks
and writes its results to ``DIR/rank<RANK>.pt``. It imports torch and the
port only, never JAX: the test holds the results against the JAX package
in its own process."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa
from repro_torch.core import ppo  # noqa: E402
from repro_torch.core.fleet import (FleetState, FlowObjective,  # noqa: E402
                                    FlowSchedule, fleet_step,
                                    _solve_fleet_rates)
from repro_torch.core.schedule import ScheduleTable  # noqa: E402
from repro_torch.core.simulator import (ObservationSpec,  # noqa: E402
                                        make_env_params)
from repro_torch.core.topology import (LinkGraph, PathSpec,  # noqa: E402
                                       topology_step, _solve_topology_rates)
from repro_torch.launch.mesh import make_fleet_mesh, mesh_over  # noqa
from repro_torch.launch.steps import init_state  # noqa: E402
from repro_torch.runtime import elastic_mesh, reshard_state  # noqa: E402
from repro_torch.runtime.elastic import full_tensor  # noqa: E402
from repro_torch.sharding import (param_specs, shard_fleet_state,  # noqa
                                  shard_flow_objectives, shard_flow_schedule,
                                  shard_path_spec, to_shardings)
from repro_torch.sharding.fleet import (FLOW_COLLECTIVES,  # noqa: E402
                                        flow_gather, flow_rows, flow_scope,
                                        full_flows, scope_of, to_local)

SUBSTEPS = 6
FLEET_SPEC = ObservationSpec(context=True, fleet=True, objectives=True)
TOPO_SPEC = FLEET_SPEC._replace(topology=True)
PPO_CFG = dict(n_envs=2, max_steps=3, ppo_epochs=2, substeps=SUBSTEPS,
               fairness_coef=0.5, obs_spec=FLEET_SPEC, log_every=0,
               device="cpu")


def params():
    return make_env_params(tpt=[0.2, 0.15, 0.2], bw=[1, 1, 1], cap=[2, 2],
                           n_max=50, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))[None]


def world(x, tag):
    """The port's (E = 1) structures of world ``tag`` in the inputs."""
    g = lambda k: x[f"{tag}_{k}"]  # noqa: E731
    flows = FlowSchedule(_t(g("t_start")), _t(g("t_end")))
    objs = FlowObjective(*(_t(g(f)) for f in FlowObjective._fields))
    state = FleetState(*(_t(g(f)) for f in FleetState._fields))
    return flows, objs, state, _t(g("acts"))


def table(x):
    return ScheduleTable(_t(x["table_tpt"]), _t(x["table_bw"]),
                         torch.tensor([0.5]))


def graph_paths(x, tag):
    graph = LinkGraph(_t(x["graph_tpt"]), _t(x["graph_bw"]),
                      torch.tensor([0.5]))
    return graph, PathSpec(_t(x[f"{tag}_onpath"])[:, None],
                           torch.tensor([float("inf")]))


def gathered(out):
    """A sharded step's (state, obs, reward) with every leaf at full F."""
    state, obs, rew = out
    return ({f: full_flows(getattr(state, f), -2 if f != "delivered" else -1)
             for f in ("buffers", "throughputs", "delivered")},
            full_flows(obs, -2), full_flows(rew, 0))


def plain(out):
    state, obs, rew = out
    return ({f: getattr(state, f) for f in ("buffers", "throughputs",
                                            "delivered")}, obs, rew)


def steps(x, mesh, res, key):
    """fleet_step and topology_step, dense and compact, sharded over
    ``mesh`` and unsharded."""
    p, tab = params(), table(x)
    for tag, max_active in (("dense", None), ("compact", 4)):
        flows, objs, state, acts = world(x, tag)
        kw = dict(substeps=SUBSTEPS, fairness_coef=0.5, max_active=max_active)
        sh = dict(flows=shard_flow_schedule(flows, mesh),
                  objectives=shard_flow_objectives(objs, mesh))
        for kind in ("fleet", "topology"):
            if kind == "fleet":
                fn, kw_k = fleet_step, dict(table=tab, spec=FLEET_SPEC)
                kw_s = {}
            else:
                graph, paths = graph_paths(x, tag)
                fn, kw_k = topology_step, dict(graph=graph, spec=TOPO_SPEC)
                kw_k["paths"] = paths
                kw_s = dict(paths=shard_path_spec(paths, mesh))
            before = dict(FLOW_COLLECTIVES)
            out = fn(p, shard_fleet_state(state, mesh), acts,
                     **{**kw, **kw_k, **sh, **kw_s})
            calls = FLOW_COLLECTIVES["calls"] - before["calls"]
            ref = fn(p, state, acts, flows=flows, objectives=objs,
                     **{**kw, **kw_k})
            res[f"{key}_{kind}_{tag}"] = gathered(out)
            res[f"{key}_{kind}_{tag}_plain"] = plain(ref)
            res[f"{key}_{kind}_{tag}_calls"] = calls
            res[f"{key}_{kind}_{tag}_placement"] = str(out[1].placements)


def solves(x, mesh, res, key):
    """K3's plain solve on this rank's rows (operands assembled) against
    the unsharded solve, for the fleet and the topology."""
    p, tab = params(), table(x)
    flows, objs, state, acts = world(x, "dense")
    graph, paths = graph_paths(x, "dense")
    threads = torch.clamp(torch.round(acts), 1.0, 50.0)
    t0 = state.t
    full = {"fleet": _solve_fleet_rates(p, tab, threads, flows, t0, SUBSTEPS,
                                        objs),
            "topology": _solve_topology_rates(p, graph, paths, threads, flows,
                                              t0, SUBSTEPS, objs)}
    sflows = shard_flow_schedule(flows, mesh)
    sobjs = shard_flow_objectives(objs, mesh)
    spaths = shard_path_spec(paths, mesh)
    with flow_scope(scope_of(sflows)):
        lflows, lobjs, lpaths = to_local((sflows, sobjs, spaths))
        lthreads = flow_rows(threads, 1)
        rows = {"fleet": _solve_fleet_rates(p, tab, lthreads, lflows, t0,
                                            SUBSTEPS, lobjs),
                "topology": _solve_topology_rates(p, graph, lpaths, lthreads,
                                                  lflows, t0, SUBSTEPS,
                                                  lobjs)}
        for k, r in rows.items():
            res[f"{key}_solve_{k}"] = (flow_gather((r, 2))[0], full[k])


def episode(x, mesh, res, key):
    """One PPO episode batch on the fleet world, flows sharded over
    ``mesh``, against mesh=None, from the same explicit draws."""
    p = params()
    cfg = ppo.PPOConfig(n_flows=8, **PPO_CFG)
    flows, objs, _, _ = world(x, "dense")
    tables = ScheduleTable(_t(x["table_tpt"]).expand(2, -1, -1),
                           _t(x["table_bw"]).expand(2, -1, -1),
                           torch.tensor([0.5, 0.5]))
    fl = FlowSchedule(*(f.expand(2, -1) for f in flows if f is not None))
    ob = FlowObjective(*(f.expand(2, -1) for f in objs))
    draws = dict(threads0=torch.from_numpy(x["ppo_threads0"]),
                 t0_draw=torch.from_numpy(x["ppo_t0"]),
                 noise=torch.from_numpy(x["ppo_noise"]))
    out = {}
    for name, (f, o) in {"plain": (fl, ob), "sharded": (
            shard_flow_schedule(fl, mesh),
            shard_flow_objectives(ob, mesh))}.items():
        fn = ppo._make_episode_fn(p, cfg, randomize_t0=True)
        state = ppo.init_agent(cfg)
        state, rew, loss = fn(state, tables, flows=f, objectives=o, **draws)
        out[name] = (rew, {n: t.detach().clone() for n, t in
                           state["params"].named_parameters()}, loss)
    res[f"{key}_episode"] = out


def training(mesh, res, key, n_flows):
    """Two rounds of train_ppo(mesh=) against mesh=None on resampled fleet
    workloads."""
    from repro_torch.scenarios import sample_fleet_batch
    p = params()
    cfg = ppo.PPOConfig(n_flows=n_flows, max_episodes=4, **PPO_CFG)

    def draw(rnd):
        return sample_fleet_batch(2, n_flows, seed=rnd, objective_mix=True,
                                  device="cpu")

    before = FLOW_COLLECTIVES["calls"]
    sharded = ppo.train_ppo(p, cfg, resample=draw, mesh=mesh)
    calls = FLOW_COLLECTIVES["calls"] - before
    alone = ppo.train_ppo(p, cfg, resample=draw)
    res[f"{key}_train"] = {
        name: (r.history, r.episodes, {n: t.detach().clone() for n, t in
                                       r.params.named_parameters()})
        for name, r in (("sharded", sharded), ("plain", alone))}
    res[f"{key}_train_calls"] = calls


def lm(res, ckpt_dir):
    """reshard_state 2x1 -> 2x2 -> 2x1 and load_checkpoint(shardings=) onto
    2x2, SMOKE smollm-135m's train state."""
    cfg = get_smoke_config("smollm-135m")
    state = init_state(cfg, 0, device="cpu")
    mesh21 = mesh_over((2, 1), ("data", "model"), device="cpu")
    mesh22 = elastic_mesh(4, model_axis=2, device="cpu")
    res["elastic_shape"] = tuple(mesh22.shape)
    a = reshard_state(state, cfg, mesh21)
    b = reshard_state(a, cfg, mesh22)
    c = reshard_state(b, cfg, mesh21)
    flat = {n: t for n, t in state["params"].items()}
    res["lm_sharded_leaves"] = sum(
        any(pl.is_shard() for pl in b["params"][n].placements) for n in flat)
    res["lm_b_equal"] = all(torch.equal(full_tensor(b["params"][n]), t)
                            for n, t in flat.items()) and all(
        torch.equal(full_tensor(b["opt"][k][n]), state["opt"][k][n])
        for k in ("m", "v") for n in flat)
    c_equal = None
    if mesh21.get_coordinate() is not None:
        c_equal = all(torch.equal(full_tensor(c["params"][n]), t)
                      for n, t in flat.items())
    res["lm_c_equal"] = c_equal
    host = {"params": {n: full_tensor(t) for n, t in b["params"].items()},
            "opt": {"m": {n: full_tensor(t) for n, t in b["opt"]["m"].items()},
                    "v": {n: full_tensor(t) for n, t in b["opt"]["v"].items()},
                    "step": full_tensor(b["opt"]["step"])}}
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, host, 1, use_engine=False)
    dist.barrier()
    pspecs = param_specs(cfg, state["params"], mesh22)
    shardings = to_shardings(mesh22, {"params": pspecs, "opt": {
        "m": pspecs, "v": pspecs, "step": ()}})
    loaded, step = load_checkpoint(ckpt_dir, state, shardings=shardings)
    res["lm_loaded"] = (step, all(
        torch.equal(full_tensor(loaded["params"][n]), t)
        for n, t in flat.items()), all(
        loaded["params"][n].placements == b["params"][n].placements
        for n in flat))


def main(d, rank, world_size):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world_size)
    x = dict(np.load(os.path.join(d, "inputs.npz")))
    res = {}
    meshes = {2: make_fleet_mesh(2, device="cpu"),
              4: make_fleet_mesh(device="cpu")}
    for n, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        steps(x, mesh, res, f"m{n}")
        solves(x, mesh, res, f"m{n}")
        episode(x, mesh, res, f"m{n}")
    training(meshes[4], res, "m4", 8)
    training(meshes[4], res, "indivisible", 6)
    lm(res, os.path.join(d, "ckpt"))
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
