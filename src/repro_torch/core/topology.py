"""Multi-link topology core: flows traverse PATHS of links, with the env
batch written out (port of ``repro.core.topology``).

The fleet core contends for ONE bottleneck; here a ``LinkGraph`` holds L
links, each with its own piecewise-constant 3-stage schedule on one shared
bin grid, and a ``PathSpec`` routes each of the F flows over a subset of
them (piecewise-constant in time, so a failover can re-route mid-run):

    rate[f] = min over links l on f's path of  rate_on_link[f, l]

Each link splits its scheduled capacity across the flows routed over it as
the fleet model does (thread-proportional shares, floors first), and the
split is work-conserving under rate caps: capacity a capped flow cannot use
is water-filled onto the uncapped flows on that link, F rounds.

Axes. The reference counts links with E; here E is the env axis, as in the
port's fleet, and L counts links. One graph is ``tpt``/``bw`` (L, T, 3) and
its routes ``onpath`` (R, F, L); a batch puts E in front: (E, L, T, 3),
(E, R, F, L), ``bin_seconds`` (E,). Every ``topology_*`` function takes a
batch: buffers (E, F, 2), threads (E, F, 3), clock t (E,).

One env step of the whole batch is ONE launch of the contention kernel
(``repro_torch.kernels.contention``, K3, on (E, S, F, L) routes with
``rounds = F``) and ONE launch of the sim_step kernel (K1, on E*F rows);
CPU tensors take the kernels' plain versions.

E=1 contract: one link, every flow routed and no finite cap is the fleet
path at atol 0. The inputs K3 sees are the fleet's one-link embedding, and
every water-fill round is an exact float no-op when the caps are infinite
(max(x - inf, 0) == 0, min(x, inf) == x, x + share * 0.0 == x), in the
kernel as in its plain version.

Not ported yet: the compact-active-set path (``max_active < F``: the
reference's ``_sparse_topology_interval``, ``_sparse_topology_observe``
and ``_sorted_water_fill``); it raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fleet import (FleetState, FlowSchedule, FlowObjective,
                                    active_at, _always_on_batch,
                                    _default_objectives_batch,
                                    _integrate_fleet_rates, _fleet_reward,
                                    fleet_observe)
from repro_torch.core.simulator import (SimParams, ObservationSpec,
                                        DEFAULT_OBS)
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.contention.ops import contention_rates

INF = float("inf")

# the topology state is the fleet state: only the world around it changes
TopologyState = FleetState


class LinkGraph(NamedTuple):
    """L links on one bin grid: ``tpt``/``bw`` (L, T, 3), or (E, L, T, 3)
    for a batch; ``bin_seconds`` () or (E,)."""

    tpt: torch.Tensor          # (..., L, T, 3) per-thread rate per link
    bw: torch.Tensor           # (..., L, T, 3) aggregate cap per link
    bin_seconds: torch.Tensor  # (...) shared bin width

    @property
    def n_links(self) -> int:
        return self.tpt.shape[-3]


class PathSpec(NamedTuple):
    """Piecewise-constant routing: ``onpath[r, f, l]`` is 1.0 when flow f
    traverses link l during route bin r (the last bin extends forever);
    (R, F, L), or (E, R, F, L) for a batch. R=1 is static routing."""

    onpath: torch.Tensor       # (..., R, F, L) 0/1 routing per route bin
    bin_seconds: torch.Tensor  # (...) route-bin width

    @property
    def n_flows(self) -> int:
        return self.onpath.shape[-2]


class Topology(NamedTuple):
    """A (graph, paths) bundle, what ``train_ppo`` takes as
    ``Workload.topology`` (batched)."""

    graph: LinkGraph
    paths: PathSpec


def make_link_graph(tpt, bw, bin_seconds=1.0, *, device=None) -> LinkGraph:
    tpt = as_f32(tpt, device)
    bw = as_f32(bw, tpt.device)
    if tpt.ndim != 3 or tpt.shape[-1] != 3 or tpt.shape != bw.shape:
        raise ValueError(f"link graph wants matching (L, T, 3) arrays: "
                         f"{tuple(tpt.shape)} vs {tuple(bw.shape)}")
    if tpt.shape[0] < 1:
        raise ValueError("a link graph needs at least one link")
    return LinkGraph(tpt=tpt, bw=bw,
                     bin_seconds=as_f32(bin_seconds, tpt.device))


def single_link_graph(table) -> LinkGraph:
    """The one-link embedding of a fleet ScheduleTable (one or a batch):
    the graph on which the topology solve equals the fleet solve."""
    return LinkGraph(tpt=table.tpt.unsqueeze(-3), bw=table.bw.unsqueeze(-3),
                     bin_seconds=table.bin_seconds)


def make_path_spec(onpath, bin_seconds=INF, *, device=None) -> PathSpec:
    """``onpath``: (F, L) for static routes or (R, F, L) for routes in bins
    of ``bin_seconds`` (static routes keep the default inf bin: every time
    lands in bin 0)."""
    onpath = as_f32(onpath, device)
    if onpath.ndim == 2:
        onpath = onpath[None]
    if onpath.ndim != 3:
        raise ValueError(f"onpath must be (F, L) or (R, F, L), got "
                         f"{tuple(onpath.shape)}")
    return PathSpec(onpath=onpath,
                    bin_seconds=as_f32(bin_seconds, onpath.device))


def all_links_path(n_flows: int, n_links: int, *, device=None) -> PathSpec:
    """Every flow traverses every link, forever (at one link, the fleet
    world)."""
    return make_path_spec(torch.ones((n_flows, n_links),
                                     device=resolve_device(device)))


def stack_link_graphs(graphs) -> LinkGraph:
    """Stack same-shape graphs into one batched LinkGraph (leading env
    axis)."""
    graphs = list(graphs)
    shapes = {tuple(g.tpt.shape) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack link graphs of shapes {shapes}")
    return LinkGraph(*(torch.stack([g[i] for g in graphs]) for i in range(3)))


def stack_path_specs(paths) -> PathSpec:
    """Stack same-shape path specs into one batched PathSpec."""
    paths = list(paths)
    shapes = {tuple(p.onpath.shape) for p in paths}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack path specs of shapes {shapes}")
    return PathSpec(*(torch.stack([p[i] for p in paths]) for i in range(2)))


def stack_topologies(topologies) -> Topology:
    topologies = list(topologies)
    return Topology(graph=stack_link_graphs(t.graph for t in topologies),
                    paths=stack_path_specs(t.paths for t in topologies))


def _batched_topology(topology: Topology) -> Topology:
    """One graph and its routes as a batch of one env; a batch as it is."""
    if topology.graph.tpt.ndim == 4:
        return topology
    graph, paths = topology
    return Topology(LinkGraph(*(x[None] for x in graph)),
                    PathSpec(*(x[None] for x in paths)))


def routes_at(paths: PathSpec, t):
    """The routing matrices of a batch of path specs at sim time ``t``:
    ``t`` (E,) gives (E, F, L), ``t`` (E, S) gives (E, S, F, L). The route
    bin is floor(t / bin_seconds), clipped to [0, R - 1]: an infinite bin
    is bin 0."""
    onpath = paths.onpath
    lead = (-1,) + (1,) * (t.ndim - 1)
    idx = torch.clamp(torch.floor(t / paths.bin_seconds.reshape(lead)), 0,
                      onpath.shape[1] - 1).to(torch.int64)
    env = torch.arange(onpath.shape[0], device=onpath.device)
    return onpath[env.reshape(lead), idx]


def graph_peak_bw(graph: LinkGraph):
    """Max aggregate bandwidth anywhere in a graph, the observation and
    reward normalization reference: a scalar for one graph, (E,) for a
    batch (equal to ``peak_bw(table)`` at one link)."""
    return torch.clamp_min(graph.bw.amax(dim=(-3, -2, -1)), 1e-9)


def link_peak_bw(graph: LinkGraph):
    """Per-link peak bandwidth, (L,) or (E, L): the per-link utilization
    reference of ``topology_features``."""
    return torch.clamp_min(graph.bw.amax(dim=(-2, -1)), 1e-9)


def pad_path_spec(paths: PathSpec, n_to: int) -> PathSpec:
    """Pad the routing matrix to ``n_to`` flows with all-zero rows (no
    path): a pathless flow moves nothing and scores zero utility, so
    padding is reward-exact. Batched specs pad the same way."""
    pad = n_to - paths.n_flows
    if pad < 0:
        raise ValueError(f"cannot pad {paths.n_flows} flows down to {n_to}")
    if pad == 0:
        return paths
    onpath = paths.onpath
    tail = onpath.new_zeros(onpath.shape[:-2] + (pad,) + onpath.shape[-1:])
    return PathSpec(onpath=torch.cat([onpath, tail], dim=-2),
                    bin_seconds=paths.bin_seconds)


def _refuse_compact(max_active, n_flows):
    if max_active is not None and max_active < n_flows:
        raise NotImplementedError(
            "the topology's compact-active-set path (max_active < F) is not "
            "ported yet; see ROADMAP.md")


# ---------------------------------------------------------------------------
# The solve and the interval
# ---------------------------------------------------------------------------


def _link_conditions(params: SimParams, graph: LinkGraph, t0, substeps: int):
    """Per-substep times (E, S) and per-link stage conditions tpt/bw
    (E, S, L, 3) of a batched graph: the reference's float32 ops in order
    (``ts = t0 + dt * arange``, then floor of ``ts / bin_seconds``), and
    the gather ``graph.tpt[env, link, bin]``."""
    dt = params.duration / substeps
    E, L, T = graph.tpt.shape[:3]
    steps = torch.arange(substeps, dtype=torch.float32, device=t0.device)
    ts = t0[:, None] + dt * steps                                   # (E, S)
    idx = torch.clamp(torch.floor(ts / graph.bin_seconds[:, None]), 0, T - 1)
    idx = idx.to(torch.int64)[:, :, None]                           # bin
    env = torch.arange(E, device=idx.device)[:, None, None]
    link = torch.arange(L, device=idx.device)[None, None, :]
    return ts, graph.tpt[env, link, idx], graph.bw[env, link, idx]


def _solve_topology_rates(params: SimParams, graph: LinkGraph,
                          paths: PathSpec, threads, flows: FlowSchedule, t0,
                          substeps: int, objectives: FlowObjective = None):
    """(E, S, F, 3) per-flow rates over the link graphs through K3: the
    schedule, activity and route gathers here, then the per-link split,
    the F water-fill rounds and the min over each flow's links of every
    env and substep in one launch."""
    ts, tpt, bw = _link_conditions(params, graph, t0, substeps)
    act = active_at(flows, ts)                                  # (E, S, F)
    onpath = routes_at(paths, ts)                               # (E, S, F, L)
    floor = cap = None
    if objectives is not None:
        floor = objectives.rate_floor.contiguous()
        cap = objectives.rate_cap.contiguous()
    return contention_rates(threads.contiguous(), act.contiguous(),
                            onpath.contiguous(), tpt.contiguous(),
                            bw.contiguous(), floor, cap,
                            rounds=threads.shape[1])


def topology_interval(params: SimParams, buffers, threads, t0, *,
                      graph: LinkGraph, paths: PathSpec, flows: FlowSchedule,
                      substeps=50, objectives: FlowObjective = None,
                      max_active: int = None):
    """Simulate ``duration`` seconds of F flows over each env's link graph
    from sim time ``t0`` (E,): the topology twin of ``fleet_interval`` (the
    same buffer dynamics; only the solve differs). Returns (buffers'
    (E, F, 2), tps (E, F, 3))."""
    _refuse_compact(max_active, flows.n_flows)
    t0 = as_f32(t0, buffers.device).expand(buffers.shape[0])
    rates = _solve_topology_rates(params, graph, paths, threads, flows, t0,
                                  substeps, objectives)
    return _integrate_fleet_rates(params, buffers, rates)


# ---------------------------------------------------------------------------
# Observation, reset, step, achievable
# ---------------------------------------------------------------------------


def topology_features(onpath, net_tps, active, link_bw_ref):
    """(..., F, 3) topology observation block, the ONE definition both
    ``topology_observe`` (sim) and ``TopologyController`` (live) emit:

      [0] bottleneck-link utilization: aggregate network throughput over
          capacity on the most-loaded link of MY path (0 for empty paths)
      [1] path length / L
      [2] my share of the aggregate on that bottleneck link

    ``onpath`` (..., F, L) routing now; ``net_tps`` (..., F) network-stage
    throughputs; ``active`` (..., F) 0/1; ``link_bw_ref`` (..., L) per-link
    bandwidth reference (sim: per-link schedule peak; live: the provisioned
    link capacities in engine units)."""
    onpath = as_f32(onpath)
    net = as_f32(net_tps, onpath.device) * as_f32(active, onpath.device)
    agg = (onpath * net[..., None]).sum(dim=-2)                 # (..., L)
    util = agg / torch.clamp_min(as_f32(link_bw_ref, onpath.device), 1e-9)
    util_f = util[..., None, :].expand_as(onpath)               # (..., F, L)
    on_util = torch.where(onpath > 0, util_f,
                          torch.full_like(util_f, -INF))
    bneck = torch.argmax(on_util, dim=-1, keepdim=True)         # first max
    has_path = onpath.sum(dim=-1) > 0
    zero = torch.zeros_like(net)
    b_util = torch.where(has_path, torch.gather(util_f, -1, bneck)[..., 0],
                         zero)
    agg_f = agg[..., None, :].expand_as(onpath)
    my_share = torch.where(
        has_path,
        net / torch.clamp_min(torch.gather(agg_f, -1, bneck)[..., 0], 1e-9),
        zero)
    path_len = onpath.sum(dim=-1) / onpath.shape[-1]
    return torch.stack([b_util, path_len, my_share], dim=-1)


def topology_observe(params: SimParams, state: TopologyState, *,
                     flows: FlowSchedule, graph: LinkGraph, paths: PathSpec,
                     spec: ObservationSpec = DEFAULT_OBS,
                     objectives: FlowObjective = None,
                     max_active: int = None):
    """(E, F, spec.frame_dim) observations: the fleet observation
    normalized by each graph's peak bandwidth, extended (spec.topology)
    with the ``topology_features`` block. At one link a topology-blind spec
    is ``fleet_observe`` bit for bit."""
    _refuse_compact(max_active, state.threads.shape[1])
    base = fleet_observe(params, state, flows=flows, spec=spec,
                         objectives=objectives, bw_ref=graph_peak_bw(graph))
    if not spec.topology:
        return base
    onpath = routes_at(paths, state.t)                          # (E, F, L)
    topo = topology_features(onpath, state.throughputs[..., 1],
                             active_at(flows, state.t), link_peak_bw(graph))
    return torch.cat([base, topo], dim=-1)


def topology_reset(params: SimParams, n_envs: int, n_flows: int, t0=0.0, *,
                   graph: LinkGraph, paths: PathSpec,
                   flows: FlowSchedule = None, substeps=50,
                   objectives: FlowObjective = None, max_active: int = None,
                   generator=None, threads=None):
    """The topology twin of ``fleet_reset``: random initial threads in
    [1, 16) (or ``threads`` (E, F, 3)), empty buffers, one warm-up interval
    over the graphs. ``t0``: a scalar or (E,)."""
    device = params.tpt.device
    if flows is None:
        flows = _always_on_batch(n_envs, n_flows, device)
    if threads is None:
        threads = torch.randint(1, 16, (n_envs, n_flows, 3),
                                generator=generator, device=device)
    threads = threads.to(device=device, dtype=torch.float32)
    buffers = torch.zeros((n_envs, n_flows, 2), dtype=torch.float32,
                          device=device)
    t0 = as_f32(t0, device).expand(n_envs)
    buffers, tps = topology_interval(params, buffers, threads, t0,
                                     graph=graph, paths=paths, flows=flows,
                                     substeps=substeps, objectives=objectives,
                                     max_active=max_active)
    return TopologyState(buffers=buffers, threads=threads, throughputs=tps,
                         t=t0 + params.duration, prev_throughputs=tps,
                         delivered=torch.zeros((n_envs, n_flows),
                                               dtype=torch.float32,
                                               device=device))


def topology_step(params: SimParams, state: TopologyState, actions, *,
                  graph: LinkGraph, paths: PathSpec,
                  flows: FlowSchedule = None, substeps=50,
                  spec: ObservationSpec = DEFAULT_OBS, fairness_coef=0.0,
                  objectives: FlowObjective = None, deadline_coef=1.0,
                  max_active: int = None):
    """actions (E, F, 3) -> round (half to even) -> clamp [1, n_max]; one
    ``duration``-second interval over the graphs. Returns (state', obs
    (E, F, frame_dim), reward (E,)); the reward is the shared fleet
    objective normalized by each graph's peak."""
    E, F = state.threads.shape[:2]
    _refuse_compact(max_active, F)
    if flows is None:
        flows = _always_on_batch(E, F, state.threads.device)
    threads = torch.clamp(torch.round(actions), min=1.0)
    threads = torch.minimum(threads, params.n_max)
    buffers, tps = topology_interval(params, state.buffers, threads, state.t,
                                     graph=graph, paths=paths, flows=flows,
                                     substeps=substeps, objectives=objectives)
    delivered0 = state.delivered
    new_state = TopologyState(buffers=buffers, threads=threads,
                              throughputs=tps, t=state.t + params.duration,
                              prev_throughputs=state.throughputs,
                              delivered=delivered0 + tps[..., 2]
                              * params.duration)
    objs = (_default_objectives_batch(E, F, tps.device)
            if objectives is None else objectives)
    reward = _fleet_reward(params, tps, threads,
                           active_at(flows, state.t + 0.5 * params.duration),
                           objs, delivered0, state.t, graph_peak_bw(graph),
                           fairness_coef, deadline_coef)
    obs = topology_observe(params, new_state, flows=flows, graph=graph,
                           paths=paths, spec=spec, objectives=objectives)
    return new_state, obs, reward


def topology_achievable(params: SimParams, graph: LinkGraph, paths: PathSpec,
                        flows: FlowSchedule, t,
                        objectives: FlowObjective = None):
    """(E,) best aggregate end-to-end rate each env's active fleet could
    sustain over its graph at sim time ``t`` (E,): the contention solve at
    full concurrency (every flow at n_max on every stage, one substep),
    the per-flow end-to-end bottlenecks summed (0 when no flow is
    active)."""
    E, F = flows.t_start.shape
    t = as_f32(t, params.tpt.device).expand(E)
    threads = params.n_max.expand(E, F, 3)
    rates = _solve_topology_rates(params, graph, paths, threads, flows, t, 1,
                                  objectives)                    # (E, 1, F, 3)
    return rates[:, 0].amin(dim=-1).sum(dim=-1)
