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

``max_active < F`` takes the compact-active-set path, the fleet's gather
(``core.fleet``) plus the columns of the routing matrix: each interval
gathers the <= max_active flows whose window intersects it, solves them
through ONE K3 launch on (E, S, A, L) operands with ``rounds = A`` and
integrates them through ONE K1 launch on E*A rows, and scatters them back;
the step scores its reward on the same gather, and the observation builds
the topology block from it (ungathered rows exactly zero). Against the
dense path it agrees to float32 reassociation noise in the flow sums
(1e-6 without finite caps; 1e-5 with caps, where the spill rounds run on
A flows instead of F). ``_sorted_water_fill`` is the rounds' closed-form
fixed point, the oracle K3's water-fill is held to where the plain round
loop is slow (``contention_rates_reference(..., fill=_sorted_water_fill)``);
no path runs it.

Sharded topologies run as sharded fleets do (``core.fleet``,
``repro_torch.sharding.fleet``): the routing matrix's flow axis is split
with the flows, the per-link loads of the observation are one
``all_reduce``, and K3 solves the assembled full-F operands on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fleet import (FleetState, FlowSchedule, FlowObjective,
                                    active_at, _always_on_batch,
                                    _default_objectives_batch,
                                    _integrate_fleet_rates, _fleet_reward,
                                    fleet_observe, _window_flow_ids, _take,
                                    _scatter, _gather_compact,
                                    _sparse_fleet_observe, _full_operands)
from repro_torch.core.simulator import (SimParams, ObservationSpec,
                                        DEFAULT_OBS)
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.contention.ops import contention_rates
from repro_torch.sharding.fleet import (STATE_DIMS, flow_all_reduce,
                                        flow_rows, flow_sharded, local_flows)

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


def _sorted_water_fill(alloc, headroom, w, lam0):
    """The closed-form fixed point of the spill rounds, O(A log A) in the
    flow axis (axis 2 of the (E, S, F, L, 3) operands ``alloc``,
    ``headroom`` and ``w``; ``lam0`` (E, S, L, 3)): the rounds converge to
    ``alloc_f = min(headroom_f, w_f * lam)``, ``lam`` the water level at
    which the redistributed pool is used up (or every cap saturated).
    Sorting the saturation breakpoints ``headroom_f / w_f`` and prefix
    summing what they consume gives ``lam`` directly.

    With no finite cap the first spill is exactly 0.0, so ``delta`` is
    +0.0 and ``min(alloc + w * 0.0, inf) == alloc``: the rounds' exact
    no-op, bit for bit. With finite caps it reaches the rounds' fixed point
    up to the order of the sums."""
    recv = w > 0                                       # only weighted flows
    h = torch.where(recv, headroom, 0.0)               # ...receive spill
    pool = alloc.sum(dim=2)                            # (E, S, L, 3)
    spill0 = torch.clamp_min(alloc - headroom, 0.0).sum(dim=2)
    r = torch.where(recv, headroom / torch.where(recv, w, 1.0), INF)
    order = torch.argsort(r, dim=2, stable=True)
    r_s = torch.gather(r, 2, order)
    h_s = torch.gather(h, 2, order)
    w_s = torch.gather(torch.where(recv, w, 0.0), 2, order)
    w_tot = w_s.sum(dim=2)
    w_rem = w_tot[:, :, None] - torch.cumsum(w_s, dim=2)  # unsaturated past i
    # water consumed when the level reaches breakpoint r_i (an uncapped
    # flow's inf is masked where no weight remains, so inf * 0 is no NaN)
    cons = (torch.cumsum(h_s, dim=2)
            + torch.where(w_rem > 0, r_s, 0.0) * w_rem)
    sat = cons < pool[:, :, None]                      # fully submerged
    h_sat = torch.where(sat, h_s, 0.0).sum(dim=2)
    w_unsat = w_tot - torch.where(sat, w_s, 0.0).sum(dim=2)
    lam = (pool - h_sat) / torch.clamp_min(w_unsat, 1e-9)
    delta = torch.where(spill0 > 0.0, torch.clamp_min(lam - lam0, 0.0), 0.0)
    return torch.minimum(alloc + w * delta[:, :, None], headroom)


def _solve_topology_rates(params: SimParams, graph: LinkGraph,
                          paths: PathSpec, threads, flows: FlowSchedule, t0,
                          substeps: int, objectives: FlowObjective = None):
    """(E, S, F, 3) per-flow rates over the link graphs through K3: the
    schedule, activity and route gathers here, then the per-link split,
    the F water-fill rounds and the min over each flow's links of every
    env and substep in one launch (F is A on the compact path). In a flow
    scope the operands are assembled to full F and the rank's rows of the
    rates kept."""
    threads, flows, objectives, onpath = _full_operands(
        threads, flows, objectives, (paths.onpath, -2))
    paths = PathSpec(onpath=onpath, bin_seconds=paths.bin_seconds)
    ts, tpt, bw = _link_conditions(params, graph, t0, substeps)
    act = active_at(flows, ts)                                  # (E, S, F)
    onpath = routes_at(paths, ts)                               # (E, S, F, L)
    floor = cap = None
    if objectives is not None:
        floor = objectives.rate_floor.contiguous()
        cap = objectives.rate_cap.contiguous()
    return flow_rows(contention_rates(threads.contiguous(), act.contiguous(),
                                      onpath.contiguous(), tpt.contiguous(),
                                      bw.contiguous(), floor, cap,
                                      rounds=threads.shape[1]), 2)


def _sparse_topology_interval(params: SimParams, graph: LinkGraph,
                              paths: PathSpec, buffers, threads, t0,
                              flows: FlowSchedule, substeps, objectives,
                              max_active: int, return_compact=False):
    """The compact-active-set path of ``topology_interval``: the fleet's
    gather of the <= max_active flows whose window intersects this
    interval, plus the same columns of every route bin's routing matrix;
    K3 on the compact set (``rounds = A``), K1 on E*A rows, scattered back.
    Flows outside the window keep their buffers and have throughputs
    EXACTLY zero. ``return_compact`` also hands back the gather (idx,
    valid, c_tps, c_threads, c_flows, c_objs) so ``topology_step`` scores
    the reward on the same compact set."""
    F = flows.n_flows
    idx = _window_flow_ids(flows, t0, params.duration, max_active)
    c_threads, c_flows, c_objs = _gather_compact(idx, F, threads, flows,
                                                 objectives)
    safe = torch.clamp_max(idx, F - 1)
    valid = idx < F
    onpath = paths.onpath                                       # (E, R, F, L)
    cols = safe[:, None, :, None].expand(-1, onpath.shape[1], -1,
                                         onpath.shape[3])
    c_paths = PathSpec(onpath=torch.where(valid[:, None, :, None],
                                          torch.gather(onpath, 2, cols), 0.0),
                       bin_seconds=paths.bin_seconds)
    c_bufs = torch.where(valid[..., None], _take(buffers, safe), 0.0)
    rates = _solve_topology_rates(params, graph, c_paths, c_threads, c_flows,
                                  t0, substeps, c_objs)
    c_bufs, c_tps = _integrate_fleet_rates(params, c_bufs, rates)
    new_buffers = _scatter(buffers, idx, c_bufs)
    tps = _scatter(torch.zeros_like(threads), idx, c_tps)
    if return_compact:
        return (new_buffers, tps, idx, valid, c_tps, c_threads, c_flows,
                c_objs)
    return new_buffers, tps


@flow_sharded((-2, -2))
def topology_interval(params: SimParams, buffers, threads, t0, *,
                      graph: LinkGraph, paths: PathSpec, flows: FlowSchedule,
                      substeps=50, objectives: FlowObjective = None,
                      max_active: int = None):
    """Simulate ``duration`` seconds of F flows over each env's link graph
    from sim time ``t0`` (E,): the topology twin of ``fleet_interval`` (the
    same buffer dynamics; only the solve differs). Returns (buffers'
    (E, F, 2), tps (E, F, 3)). ``max_active``: optional bound on the flows
    any one interval touches (the compact path; a caller PROMISE, as in
    ``fleet_interval``); None or >= F runs the dense solve."""
    t0 = as_f32(t0, buffers.device).expand(buffers.shape[0])
    if max_active is not None and max_active < flows.n_flows:
        return _sparse_topology_interval(params, graph, paths, buffers,
                                         threads, t0, flows, substeps,
                                         objectives, max_active)
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
    link capacities in engine units). In a flow scope the per-link loads
    are summed over the whole fleet."""
    onpath = as_f32(onpath)
    net = as_f32(net_tps, onpath.device) * as_f32(active, onpath.device)
    agg = flow_all_reduce((onpath * net[..., None]).sum(dim=-2))  # (..., L)
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


def _sparse_topology_observe(params: SimParams, state: TopologyState, *,
                             flows, graph, paths, spec, objectives,
                             max_active: int):
    """The compact-active-set path of ``topology_observe``: the fleet's
    compact observation plus the rows of the routing matrix now feeding
    ``topology_features`` on the compact set (the per-link loads drop only
    exact +0.0 terms: an inactive flow adds ``net * 0``). Ungathered rows
    are EXACTLY zero; gathered rows match the dense path to float32
    reassociation noise."""
    F = state.threads.shape[1]
    base = _sparse_fleet_observe(params, state, flows=flows, spec=spec,
                                 objectives=objectives,
                                 bw_ref=graph_peak_bw(graph),
                                 max_active=max_active)
    if not spec.topology:
        return base
    idx = _window_flow_ids(flows, state.t, params.duration, max_active)
    safe = torch.clamp_max(idx, F - 1)
    valid = idx < F
    _, c_flows, _ = _gather_compact(idx, F, state.threads, flows, None)
    c_onpath = torch.where(valid[..., None],
                           _take(routes_at(paths, state.t), safe), 0.0)
    c_net = torch.where(valid, _take(state.throughputs[..., 1], safe), 0.0)
    topo = topology_features(c_onpath, c_net, active_at(c_flows, state.t),
                             link_peak_bw(graph))               # (E, A, 3)
    full = topo.new_zeros((topo.shape[0], F, topo.shape[-1]))
    return torch.cat([base, _scatter(full, idx, topo)], dim=-1)


@flow_sharded(-2)
def topology_observe(params: SimParams, state: TopologyState, *,
                     flows: FlowSchedule, graph: LinkGraph, paths: PathSpec,
                     spec: ObservationSpec = DEFAULT_OBS,
                     objectives: FlowObjective = None,
                     max_active: int = None):
    """(E, F, spec.frame_dim) observations: the fleet observation
    normalized by each graph's peak bandwidth, extended (spec.topology)
    with the ``topology_features`` block. At one link a topology-blind spec
    is ``fleet_observe`` bit for bit. ``max_active``: the compact path
    (ungathered rows exactly zero)."""
    if max_active is not None and max_active < state.threads.shape[1]:
        return _sparse_topology_observe(params, state, flows=flows,
                                        graph=graph, paths=paths, spec=spec,
                                        objectives=objectives,
                                        max_active=max_active)
    base = fleet_observe(params, state, flows=flows, spec=spec,
                         objectives=objectives, bw_ref=graph_peak_bw(graph))
    if not spec.topology:
        return base
    onpath = routes_at(paths, state.t)                          # (E, F, L)
    topo = topology_features(onpath, state.throughputs[..., 1],
                             active_at(flows, state.t), link_peak_bw(graph))
    return torch.cat([base, topo], dim=-1)


@flow_sharded(STATE_DIMS)
def topology_reset(params: SimParams, n_envs: int, n_flows: int, t0=0.0, *,
                   graph: LinkGraph, paths: PathSpec,
                   flows: FlowSchedule = None, substeps=50,
                   objectives: FlowObjective = None, max_active: int = None,
                   generator=None, threads=None):
    """The topology twin of ``fleet_reset``: random initial threads in
    [1, 16) (or ``threads`` (E, F, 3)), empty buffers, one warm-up interval
    over the graphs. ``t0``: a scalar or (E,). In a flow scope ``n_flows``
    is the whole fleet's, as in ``fleet_reset``."""
    device = params.tpt.device
    n_local = local_flows(n_flows)
    if flows is None:
        flows = _always_on_batch(n_envs, n_local, device)
    if threads is None:
        threads = flow_rows(torch.randint(1, 16, (n_envs, n_flows, 3),
                                          generator=generator,
                                          device=device), 1)
    threads = threads.to(device=device, dtype=torch.float32)
    buffers = torch.zeros((n_envs, n_local, 2), dtype=torch.float32,
                          device=device)
    t0 = as_f32(t0, device).expand(n_envs)
    buffers, tps = topology_interval(params, buffers, threads, t0,
                                     graph=graph, paths=paths, flows=flows,
                                     substeps=substeps, objectives=objectives,
                                     max_active=max_active)
    return TopologyState(buffers=buffers, threads=threads, throughputs=tps,
                         t=t0 + params.duration, prev_throughputs=tps,
                         delivered=torch.zeros((n_envs, n_local),
                                               dtype=torch.float32,
                                               device=device))


@flow_sharded((STATE_DIMS, -2, None))
def topology_step(params: SimParams, state: TopologyState, actions, *,
                  graph: LinkGraph, paths: PathSpec,
                  flows: FlowSchedule = None, substeps=50,
                  spec: ObservationSpec = DEFAULT_OBS, fairness_coef=0.0,
                  objectives: FlowObjective = None, deadline_coef=1.0,
                  max_active: int = None):
    """actions (E, F, 3) -> round (half to even) -> clamp [1, n_max]; one
    ``duration``-second interval over the graphs. Returns (state', obs
    (E, F, frame_dim), reward (E,)); the reward is the shared fleet
    objective normalized by each graph's peak. ``max_active``: the compact
    path, whose reward is scored on the interval's gather."""
    E, F = state.threads.shape[:2]
    if flows is None:
        flows = _always_on_batch(E, F, state.threads.device)
    threads = torch.clamp(torch.round(actions), min=1.0)
    threads = torch.minimum(threads, params.n_max)
    bw_ref = graph_peak_bw(graph)
    t_mid = state.t + 0.5 * params.duration
    sparse = max_active is not None and max_active < F
    if sparse:
        # ONE gather serves the solve and the reward: the reward's instant
        # (t + duration/2) lies inside the interval window
        (buffers, tps, idx, valid, c_tps, c_threads, c_flows,
         c_objs) = _sparse_topology_interval(
            params, graph, paths, state.buffers, threads, state.t, flows,
            substeps, objectives, max_active, return_compact=True)
    else:
        buffers, tps = topology_interval(params, state.buffers, threads,
                                         state.t, graph=graph, paths=paths,
                                         flows=flows, substeps=substeps,
                                         objectives=objectives)
    delivered0 = state.delivered
    new_state = TopologyState(buffers=buffers, threads=threads,
                              throughputs=tps, t=state.t + params.duration,
                              prev_throughputs=state.throughputs,
                              delivered=delivered0 + tps[..., 2]
                              * params.duration)
    if sparse:
        if c_objs is None:
            c_objs = _default_objectives_batch(E, max_active, tps.device)
        c_delivered0 = torch.where(
            valid, _take(delivered0, torch.clamp_max(idx, F - 1)), 0.0)
        reward = _fleet_reward(params, c_tps, c_threads,
                               active_at(c_flows, t_mid), c_objs,
                               c_delivered0, state.t, bw_ref, fairness_coef,
                               deadline_coef)
    else:
        objs = (_default_objectives_batch(E, F, tps.device)
                if objectives is None else objectives)
        reward = _fleet_reward(params, tps, threads, active_at(flows, t_mid),
                               objs, delivered0, state.t, bw_ref,
                               fairness_coef, deadline_coef)
    obs = topology_observe(params, new_state, flows=flows, graph=graph,
                           paths=paths, spec=spec, objectives=objectives,
                           max_active=max_active)
    return new_state, obs, reward


@flow_sharded(None)
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
    return flow_all_reduce(rates[:, 0].amin(dim=-1).sum(dim=-1))
