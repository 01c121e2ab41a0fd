"""Multi-flow fleet core: F concurrent transfers sharing one bottleneck,
with the env batch written out (port of ``repro.core.fleet``).

Each flow runs its own 3-stage pipeline with its own staging buffers and
thread pools; the stage bandwidths of the schedule are one pool, split
across the flows ACTIVE in each sub-interval in proportion to their thread
counts:

    eff[f]   = threads[f] * active[f]                 (per stage)
    share[f] = eff[f] / sum_g eff[g]
    rate[f]  = min(eff[f] * TPT, share[f] * B)

Per-flow objectives (``FlowObjective``: priority weight, deadline, rate
floor and cap) shape the split and the reward; the default objective is
the objective-free program. Flows join and leave through a
``FlowSchedule`` of [t_start, t_end) activity windows.

Where the JAX package vmaps a per-env fleet, every function here takes a
leading env axis E: buffers (E, F, 2), threads (E, F, 3), clock t (E,),
batched ``FlowSchedule``/``FlowObjective`` (E, F) and a batched
``ScheduleTable`` (E, T, 3) or None for the params' static conditions. One
env step of the whole batch is ONE launch of the contention kernel
(``repro_torch.kernels.contention``, K3, with ``rounds=0`` on the one-link
embedding) and ONE launch of the sim_step kernel (K1, on E*F rows); CPU
tensors take the kernels' plain versions.

``max_active`` bounds the flows any one interval can touch: the solve then
gathers that compact set (ascending flow order, empty slots filled with F),
contends and integrates it, and scatters it back through an F+1-row buffer
whose last row is dropped — no host sync inside a step.

Sharded fleets: given ``DTensor`` leaves split over a mesh's "flows" axis
(``repro_torch.sharding.fleet.shard_*``), each entry point runs on the
rank's own flows and returns outputs sharded the same way: the reductions
over F are one ``all_reduce`` each, and the contention solve assembles its
full-F operands and keeps the rank's rows (``sharding.fleet``).

Liveness faults reach the fleet as edits of these structures
(``repro_torch.scenarios.faults``): a kill with a restart becomes a
``FlowSchedule`` down window [down_start, down_end) in which the flow is
inactive, a kill without one truncates ``t_end``, and stage hangs zero
table bins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.schedule import ScheduleTable, peak_bw, schedule_at
from repro_torch.core.simulator import (SimParams, ObservationSpec,
                                        DEFAULT_OBS, _table_or_params)
from repro_torch.core.utility import (utility, needed_rate, needed_rate_np,
                                      deadline_penalty)
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.contention.ops import contention_rates
from repro_torch.kernels.sim_step.ops import sim_interval_batch
from repro_torch.sharding.fleet import (STATE_DIMS, flow_all_reduce,
                                        flow_gather, flow_rows, flow_sharded,
                                        global_flows, local_flows)

INF = float("inf")


def _host(x):
    """A NumPy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FlowSchedule(NamedTuple):
    """Per-flow activity windows: flow ``f`` is active on
    ``[t_start[f], t_end[f])`` of the sim clock; (F,) for one fleet,
    (E, F) for a batch.

    ``down_start``/``down_end`` are the optional liveness-fault fields:
    flow ``f`` is forced inactive on ``[down_start[f], down_end[f])``, one
    kill -> restart outage (compiled from a FaultSpec by
    ``repro_torch.scenarios.faults``). None, the default, is the fault-free
    program; an all-inf window adds two compares that are False
    everywhere, so it is an exact no-op."""

    t_start: torch.Tensor
    t_end: torch.Tensor
    down_start: torch.Tensor = None
    down_end: torch.Tensor = None

    @property
    def n_flows(self) -> int:
        return self.t_start.shape[-1]


def _map_schedule(fn, flows: FlowSchedule) -> FlowSchedule:
    """``fn`` applied to every field of ``flows`` that is set."""
    return FlowSchedule(*(None if x is None else fn(x) for x in flows))


def make_flow_schedule(t_start, t_end, down_start=None, down_end=None, *,
                       device=None) -> FlowSchedule:
    t_start = as_f32(t_start, device)
    t_end = as_f32(t_end, t_start.device)
    if t_start.shape != t_end.shape or t_start.ndim != 1:
        raise ValueError(f"flow schedule must be two (F,) arrays: "
                         f"{tuple(t_start.shape)} vs {tuple(t_end.shape)}")
    if (down_start is None) != (down_end is None):
        raise ValueError("pass both down_start and down_end, or neither")
    if down_start is not None:
        down_start = as_f32(down_start, t_start.device)
        down_end = as_f32(down_end, t_start.device)
        if (down_start.shape != t_start.shape
                or down_end.shape != t_start.shape):
            raise ValueError(f"down windows must match the (F,) schedule: "
                             f"{tuple(down_start.shape)}/"
                             f"{tuple(down_end.shape)} vs "
                             f"{tuple(t_start.shape)}")
    return FlowSchedule(t_start=t_start, t_end=t_end,
                        down_start=down_start, down_end=down_end)


def always_on(n_flows: int, *, device=None) -> FlowSchedule:
    """All F flows active for the whole episode."""
    device = resolve_device(device)
    return FlowSchedule(
        t_start=torch.zeros((n_flows,), dtype=torch.float32, device=device),
        t_end=torch.full((n_flows,), INF, dtype=torch.float32,
                         device=device))


def _always_on_host(n_flows: int) -> FlowSchedule:
    """``always_on`` on the CPU, for the NumPy arrival families."""
    return always_on(n_flows, device="cpu")


def _always_on_batch(n_envs, n_flows, device) -> FlowSchedule:
    return _map_schedule(lambda x: x.expand(n_envs, n_flows),
                         always_on(n_flows, device=device))


def stack_flow_schedules(schedules) -> FlowSchedule:
    """Stack same-F schedules into one batched FlowSchedule (leading env
    axis). Down windows stack too: in a mix of faulted and fault-free
    schedules the missing windows become all-inf (exact no-ops); all None
    stays None."""
    schedules = list(schedules)
    sizes = {s.n_flows for s in schedules}
    if len(sizes) != 1:
        raise ValueError(f"cannot stack fleets of different sizes {sizes}")
    if all(s.down_start is None for s in schedules):
        down_start = down_end = None
    else:
        def _down(s, x):
            return torch.full_like(s.t_start, INF) if x is None else x
        down_start = torch.stack([_down(s, s.down_start) for s in schedules])
        down_end = torch.stack([_down(s, s.down_end) for s in schedules])
    return FlowSchedule(t_start=torch.stack([s.t_start for s in schedules]),
                        t_end=torch.stack([s.t_end for s in schedules]),
                        down_start=down_start, down_end=down_end)


def active_at(flows: FlowSchedule, t):
    """Float mask of the flows active at sim time ``t``: (F,) flows and a
    scalar ``t`` give (F,); (E, F) flows and ``t`` (E,) give (E, F), and
    ``t`` (E, S) gives (E, S, F). A flow inside its down window is
    inactive."""
    t = torch.as_tensor(t, dtype=torch.float32, device=flows.t_start.device)
    lead = flows.t_start.shape[:-1]
    extra = t.ndim - len(lead)
    shape = lead + (1,) * extra + (flows.n_flows,)
    t = t[..., None]
    act = ((t >= flows.t_start.reshape(shape))
           & (t < flows.t_end.reshape(shape)))
    if flows.down_start is not None:
        act &= ~((t >= flows.down_start.reshape(shape))
                 & (t < flows.down_end.reshape(shape)))
    return act.to(torch.float32)


# ---------------------------------------------------------------------------
# Fleet scale-out: pow2 buckets, padding, and the compact active-set gather
# ---------------------------------------------------------------------------


def flow_bucket(n: int) -> int:
    """Next power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def max_concurrent_flows(flows: FlowSchedule, *, window: float = 0.0) -> int:
    """Host-side event sweep: the max number of flows whose [t_start,
    t_end) window intersects ANY ``window``-second interval — the tight
    bound to feed ``max_active`` (pass the step ``duration``). NumPy on the
    host; batched schedules return the max over the batch."""
    ts = _host(flows.t_start).astype(np.float64)
    te = _host(flows.t_end).astype(np.float64)
    if ts.ndim > 1:
        flat = ts.reshape(-1, ts.shape[-1])
        flat_e = te.reshape(-1, te.shape[-1])
        return max(max_concurrent_flows(FlowSchedule(s, e), window=window)
                   for s, e in zip(flat, flat_e))
    starts = np.sort(ts - window)
    ends = np.sort(te)
    live = best = j = 0
    for s in starts:
        while j < len(ends) and ends[j] <= s:
            live -= 1
            j += 1
        live += 1
        best = max(best, live)
    return best


def _pad(x, pad, fill):
    tail = torch.full(x.shape[:-1] + (pad,), fill, dtype=torch.float32,
                      device=x.device)
    return torch.cat([x, tail], dim=-1)


def pad_flow_schedule(flows: FlowSchedule, n_to: int) -> FlowSchedule:
    """Pad to ``n_to`` flows with never-active windows (t_start = t_end =
    inf): a padded flow moves nothing, scores zero utility and is masked
    out of the Jain term, so the reward is unchanged."""
    pad = n_to - flows.n_flows
    if pad < 0:
        raise ValueError(f"cannot pad {flows.n_flows} flows down to {n_to}")
    if pad == 0:
        return flows
    # a padded flow never runs, so its down window is moot: inf/inf
    return _map_schedule(lambda x: _pad(x, pad, INF), flows)


# per-field fill values for padded / invalid flow objectives: the default
# objective, an exact no-op through the whole solve
_OBJECTIVE_FILLS = {"weight": 1.0, "deadline": INF, "demand": INF,
                    "rate_floor": 0.0, "rate_cap": INF}


def pad_flow_objectives(objectives, n_to: int):
    """Objective twin of ``pad_flow_schedule``: pads with the default
    objective. None stays None."""
    if objectives is None:
        return None
    pad = n_to - objectives.n_flows
    if pad < 0:
        raise ValueError(f"cannot pad {objectives.n_flows} flows to {n_to}")
    if pad == 0:
        return objectives
    return type(objectives)(**{
        f: _pad(getattr(objectives, f), pad, _OBJECTIVE_FILLS[f])
        for f in objectives._fields})


def _window_flow_ids(flows: FlowSchedule, t0, duration, max_active: int):
    """(E, max_active) int64 indices of the flows whose activity window
    intersects [t0, t0 + duration), ascending, empty slots filled with F.
    A cumsum over the hit mask gives each hit its slot; one scatter into an
    (E, max_active + 1) buffer whose last column takes the misses and the
    overflow. ``max_active`` is a caller PROMISE: flows past it are
    treated as absent for the interval."""
    E, F = flows.t_start.shape
    hit = ((flows.t_start < (t0 + duration)[:, None])
           & (flows.t_end > t0[:, None]))
    slot = torch.cumsum(hit, dim=-1) - 1
    slot = torch.where(hit & (slot < max_active), slot,
                       torch.full_like(slot, max_active))
    ids = torch.full((E, max_active + 1), F, dtype=torch.int64,
                     device=hit.device)
    src = torch.arange(F, device=hit.device).expand(E, F)
    return ids.scatter_(1, slot, src)[:, :max_active]


def _take(x, safe):
    """Rows ``safe`` (E, A) of the per-flow (E, F, ...) tensor ``x``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, safe]


def _scatter(base, idx, values):
    """``base`` (E, F, ...) with rows ``idx`` (E, A) set to ``values``;
    slots holding F land in a dropped extra row."""
    E, F = base.shape[:2]
    buf = torch.cat([base, base.new_zeros((E, 1) + base.shape[2:])], dim=1)
    rows = torch.arange(E, device=base.device)[:, None]
    buf[rows, idx] = values
    return buf[:, :F]


def _gather_compact(idx, n_flows, threads, flows, objectives):
    """The compact (E, A) slice of a fleet. Invalid slots (idx == F) become
    never-active flows with default objectives, so every rate and utility
    term they touch is exactly zero."""
    safe = torch.clamp_max(idx, n_flows - 1)
    valid = idx < n_flows
    c_threads = torch.where(valid[..., None], _take(threads, safe), 1.0)
    c_flows = _map_schedule(lambda x: torch.where(valid, _take(x, safe),
                                                  INF), flows)
    c_objs = None if objectives is None else type(objectives)(**{
        f: torch.where(valid, _take(getattr(objectives, f), safe),
                       _OBJECTIVE_FILLS[f])
        for f in objectives._fields})
    return c_threads, c_flows, c_objs


# ---------------------------------------------------------------------------
# Per-flow objectives: priority tiers, deadlines, rate floors/caps
# ---------------------------------------------------------------------------

PRIORITY_TIERS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
WEIGHT_REF = PRIORITY_TIERS["gold"]   # observation normalization reference
SLACK_REF = 20.0     # seconds: tanh scale of the deadline-slack feature
URGENCY_CLIP = 4.0   # cap on the needed-rate/bw_ref urgency feature


class FlowObjective(NamedTuple):
    """What each flow is FOR, (F,) per field or (E, F) for a batch.
    Defaults (ones / inf / zeros) are the objective-free world.

    weight      priority weight (gold 4, silver 2, bronze 1)
    deadline    sim-seconds by which ``demand`` should be delivered
    demand      Gbit the deadline refers to (inf = no deadline objective)
    rate_floor  guaranteed per-stage rate while active (0 = none)
    rate_cap    hard per-stage rate ceiling (inf = none)
    """

    weight: torch.Tensor
    deadline: torch.Tensor
    demand: torch.Tensor
    rate_floor: torch.Tensor
    rate_cap: torch.Tensor

    @property
    def n_flows(self) -> int:
        return self.weight.shape[-1]


def make_flow_objective(n_flows=None, *, weight=None, deadline=None,
                        demand=None, rate_floor=None, rate_cap=None,
                        tiers=None, device=None) -> FlowObjective:
    """A FlowObjective from any subset of fields; omitted fields take their
    objective-free defaults. ``tiers`` spells ``weight`` as tier names."""
    if tiers is not None:
        if weight is not None:
            raise ValueError("pass either weight or tiers, not both")
        weight = [PRIORITY_TIERS[t] for t in tiers]
    for v in (weight, deadline, demand, rate_floor, rate_cap):
        if v is None or np.ndim(_host(v)) == 0:
            continue  # scalars broadcast to any F
        n = np.shape(_host(v))[-1]
        if n_flows is None:
            n_flows = n
        elif n_flows != n:
            raise ValueError(f"objective fields disagree on F: "
                             f"{n_flows} vs {n}")
    if n_flows is None:
        raise ValueError("empty objective: pass n_flows or at least one "
                         "non-scalar field")
    device = resolve_device(device)

    def _field(v, default):
        arr = as_f32(default if v is None else v, device)
        return arr.expand(n_flows).clone() if arr.ndim == 0 else arr

    return FlowObjective(weight=_field(weight, 1.0),
                         deadline=_field(deadline, INF),
                         demand=_field(demand, INF),
                         rate_floor=_field(rate_floor, 0.0),
                         rate_cap=_field(rate_cap, INF))


def default_objectives(n_flows: int, *, device=None) -> FlowObjective:
    """The objective-free fleet: weight 1, no deadline, no floor/cap."""
    return make_flow_objective(n_flows, device=device)


def _default_objectives_batch(n_envs, n_flows, device) -> FlowObjective:
    objs = default_objectives(n_flows, device=device)
    return FlowObjective(*(x.expand(n_envs, n_flows) for x in objs))


def stack_flow_objectives(objectives) -> FlowObjective:
    """Stack same-F objectives into one batched FlowObjective."""
    objectives = list(objectives)
    sizes = {o.n_flows for o in objectives}
    if len(sizes) != 1:
        raise ValueError(f"cannot stack fleets of different sizes {sizes}")
    return FlowObjective(*(torch.stack([getattr(o, f) for o in objectives])
                           for f in FlowObjective._fields))


def objective_features(objectives: FlowObjective, t, delivered, *,
                       bw_ref, duration=1.0):
    """(E, F, 3) objective observation block — t (E,), delivered (E, F),
    bw_ref (E,):

      [0] weight / WEIGHT_REF
      [1] tanh((deadline - t) / SLACK_REF)   (1.0 without a deadline)
      [2] clip(needed_rate / bw_ref)         (0 without a deadline)
    """
    t = t[:, None]
    slack = torch.tanh((objectives.deadline - t) / SLACK_REF)
    need = needed_rate(objectives.demand, delivered, objectives.deadline, t,
                       min_horizon=duration)
    urgency = torch.clamp(need / bw_ref[:, None], 0.0, URGENCY_CLIP)
    weight = (objectives.weight / WEIGHT_REF).expand_as(slack)
    return torch.stack([weight, slack, urgency], dim=-1)


def objective_features_np(objectives: FlowObjective, t, delivered, *,
                          bw_ref, duration=1.0):
    """NumPy twin of ``objective_features`` for one fleet (the live
    controller's hot path): (F, 3) float32, no device dispatch."""
    t = np.float32(t)
    weight = _host(objectives.weight).astype(np.float32)
    deadline = _host(objectives.deadline).astype(np.float32)
    demand = _host(objectives.demand).astype(np.float32)
    slack = np.tanh((deadline - t) / np.float32(SLACK_REF))
    need = needed_rate_np(demand, delivered, deadline, t,
                          min_horizon=duration)
    urgency = np.clip(need / np.float32(bw_ref), np.float32(0.0),
                      np.float32(URGENCY_CLIP))
    return np.stack([weight / np.float32(WEIGHT_REF), slack, urgency],
                    axis=-1).astype(np.float32)


class FleetState(NamedTuple):
    """The flow-batched twin of EnvState: per-flow leaves (E, F, ...), one
    sim clock per env. ``delivered`` is each flow's cumulative goodput
    (Gbit) since reset, what deadline objectives are scored against."""

    buffers: torch.Tensor           # (E, F, 2)
    threads: torch.Tensor           # (E, F, 3)
    throughputs: torch.Tensor       # (E, F, 3)
    t: torch.Tensor                 # (E,)
    prev_throughputs: torch.Tensor  # (E, F, 3)
    delivered: torch.Tensor         # (E, F)


# ---------------------------------------------------------------------------
# The solve, the integration, the interval
# ---------------------------------------------------------------------------


def _substep_conditions(params: SimParams, table: ScheduleTable, t0,
                        substeps: int):
    """Per-substep times (E, S) and stage conditions tpt/bw (E, S, 3): the
    reference's float32 ops in order (``ts = t0 + dt * arange``, then floor
    of ``ts / bin_seconds``)."""
    dt = params.duration / substeps
    T = table.tpt.shape[1]
    steps = torch.arange(substeps, dtype=torch.float32, device=t0.device)
    ts = t0[:, None] + dt * steps
    idx = torch.clamp(torch.floor(ts / table.bin_seconds[:, None]), 0, T - 1)
    idx = idx.to(torch.int64)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return ts, table.tpt[rows, idx], table.bw[rows, idx]


def _fleet_substep_rates(params: SimParams, table: ScheduleTable, threads,
                         flows: FlowSchedule, t0, substeps: int,
                         objectives: FlowObjective = None):
    """(E, S, F, 3) per-flow rates under contention, the plain dense solve
    (the reference's, op for op). With ``objectives`` each flow's demand is
    clamped to its cap, every active flow is first guaranteed min(floor,
    demand) (floors scaled down when oversubscribed) and the residual
    splits thread-proportionally. The trailing act mask makes "inactive
    moves nothing" exact on every path."""
    ts, tpt, bw = _substep_conditions(params, table, t0, substeps)
    act = active_at(flows, ts)                         # (E, S, F)
    eff = threads[:, None] * act[..., None]            # (E, S, F, 3)
    total = torch.clamp_min(eff.sum(dim=2), 1e-9)      # (E, S, 3)
    share = eff / total[:, :, None]
    tpt, bw = tpt[:, :, None], bw[:, :, None]
    if objectives is None:
        return torch.minimum(eff * tpt, share * bw) * act[..., None]
    demand = torch.minimum(eff * tpt, objectives.rate_cap[:, None, :, None])
    guaranteed = torch.minimum(objectives.rate_floor[:, None, :, None],
                               demand)
    g_tot = guaranteed.sum(dim=2, keepdim=True)
    guaranteed = guaranteed * torch.clamp_max(
        bw / torch.clamp_min(g_tot, 1e-9), 1.0)
    residual = torch.clamp_min(bw - guaranteed.sum(dim=2, keepdim=True), 0.0)
    return (torch.minimum(demand, guaranteed + share * residual)
            * act[..., None])


def _full_operands(threads, flows, objectives, *extra):
    """A solve's per-flow operands at full F (in a flow scope; as they are
    outside one): threads (E, F, 3), the schedule and objective fields
    (E, F), and ``extra`` (tensor, flow dim) pairs, in one gather."""
    pairs = [(threads, -2)]
    pairs += [(x, -1) for x in flows if x is not None]
    if objectives is not None:
        pairs += [(x, -1) for x in objectives]
    full = iter(flow_gather(*pairs, *extra))
    threads = next(full)
    flows = type(flows)(*(None if x is None else next(full) for x in flows))
    if objectives is not None:
        objectives = type(objectives)(*(next(full) for _ in objectives))
    return (threads, flows, objectives, *full)


def _solve_fleet_rates(params: SimParams, table: ScheduleTable, threads,
                       flows: FlowSchedule, t0, substeps: int, objectives):
    """(E, S, F, 3) contention rates through K3: the schedule and activity
    gathers here, then the whole solve of every env and substep in one
    launch on the one-link embedding (onpath all ones), ``rounds=0`` — the
    single-bottleneck fleet model does not water-fill. In a flow scope the
    operands are assembled to full F and the rank's rows of the rates
    kept."""
    threads, flows, objectives = _full_operands(threads, flows, objectives)
    ts, tpt, bw = _substep_conditions(params, table, t0, substeps)
    act = active_at(flows, ts)                         # (E, S, F)
    onpath = torch.ones(act.shape + (1,), dtype=torch.float32,
                        device=act.device)
    floor = cap = None
    if objectives is not None:
        floor = objectives.rate_floor.contiguous()
        cap = objectives.rate_cap.contiguous()
    return flow_rows(contention_rates(threads.contiguous(), act, onpath,
                                      tpt[:, :, None].contiguous(),
                                      bw[:, :, None].contiguous(), floor,
                                      cap, rounds=0), 2)


def _integrate_fleet_rates(params: SimParams, buffers, rates):
    """Push (E, S, F, 3) per-flow rates through the buffer dynamics: one
    sim_step launch on E*F rows. Returns (buffers' (E, F, 2), tps
    (E, F, 3))."""
    E, S, F = rates.shape[:3]
    dt = params.duration / S
    rates_dt = (rates * dt).permute(0, 2, 1, 3).reshape(E * F, S, 3)
    cap = params.cap.expand(E * F, 2).contiguous()
    buffers, moved = sim_interval_batch(
        buffers.reshape(E * F, 2).contiguous(), rates_dt.contiguous(), cap)
    return (buffers.reshape(E, F, 2),
            (moved / params.duration).reshape(E, F, 3))


def _sparse_fleet_interval(params: SimParams, table, buffers, threads, t0,
                           flows: FlowSchedule, substeps, objectives,
                           max_active: int, return_compact=False):
    """The compact-active-set path of ``fleet_interval``: gather the
    <= max_active flows whose window intersects this interval, contend and
    integrate only those, scatter back. Flows outside the window keep their
    buffers and have throughputs EXACTLY zero. ``return_compact`` also
    hands back the gather (idx, valid, c_tps, c_threads, c_flows, c_objs)
    so ``fleet_step`` scores the reward on the same compact set."""
    F = flows.n_flows
    idx = _window_flow_ids(flows, t0, params.duration, max_active)
    c_threads, c_flows, c_objs = _gather_compact(idx, F, threads, flows,
                                                 objectives)
    valid = idx < F
    c_bufs = torch.where(valid[..., None],
                         _take(buffers, torch.clamp_max(idx, F - 1)), 0.0)
    rates = _solve_fleet_rates(params, table, c_threads, c_flows, t0,
                               substeps, c_objs)
    c_bufs, c_tps = _integrate_fleet_rates(params, c_bufs, rates)
    new_buffers = _scatter(buffers, idx, c_bufs)
    tps = _scatter(torch.zeros_like(threads), idx, c_tps)
    if return_compact:
        return (new_buffers, tps, idx, valid, c_tps, c_threads, c_flows,
                c_objs)
    return new_buffers, tps


@flow_sharded((-2, -2))
def fleet_interval(params: SimParams, buffers, threads, t0, *,
                   flows: FlowSchedule, table=None, substeps=50,
                   objectives: FlowObjective = None, max_active: int = None):
    """Simulate ``duration`` seconds of F contending flows in every env
    from sim time ``t0`` (E,). buffers (E, F, 2), threads (E, F, 3);
    returns (buffers' (E, F, 2), tps (E, F, 3)). ``max_active``: optional
    bound on the flows any one interval touches (the compact path); None or
    >= F runs the dense solve."""
    tab = _table_or_params(params, table, buffers.shape[0])
    t0 = as_f32(t0, buffers.device).expand(buffers.shape[0])
    if max_active is not None and max_active < flows.n_flows:
        return _sparse_fleet_interval(params, tab, buffers, threads, t0,
                                      flows, substeps, objectives,
                                      max_active)
    rates = _solve_fleet_rates(params, tab, threads, flows, t0, substeps,
                               objectives)
    return _integrate_fleet_rates(params, buffers, rates)


# ---------------------------------------------------------------------------
# Observation and reward
# ---------------------------------------------------------------------------


def _sparse_fleet_observe(params: SimParams, state: FleetState, *, flows,
                          spec, objectives, bw_ref, max_active: int):
    """Compact-active-set path of ``fleet_observe``: the feature program on
    the <= max_active flows whose window intersects [t, t + duration),
    scattered back; ungathered rows are EXACTLY zero. The active fraction
    keeps the TRUE fleet size as its denominator."""
    F = state.threads.shape[1]
    idx = _window_flow_ids(flows, state.t, params.duration, max_active)
    safe = torch.clamp_max(idx, F - 1)
    valid = idx < F
    c_threads, c_flows, c_objs = _gather_compact(idx, F, state.threads,
                                                 flows, objectives)

    def _rows(x):
        return torch.where(valid[..., None], _take(x, safe), 0.0)

    c_state = FleetState(
        buffers=_rows(state.buffers), threads=c_threads,
        throughputs=_rows(state.throughputs), t=state.t,
        prev_throughputs=_rows(state.prev_throughputs),
        delivered=torch.where(valid, _take(state.delivered, safe), 0.0))
    obs_c = fleet_observe(params, c_state, flows=c_flows, spec=spec,
                          objectives=c_objs, bw_ref=bw_ref, _n_total=F)
    base = obs_c.new_zeros((obs_c.shape[0], F, obs_c.shape[-1]))
    return _scatter(base, idx, obs_c)


@flow_sharded(-2)
def fleet_observe(params: SimParams, state: FleetState, *,
                  flows: FlowSchedule, table=None,
                  spec: ObservationSpec = DEFAULT_OBS,
                  objectives: FlowObjective = None, bw_ref=None,
                  max_active: int = None, _n_total: int = None):
    """(E, F, spec.frame_dim) observations: row (e, f) is what the
    single-flow ``observe`` gives for flow f's slice, extended (spec.fleet)
    with the active fraction, aggregate link utilization and my-share, and
    (spec.objectives) with ``objective_features``. ``bw_ref`` (E,)
    overrides the normalization reference (default: the table's peak).
    ``max_active``: the compact path (ungathered rows exactly zero).
    ``_n_total`` is internal: the true fleet size of a compact slice."""
    E, F = state.threads.shape[:2]
    if bw_ref is None:
        bw_ref = peak_bw(_table_or_params(params, table, E))
    if max_active is not None and max_active < F:
        return _sparse_fleet_observe(params, state, flows=flows, spec=spec,
                                     objectives=objectives, bw_ref=bw_ref,
                                     max_active=max_active)
    ref = bw_ref[:, None, None]
    tps = state.throughputs
    free = (params.cap - state.buffers) / torch.clamp_min(params.cap, 1e-9)
    parts = [torch.cat([state.threads / params.n_max, tps / ref, free],
                       dim=-1)]                                 # (E, F, 8)
    if spec.context:
        delta = (tps - state.prev_throughputs) / ref
        drain = torch.stack([
            (tps[..., 1] - tps[..., 0]) * params.duration
            / torch.clamp_min(params.cap[0], 1e-9),
            (tps[..., 2] - tps[..., 1]) * params.duration
            / torch.clamp_min(params.cap[1], 1e-9),
        ], dim=-1)
        parts += [delta, drain]
    if spec.fleet:
        denom = global_flows(F) if _n_total is None else _n_total
        act = active_at(flows, state.t)                         # (E, F)
        net = tps[..., 1] * act
        n_act, agg = flow_all_reduce(torch.cat([
            act.sum(dim=-1, keepdim=True),
            net.sum(dim=-1, keepdim=True)], dim=-1)).split(1, dim=-1)
        parts.append(torch.stack([
            (n_act / denom).expand(E, F),
            (agg / bw_ref[:, None]).expand(E, F),
            net / torch.clamp_min(agg, 1e-9),
        ], dim=-1))
    if spec.objectives:
        if objectives is None:
            objectives = _default_objectives_batch(E, F, tps.device)
        parts.append(objective_features(
            objectives, state.t, state.delivered, bw_ref=bw_ref,
            duration=params.duration))
    return torch.cat(parts, dim=-1)


def jain_index(x, active=None, weights=None):
    """Jain's fairness index over the last axis, active entries only:
    (sum x)^2 / (n * sum x^2) — 1.0 at an even split, 1/n when one flow
    hoards everything; empty or all-zero fleets score 1.0. ``weights``: the
    index is taken over x/w (fair = goodput proportional to priority)."""
    if weights is not None:
        x = x / weights
    if active is not None:
        x = x * active
        s, s2, n = flow_all_reduce(torch.stack([
            x.sum(dim=-1), (x * x).sum(dim=-1), active.sum(dim=-1)]))
        return _jain(s, s2, torch.clamp_min(n, 1.0))
    s, s2 = flow_all_reduce(torch.stack([x.sum(dim=-1), (x * x).sum(dim=-1)]))
    return _jain(s, s2, float(global_flows(x.shape[-1])))


def _jain(s, s2, n):
    """Jain's index from the flow sums of x and x^2 and the count n."""
    return torch.where(s2 > 0, s * s / (n * s2), torch.ones_like(s))


def _fleet_reward(params: SimParams, tps, threads, act,
                  objs: FlowObjective, delivered0, t, bw_ref,
                  fairness_coef, deadline_coef):
    """The shared fleet objective, (E,):

    reward = sum_f w_f * utility(t_f, n_f)
             - deadline_coef * sum_f w_f * miss_penalty_f
             + fairness_coef * Jain(goodput_f / w_f over active flows).

    The weighted utility is written base + correction, as the reference
    writes it, so the default objective adds exact zeros."""
    need = needed_rate(objs.demand, delivered0, objs.deadline, t[:, None],
                       min_horizon=params.duration)
    miss_on = (torch.isfinite(objs.deadline) & torch.isfinite(objs.demand)
               & (objs.demand > delivered0))
    penalty = torch.where(
        miss_on,
        deadline_penalty(tps[..., 2], need, scale=bw_ref[:, None]) * act,
        0.0)
    u = utility(tps, threads, k=params.k)                       # (E, F)
    fair = tps[..., 2] / objs.weight * act     # jain_index's x, one sum
    u_sum, wu_sum, pen_sum, s, s2, n_act = flow_all_reduce(torch.stack([
        u.sum(dim=-1), ((objs.weight - 1.0) * u).sum(dim=-1),
        (objs.weight * penalty).sum(dim=-1), fair.sum(dim=-1),
        (fair * fair).sum(dim=-1), act.sum(dim=-1)]))
    return (u_sum + wu_sum - deadline_coef * pen_sum
            + fairness_coef * _jain(s, s2, torch.clamp_min(n_act, 1.0)))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@flow_sharded(STATE_DIMS)
def fleet_reset(params: SimParams, n_envs: int, n_flows: int, t0=0.0, *,
                flows: FlowSchedule = None, table=None, substeps=50,
                objectives: FlowObjective = None, max_active: int = None,
                generator=None, threads=None):
    """Random initial threads per flow in [1, 16), empty buffers, one
    warm-up interval under contention for consistent observations.
    ``t0``: a scalar or (E,). ``threads``: optional (E, F, 3) in place of
    the draw from ``generator``. ``delivered`` starts at zero. In a flow
    scope ``n_flows`` is the whole fleet's: the threads are drawn at full F
    and the rank keeps its rows."""
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
    buffers, tps = fleet_interval(params, buffers, threads, t0, flows=flows,
                                  table=table, substeps=substeps,
                                  objectives=objectives,
                                  max_active=max_active)
    return FleetState(buffers=buffers, threads=threads, throughputs=tps,
                      t=t0 + params.duration, prev_throughputs=tps,
                      delivered=torch.zeros((n_envs, n_local),
                                            dtype=torch.float32,
                                            device=device))


@flow_sharded((STATE_DIMS, -2, None))
def fleet_step(params: SimParams, state: FleetState, actions, *,
               flows: FlowSchedule = None, table=None, substeps=50,
               spec: ObservationSpec = DEFAULT_OBS, fairness_coef=0.0,
               objectives: FlowObjective = None, deadline_coef=1.0,
               max_active: int = None):
    """actions (E, F, 3) raw continuous -> round (half to even) -> clamp
    [1, n_max], per flow. Returns (state', obs (E, F, frame_dim), reward
    (E,)). Inactive flows move nothing, score zero utility and are masked
    out of the Jain term."""
    E, F = state.threads.shape[:2]
    if flows is None:
        flows = _always_on_batch(E, F, state.threads.device)
    threads = torch.clamp(torch.round(actions), min=1.0)
    threads = torch.minimum(threads, params.n_max)
    tab = _table_or_params(params, table, E)
    bw_ref = peak_bw(tab)
    t_mid = state.t + 0.5 * params.duration
    sparse = max_active is not None and max_active < F
    if sparse:
        # ONE gather serves the solve and the reward: the reward's instant
        # (t + duration/2) lies inside the interval window
        (buffers, tps, idx, valid, c_tps, c_threads, c_flows,
         c_objs) = _sparse_fleet_interval(
            params, tab, state.buffers, threads, state.t, flows, substeps,
            objectives, max_active, return_compact=True)
    else:
        buffers, tps = fleet_interval(params, state.buffers, threads,
                                      state.t, flows=flows, table=tab,
                                      substeps=substeps,
                                      objectives=objectives)
    delivered0 = state.delivered
    new_state = FleetState(buffers=buffers, threads=threads, throughputs=tps,
                           t=state.t + params.duration,
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
                               c_delivered0, state.t, bw_ref,
                               fairness_coef, deadline_coef)
    else:
        objs = (_default_objectives_batch(E, F, tps.device)
                if objectives is None else objectives)
        reward = _fleet_reward(params, tps, threads, active_at(flows, t_mid),
                               objs, delivered0, state.t, bw_ref,
                               fairness_coef, deadline_coef)
    obs = fleet_observe(params, new_state, flows=flows, spec=spec,
                        objectives=objectives, bw_ref=bw_ref,
                        max_active=max_active)
    return new_state, obs, reward


@flow_sharded(None)
def fleet_achievable(params: SimParams, table, flows: FlowSchedule, t):
    """(E,) best aggregate end-to-end rate the ACTIVE fleet of each env
    could sustain at sim time ``t`` (E,): the slowest stage's scheduled
    cap, itself capped by what n_active * n_max threads can carry (0 when
    no flow is active)."""
    tab = _table_or_params(params, table, flows.t_start.shape[0])
    tpt, bw = schedule_at(tab, t)                               # (E, 3)
    n_act = flow_all_reduce(active_at(flows, t).sum(dim=-1,
                                                    keepdim=True))  # (E, 1)
    return torch.minimum(n_act * params.n_max * tpt, bw).amin(dim=-1)
