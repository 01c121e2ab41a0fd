"""Evaluation harness: score controllers on dynamic scenarios (port of
``repro.scenarios.evaluate``).

SINGLE FLOW (``run_in_dynamic_sim``, ``evaluate_scenario``): any controller
(AutoMDTController, MarlinOptimizer, GlobusController, or the
exploration-only StaticController) through the schedule-aware dense
simulator (one env, E=1: one sim_step launch per step on the card), scored
per scenario on

  convergence_steps   first step at >= ``frac`` of the instantaneous
                      achievable bottleneck (None if never reached)
  utilization         mean delivered / achievable over the run
  mean_utility        mean per-step utility reward (the PPO objective)
  completion_s        steps to deliver ``total_gbit`` (None if unfinished)

against the two frozen-world baselines: ``static_baseline`` (Globus-style
fixed configuration) and ``exploration_baseline`` (probe the schedule's
opening conditions once, hold n* forever).

FLEET (``run_fleet_in_dynamic_sim``): F contending flows through
``repro_torch.core.fleet`` (E=1) under the scenario's condition table and
an arrival schedule. The actor is a shared ``FleetPolicy`` (it sees the
whole fleet observation matrix) or a list of F independent controllers
(Globus, Marlin, AutoMDT, each blind to the others). Scored on aggregate
utilization — total delivered over the integral of the fleet-aware
achievable bottleneck — and the time-mean Jain index over steps where
flows contend. Each sim step is one contention launch and one sim_step
launch on the card.

TOPOLOGY (``run_topology_in_dynamic_sim``): the same over a multi-link
``TopologySpec`` through ``repro_torch.core.topology``: utilization over
the integrated path-aware achievable (one more contention launch per
step), Jain, and on ``link_failover`` the recovery time after the
failure.

Initial threads come from a ``torch.Generator`` seeded with ``seed`` on
the params' device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core import GlobusController, explore
from repro_torch.core.controller import AutoMDTController, FleetPolicy
from repro_torch.core.fleet import (FlowSchedule, FlowObjective, jain_index,
                                    fleet_reset, fleet_step, fleet_observe,
                                    fleet_achievable, _map_schedule)
from repro_torch.core.simulator import (SimParams, make_env_params,
                                        env_reset, env_step, SimEnv)
from repro_torch.core.topology import (topology_reset, topology_step,
                                       topology_observe, topology_achievable,
                                       _batched_topology)
from repro_torch.device import as_f32
from repro_torch.scenarios.schedule import ScheduleTable, bottleneck_trace


class StaticController:
    """Exploration-only baseline: holds one fixed allocation forever."""

    def __init__(self, n3):
        self.n = np.asarray(n3, dtype=int)

    def update(self, throughputs):
        return self.n.copy()


def default_params(spec, *, n_max=50, cap=2.0, device=None) -> SimParams:
    """SimParams for a spec on ``device`` (None: the CUDA device): the
    static tpt/bw fields hold the BASE conditions (only cap/n_max/duration/
    k matter on the scheduled path)."""
    return make_env_params(tpt=list(spec.base_tpt), bw=list(spec.base_bw),
                           cap=[cap, cap], n_max=n_max, device=device)


def exploration_baseline(spec, params, *, n_samples=120, seed=0):
    """Probe the scenario's OPENING conditions (explore once before the
    transfer, trust the numbers forever), then never adapt. The probe world
    is the schedule's first bin held constant, a ``SimEnv`` on the params'
    device."""
    table = spec.table(device=params.tpt.device)
    opening = ScheduleTable(tpt=table.tpt[:1], bw=table.bw[:1],
                            bin_seconds=table.bin_seconds)
    env = SimEnv(params, opening, seed=seed)
    env.reset()
    ex = explore(env.probe, n_samples=n_samples,
                 n_max=int(params.n_max), seed=seed)
    return StaticController(ex.n_star_int()), ex


def static_baseline(**kw):
    return GlobusController(**kw)


@dataclass
class EvalResult:
    scenario: str
    controller: str
    convergence_steps: int | None
    utilization: float
    mean_utility: float
    delivered: float          # Gbit
    completion_s: float | None  # simulated seconds
    threads: np.ndarray = field(repr=False)
    tput: np.ndarray = field(repr=False)


def _obs_dict(cap, st):
    """The engine observe()-dict contract from one flow's (threads,
    throughputs, buffers) slice, NumPy on the host; ``cap`` (2,)."""
    return {"threads": list(st.threads),
            "throughputs": list(st.throughputs),
            "sender_free": float(cap[0] - st.buffers[0]),
            "receiver_free": float(cap[1] - st.buffers[1]),
            "sender_capacity": float(cap[0]),
            "receiver_capacity": float(cap[1])}


def _host_env(st, e=0):
    """Env ``e``'s slice of a batched state, on the host."""
    return type(st)(*(x[e].cpu().numpy() for x in st))


def _act(controller, o):
    """One per-flow controller's action on an observe() dict."""
    if isinstance(controller, AutoMDTController):
        return controller.step(o)
    return controller.update(o["throughputs"])


def run_in_dynamic_sim(spec, params, controller, *, steps=None, seed=7,
                       total_gbit=None, frac=0.95, label=None):
    """One controller through one scenario (1 env step = ``params.duration``
    simulated seconds) on the params' device. ``steps`` defaults to the
    scenario horizon; delivered/completion are in Gbit and simulated
    seconds."""
    device = params.tpt.device
    table = spec.table(device=device)
    batch = ScheduleTable(tpt=table.tpt[None], bw=table.bw[None],
                          bin_seconds=table.bin_seconds.reshape(1))
    duration = float(params.duration)
    steps = steps or int(round(spec.horizon / duration))
    achievable = bottleneck_trace(table, float(params.n_max)).cpu().numpy()
    bin_s = float(table.bin_seconds)
    cap = params.cap.cpu().numpy()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = env_reset(params, 1, table=batch, generator=gen)
    if hasattr(controller, "reset"):
        controller.reset()  # fresh context deltas for every scenario run
    threads_hist, tput_hist, util_hist, ach_hist = [], [], [], []
    delivered = 0.0
    completion = None
    host = _host_env(st)
    for i in range(steps):
        n = _act(controller, _obs_dict(cap, host))
        st, _, r = env_step(params, st,
                            as_f32(np.asarray(n, float), device)[None],
                            table=batch)
        host = _host_env(st)
        t_mid = float(host.t) - 0.5 * duration
        idx = min(max(int(t_mid / bin_s), 0), len(achievable) - 1)
        threads_hist.append(host.threads.tolist())
        tput_hist.append(float(host.throughputs[2]))
        util_hist.append(float(r[0]))
        ach_hist.append(float(achievable[idx]))
        delivered += tput_hist[-1] * duration  # Gbit/s over duration s
        if (total_gbit is not None and completion is None
                and delivered >= total_gbit):
            completion = (i + 1) * duration  # sim seconds; keep running:
            # utilization and convergence are scored over the full horizon
    tput = np.asarray(tput_hist)
    ach = np.maximum(np.asarray(ach_hist), 1e-9)
    hits = np.nonzero(tput >= frac * ach)[0]
    return EvalResult(
        scenario=spec.name,
        controller=label or type(controller).__name__,
        convergence_steps=int(hits[0]) + 1 if len(hits) else None,
        utilization=float(np.mean(np.minimum(tput / ach, 1.0))),
        mean_utility=float(np.mean(util_hist)),
        delivered=delivered,
        completion_s=completion,
        threads=np.asarray(threads_hist),
        tput=tput,
    )


def evaluate_scenario(spec, agent_controller, *, params=None, steps=None,
                      seed=7, total_gbit=None, device=None):
    """Agent vs the two frozen-world baselines on one scenario. Returns
    {label: EvalResult}. ``params`` default to ``default_params(spec)`` on
    ``device``."""
    params = params or default_params(spec, device=device)
    expl_ctrl, _ = exploration_baseline(spec, params, seed=seed)
    runs = {
        "automdt": agent_controller,
        "static": static_baseline(),
        "exploration_only": expl_ctrl,
    }
    return {label: run_in_dynamic_sim(spec, params, ctrl, steps=steps,
                                      seed=seed, total_gbit=total_gbit,
                                      label=label)
            for label, ctrl in runs.items()}


@dataclass
class FleetEvalResult:
    scenario: str
    arrival: str
    controller: str
    utilization: float   # total delivered / integrated achievable bottleneck
    jain: float          # time-mean (weighted) Jain index over contended steps
    delivered: float     # Gbit, summed over flows
    mean_active: float   # mean number of active flows per step
    goodput: np.ndarray = field(repr=False)   # (steps, F) per-flow write tps
    threads: np.ndarray = field(repr=False)   # (steps, F, 3)
    # objective scoring (all trivial when no flow carries an objective):
    deadline_hits: int = 0        # deadline flows whose demand landed on time
    deadline_total: int = 0       # flows carrying a finite deadline+demand
    deadline_hit_rate: float = 1.0   # hits/total (1.0 when no deadlines)
    weighted_utilization: float = 0.0  # sum w_f*delivered_f / (mean_w * ach)


def _obs_dict(cap, st):
    """The engine observe()-dict contract from one flow's (threads,
    throughputs, buffers) slice, NumPy on the host; ``cap`` (2,)."""
    return {"threads": list(st.threads),
            "throughputs": list(st.throughputs),
            "sender_free": float(cap[0] - st.buffers[0]),
            "receiver_free": float(cap[1] - st.buffers[1]),
            "sender_capacity": float(cap[0]),
            "receiver_capacity": float(cap[1])}


def _flow_obs_dict(cap, st, f):
    """Flow ``f``'s slice of a host copy of one env's FleetState (leaves
    (F, ...)) through ``_obs_dict``."""
    return _obs_dict(cap, SimpleNamespace(threads=st.threads[f],
                                          throughputs=st.throughputs[f],
                                          buffers=st.buffers[f]))


def run_fleet_in_dynamic_sim(spec, flows: FlowSchedule, params, actor, *,
                             steps=None, seed=7, label=None,
                             arrival="always_on",
                             objectives: FlowObjective = None,
                             apply_floors=True):
    """F flows through one scenario under one arrival schedule ``flows``
    (F,). ``actor`` is a shared actor — a ``FleetPolicy`` or a wrapper
    around one such as ``core.online.OnlineFleetPolicy`` — or a list of F
    per-flow controllers (``.step(obs_dict)`` or ``.update(throughputs)``).
    A shared actor with ``observe_outcome`` is fed each step's
    throughputs, threads and activity mask (the online-adaptation hook).
    The initial threads are drawn from a ``torch.Generator`` seeded with
    ``seed`` on the params' device.

    ``objectives``: optional per-flow FlowObjective (F,). Scoring then also
    reports deadline hits, the hit rate, the priority-weighted utilization
    and a priority-weighted Jain index. ``apply_floors`` (default): the
    contention model enforces the objectives' floors/caps;
    ``apply_floors=False`` scores an objective-blind world against the
    same objectives."""
    device = params.tpt.device
    table = spec.table(device=device)
    table = ScheduleTable(tpt=table.tpt[None], bw=table.bw[None],
                          bin_seconds=table.bin_seconds.reshape(1))
    n_flows = flows.n_flows
    duration = float(params.duration)
    steps = steps or int(round(spec.horizon / duration))
    t_start = flows.t_start.cpu().numpy()
    t_end = flows.t_end.cpu().numpy()
    batch = _map_schedule(lambda x: as_f32(x, device)[None], flows)
    objs = (None if objectives is None else
            FlowObjective(*(as_f32(x, device)[None] for x in objectives)))
    world_obj = objs if apply_floors else None
    weights = (objectives.weight.cpu().numpy() if objectives is not None
               else np.ones(n_flows))
    jain_w = (None if objectives is None
              else torch.as_tensor(weights, dtype=torch.float32))
    cap = params.cap.cpu().numpy()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = fleet_reset(params, 1, n_flows, flows=batch, table=table,
                     objectives=world_obj, generator=gen)
    shared = not isinstance(actor, (list, tuple))
    if shared:
        actor.reset()
    else:
        for c in actor:
            if hasattr(c, "reset"):
                c.reset()
    goodput, threads_hist, jains, achs = [], [], [], []
    n_active_hist = []
    for _ in range(steps):
        if shared:
            obs = fleet_observe(params, st, flows=batch, table=table,
                                spec=actor.obs_spec._replace(history=1),
                                objectives=objs)
            acts = actor.act(obs[0].cpu().numpy())
        else:
            host = _host_env(st)
            acts = [_act(ctrl, _flow_obs_dict(cap, host, f))
                    for f, ctrl in enumerate(actor)]
        st, _, _ = fleet_step(params, st,
                              as_f32(np.asarray(acts, float), device)[None],
                              flows=batch, table=table,
                              objectives=world_obj)
        t_mid = float(st.t[0]) - 0.5 * duration
        # the activity windows only, as the reference reads them: a flow
        # inside a down window still counts as active here (ROADMAP R5)
        active = ((t_mid >= t_start) & (t_mid < t_end)).astype(np.float32)
        if shared and hasattr(actor, "observe_outcome"):
            # the reward an action realized lives in the post-step state;
            # the reference hands the hook a float64 mask
            actor.observe_outcome(st.throughputs[0].cpu().numpy(),
                                  st.threads[0].cpu().numpy(),
                                  active.astype(float))
        g = st.throughputs[0, :, 2].cpu().numpy()
        goodput.append(g)
        threads_hist.append(st.threads[0].cpu().numpy())
        achs.append(float(fleet_achievable(params, table, batch,
                                           as_f32([t_mid], device))[0]))
        n_active_hist.append(active.sum())
        if active.sum() >= 2:
            jains.append(float(jain_index(torch.from_numpy(g),
                                          torch.from_numpy(active),
                                          weights=jain_w)))
    goodput = np.asarray(goodput)
    delivered = float(goodput.sum() * duration)
    achievable = float(np.sum(achs) * duration)
    per_flow = goodput.sum(axis=0) * duration                   # (F,) Gbit
    hits, total = _deadline_hits(goodput, objectives, duration)
    w_util = float((weights * per_flow).sum()
                   / max(weights.mean() * achievable, 1e-9))
    return FleetEvalResult(
        scenario=spec.name,
        arrival=arrival,
        controller=label or (type(actor).__name__ if shared
                             else type(actor[0]).__name__),
        utilization=min(delivered / max(achievable, 1e-9), 1.0),
        jain=float(np.mean(jains)) if jains else 1.0,
        delivered=delivered,
        mean_active=float(np.mean(n_active_hist)),
        goodput=goodput,
        threads=np.asarray(threads_hist),
        deadline_hits=hits,
        deadline_total=total,
        deadline_hit_rate=hits / total if total else 1.0,
        weighted_utilization=min(w_util, 1.0),
    )


def _deadline_hits(goodput, objectives: FlowObjective, duration):
    """(hits, total) over the flows carrying a finite deadline+demand: a hit
    is the flow's cumulative goodput reaching its demand by the last step
    that ENDS on or before the deadline. Recorded row ``j`` covers sim time
    ``[(j+1)*duration, (j+2)*duration)`` (the reset warm-up advances the
    clock one interval first), so the rows counted toward deadline ``D``
    are the first ``floor(D/duration) - 1``. A deadline past the evaluated
    window is neither a hit nor a miss."""
    if objectives is None:
        return 0, 0
    deadline = objectives.deadline.cpu().numpy()
    demand = objectives.demand.cpu().numpy()
    cum = np.cumsum(goodput, axis=0) * duration   # (steps, F)
    hits = total = 0
    for f in range(goodput.shape[1]):
        if not (np.isfinite(deadline[f]) and np.isfinite(demand[f])):
            continue
        k = int(deadline[f] / duration) - 1
        if k > cum.shape[0]:
            continue
        total += 1
        if k > 0 and cum[k - 1, f] >= demand[f] - 1e-6:
            hits += 1
    return hits, total


@dataclass
class TopologyEvalResult:
    scenario: str
    controller: str
    utilization: float   # total delivered / integrated achievable over paths
    jain: float          # time-mean Jain index over contended steps
    delivered: float     # Gbit, summed over flows
    mean_active: float   # mean number of active flows per step
    recovery_s: float | None  # link_failover: sim-seconds from the failure
    #                           to the fleet re-reaching recovery_frac of
    #                           achievable (None: never / not a failover)
    goodput: np.ndarray = field(repr=False)   # (steps, F) per-flow write tps
    threads: np.ndarray = field(repr=False)   # (steps, F, 3)


def run_topology_in_dynamic_sim(tspec, flows: FlowSchedule, params, actor, *,
                                steps=None, seed=7, label=None,
                                objectives: FlowObjective = None,
                                recovery_frac=0.7):
    """F flows over a multi-link TopologySpec, on the params' device.
    ``actor`` is a shared ``FleetPolicy`` (fed ``topology_observe``
    matrices under its own spec: a topology-blind FLEET_OBS policy never
    sees the topology dims) or a list of F independent per-flow
    controllers. Utilization is total delivered over the integrated
    path-aware achievable; Jain averages over steps where >= 2 flows are
    active. On ``link_failover``, ``recovery_s`` is how long after the
    failure the fleet takes to climb back to ``recovery_frac`` of the
    post-failure achievable rate."""
    device = params.tpt.device
    graph, paths = _batched_topology(tspec.topology(device=device))
    n_flows = flows.n_flows
    duration = float(params.duration)
    steps = steps or int(round(tspec.horizon / duration))
    t_start = flows.t_start.cpu().numpy()
    t_end = flows.t_end.cpu().numpy()
    t_fail = (float(paths.bin_seconds[0])
              if tspec.family == "link_failover" else None)
    batch = _map_schedule(lambda x: as_f32(x, device)[None], flows)
    objs = (None if objectives is None else
            FlowObjective(*(as_f32(x, device)[None] for x in objectives)))
    world = dict(flows=batch, graph=graph, paths=paths, objectives=objs)
    cap = params.cap.cpu().numpy()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = topology_reset(params, 1, n_flows, generator=gen, **world)
    shared = isinstance(actor, FleetPolicy)
    for c in [actor] if shared else actor:
        if hasattr(c, "reset"):
            c.reset()
    goodput, threads_hist, jains, achs = [], [], [], []
    n_active_hist = []
    recovery = None
    for _ in range(steps):
        if shared:
            obs = topology_observe(params, st,
                                   spec=actor.obs_spec._replace(history=1),
                                   **world)
            acts = actor.act(obs[0].cpu().numpy())
        else:
            host = _host_env(st)
            acts = [_act(ctrl, _flow_obs_dict(cap, host, f))
                    for f, ctrl in enumerate(actor)]
        st, _, _ = topology_step(params, st,
                                 as_f32(np.asarray(acts, float), device)[None],
                                 **world)
        t_mid = float(st.t[0]) - 0.5 * duration
        active = ((t_mid >= t_start) & (t_mid < t_end)).astype(np.float32)
        g = st.throughputs[0, :, 2].cpu().numpy()
        ach = float(topology_achievable(params, graph, paths, batch,
                                        as_f32([t_mid], device),
                                        objectives=objs)[0])
        goodput.append(g)
        threads_hist.append(st.threads[0].cpu().numpy())
        achs.append(ach)
        n_active_hist.append(active.sum())
        if active.sum() >= 2:
            jains.append(float(jain_index(torch.from_numpy(g),
                                          torch.from_numpy(active))))
        if (t_fail is not None and recovery is None and t_mid >= t_fail
                and g.sum() >= recovery_frac * max(ach, 1e-9)):
            recovery = t_mid + 0.5 * duration - t_fail
    goodput = np.asarray(goodput)
    delivered = float(goodput.sum() * duration)
    achievable = float(np.sum(achs) * duration)
    return TopologyEvalResult(
        scenario=tspec.name,
        controller=label or (type(actor).__name__ if shared
                             else type(actor[0]).__name__),
        utilization=min(delivered / max(achievable, 1e-9), 1.0),
        jain=float(np.mean(jains)) if jains else 1.0,
        delivered=delivered,
        mean_active=float(np.mean(n_active_hist)),
        recovery_s=recovery,
        goodput=goodput,
        threads=np.asarray(threads_hist),
    )
