"""Fleet evaluation: score a shared fleet policy, or F independent per-flow
controllers, on one scenario under one flow-arrival schedule (port of the
fleet half of ``repro.scenarios.evaluate``).

F contending flows run through ``repro_torch.core.fleet`` (one env, E=1)
under the scenario's condition table and the arrival schedule. The actor
is a shared ``FleetPolicy`` (it sees the whole fleet observation matrix)
or a list of F independent controllers (Globus, Marlin, AutoMDT, each
blind to the others). Scored on aggregate utilization — total delivered
over the integral of the fleet-aware achievable bottleneck — and the
time-mean Jain index over steps where flows contend. Each sim step is one
contention launch and one sim_step launch on the card.

The single-flow harness (``run_in_dynamic_sim``, the exploration-only
baseline) and the topology scorer are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.controller import AutoMDTController
from repro_torch.core.fleet import (FlowSchedule, FlowObjective, jain_index,
                                    fleet_reset, fleet_step, fleet_observe,
                                    fleet_achievable)
from repro_torch.device import as_f32
from repro_torch.scenarios.schedule import ScheduleTable


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
    (F,). ``actor`` is a shared ``FleetPolicy`` or a list of F per-flow
    controllers (``.step(obs_dict)`` or ``.update(throughputs)``). The
    initial threads are drawn from a ``torch.Generator`` seeded with
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
    batch = FlowSchedule(*(as_f32(x, device)[None] for x in flows))
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
            host = SimpleNamespace(
                threads=st.threads[0].cpu().numpy(),
                throughputs=st.throughputs[0].cpu().numpy(),
                buffers=st.buffers[0].cpu().numpy())
            acts = []
            for f, ctrl in enumerate(actor):
                o = _flow_obs_dict(cap, host, f)
                if isinstance(ctrl, AutoMDTController):
                    acts.append(ctrl.step(o))
                else:
                    acts.append(ctrl.update(o["throughputs"]))
        st, _, _ = fleet_step(params, st,
                              as_f32(np.asarray(acts, float), device)[None],
                              flows=batch, table=table,
                              objectives=world_obj)
        t_mid = float(st.t[0]) - 0.5 * duration
        active = ((t_mid >= t_start) & (t_mid < t_end)).astype(np.float32)
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
