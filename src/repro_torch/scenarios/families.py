"""The scenario families (a copy of ``repro.scenarios.families``):
generators of time-varying condition tables.

Every family is a pure function of ``(ScenarioSpec-level knobs, seed)`` built
host-side with numpy (a schedule is built once, then replayed many times on
accelerator or against the live engine), returning ``(tpt[T,3], bw[T,3])``.
Determinism contract: the same arguments — including ``seed`` — produce
bit-identical tables (tested in tests/test_scenarios.py).

Condition families:

  static        frozen conditions (the control group)
  step          one step change of a stage's bandwidth at a chosen time
  diurnal       smooth day/night ramp of the network share, sampled into bins
  bursty        seeded on/off competing background traffic on the network
  square_wave   the bottleneck migrates read -> network -> write cyclically
  brownout      transient near-zero brown-outs of a random stage
  random_walk   seeded multiplicative random walk of every stage's bandwidth

FLOW-ARRIVAL families (the fleet layer) are a second axis: instead of moving
the conditions, they move the POPULATION — per-flow [t_start, t_end)
activity windows over the horizon, consumed as a
``repro_torch.core.fleet.FlowSchedule``. Same determinism contract; each
returns ``(t_start[F], t_end[F])`` with ``np.inf`` meaning "stays until the
end":

  always_on        every flow active for the whole run (F=1: single-flow)
  staggered_start  flow i joins at i * spacing (rolling user arrivals)
  poisson_arrivals seeded exponential inter-arrival gaps (flow 0 anchors
                   the run at t=0 so the fleet is never empty)
  flash_crowd      one long-running flow; the rest pile on together
                   mid-run and leave together (the Globus-endpoint rush)

TOPOLOGY families (the multi-link layer of the JAX package's
repro.core.topology, not ported yet) are a third axis: the WORLD
becomes a LinkGraph of E per-link tables plus a routing matrix.
Each returns ``(tpt[E,T,3], bw[E,T,3], onpath[2,F,E],
route_bin_seconds)`` — the canonical TWO route bins (static families
repeat the same route in both bins so batches of mixed families stack; the
lookup clips, so semantics are unchanged):

  regional_diurnal  every link runs the diurnal dip OUT OF PHASE (phase
                    2*pi*e/E — the day reaches each region hours apart);
                    flows traverse seeded contiguous runs of links
  link_failover     all flows start on the primary link; at ``at_frac`` it
                    collapses and the routes move to narrower standby
                    link(s) — the mid-transfer re-route regime
  cross_traffic     a series path (every flow crosses every link); seeded
                    bursts steal one link's capacity while the others get
                    headroom — the binding constraint MOVES between links
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fleet import _always_on_host as _core_always_on

R, N, W = 0, 1, 2


def _base(horizon, bin_seconds, base_tpt, base_bw):
    T = max(int(round(horizon / bin_seconds)), 1)
    tpt = np.tile(np.asarray(base_tpt, np.float32), (T, 1))
    bw = np.tile(np.asarray(base_bw, np.float32), (T, 1))
    return T, tpt, bw


def _scale(tpt, bw, rows, stage, factor, mode):
    """Degrade (or boost) a stage over ``rows``. ``mode`` picks WHAT moves:

      "tpt"   per-thread rate only (competing flows shrink each stream's
              share; the aggregate cap stands) — the optimal thread count
              n* = bw/tpt RISES, so a frozen allocation underutilizes and
              adaptation actually pays. The default for most families.
      "bw"    aggregate cap only (admin cap / link reroute) — n* falls;
              holding stale extra threads burns the k^-n utility penalty.
      "both"  capacity collapse (brown-out, dead disk): both move together.
    """
    if mode in ("tpt", "both"):
        tpt[rows, stage] *= factor
    if mode in ("bw", "both"):
        bw[rows, stage] *= factor


def static(horizon, bin_seconds, base_tpt, base_bw, seed=0):
    _, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    return tpt, bw


def step(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
         stage=N, at_frac=0.5, factor=0.4, mode="tpt"):
    """Stage ``stage`` degrades (or recovers) by ``factor`` at ``at_frac`` of
    the horizon and stays there. Default mode="tpt": a competing transfer
    lands on the shared resource and per-stream share collapses — the agent
    must RAISE that stage's concurrency to win its share back."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    cut = min(int(round(at_frac * T)), T - 1)
    _scale(tpt, bw, slice(cut, T), stage, factor, mode)
    return tpt, bw


def diurnal(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
            period_frac=1.0, depth=0.5, phase=0.0, mode="tpt"):
    """Per-stream network share ramps down and back up once per ``period``
    (a scaled-down day of background load): share = base * (1 - depth *
    (1 - cos)/2)."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    period = max(period_frac * horizon, bin_seconds)
    t = (np.arange(T) + 0.5) * bin_seconds
    dip = depth * 0.5 * (1.0 - np.cos(2 * np.pi * t / period + phase))
    scale = (1.0 - dip).astype(np.float32)
    for i in range(T):
        _scale(tpt, bw, i, N, scale[i], mode)
    return tpt, bw


def bursty(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
           burst_prob=0.25, load=0.6, mean_len=3, mode="tpt"):
    """Competing background traffic: seeded on/off bursts steal ``load`` of
    each stream's network share; burst lengths are geometric with
    ``mean_len`` bins. More parallel streams reclaim share during a burst —
    exactly why these tools use parallelism."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    rng = np.random.default_rng(seed)
    on = False
    for i in range(T):
        if on:
            on = rng.random() >= 1.0 / max(mean_len, 1)
        else:
            on = rng.random() < burst_prob
        if on:
            _scale(tpt, bw, i, N, 1.0 - load, mode)
    return tpt, bw


def square_wave(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
                period_bins=10, factor=0.35, mode="tpt"):
    """Bottleneck migration: the degraded stage cycles read -> network ->
    write every ``period_bins`` bins (the paper's three Fig. 5 scenarios,
    concatenated in time — each phase wants a different allocation)."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    for i in range(T):
        stage = (i // max(period_bins, 1)) % 3
        _scale(tpt, bw, i, stage, factor, mode)
    return tpt, bw


def brownout(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
             n_events=2, duration_bins=2, floor=0.08, mode="both"):
    """Transient stage brown-outs: ``n_events`` seeded windows where one
    random stage collapses to ``floor`` of its capacity (storage contention,
    failing NIC, GC pause ... pick your outage). Capacity collapse hits both
    the per-thread rate and the aggregate cap."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    rng = np.random.default_rng(seed)
    for _ in range(n_events):
        stage = int(rng.integers(0, 3))
        start = int(rng.integers(0, max(T - duration_bins, 1)))
        _scale(tpt, bw, slice(start, start + duration_bins), stage, floor,
               mode)
    return tpt, bw


def random_walk(horizon, bin_seconds, base_tpt, base_bw, seed=0, *,
                sigma=0.12, lo=0.25, hi=1.0, mode="tpt"):
    """Seeded multiplicative random walk of every stage's per-thread share,
    clipped to [lo, hi] x base — the 'weather' family for domain
    randomization."""
    T, tpt, bw = _base(horizon, bin_seconds, base_tpt, base_bw)
    rng = np.random.default_rng(seed)
    scale = np.ones(3, np.float32)
    for i in range(T):
        scale = np.clip(scale * np.exp(rng.normal(0.0, sigma, size=3)),
                        lo, hi).astype(np.float32)
        for stage in range(3):
            _scale(tpt, bw, i, stage, scale[stage], mode)
    return tpt, bw


FAMILIES = {
    "static": static,
    "step": step,
    "diurnal": diurnal,
    "bursty": bursty,
    "square_wave": square_wave,
    "brownout": brownout,
    "random_walk": random_walk,
}


# ---------------------------------------------------------------------------
# Flow-arrival families (the fleet layer): when do flows join and leave?
# ---------------------------------------------------------------------------

def always_on(n_flows, horizon, seed=0):
    """All flows run start to finish (F=1 is the single-flow world) — the
    family-contract wrapper over ``repro_torch.core.fleet.always_on`` (ONE
    definition of "always active")."""
    sched = _core_always_on(n_flows)
    return (np.asarray(sched.t_start, np.float32),
            np.asarray(sched.t_end, np.float32))


def staggered_start(n_flows, horizon, seed=0, *, spacing_frac=0.15,
                    hold_frac=None):
    """Flow i joins at ``i * spacing_frac * horizon`` and stays (or holds for
    ``hold_frac * horizon`` when given) — the rolling-arrival regime where
    the early flow must first fill the link alone, then yield share. Late
    flows are clipped to 0.9*horizon (same guard as poisson_arrivals) so a
    large fleet never schedules permanently-inactive flows."""
    t_start = np.minimum(np.arange(n_flows) * spacing_frac * horizon,
                         0.9 * horizon).astype(np.float32)
    if hold_frac is None:
        t_end = np.full(n_flows, np.inf, np.float32)
    else:
        t_end = (t_start + hold_frac * horizon).astype(np.float32)
    return t_start, t_end


def poisson_arrivals(n_flows, horizon, seed=0, *, rate=None, hold_frac=None):
    """Seeded Poisson process: exponential inter-arrival gaps at ``rate``
    flows/second (default: the fleet arrives over ~the first 60% of the
    horizon). Flow 0 anchors the run at t=0 so the bottleneck always has at
    least one customer; late stragglers are clipped into the horizon."""
    if n_flows == 0:  # an empty fleet is a valid (if quiet) arrival plan
        return (np.zeros(0, np.float32), np.zeros(0, np.float32))
    rng = np.random.default_rng(seed)
    rate = rate if rate is not None else n_flows / max(0.6 * horizon, 1e-9)
    gaps = rng.exponential(1.0 / rate, size=n_flows)
    t_start = np.cumsum(gaps) - gaps[0]  # flow 0 at t=0
    t_start = np.minimum(t_start, 0.9 * horizon).astype(np.float32)
    if hold_frac is None:
        t_end = np.full(n_flows, np.inf, np.float32)
    else:
        t_end = (t_start + hold_frac * horizon).astype(np.float32)
    return t_start, t_end


def flash_crowd(n_flows, horizon, seed=0, *, at_frac=0.4, leave_frac=0.85):
    """One long-running flow; at ``at_frac`` of the horizon the remaining
    F-1 flows all pile on AT ONCE, then leave together at ``leave_frac`` —
    the shared-endpoint rush hour the Globus service reports."""
    t_start = np.full(n_flows, at_frac * horizon, np.float32)
    t_end = np.full(n_flows, leave_frac * horizon, np.float32)
    if n_flows:  # the anchor flow only exists in a non-empty fleet
        t_start[0] = 0.0
        t_end[0] = np.inf
    return t_start, t_end


ARRIVAL_FAMILIES = {
    "always_on": always_on,
    "staggered_start": staggered_start,
    "poisson_arrivals": poisson_arrivals,
    "flash_crowd": flash_crowd,
}


# ---------------------------------------------------------------------------
# Topology families (the multi-link layer): per-link schedules + routes
# ---------------------------------------------------------------------------

def _static_routes(onpath):
    """Repeat a static (F, E) route in both canonical route bins."""
    return np.stack([onpath, onpath]).astype(np.float32)


def regional_diurnal(n_links, n_flows, horizon, bin_seconds, base_tpt,
                     base_bw, seed=0, *, depth=0.6, period_frac=1.0,
                     path_len=2, mode="tpt"):
    """E regional links, each running the ``diurnal`` dip OUT OF PHASE
    (phase 2*pi*e/E): the day reaches each region hours apart, so a path's
    binding link rotates around the graph. Each flow traverses a seeded
    contiguous run of ``path_len`` links (routes are static — both route
    bins identical)."""
    rng = np.random.default_rng(seed)
    tables = [diurnal(horizon, bin_seconds, base_tpt, base_bw,
                      depth=depth, period_frac=period_frac,
                      phase=2 * np.pi * e / n_links, mode=mode)
              for e in range(n_links)]
    tpt = np.stack([t for t, _ in tables])
    bw = np.stack([b for _, b in tables])
    L = min(max(int(path_len), 1), n_links)
    onpath = np.zeros((n_flows, n_links), np.float32)
    for f in range(n_flows):
        e0 = int(rng.integers(0, n_links - L + 1))
        onpath[f, e0:e0 + L] = 1.0
    return tpt, bw, _static_routes(onpath), horizon / 2.0


def link_failover(n_links, n_flows, horizon, bin_seconds, base_tpt,
                  base_bw, seed=0, *, at_frac=0.5, degrade=0.05,
                  backup_factor=0.45):
    """All flows start on the wide primary (link 0); at ``at_frac`` of the
    horizon the primary collapses to ``degrade`` of its capacity and the
    routes MOVE to the standby link(s) — each only ``backup_factor`` as
    wide, so the fleet must re-split a much narrower pool mid-transfer.
    Route bin 0 is the primary path, bin 1 the failover assignment
    (round-robin over the standbys); ``route_bin_seconds`` is the failure
    time. n_links=1 degenerates to a collapse with nowhere to go (both
    route bins stay on link 0)."""
    T, tpt0, bw0 = _base(horizon, bin_seconds, base_tpt, base_bw)
    cut = min(int(round(at_frac * T)), T - 1)
    tpt = np.stack([tpt0.copy() for _ in range(n_links)])
    bw = np.stack([bw0.copy() for _ in range(n_links)])
    # the primary collapses at the cut (capacity loss: everything moves)
    _scale(tpt[0], bw[0], slice(cut, T), slice(None), degrade, "both")
    for e in range(1, n_links):  # standbys: narrower, but steady
        _scale(tpt[e], bw[e], slice(0, T), slice(None), backup_factor,
               "both")
    primary = np.zeros((n_flows, n_links), np.float32)
    backup = np.zeros((n_flows, n_links), np.float32)
    if n_flows:
        primary[:, 0] = 1.0
        if n_links > 1:
            backup[np.arange(n_flows), 1 + np.arange(n_flows)
                   % (n_links - 1)] = 1.0
        else:
            backup[:, 0] = 1.0
    routes = np.stack([primary, backup]).astype(np.float32)
    return tpt, bw, routes, at_frac * horizon


def cross_traffic(n_links, n_flows, horizon, bin_seconds, base_tpt,
                  base_bw, seed=0, *, load=0.6, burst_prob=0.25,
                  mean_len=3, headroom=1.25, mode="tpt"):
    """A SERIES path: every flow traverses every link (source site ->
    WAN -> destination site). One seeded link carries ``bursty`` cross
    traffic stealing ``load`` of its capacity; the other links get
    ``headroom`` extra so the binding constraint MOVES onto the congested
    segment during bursts and off it between them. Routes are static all
    ones (both route bins identical)."""
    rng = np.random.default_rng(seed)
    target = int(rng.integers(0, n_links))
    T = max(int(round(horizon / bin_seconds)), 1)
    tpt, bw = [], []
    for e in range(n_links):
        if e == target:
            t_e, b_e = bursty(horizon, bin_seconds, base_tpt, base_bw,
                              seed=seed + 1, burst_prob=burst_prob,
                              load=load, mean_len=mean_len, mode=mode)
        else:
            _, t_e, b_e = _base(horizon, bin_seconds, base_tpt, base_bw)
            _scale(t_e, b_e, slice(0, T), slice(None), headroom, "both")
        tpt.append(t_e)
        bw.append(b_e)
    onpath = np.ones((n_flows, n_links), np.float32)
    return (np.stack(tpt), np.stack(bw), _static_routes(onpath),
            horizon / 2.0)


TOPOLOGY_FAMILIES = {
    "regional_diurnal": regional_diurnal,
    "link_failover": link_failover,
    "cross_traffic": cross_traffic,
}
