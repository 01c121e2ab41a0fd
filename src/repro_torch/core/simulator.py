"""The dense, schedule-native transfer simulator with the env batch written
out (port of ``repro.core.simulator``).

One simulated interval = ``substeps`` sub-intervals; in each, every stage
moves min(n_i * TPT_i * dt, B_i * dt, available bytes / free space) through
the two staging buffers in pipeline order (read -> network -> write). Where
the JAX package vmaps a per-env step, every function here takes a leading
env axis E: buffers (E, 2), threads (E, 3), clock t (E,), and a batched
``ScheduleTable`` (E, T, 3) or None for the params' static conditions. The
substep integration of the whole batch is ONE launch of the sim_step kernel
(``repro_torch.kernels.sim_step``; its plain version on CPU tensors).

Random draws come from ``torch.Generator``s on the device. Threefry cannot
be reproduced in torch, so ``env_reset`` and ``SimEnv`` also take the
initial thread counts as an explicit tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.schedule import ScheduleTable, constant_table, peak_bw
from repro_torch.core.utility import utility, K_DEFAULT
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.sim_step.ops import sim_interval_batch


class SimParams(NamedTuple):
    tpt: torch.Tensor       # (3,) per-thread throughput (bytes/s or Gbit/s)
    bw: torch.Tensor        # (3,) aggregate per-stage bandwidth cap
    cap: torch.Tensor       # (2,) sender/receiver staging buffer capacity
    n_max: torch.Tensor     # scalar, max threads per stage
    duration: torch.Tensor  # scalar, seconds simulated per env step
    k: torch.Tensor         # utility penalty base


def make_env_params(*, tpt, bw, cap, n_max=100, duration=1.0, k=K_DEFAULT,
                    device=None):
    device = resolve_device(device)
    return SimParams(tpt=as_f32(tpt, device), bw=as_f32(bw, device),
                     cap=as_f32(cap, device), n_max=as_f32(n_max, device),
                     duration=as_f32(duration, device),
                     k=as_f32(k, device))


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------

OBS_DIM = 8       # the paper's base observation (§IV-D-1)
CONTEXT_DIM = 5   # schedule context: 3 throughput deltas + 2 drain rates
FLEET_DIM = 3     # cross-flow: active fraction, aggregate util, my share
OBJ_DIM = 3       # per-flow objective: priority, deadline slack, urgency
TOPO_DIM = 3      # per-flow topology: bottleneck util, path length, share
ACT_DIM = 3


class ObservationSpec(NamedTuple):
    """What the agent sees (the reference's spec, field for field).

    context=False: the paper's 8 dims — thread counts, throughputs, and
    unused buffer fractions, normalized to [0, 1]. context=True adds 5 dims
    of schedule context: per-stage throughput deltas vs the previous step
    and the two buffers' normalized drain rates. history=K: the policy
    input is the last K frames stacked oldest-first (zero-padded at reset);
    ``observe`` always returns one frame. fleet/objectives/topology are the
    multi-flow extensions; single-flow ``observe`` never emits them."""

    context: bool = False
    history: int = 1
    fleet: bool = False
    objectives: bool = False
    topology: bool = False

    @property
    def frame_dim(self) -> int:
        return (OBS_DIM + (CONTEXT_DIM if self.context else 0)
                + (FLEET_DIM if self.fleet else 0)
                + (OBJ_DIM if self.objectives else 0)
                + (TOPO_DIM if self.topology else 0))

    @property
    def dim(self) -> int:
        return self.frame_dim * self.history


def HistorySpec(history: int = 4, *, context: bool = False) -> ObservationSpec:
    """Frame-stacking extension of ObservationSpec: the last ``history``
    observations concatenated oldest-first (default 4)."""
    return ObservationSpec(context=context, history=history)


DEFAULT_OBS = ObservationSpec()
CONTEXT_OBS = ObservationSpec(context=True)
FLEET_OBS = ObservationSpec(context=True, fleet=True)
OBJECTIVE_OBS = ObservationSpec(context=True, fleet=True, objectives=True)
TOPOLOGY_OBS = ObservationSpec(context=True, fleet=True, topology=True)


def history_init(spec: ObservationSpec, frame):
    """Fresh (..., K, frame_dim) history holding one real frame (newest =
    last row) and K-1 zero-padded slots; ``frame`` is (..., frame_dim)."""
    hist = frame.new_zeros(frame.shape[:-1] + (spec.history, frame.shape[-1]))
    hist[..., -1, :] = frame
    return hist


def history_push(hist, frame):
    """Shift the window one step: drop the oldest row, append ``frame``."""
    return torch.cat([hist[..., 1:, :], frame[..., None, :]], dim=-2)


def history_flatten(hist):
    """(..., K, frame_dim) -> (..., K*frame_dim) network input."""
    return hist.reshape(hist.shape[:-2] + (-1,))


class EnvState(NamedTuple):
    buffers: torch.Tensor           # (E, 2) sender/receiver occupancy
    threads: torch.Tensor           # (E, 3) current concurrency
    throughputs: torch.Tensor       # (E, 3) last measured throughput
    t: torch.Tensor                 # (E,) simulated seconds elapsed
    prev_throughputs: torch.Tensor  # (E, 3) previous step's throughputs


def _table_or_params(params: SimParams, table, n_envs: int) -> ScheduleTable:
    """The ONE place where static and scheduled worlds meet: no table means
    the params' frozen conditions as a 1-bin schedule, one per env."""
    if table is None:
        tab = constant_table(params.tpt, params.bw, params.duration)
        return ScheduleTable(tpt=tab.tpt.expand(n_envs, 1, 3),
                             bw=tab.bw.expand(n_envs, 1, 3),
                             bin_seconds=tab.bin_seconds.expand(n_envs))
    return table


def _substep_rates(params: SimParams, table: ScheduleTable, threads, t0,
                   substeps: int):
    """(E, substeps, 3) aggregate per-stage rates, one lookup per
    sub-interval. The same float32 ops in the same order as the reference
    (``ts = t0 + dt * arange``, then floor of ``ts / bin_seconds``), so a
    bin index cannot flip at an exact boundary."""
    dt = params.duration / substeps
    T = table.tpt.shape[1]
    steps = torch.arange(substeps, dtype=torch.float32, device=threads.device)
    ts = t0[:, None] + dt * steps                          # (E, S)
    idx = torch.clamp(torch.floor(ts / table.bin_seconds[:, None]), 0, T - 1)
    idx = idx.to(torch.int64)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return torch.minimum(threads[:, None, :] * table.tpt[rows, idx],
                         table.bw[rows, idx])


def sim_interval(params: SimParams, buffers, threads, t0, *, table=None,
                 substeps=50):
    """Simulate ``duration`` seconds from sim time ``t0`` (E,) for every env
    under ``table`` (None = the params' static conditions). Returns
    (buffers' (E, 2), throughputs (E, 3)). One kernel launch."""
    E = buffers.shape[0]
    tab = _table_or_params(params, table, E)
    dt = params.duration / substeps
    rates = _substep_rates(params, tab, threads, t0, substeps)
    cap = params.cap.expand(E, 2).contiguous()
    buffers, moved = sim_interval_batch(buffers.contiguous(),
                                        (rates * dt).contiguous(), cap)
    return buffers, moved / params.duration


def observe(params: SimParams, state: EnvState, *, table=None,
            spec: ObservationSpec = DEFAULT_OBS):
    """(E, spec.frame_dim) observation. Normalized by the schedule's PEAK
    bandwidth (static world: max(params.bw)) so the scale is stable while
    conditions move underneath the agent."""
    E = state.buffers.shape[0]
    bw_ref = peak_bw(_table_or_params(params, table, E))[:, None]   # (E, 1)
    free = (params.cap - state.buffers) / torch.clamp_min(params.cap, 1e-9)
    base = torch.cat([state.threads / params.n_max,
                      state.throughputs / bw_ref, free], dim=-1)    # (E, 8)
    if not spec.context:
        return base
    tps = state.throughputs
    delta = (tps - state.prev_throughputs) / bw_ref
    drain = torch.stack([
        (tps[:, 1] - tps[:, 0]) * params.duration
        / torch.clamp_min(params.cap[0], 1e-9),
        (tps[:, 2] - tps[:, 1]) * params.duration
        / torch.clamp_min(params.cap[1], 1e-9),
    ], dim=-1)
    return torch.cat([base, delta, drain], dim=-1)                  # (E, 13)


def env_reset(params: SimParams, n_envs: int, t0=0.0, *, table=None,
              substeps=50, generator=None, threads=None):
    """Random initial threads in [1, 16) (paper: each episode starts from a
    new random allocation), empty buffers, one warm-up interval for
    consistent observations. ``t0``: sim time the episodes start at, a
    scalar or (E,). ``threads``: optional (E, 3) initial threads in place
    of the draw from ``generator``."""
    device = params.tpt.device
    if threads is None:
        threads = torch.randint(1, 16, (n_envs, 3), generator=generator,
                                device=device)
    threads = threads.to(device=device, dtype=torch.float32)
    buffers = torch.zeros((n_envs, 2), dtype=torch.float32, device=device)
    t0 = as_f32(t0, device).expand(n_envs)
    buffers, tps = sim_interval(params, buffers, threads, t0, table=table,
                                substeps=substeps)
    return EnvState(buffers=buffers, threads=threads, throughputs=tps,
                    t=t0 + params.duration, prev_throughputs=tps)


def env_step(params: SimParams, state: EnvState, action, *, table=None,
             substeps=50, spec: ObservationSpec = DEFAULT_OBS):
    """action: (E, 3) raw continuous -> round (half to even) -> clamp to
    [1, n_max] (§IV-F). The sim clock advances by ``duration``.
    Returns (state', obs (E, frame_dim), reward (E,))."""
    threads = torch.clamp(torch.round(action), min=1.0)
    threads = torch.minimum(threads, params.n_max)
    buffers, tps = sim_interval(params, state.buffers, threads, state.t,
                                table=table, substeps=substeps)
    new_state = EnvState(buffers=buffers, threads=threads, throughputs=tps,
                         t=state.t + params.duration,
                         prev_throughputs=state.throughputs)
    reward = utility(tps, threads, k=params.k)
    return new_state, observe(params, new_state, table=table, spec=spec), \
        reward


class SimEnv:
    """Host-side wrapper of ONE env (the controller, benchmarks and
    exploration use it): the functional API at E=1. Pass ``table`` (T, 3)
    for a dynamic scenario — the clock keeps advancing across reset(), as a
    real engine's world does — or omit it for the static world."""

    def __init__(self, params: SimParams, table=None, *, substeps=50, seed=0,
                 spec: ObservationSpec = DEFAULT_OBS):
        self.params = params
        self.table = (None if table is None else ScheduleTable(
            tpt=table.tpt[None], bw=table.bw[None],
            bin_seconds=table.bin_seconds.reshape(1)))
        self.substeps = substeps
        self.spec = spec
        self._gen = torch.Generator(device=params.tpt.device)
        self._gen.manual_seed(seed)
        self.state = None

    def reset(self, threads=None):
        """New episode; ``threads`` (3,) in place of the random draw."""
        t0 = (self.state.t if self.table is not None and self.state is not None
              else 0.0)
        self.state = env_reset(
            self.params, 1, t0, table=self.table, substeps=self.substeps,
            generator=self._gen,
            threads=(None if threads is None
                     else as_f32(threads, self.params.tpt.device)[None]))
        return observe(self.params, self.state, table=self.table,
                       spec=self.spec)[0]

    def _step(self, action):
        action = as_f32(action, self.params.tpt.device)[None]
        self.state, obs, reward = env_step(
            self.params, self.state, action, table=self.table,
            substeps=self.substeps, spec=self.spec)
        return obs, reward

    def step(self, action):
        obs, reward = self._step(action)
        return obs[0], float(reward[0])

    # engine-like probe interface for the exploration phase
    def probe(self, threads):
        self._step(threads)
        return [float(x) for x in self.state.throughputs[0].cpu()]
