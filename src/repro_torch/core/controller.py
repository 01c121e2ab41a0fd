"""Production phase (§IV-F) (port of ``repro.core.controller``:
``AutoMDTController``, ``FleetPolicy``, ``_FleetFrames`` and
``FleetController``).

Load the best offline-trained policy and re-enter the interaction loop with
no episode limit until the dataset has been transferred. Every step: build
the observation frame from the engine's observe() dict, take the policy's
diagonal Gaussian action (its mean when ``deterministic``), round, clamp to
[1, n_max], apply it to the engine.

Works against any engine exposing
    observe() -> dict(threads, throughputs, sender_free, receiver_free,
                      sender_capacity, receiver_capacity)
    set_concurrency((n_r, n_n, n_w))
as ``repro_torch.transfer.TransferEngine`` and the simulators do.

The frames are built on the host in NumPy (the reference's program, line
for line); the act step — network forward, sampling, round and clamp — runs
on the policy's device as ONE dispatch per control interval, counted in
``FleetPolicy.n_dispatch``, with one (F, 3) copy back to the host. Frame
stacking (spec.history > 1) keeps the zero-padded K-frame window the PPO
rollout carries, and ``policy="gru"`` threads the recurrent carry (zeros
at reset) on the device, so sim-trained params drop into the live loop
unchanged.

``FleetController`` runs ONE shared policy across N live engines on a
``SharedLink``: the batched observations become the (F, frame_dim) matrix
in a handful of NumPy ops, with the cross-flow features and the objective
block (``objective_features_np``) computed as ``fleet_observe`` computes
them, a heartbeat health check masking stalled flows, and one act
dispatch per control interval. ``TopologyController`` steers N engines
whose stages traverse a ``MultiLink`` and appends the topology block
(``core.topology.topology_features``, the sim's own definition).

``online=OnlineConfig(...)`` puts the online adaptation layer
(``core.online``: replay buffer, residual bandit head, safety rails) over
the frozen policy in either controller: each step settles the previous
interval's decision against the reward the new telemetry realized, then
post-adjusts the frozen action. ``online=None`` runs the frozen-policy
program unchanged.
"""

from __future__ import annotations

import copy
import re
import time

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.fleet import (FlowObjective, objective_features_np,
                                    default_objectives, _host)
from repro_torch.core.online import OnlineAdapter, OnlineConfig
from repro_torch.core.simulator import ObservationSpec, DEFAULT_OBS, TOPO_DIM
from repro_torch.core.topology import topology_features
from repro_torch.device import resolve_device

# the health check's worker namespace: ONLY ``flow<digits>`` belongs to the
# fleet controller; a shared registry may carry foreign workers
_FLOW_WORKER = re.compile(r"flow(\d+)")

_OBS_KEYS = ("threads", "throughputs", "sender_free", "receiver_free",
             "sender_capacity", "receiver_capacity")


def _stack_observations(obs_list):
    """List of per-flow observe() dicts -> dict of (F, ...) float arrays."""
    return {k: np.asarray([o[k] for o in obs_list], float)
            for k in _OBS_KEYS}


class _FleetFrames:
    """The per-flow observation frames from consecutive BATCHED observations
    — the live twin of the simulator's ``observe``, computed on (F, ...)
    matrices (F=1 for ``AutoMDTController``). Holds the previous
    throughputs (context deltas) and the running bandwidth max used when no
    explicit normalization reference is given."""

    def __init__(self, *, n_max, bw_ref, obs_spec: ObservationSpec,
                 interval):
        self.n_max = n_max
        self.bw_ref = bw_ref
        self.obs_spec = obs_spec
        self.interval = interval
        self._bw_seen = 1e-9
        self._prev_tps = None     # (F, 3) float64

    def reset(self):
        self._bw_seen = 1e-9
        self._prev_tps = None

    def bw(self, tps):
        """Scalar normalization reference: the explicit ``bw_ref`` when
        given (0 is a legitimate, clamped reference), else the RUNNING max
        over the run, so the scale never shrinks with a bandwidth dip."""
        if self.bw_ref is not None:
            return max(float(self.bw_ref), 1e-9)
        if tps.size:
            self._bw_seen = max(self._bw_seen, float(tps.max()), 1e-9)
        return self._bw_seen

    def frames(self, obs):
        """dict of (F, ...) arrays -> (F, base_dim) float32 frame block."""
        threads = np.asarray(obs["threads"], float)
        tps = np.asarray(obs["throughputs"], float)
        bw = self.bw(tps)
        s_cap = np.maximum(np.asarray(obs["sender_capacity"], float), 1e-9)
        r_cap = np.maximum(np.asarray(obs["receiver_capacity"], float),
                           1e-9)
        parts = [
            threads / self.n_max,
            tps / bw,
            np.stack([np.asarray(obs["sender_free"], float) / s_cap,
                      np.asarray(obs["receiver_free"], float) / r_cap],
                     axis=-1),
        ]
        if self.obs_spec.context:
            prev = self._prev_tps if self._prev_tps is not None else tps
            parts.append((tps - prev) / bw)
            parts.append(np.stack([
                (tps[:, 1] - tps[:, 0]) * self.interval / s_cap,
                (tps[:, 2] - tps[:, 1]) * self.interval / r_cap,
            ], axis=-1))
        self._prev_tps = tps
        return np.concatenate(parts, axis=-1).astype(np.float32)


class AutoMDTController:
    def __init__(self, policy_params, *, n_max=100, bw_ref=None,
                 deterministic=False, seed=0,
                 obs_spec: ObservationSpec = DEFAULT_OBS, interval=1.0,
                 policy="mlp", online: OnlineConfig = None, device=None):
        if policy not in ("mlp", "stacked", "gru"):
            raise ValueError(f"unknown policy {policy!r}")
        self.params = policy_params
        self.n_max = n_max
        self.bw_ref = bw_ref  # normalization reference (exploration B max)
        self.deterministic = deterministic
        self.obs_spec = obs_spec
        self.interval = interval  # seconds per control step (drain scaling)
        self.policy = "gru" if policy == "gru" else "mlp"
        self._frames = _FleetFrames(n_max=n_max, bw_ref=bw_ref,
                                    obs_spec=obs_spec, interval=interval)
        # the temporal stepping is the F=1 slice of the fleet policy
        self._policy = FleetPolicy(policy_params, n_max=n_max,
                                   deterministic=deterministic, seed=seed,
                                   obs_spec=obs_spec, policy=policy,
                                   device=device)
        # the online adaptation layer: None runs the frozen-policy program
        self._online = (None if online is None else
                        OnlineAdapter(online, n_flows=1, n_max=n_max))

    @property
    def n_dispatch(self):
        return self._policy.n_dispatch

    def _frame_vector(self, obs: dict):
        return self._frames.frames(_stack_observations([obs]))[0]

    def _obs_vector(self, obs: dict):
        """Network input under the spec: one frame, or the flattened K-frame
        window (zero-padded until K real frames have been seen)."""
        return self._policy._window(self._frame_vector(obs)[None])[0]

    def reset(self):
        """Clear per-run state (context deltas, running bw max, history
        window, GRU carry)."""
        self._frames.reset()
        self._policy.reset()
        if self._online is not None:
            self._online.reset()

    def step(self, obs: dict):
        """obs dict -> next concurrency tuple (ints)."""
        frame = self._frame_vector(obs)
        if self._online is not None:
            # settle the previous interval's decision: the reward its
            # action realized is in THIS observation's telemetry
            self._online.observe_outcome(
                np.asarray(obs["throughputs"], float)[None],
                np.asarray(obs["threads"], float)[None])
        vec = self._policy._window(frame[None])[0]
        n = self._policy._action(vec[None])[0]
        if self._online is not None:
            n = self._online.adjust(frame[None], n[None])[0]
        return tuple(n.tolist())

    def run(self, engine, *, total_bytes=None, interval=1.0, max_steps=None,
            on_step=None):
        """Drive a live engine until ``total_bytes`` moved (or
        engine.done()), on the ``time.monotonic()`` clock. Returns the trace
        [(t, threads, throughputs)]."""
        trace = []
        t0 = time.monotonic()
        steps = 0
        while True:
            obs = engine.observe()
            n = self.step(obs)
            engine.set_concurrency(n)
            engine.wait(interval)
            obs2 = engine.observe()
            trace.append((time.monotonic() - t0, n,
                          tuple(obs2["throughputs"])))
            if on_step:
                on_step(trace[-1])
            steps += 1
            if total_bytes is not None and engine.bytes_written() >= total_bytes:
                break
            if getattr(engine, "done", lambda: False)():
                break
            if not getattr(engine, "alive", True):
                break  # closed mid-run: done() will never turn true
            if max_steps is not None and steps >= max_steps:
                break
        return trace


class FleetPolicy:
    """ONE trained policy stepped across F flows: maps a (F, frame_dim)
    frame matrix to (F, 3) integer thread allocations, keeping the per-flow
    zero-padded history windows or the (F, H) GRU carries (zeros at reset)
    the rollout used in training. ``policy_params`` is the policy module
    (``TrainResult.params["policy"]``); a copy of it is placed on ``device``
    (None: the CUDA device), so the caller's module stays where it is. Each
    act step is one forward, one sample, one round and one clamp on the
    device, counted in ``n_dispatch``."""

    def __init__(self, policy_params, *, n_max=100, deterministic=True,
                 seed=0, obs_spec: ObservationSpec = DEFAULT_OBS,
                 policy="mlp", device=None):
        if policy not in ("mlp", "stacked", "gru"):
            raise ValueError(f"unknown policy {policy!r}")
        self.device = resolve_device(device)
        self.params = copy.deepcopy(policy_params).to(self.device)
        self.n_max = float(n_max)
        self.deterministic = deterministic
        self.obs_spec = obs_spec
        self.policy = "gru" if policy == "gru" else "mlp"
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.n_dispatch = 0  # act steps run (one per control interval)
        self._hist = None    # (F, K, frame_dim) when obs_spec.history > 1
        self._carry = None   # (F, H) GRU carry, on the device

    def reset(self):
        self._hist = None
        self._carry = None

    def _window(self, frames):
        """Maintain the per-flow zero-padded K-frame windows: (F, frame_dim)
        new frames -> (F, dim) network input (K=1 passes frames through)."""
        frames = np.asarray(frames, np.float32)
        n_flows = frames.shape[0]
        K = self.obs_spec.history
        if K == 1:
            return frames
        if self._hist is None:
            self._hist = np.zeros((n_flows, K, frames.shape[1]), np.float32)
        self._hist = np.concatenate([self._hist[:, 1:],
                                     frames[:, None]], axis=1)
        return self._hist.reshape(n_flows, -1)

    @torch.no_grad()
    def _action(self, vec):
        """(F, dim) network input -> (F, 3) int thread allocations,
        threading the GRU carry when recurrent."""
        x = torch.as_tensor(np.asarray(vec, np.float32), device=self.device)
        if self.policy == "gru":
            if self._carry is None:
                self._carry = nets.rnn_carry(self.params, (x.shape[0],))
            self._carry, mean, std = self.params(self._carry, x)
        else:
            mean, std = self.params(x)
        a = mean
        if not self.deterministic:
            a = mean + std * torch.randn(mean.shape, generator=self._gen,
                                         device=self.device)
        a = torch.clamp(torch.round(a), 1.0, self.n_max)
        self.n_dispatch += 1
        return a.cpu().numpy().astype(int)

    def act(self, frames):
        """frames: (F, frame_dim) -> (F, 3) int thread allocations."""
        return self._action(self._window(np.asarray(frames, np.float32)))


def _observe_fleet(engines):
    """One batched telemetry pass: every engine snapshotted against ONE
    timestamp (``observe_at``) so the per-flow rate windows stay aligned;
    engines without the batched hook use their own clock."""
    now = time.monotonic()
    return [e.observe_at(now) if hasattr(e, "observe_at") else e.observe()
            for e in engines]


class FleetController:
    """Production phase for a FLEET: one shared policy drives N live engines
    contending on a SharedLink, mirroring the sim contention model. The
    batched observations become the (F, frame_dim) matrix (``_FleetFrames``)
    and, when the spec carries them, the cross-flow features — active
    fraction, aggregate network utilization over ``bw_ref``, each flow's
    share of the aggregate — and the objective block are appended exactly
    as ``fleet_observe`` computes them, so sim-trained fleet params
    transfer unchanged. ``objectives`` are in ENGINE units (deadline in
    seconds on the run clock, demand in the engines' byte units). A
    topology spec needs the subclass that supplies its block
    (``TopologyController``)."""

    _topology_block = False  # whether this class appends TOPO_DIM features

    def __init__(self, policy_params, *, n_flows, n_max=100, bw_ref=None,
                 deterministic=True, seed=0,
                 obs_spec: ObservationSpec = DEFAULT_OBS, interval=1.0,
                 policy="mlp", objectives: FlowObjective = None,
                 online: OnlineConfig = None, device=None):
        if obs_spec.topology and not self._topology_block:
            raise NotImplementedError("FleetController emits no topology "
                                      "features: use TopologyController")
        self.n_flows = n_flows
        self.n_max = n_max
        self.bw_ref = bw_ref
        self.obs_spec = obs_spec
        self.interval = interval
        # held as host arrays: the objective block is NumPy on the hot path
        self.objectives = (None if objectives is None else FlowObjective(
            *(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x) for x in objectives)))
        self._frames = _FleetFrames(n_max=n_max, bw_ref=bw_ref,
                                    obs_spec=obs_spec, interval=interval)
        self.fleet_policy = FleetPolicy(policy_params, n_max=n_max,
                                        deterministic=deterministic,
                                        seed=seed, obs_spec=obs_spec,
                                        policy=policy, device=device)
        # the online adaptation layer: None runs the frozen-policy program;
        # the realized reward rides the objective weights when given
        self._online = (None if online is None else OnlineAdapter(
            online, n_flows=n_flows, n_max=n_max,
            weights=None if objectives is None else self.objectives.weight))

    def reset(self):
        self._frames.reset()
        self.fleet_policy.reset()
        if self._online is not None:
            self._online.reset()

    def _frame_width(self):
        """Frame dims this class emits (the topology block is the
        subclass's)."""
        w = self.obs_spec.frame_dim
        return w - TOPO_DIM if self.obs_spec.topology else w

    def _fleet_bw(self):
        # the aggregate-utilization normalization: the explicit reference
        # when given (0 is explicit too, clamped), else the running max
        if self.bw_ref is not None:
            return max(float(self.bw_ref), 1e-9)
        return max(self._frames._bw_seen, 1e-9)

    def frames(self, obs_list, active=None, t=0.0, delivered=None):
        """(F, frame_dim) matrix from the engines' observe() dicts."""
        return self.frames_arrays(_stack_observations(obs_list), active,
                                  t=t, delivered=delivered)

    def frames_arrays(self, obs, active=None, t=0.0, delivered=None):
        """(F, frame_dim) matrix from a BATCHED observation: ``obs`` maps
        the observe() keys to (F, ...) arrays. ``active``: optional (F,)
        0/1 mask of the flows transferring (default: all); inactive flows
        are masked out of the aggregate and share features. With the
        objective dims, ``t`` (run-clock seconds) and ``delivered`` ((F,)
        bytes written per flow, default zeros) feed the objective block."""
        tps = np.asarray(obs["throughputs"], float)
        F = tps.shape[0]
        if F == 0:
            return np.zeros((0, self._frame_width()), np.float32)
        if self.bw_ref is None:
            # ONE normalization reference across the whole fleet, as the
            # sim divides every flow by the same schedule peak
            self._frames._bw_seen = max(self._frames._bw_seen,
                                        float(tps.max()), 1e-9)
        base = self._frames.frames(obs)
        if self.obs_spec.fleet:
            act = (np.ones(F) if active is None
                   else np.asarray(active, float))
            net = tps[:, 1] * act
            agg = net.sum()
            rows = np.stack([
                np.full(F, act.sum() / max(self.n_flows, 1)),
                np.full(F, agg / self._fleet_bw()),
                net / max(agg, 1e-9),
            ], axis=-1)
            base = np.concatenate([base, rows], axis=-1)
        if self.obs_spec.objectives:
            obj = (self.objectives if self.objectives is not None
                   else default_objectives(F, device="cpu"))
            dlv = (np.zeros(F) if delivered is None
                   else np.asarray(delivered, float))
            rows = objective_features_np(obj, float(t), dlv,
                                         bw_ref=self._fleet_bw(),
                                         duration=self.interval)
            base = np.concatenate([base, rows], axis=-1)
        return base.astype(np.float32)

    def step(self, obs_list, active=None, t=0.0, delivered=None):
        """List of observe() dicts -> list of (n_r, n_n, n_w) tuples."""
        acts = self.step_arrays(_stack_observations(obs_list), active,
                                t=t, delivered=delivered)
        return [tuple(int(x) for x in row) for row in acts]

    def step_arrays(self, obs, active=None, t=0.0, delivered=None):
        """Batched observation dict -> (F, 3) int action matrix in ONE act
        dispatch."""
        frames = self.frames_arrays(obs, active, t=t, delivered=delivered)
        if frames.shape[0] == 0:
            return np.zeros((0, 3), int)
        if self._online is not None:
            # settle the previous interval's decision against the reward
            # its action realized (this snapshot's telemetry)
            self._online.observe_outcome(
                np.asarray(obs["throughputs"], float),
                np.asarray(obs["threads"], float), active)
        acts = self.fleet_policy.act(frames)
        if self._online is not None:
            acts = self._online.adjust(frames, acts, active)
        return acts

    @staticmethod
    def _settle_sleep(seconds, engines, settled):
        """Sleep the control interval in short slices, returning as soon as
        EVERY engine has settled."""
        deadline = time.monotonic() + seconds
        while not all(settled(i, e) for i, e in enumerate(engines)):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    def run(self, engines, *, interval=1.0, max_steps=None, total_bytes=None,
            on_step=None, registry=None, dead_after=None):
        """Drive N live engines until every one reports done() or is closed
        (or ``total_bytes`` moved fleet-wide / ``max_steps`` elapsed).
        Engines that finish or are torn down keep being observed but are
        masked inactive and no longer steered. Exit conditions are checked
        BEFORE each interval's sleep, and the sleep is abort-aware. The run
        clock is ``time.monotonic()``.

        ``engines``: a list of engines, or a ``SharedLink`` — then the
        per-flow byte counters ride its batched ``bytes_written_all()``.
        ONE byte snapshot per interval feeds ``delivered``, the health
        check and the termination sum.

        Health checks: with ``registry`` (a ``HeartbeatRegistry``), the
        controller beats ``flow<i>`` for every engine that made byte
        progress since the last step (and once up front). A flow whose last
        beat is older than ``dead_after`` seconds (default ``4 *
        interval``) is DEAD: masked like a closed engine, no longer
        steered, not required for termination; it is re-admitted once it
        makes progress again.

        Returns the trace [(t, [n3 per flow], [goodput per flow])]."""
        link = (engines if hasattr(engines, "bytes_written_all")
                and hasattr(engines, "engines") else None)
        if link is not None:
            engines = list(link.engines)

        def snapshot_bytes():
            if link is not None:
                return link.bytes_written_all()
            return [e.bytes_written() for e in engines]

        def observe_now():
            if link is not None:
                return link.observe_all()
            return _observe_fleet(engines)

        dead = set()    # flow indices declared dead by the health check
        if registry is not None and dead_after is None:
            dead_after = 4.0 * interval
        last_bytes = [None] * len(engines)

        def settled(i, e):
            return i in dead or e.done() or not getattr(e, "alive", True)

        def health_check(step, bytes_now):
            for i, b in enumerate(bytes_now):
                # progress (or first sight, or clean completion) = alive
                if (last_bytes[i] is None or b > last_bytes[i]
                        or engines[i].done()):
                    registry.beat(f"flow{i}", step, interval)
                last_bytes[i] = b
            now_m = time.monotonic()
            dead.clear()   # recomputed each check: progress re-admits
            for w, (beat_t, _, _) in registry.snapshot().items():
                m = _FLOW_WORKER.fullmatch(w)
                if m is None:
                    continue   # a foreign worker: not ours
                idx = int(m.group(1))
                if idx < len(engines) and now_m - beat_t > dead_after:
                    dead.add(idx)

        trace = []
        t0 = time.monotonic()
        steps = 0
        while True:
            delivered = snapshot_bytes()
            if registry is not None:
                health_check(steps, delivered)
            if total_bytes is not None and sum(delivered) >= total_bytes:
                break
            if all(settled(i, e) for i, e in enumerate(engines)):
                break
            if max_steps is not None and steps >= max_steps:
                break
            obs = observe_now()
            active = np.asarray([0.0 if settled(i, e) else 1.0
                                 for i, e in enumerate(engines)])
            for i, (e, n) in enumerate(
                    zip(engines,
                        self.step(obs, active, t=time.monotonic() - t0,
                                  delivered=delivered))):
                if not settled(i, e):
                    e.set_concurrency(n)
            self._settle_sleep(interval, engines, settled)
            obs2 = observe_now()
            trace.append((time.monotonic() - t0,
                          [tuple(o["threads"]) for o in obs2],
                          [o["throughputs"][2] for o in obs2]))
            if on_step:
                on_step(trace[-1])
            steps += 1
        return trace


class TopologyController(FleetController):
    """Production phase over a MULTI-LINK path topology: the shared policy
    drives N live engines whose stages traverse a
    ``repro_torch.transfer.MultiLink`` (one StageThrottle pool per link).
    On top of the fleet frames it appends the TOPOLOGY_OBS block —
    bottleneck-link utilization, path length, my share on the bottleneck —
    through the sim's own ``topology_features`` on host tensors.

    ``paths``: a static (F, L) 0/1 routing matrix, or a PathSpec-like
    object (``onpath`` (R, F, L) + ``bin_seconds``) looked up on the
    controller's run clock, so a failover moves the features when
    ``MultiLink.reroute`` moves the tokens (``set_paths`` for re-routing
    decided elsewhere). ``link_bw_ref``: (L,) per-link bandwidth reference
    in ENGINE units (the live twin of the per-link schedule peaks)."""

    _topology_block = True

    def __init__(self, policy_params, *, paths, link_bw_ref, **kwargs):
        super().__init__(policy_params, **kwargs)
        self.link_bw_ref = np.asarray(link_bw_ref, float)
        self.set_paths(paths)

    def set_paths(self, paths):
        if hasattr(paths, "onpath"):
            self._onpath = _host(paths.onpath).astype(float)
            self._route_bin = float(_host(paths.bin_seconds))
        else:
            self._onpath = _host(paths).astype(float)[None]
            self._route_bin = np.inf
        if self._onpath.ndim != 3 or self._onpath.shape[1] != self.n_flows:
            raise ValueError(f"paths must route {self.n_flows} flows: "
                             f"{self._onpath.shape}")

    def routes(self, t=0.0):
        """(F, L) routing matrix at run-clock time ``t``."""
        r = (0 if not np.isfinite(self._route_bin)
             else min(int(t / self._route_bin), self._onpath.shape[0] - 1))
        return self._onpath[r]

    def frames_arrays(self, obs, active=None, t=0.0, delivered=None):
        base = super().frames_arrays(obs, active, t=t, delivered=delivered)
        if not self.obs_spec.topology:
            return base
        if base.shape[0] == 0:
            return np.zeros((0, self.obs_spec.frame_dim), np.float32)
        act = (np.ones(base.shape[0]) if active is None
               else np.asarray(active, float))
        net = np.asarray(obs["throughputs"], float)[:, 1]
        host = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        # literally the sim's feature block, on host tensors: ONE definition
        rows = topology_features(host(self.routes(t)), host(net), host(act),
                                 host(self.link_bw_ref)).numpy()
        return np.concatenate([base, rows], axis=-1).astype(np.float32)
