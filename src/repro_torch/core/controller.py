"""Production phase (§IV-F) for one flow (port of ``repro.core.controller``:
``AutoMDTController``, ``FleetPolicy`` and ``_FleetFrames``).

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
unchanged. Fleet and topology controllers, and online adaptation, belong to
later slices of the port.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.simulator import ObservationSpec, DEFAULT_OBS
from repro_torch.device import resolve_device

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
                 policy="mlp", online=None, device=None):
        if policy not in ("mlp", "stacked", "gru"):
            raise ValueError(f"unknown policy {policy!r}")
        if online is not None:
            raise NotImplementedError("online adaptation lands with the "
                                      "faults-and-online slice of the port")
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

    def step(self, obs: dict):
        """obs dict -> next concurrency tuple (ints)."""
        vec = self._obs_vector(obs)
        return tuple(self._policy._action(vec[None])[0].tolist())

    def run(self, engine, *, total_bytes=None, interval=1.0, max_steps=None,
            on_step=None):
        """Drive a live engine until ``total_bytes`` moved (or
        engine.done()), on the ``time.monotonic()`` clock. Returns the trace
        [(t, threads, throughputs)]."""
        import time
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
