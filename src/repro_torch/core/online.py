"""Online adaptation over the frozen offline policy (hybrid offline/online).

The paper's agent is trained OFFLINE because online training in production
networks is impractical — but a frozen policy cannot re-converge when the
world leaves its training distribution (a condition family it never saw, a
fault regime excluded from ``fault_mix``). Following the hybrid-RL sequel
(PAPERS.md, arxiv 2511.06159), this module adds a lightweight ONLINE layer
on top of the frozen policy rather than replacing it:

  ReplayBuffer      a ring of live ``observe()`` transitions — the frame
                    the decision was taken on, the per-stage residual arm
                    chosen, and the reward realized one control interval
                    later via the existing ``utility`` path. Old
                    transitions age out, so the learner's window slides
                    with the regime instead of averaging over all history.

  ResidualBandit    the online head: a per-stage contextual 3-armed bandit
                    (hold / trim down / trim up) over an ACCUMULATING
                    residual added to the frozen policy's action. Each
                    (stage, arm) carries a ridge-regularized linear reward
                    model refit from the replay buffer; arms are chosen by
                    a deterministic UCB rule (optionally epsilon-dithered
                    from a seeded generator), so the head is bit-
                    deterministic given a transition stream — the online
                    twin of the repo's seeded-training contract.

  OnlineAdapter     the safety rails. The head's advantage over the frozen
                    action is tracked as a normalized EWMA of (realized
                    reward − the frozen policy's reward reference, itself
                    an EWMA collected on frozen-only steps). When the
                    estimate degrades below ``fallback`` the controller
                    snaps back to the frozen policy (residuals zeroed);
                    while disengaged the estimate relaxes toward neutral
                    and the controller re-engages only after ``cooldown``
                    steps AND once the estimate clears ``re_engage`` — a
                    hysteresis band (``fallback < re_engage``) so a noisy
                    boundary cannot make the controller flap.

Wired through ``AutoMDTController``/``FleetController`` as an
``online=OnlineConfig(...)`` knob. ``online=None`` runs LITERALLY the
existing program — bit-identical actions, pinned at atol=0 against
pre-change goldens in tests/test_online.py, per the repo's default-off
convention.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.utility import K_DEFAULT

# arm order: HOLD first so an untrained (all-ties) head keeps the frozen
# action instead of drifting
ARM_DELTA = np.asarray([0.0, -1.0, 1.0])
HOLD = 0


@dataclass(frozen=True)
class OnlineConfig:
    """Knobs for the online adaptation layer (``online=None`` disables it
    entirely — the frozen-policy program runs unchanged).

    step/max_residual are in THREADS: each engaged control interval the
    head trims the per-stage residual by ±``step`` (or holds), and the
    accumulated residual is clamped to ±``max_residual`` before being
    added to the frozen action. The rail thresholds are NORMALIZED reward
    units (fraction of the running reward scale): ``fallback`` must sit
    strictly below ``re_engage`` — that gap IS the hysteresis band."""

    step: float = 2.0          # residual trim per engaged interval (threads)
    max_residual: float = 16.0  # |accumulated residual| clamp (threads)
    buffer: int = 256          # replay-buffer capacity (transitions)
    update_every: int = 1      # head refits every N fed control intervals
    ridge: float = 1.0         # ridge regularizer of the linear reward model
    explore: float = 0.3       # deterministic UCB exploration bonus scale
    epsilon: float = 0.0       # seeded random-arm dither probability
    beta: float = 0.3          # EWMA rate (advantage + reward references)
    warmup: int = 3            # frozen-only intervals before first engage
    fallback: float = -0.25    # advantage below this => frozen fallback
    re_engage: float = -0.05   # advantage above this (+cooldown) => engage
    cooldown: int = 4          # min disengaged intervals before re-engage
    seed: int = 0              # dither stream seed (unused when epsilon=0)
    k: float = K_DEFAULT       # utility exponent base for realized reward

    def __post_init__(self):
        if not self.fallback < self.re_engage:
            raise ValueError(
                f"hysteresis band requires fallback < re_engage: "
                f"{self.fallback} vs {self.re_engage}")
        if self.warmup < 1:
            raise ValueError("warmup must be >= 1 (the rails need at least "
                             "one frozen reward reference)")


def realized_reward(throughputs, threads, *, weights=None, k=K_DEFAULT):
    """(F,) per-flow realized reward from live telemetry — the NumPy twin
    of ``utility.flow_utility`` (sum over the flow's three stages of
    tps / k^n, priority-weighted when objectives carry weights), computed
    host-side so the observe path never round-trips the device."""
    tps = np.asarray(throughputs, float)
    n = np.asarray(threads, float)
    u = np.sum(tps / np.power(float(k), n), axis=-1)
    if weights is not None:
        u = np.asarray(weights, float) * u
    return u


class ReplayBuffer:
    """Ring buffer of live transitions: (frame, residual-at-decision, arm
    per stage, realized reward). Plain NumPy, fixed capacity — the oldest
    transitions age out, which is what lets the head track a moving regime
    (and is why the head refits FROM the buffer instead of accumulating
    sufficient statistics forever)."""

    def __init__(self, capacity, ctx_dim):
        self.capacity = int(capacity)
        self.frames = np.zeros((self.capacity, ctx_dim))
        self.residuals = np.zeros((self.capacity, 3))
        self.arms = np.zeros((self.capacity, 3), int)
        self.rewards = np.zeros(self.capacity)
        self._n = 0      # rows ever pushed
        self._head = 0   # next write slot

    def __len__(self):
        return min(self._n, self.capacity)

    def push(self, frames, residuals, arms, rewards):
        """Append a batch of per-flow transitions (vectorized ring write)."""
        frames = np.atleast_2d(frames)
        m = frames.shape[0]
        if m == 0:
            return
        idx = (self._head + np.arange(m)) % self.capacity
        self.frames[idx] = frames
        self.residuals[idx] = np.atleast_2d(residuals)
        self.arms[idx] = np.atleast_2d(arms)
        self.rewards[idx] = np.asarray(rewards, float)
        self._head = int((self._head + m) % self.capacity)
        self._n += m

    def view(self):
        """(frames, residuals, arms, rewards) over the valid rows."""
        n = len(self)
        return (self.frames[:n], self.residuals[:n], self.arms[:n],
                self.rewards[:n])


class ResidualBandit:
    """Per-stage contextual 3-armed bandit over residual trims.

    Context for stage ``s`` is the decision frame plus that stage's
    normalized accumulated residual (so the model can tell "trim up from
    +8" apart from "trim up from 0"). Each (stage, arm) holds a ridge
    linear reward model refit from the replay buffer; arm choice is
    deterministic UCB — predicted reward plus ``explore * sqrt(x A^-1 x)``
    — with ties resolved toward HOLD by arm order."""

    def __init__(self, cfg: OnlineConfig, ctx_dim, *, n_norm):
        self.cfg = cfg
        self.ctx_dim = int(ctx_dim) + 1   # frame + residual fraction
        self.n_norm = float(n_norm)
        self._rng = np.random.default_rng(cfg.seed)
        self._A = np.tile(np.eye(self.ctx_dim) * cfg.ridge, (3, 3, 1, 1))
        self._b = np.zeros((3, 3, self.ctx_dim))
        self._w = np.zeros((3, 3, self.ctx_dim))
        self._Ainv = np.tile(np.eye(self.ctx_dim) / cfg.ridge, (3, 3, 1, 1))

    def _ctx(self, frames, residuals, stage):
        frames = np.atleast_2d(frames)
        res = np.atleast_2d(residuals)[:, stage] / max(self.n_norm, 1e-9)
        return np.concatenate([frames, res[:, None]], axis=-1)

    def refit(self, buffer: ReplayBuffer):
        """Rebuild every (stage, arm) model from the buffer's current
        window — O(len(buffer) * ctx_dim^2), trivial at live fleet sizes,
        and the rebuild (not an incremental update) is what makes old
        regimes AGE OUT with their transitions."""
        frames, residuals, arms, rewards = buffer.view()
        for s in range(3):
            ctx = self._ctx(frames, residuals, s) if len(frames) else None
            for a in range(3):
                A = np.eye(self.ctx_dim) * self.cfg.ridge
                b = np.zeros(self.ctx_dim)
                if ctx is not None:
                    mask = arms[:, s] == a
                    if mask.any():
                        X = ctx[mask]
                        A = A + X.T @ X
                        b = b + X.T @ rewards[mask]
                self._A[s, a] = A
                self._b[s, a] = b
                self._Ainv[s, a] = np.linalg.inv(A)
                self._w[s, a] = self._Ainv[s, a] @ b

    def choose(self, frames, residuals):
        """(F, frame_dim) decision frames + (F, 3) accumulated residuals ->
        (F, 3) arm indices, deterministically (UCB; seeded dither only when
        ``epsilon > 0``)."""
        F = np.atleast_2d(frames).shape[0]
        arms = np.zeros((F, 3), int)
        for s in range(3):
            x = self._ctx(frames, residuals, s)            # (F, D)
            q = np.empty((F, 3))
            for a in range(3):
                bonus = np.sqrt(np.maximum(
                    np.einsum("fd,dk,fk->f", x, self._Ainv[s, a], x), 0.0))
                q[:, a] = x @ self._w[s, a] + self.cfg.explore * bonus
            arms[:, s] = np.argmax(q, axis=1)   # ties -> lowest index = HOLD
        if self.cfg.epsilon > 0.0:
            dither = self._rng.random((F, 3)) < self.cfg.epsilon
            arms = np.where(dither, self._rng.integers(0, 3, (F, 3)), arms)
        return arms


class OnlineAdapter:
    """The per-controller online layer: replay buffer + residual head +
    safety rails, shared by the live controllers and the sim-side
    ``OnlineFleetPolicy``. Protocol per control interval:

        adapter.observe_outcome(tps, threads[, active])  # reward feedback
        applied = adapter.adjust(frames, frozen_actions[, active])

    (``observe_outcome`` settles the PREVIOUS interval's pending decision —
    live telemetry realizes an action's reward one interval later.)"""

    def __init__(self, cfg: OnlineConfig, *, n_flows, n_max, weights=None):
        self.cfg = cfg
        self.n_flows = int(n_flows)
        self.n_max = float(n_max)
        self.weights = None if weights is None else np.asarray(weights, float)
        self.buffer = None    # lazy: ctx dim known at the first adjust()
        self.head = None
        self.reset()

    def reset(self):
        self.buffer = None
        self.head = None
        self.residual = np.zeros((self.n_flows, 3))
        self.mode = "warmup"      # "warmup" -> "on" <-> "off"
        self.advantage = 0.0      # normalized EWMA advantage estimate
        self.n_fallbacks = 0
        self._frozen_ref = None   # EWMA reward under frozen-only steering
        self._r_scale = None      # EWMA |reward| (rail normalization)
        self._fed = 0
        self._off_steps = 0
        self._pending = None

    @property
    def engaged(self):
        return self.mode == "on"

    def _ensure(self, ctx_dim):
        if self.head is None:
            # the buffer stores raw decision frames; the +1 residual
            # feature is the bandit's own context extension
            self.buffer = ReplayBuffer(self.cfg.buffer, ctx_dim)
            self.head = ResidualBandit(self.cfg, ctx_dim, n_norm=self.n_max)

    def observe_outcome(self, throughputs, threads, active=None):
        """Feed the realized outcome of the previous interval's actions:
        (F, 3) throughputs/threads from live telemetry (or the sim state).
        Computes the reward on the existing ``utility`` path, records the
        pending transition, refits the head, and advances the rails."""
        if self._pending is None:
            return
        frames, residuals, arms, was_engaged, act = self._pending
        self._pending = None
        reward = realized_reward(throughputs, threads, weights=self.weights,
                                 k=self.cfg.k)
        mask = (np.ones(len(reward), bool) if act is None
                else np.asarray(act, float) > 0.0)
        r_mean = float(reward[mask].mean()) if mask.any() else 0.0
        beta = self.cfg.beta
        self._r_scale = (abs(r_mean) if self._r_scale is None
                         else (1 - beta) * self._r_scale + beta * abs(r_mean))
        if mask.any():
            self.buffer.push(frames[mask], residuals[mask], arms[mask],
                             reward[mask])
        self._fed += 1
        if self._fed % max(self.cfg.update_every, 1) == 0:
            self.head.refit(self.buffer)
        self._rails(r_mean, was_engaged)

    def _rails(self, r_mean, was_engaged):
        """Advance the safety-rail state machine one interval."""
        beta, cfg = self.cfg.beta, self.cfg
        if was_engaged:
            scale = max(self._r_scale or 0.0, 1e-9)
            ref = self._frozen_ref if self._frozen_ref is not None else r_mean
            delta = float(np.clip((r_mean - ref) / scale, -4.0, 4.0))
            self.advantage = (1 - beta) * self.advantage + beta * delta
            if self.advantage < cfg.fallback:
                self.mode = "off"
                self.n_fallbacks += 1
                self._off_steps = 0
                self.residual[:] = 0.0
            return
        # frozen-only interval: re-anchor the frozen reward reference
        self._frozen_ref = (r_mean if self._frozen_ref is None
                            else (1 - beta) * self._frozen_ref
                            + beta * r_mean)
        if self.mode == "warmup":
            if self._fed >= cfg.warmup:
                self.mode = "on"
        elif self.mode == "off":
            self._off_steps += 1
            # relax toward neutral: after the cooldown the head gets to
            # probe again once the estimate clears the upper threshold
            self.advantage *= (1 - beta)
            if (self._off_steps >= cfg.cooldown
                    and self.advantage >= cfg.re_engage):
                self.mode = "on"

    def adjust(self, frames, frozen, active=None):
        """(F, frame_dim) decision frames + (F, 3) frozen actions -> the
        (F, 3) actions to apply. Engaged: the head trims the accumulated
        residual and the clipped sum is applied; disengaged: the frozen
        action passes through untouched (residuals stay zero)."""
        frames = np.atleast_2d(np.asarray(frames, float))
        frozen = np.atleast_2d(np.asarray(frozen, float))
        self._ensure(frames.shape[1])
        if self.engaged:
            arms = self.head.choose(frames, self.residual)
            decided_at = self.residual.copy()
            self.residual = np.clip(
                self.residual + self.cfg.step * ARM_DELTA[arms],
                -self.cfg.max_residual, self.cfg.max_residual)
            applied = np.clip(frozen + np.round(self.residual), 1.0,
                              self.n_max)
        else:
            arms = np.full(frozen.shape, HOLD, int)
            decided_at = self.residual.copy()
            applied = frozen
        self._pending = (frames, decided_at, arms, self.engaged, active)
        return applied.astype(int)


class OnlineFleetPolicy:
    """``FleetPolicy`` + ``OnlineAdapter`` for the sim-side evaluation loop:
    duck-types the shared-actor contract (``obs_spec``/``reset``/``act``)
    and adds the ``observe_outcome`` feedback hook
    ``run_fleet_in_dynamic_sim`` calls after each contention step. The
    frozen policy is stepped IDENTICALLY to the plain actor (same RNG
    stream, same windows/carries); the adapter only post-adjusts its
    actions — per-stage residual over the frozen action, never a second
    policy."""

    def __init__(self, fleet_policy, cfg: OnlineConfig, *, n_flows,
                 weights=None):
        self.policy = fleet_policy
        self.adapter = OnlineAdapter(cfg, n_flows=n_flows,
                                     n_max=float(fleet_policy.n_max),
                                     weights=weights)

    @property
    def obs_spec(self):
        return self.policy.obs_spec

    def reset(self):
        self.policy.reset()
        self.adapter.reset()

    def act(self, frames):
        frames = np.asarray(frames, np.float32)
        frozen = self.policy.act(frames)
        return self.adapter.adjust(frames, frozen)

    def observe_outcome(self, throughputs, threads, active=None):
        self.adapter.observe_outcome(throughputs, threads, active)
