"""Algorithm 2: PPO training for thread allocation, single flow (port of
``repro.core.ppo``).

Faithful loop structure: N episodes, each = reset to random threads + M env
steps + ONE batched update over the episode memory (clipped surrogate +
0.5*MSE critic - 0.1*entropy, AdamW), old policy refreshed after each
episode batch, convergence when the best episode reward reaches
0.9*R_max*M and then ``patience`` episodes pass without improvement.

``train_ppo`` covers the single-flow regimes:

  static          train_ppo(params, cfg) — no workload; the env runs the
                  params' frozen conditions as a 1-bin schedule
  single schedule train_ppo(params, cfg, workload=Workload(tables=...))
  domain random.  train_ppo(params, cfg, workload=..., resample=fn) — the
                  batched tables are redrawn before every episode batch

The rollout steps all ``cfg.n_envs`` envs as one batch: one env step of the
whole batch is one launch of the simulator kernel. ``cfg.policy`` selects
the temporal policy ("mlp" | "stacked" frame-stacking | "gru" recurrent
carry). Fleet training (``n_flows > 1``), topologies and meshes belong to
later slices of the port and raise NotImplementedError.

Random draws (initial threads, episode start times, action noise) come from
one ``torch.Generator`` on the device; the rollout also takes them as
explicit tensors, which is how the tests hand it the reference's draws.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.core import networks as nets
from repro_torch.core.simulator import (env_reset, env_step, observe, ACT_DIM,
                                        ObservationSpec, DEFAULT_OBS,
                                        history_init, history_push,
                                        history_flatten)
from repro_torch.core.workload import Workload
from repro_torch.device import resolve_device
from repro_torch.optim import adamw_init, adamw_update

POLICIES = ("mlp", "stacked", "gru")


@dataclass
class PPOConfig:
    max_steps: int = 10          # M — steps per episode
    max_episodes: int = 30000    # N
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 1.0      # 1.0: the paper's discounted Monte-Carlo
    # returns; < 1.0: GAE(lambda) bootstrapped on the pre-update critic
    clip_eps: float = 0.2
    entropy_coef: float = 0.1
    critic_coef: float = 0.5
    ppo_epochs: int = 4
    normalize_adv: bool = True
    n_envs: int = 1              # envs stepped together in one batch
    substeps: int = 50
    patience: int = 1000
    convergence_frac: float = 0.9
    action_scale: float = 25.0
    init_log_std: float = 1.5
    max_grad_norm: float = 0.5
    seed: int = 0
    log_every: int = 0
    obs_spec: ObservationSpec = DEFAULT_OBS
    policy: str = "mlp"          # "mlp" | "stacked" | "gru"
    history: int = 4             # frames stacked when policy="stacked"
    rnn_hidden: int = 64         # GRU carry width when policy="gru"
    n_flows: int = 1             # > 1: fleet training (a later slice)
    pad_flows: bool = False      # fleet scale-out (a later slice)
    param_selection: str = "best_episode"  # | "batch_mean"
    device: str | None = None    # None: the CUDA device


@dataclass
class TrainResult:
    params: nn.ModuleDict        # {"policy", "value"}: the BEST params
    episodes: int
    wall_s: float
    history: list
    converged_at: int | None
    best_reward: float
    r_max: float | None


def effective_obs_spec(cfg: PPOConfig) -> ObservationSpec:
    """The observation layout the POLICY consumes: policy="stacked"
    frame-stacks ``cfg.history`` frames onto ``cfg.obs_spec`` (unless the
    spec already carries a history); "mlp"/"gru" take the spec as given."""
    if cfg.policy == "stacked" and cfg.obs_spec.history == 1:
        return cfg.obs_spec._replace(history=cfg.history)
    return cfg.obs_spec


def init_agent(cfg: PPOConfig, generator=None):
    """Fresh {"params": ModuleDict(policy, value), "opt": AdamW state} on
    ``cfg.device``. Weights are drawn from ``generator`` (default: a CPU
    generator seeded with ``cfg.seed``) on the CPU, then moved."""
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r}; expected one of "
                         f"{POLICIES}")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    obs_dim = effective_obs_spec(cfg).dim
    if cfg.policy == "gru":
        params = nn.ModuleDict({
            "policy": nets.RNNPolicyNet(
                obs_dim=obs_dim, act_dim=ACT_DIM, rnn_hidden=cfg.rnn_hidden,
                action_scale=cfg.action_scale,
                init_log_std=cfg.init_log_std, generator=generator),
            "value": nets.RNNValueNet(obs_dim=obs_dim,
                                      rnn_hidden=cfg.rnn_hidden,
                                      generator=generator),
        })
    else:
        params = nn.ModuleDict({
            "policy": nets.PolicyNet(obs_dim=obs_dim, act_dim=ACT_DIM,
                                     action_scale=cfg.action_scale,
                                     init_log_std=cfg.init_log_std,
                                     generator=generator),
            "value": nets.ValueNet(obs_dim=obs_dim, generator=generator),
        })
    params = params.to(resolve_device(cfg.device))
    return {"params": params, "opt": adamw_init(_named(params))}


def _named(params: nn.Module):
    return dict(params.named_parameters())


@torch.no_grad()
def _rollout(policy_net, env_params, tables, generator=None, *, n_envs, M,
             substeps, spec, randomize_t0, policy="mlp", threads0=None,
             t0_draw=None, noise=None):
    """One episode in each of ``n_envs`` envs, stepped as one batch, under
    the batched ``tables`` (None = the params' static conditions). When
    ``randomize_t0`` each episode's start time is drawn uniformly over its
    schedule horizon (domain randomization); static training starts at 0.

    Draws from ``generator`` unless given explicitly: ``threads0`` (E, 3)
    initial threads, ``t0_draw`` (E,) uniform [0, 1) start-time draws, and
    ``noise`` (M, E, 3) standard normal action noise.

    Temporal policies carry the (E, K, frame_dim) history window
    (zero-padded at reset) and, for "gru", the (E, H) recurrent carry (zeros
    at episode start). Returns (obs (E, M, D), action (E, M, 3), reward
    (E, M), logp (E, M)); obs is the stacked network input."""
    device = env_params.tpt.device
    if randomize_t0:
        horizon = tables.tpt.shape[1] * tables.bin_seconds            # (E,)
        span = torch.clamp_min(horizon - (M + 1) * env_params.duration, 0.0)
        if t0_draw is None:
            t0_draw = torch.rand(n_envs, generator=generator, device=device)
        t0 = t0_draw * span
    else:
        t0 = 0.0
    fspec = spec._replace(history=1)  # env-level spec: observe() is per-frame
    state = env_reset(env_params, n_envs, t0, table=tables, substeps=substeps,
                      generator=generator, threads=threads0)
    hist = history_init(spec, observe(env_params, state, table=tables,
                                      spec=fspec))
    recurrent = policy == "gru"
    h = nets.rnn_carry(policy_net, (n_envs,)) if recurrent else None
    traj = []
    for m in range(M):
        obs = history_flatten(hist)
        if recurrent:
            h, mean, std = policy_net(h, obs)
        else:
            mean, std = policy_net(obs)
        eps = (noise[m] if noise is not None else
               torch.randn(mean.shape, generator=generator, device=device))
        action = mean + std * eps
        logp = nets.gaussian_logp(mean, std, action)
        state, obs_next, reward = env_step(env_params, state, action,
                                           table=tables, substeps=substeps,
                                           spec=fspec)
        hist = history_push(hist, obs_next)
        traj.append((obs, action, reward, logp))
    obs, act, rew, logp = (torch.stack(x, dim=1) for x in zip(*traj))
    return obs, act, rew, logp


def _returns(rew, gamma):
    """Discounted returns along the last (step) axis."""
    g = torch.zeros_like(rew[..., 0])
    out = []
    for m in reversed(range(rew.shape[-1])):
        g = rew[..., m] + gamma * g
        out.append(g)
    return torch.stack(out[::-1], dim=-1)


def _gae_returns(rew, values, gamma, lam):
    """GAE(lambda) targets along the last (step) axis: advantage a_t =
    delta_t + gamma*lam*a_{t+1}, delta_t = r_t + gamma*V(s_{t+1}) - V(s_t),
    V = 0 past the horizon, returned as a_t + V(s_t)."""
    v_next = torch.cat([values[..., 1:], torch.zeros_like(values[..., :1])],
                       dim=-1)
    a = torch.zeros_like(rew[..., 0])
    out = []
    for m in reversed(range(rew.shape[-1])):
        a = ((rew[..., m] + gamma * v_next[..., m] - values[..., m])
             + gamma * lam * a)
        out.append(a + values[..., m])
    return torch.stack(out[::-1], dim=-1)


def _surrogate(logp, logp_old, v, ret, entropy, cfg: PPOConfig):
    """Clipped PPO surrogate shared by the feed-forward and recurrent
    losses. The advantage is normalized by the POPULATION std, as
    ``jnp.std``."""
    adv = ret - v.detach()
    if cfg.normalize_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    actor = -torch.minimum(surr1, surr2).mean()
    critic = cfg.critic_coef * torch.mean((ret - v) ** 2)
    entropy = entropy.mean()
    total = actor + critic - cfg.entropy_coef * entropy
    return total, {"actor": actor, "critic": critic, "entropy": entropy}


def _loss(params, batch, cfg: PPOConfig):
    obs, act, ret, logp_old = batch
    mean, std = params["policy"](obs)
    logp = nets.gaussian_logp(mean, std, act)
    v = params["value"](obs)
    return _surrogate(logp, logp_old, v, ret, nets.gaussian_entropy(std), cfg)


def _loss_recurrent(params, batch, cfg: PPOConfig):
    """Recurrent PPO loss: replay the GRUs over each episode sequence from
    the zero carry (truncated BPTT over the M-step episode). ``batch`` keeps
    episode structure: obs (E, M, D), act (E, M, A), ret (E, M), logp_old
    (E, M)."""
    obs, act, ret, logp_old = batch
    pol, val = params["policy"], params["value"]
    E, M = obs.shape[0], obs.shape[1]
    hp, hv = nets.rnn_carry(pol, (E,)), nets.rnn_carry(val, (E,))
    logp, v, ent = [], [], []
    for m in range(M):
        hp, mean, std = pol(hp, obs[:, m])
        hv, v_m = val(hv, obs[:, m])
        logp.append(nets.gaussian_logp(mean, std, act[:, m]))
        v.append(v_m)
        ent.append(nets.gaussian_entropy(std))
    logp, v, ent = (torch.stack(x, dim=1) for x in (logp, v, ent))
    return _surrogate(logp, logp_old, v, ret, ent, cfg)


@torch.no_grad()
def _values(params, obs, recurrent):
    """The pre-update critic's values (E, M) along each episode."""
    if not recurrent:
        return params["value"](obs)
    val = params["value"]
    hv = nets.rnn_carry(val, (obs.shape[0],))
    out = []
    for m in range(obs.shape[1]):
        hv, v = val(hv, obs[:, m])
        out.append(v)
    return torch.stack(out, dim=1)


def _make_episode_fn(env_params, cfg: PPOConfig, *, randomize_t0):
    """One call = n_envs episodes (one batched rollout) + ppo_epochs
    updates of the single flow. The train state's modules are updated in
    place: AdamW computes the new values functionally and they are copied
    into the parameters, so the modules' identity survives the update."""
    spec = effective_obs_spec(cfg)
    recurrent = cfg.policy == "gru"
    loss_fn = _loss_recurrent if recurrent else _loss

    def episode(train_state, tables, generator=None, *, threads0=None,
                t0_draw=None, noise=None):
        params, opt = train_state["params"], train_state["opt"]
        obs, act, rew, logp = _rollout(
            params["policy"], env_params, tables, generator,
            n_envs=cfg.n_envs, M=cfg.max_steps, substeps=cfg.substeps,
            spec=spec, randomize_t0=randomize_t0, policy=cfg.policy,
            threads0=threads0, t0_draw=t0_draw, noise=noise)
        if cfg.gae_lambda == 1.0:  # the paper's Monte-Carlo path
            ret = _returns(rew, cfg.gamma)
        else:
            ret = _gae_returns(rew, _values(params, obs, recurrent),
                               cfg.gamma, cfg.gae_lambda)
        if recurrent:  # the loss replays carries over episode sequences
            batch = (obs, act, ret, logp)
        else:
            batch = (obs.reshape(-1, spec.dim), act.reshape(-1, ACT_DIM),
                     ret.reshape(-1), logp.reshape(-1))
        named = _named(params)
        for _ in range(cfg.ppo_epochs):
            loss, _ = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, list(named.values()))
            new, opt, _ = adamw_update(
                {n: p.detach() for n, p in named.items()},
                dict(zip(named, grads)), opt, lr=cfg.lr, weight_decay=0.0,
                max_grad_norm=cfg.max_grad_norm)
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(new[n])
        return ({"params": params, "opt": opt}, rew.sum(dim=1),
                loss.detach())

    return episode


def train_ppo(env_params, cfg: PPOConfig = None, *, workload=None,
              resample=None, r_max=None, mesh=None):
    """Algorithm 2, schedule-native, single flow. Returns TrainResult with
    the BEST (not last) params.

    ``workload``: a ``Workload`` whose ``tables`` is a batched ScheduleTable
    (leading axis cfg.n_envs), or None for the params' static conditions.
    ``resample``: optional ``fn(round_index) -> Workload`` called before
    every episode batch to redraw the tables; an explicitly passed
    ``workload`` is honored for round 0, resampling starts at round 1."""
    cfg = cfg or PPOConfig()
    if cfg.n_flows > 1 or cfg.pad_flows:
        raise NotImplementedError("fleet training (n_flows > 1, pad_flows) "
                                  "lands with the fleet slice of the port")
    if mesh is not None:
        raise NotImplementedError("train_ppo(mesh=) lands with the "
                                  "multi-GPU fleet slice of the port")
    device = resolve_device(cfg.device)
    if env_params.tpt.device.type != device.type:
        raise ValueError(f"env params live on {env_params.tpt.device}, "
                         f"the config asks for {device}")
    wl = workload if workload is not None else Workload()
    gen = torch.Generator(device=env_params.tpt.device)
    gen.manual_seed(cfg.seed)
    train_state = init_agent(cfg)
    scheduled = wl.tables is not None or resample is not None
    episode_fn = _make_episode_fn(env_params, cfg, randomize_t0=scheduled)

    best_r = -float("inf")
    best_sel = -float("inf")  # selection metric (batch_mean mode)
    best_params = copy.deepcopy(train_state["params"])
    stagnant = 0
    converged_at = None
    history = []
    t0 = time.time()
    n_episodes = 0
    rnd = 0
    by_batch_mean = cfg.param_selection == "batch_mean"

    while n_episodes < cfg.max_episodes:
        if resample is not None and (wl.tables is None or rnd > 0):
            wl = resample(rnd)
            if not isinstance(wl, Workload):
                raise TypeError("resample(round) must return a Workload")
        rnd += 1
        train_state, ep_rewards, loss = episode_fn(train_state, wl.tables,
                                                   gen)
        ep_rewards = ep_rewards.cpu().numpy()
        if by_batch_mean:
            batch_mean = float(ep_rewards.mean())
            if batch_mean > best_sel:
                best_sel = batch_mean
                best_params = copy.deepcopy(train_state["params"])
                stagnant = 0
            else:
                stagnant += len(ep_rewards)
        for r in ep_rewards:
            n_episodes += 1
            history.append(float(r))
            if r > best_r:
                best_r = float(r)
                if not by_batch_mean:
                    best_params = copy.deepcopy(train_state["params"])
                    stagnant = 0
            elif not by_batch_mean:
                stagnant += 1
        if cfg.log_every and n_episodes % cfg.log_every < cfg.n_envs:
            print(f"[ppo] ep={n_episodes} best={best_r:.3f} "
                  f"loss={float(loss):.3f}", flush=True)
        if r_max is not None:
            if (converged_at is None
                    and best_r >= cfg.convergence_frac * r_max * cfg.max_steps):
                converged_at = n_episodes
            if converged_at is not None and stagnant >= cfg.patience:
                break

    return TrainResult(params=best_params, episodes=n_episodes,
                       wall_s=time.time() - t0, history=history,
                       converged_at=converged_at, best_reward=float(best_r),
                       r_max=r_max)
