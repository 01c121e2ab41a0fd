"""Algorithm 2: PPO training for thread allocation (port of
``repro.core.ppo``).

Faithful loop structure: N episodes, each = reset to random threads + M env
steps + ONE batched update over the episode memory (clipped surrogate +
0.5*MSE critic - 0.1*entropy, AdamW), old policy refreshed after each
episode batch, convergence when the best episode reward reaches
0.9*R_max*M and then ``patience`` episodes pass without improvement.

``train_ppo`` covers these regimes:

  static          train_ppo(params, cfg) — no workload; the env runs the
                  params' frozen conditions as a 1-bin schedule
  single schedule train_ppo(params, cfg, workload=Workload(tables=...))
  domain random.  train_ppo(params, cfg, workload=..., resample=fn) — the
                  batched workload is redrawn before every episode batch
  fleet           cfg.n_flows > 1: ONE shared policy steps every flow's
                  observation row through the contention model of
                  ``repro_torch.core.fleet``; the step reward is shared
                  across the fleet (aggregate utility + fairness_coef *
                  Jain, with per-flow objectives when the workload has
                  them), and each (env, step, flow) is one PPO sample
                  against the shared return
  topology        workload.topology set: the fleet's shared policy over
                  flows that traverse multi-link paths
                  (``repro_torch.core.topology``: per-link work-conserving
                  contention, min over each flow's links); episode start
                  times randomize over the graphs' horizon

The rollout steps all ``cfg.n_envs`` envs (and all their flows) as one
batch: one env step of the whole batch is one launch of the simulator
kernel, plus one of the contention kernel in fleet and topology mode.
``cfg.policy`` selects the temporal policy ("mlp" | "stacked"
frame-stacking | "gru" recurrent carry).

``train_ppo(mesh=)`` splits every round's flows, objectives and routes over
the mesh's "flows" axis (``repro_torch.sharding.fleet``). Each rank then
steps its own flows: the random draws are made at full F from the one
generator and each rank keeps its rows, so they equal the unsharded run's;
the fleet's reductions, the loss's means and the gradients are summed over
the ranks (``flow_all_reduce``); the parameters and AdamW state are
replicated, so every rank makes the same update, keeps the same best
params and returns the same result.

Random draws (initial threads, episode start times, action noise) come from
one ``torch.Generator`` on the device; the rollout also takes them as
explicit tensors, which is how the tests hand it the reference's draws.
"""

from __future__ import annotations

import copy
import time
import warnings
from dataclasses import dataclass, replace as dc_replace

import torch
from torch import nn

from repro_torch.core import networks as nets
from repro_torch.core.fleet import (fleet_reset, fleet_step, fleet_observe,
                                    flow_bucket, pad_flow_schedule,
                                    pad_flow_objectives, _always_on_batch)
from repro_torch.core.topology import (Topology, topology_reset,
                                       topology_step, topology_observe,
                                       pad_path_spec)
from repro_torch.core.simulator import (env_reset, env_step, observe, ACT_DIM,
                                        ObservationSpec, DEFAULT_OBS,
                                        history_init, history_push,
                                        history_flatten)
from repro_torch.core.workload import Workload
from repro_torch.device import resolve_device
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.sharding.fleet import (current, flow_all_reduce, flow_rows,
                                        flow_scope, local_flows, scope_of,
                                        shard_flow_objectives,
                                        shard_flow_schedule, shard_path_spec,
                                        to_local)

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
    n_flows: int = 1             # > 1: fleet training, ONE shared policy
    fairness_coef: float = 0.0   # weight of the Jain fairness reward term
    deadline_coef: float = 1.0   # weight of the deadline-miss penalty
    max_active: int | None = None  # fleet scale-out: bound on the flows
    # any one step interval touches (the compact solve); size it with
    # core.fleet.max_concurrent_flows + flow_bucket; None = the dense solve
    pad_flows: bool = False      # pad the fleet to flow_bucket(n_flows)
    # with never-active flows (the reward is unchanged)
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


def _rollout_fleet(policy_net, env_params, tables, flows, objectives,
                   generator=None, **kw):
    """One fleet episode in each of ``n_envs`` envs, stepped as one batch:
    F flows contend for the scheduled capacity, ONE shared policy maps each
    flow's observation row to that flow's action, and every step's reward
    is the shared fleet objective. ``flows``/``objectives``: batched
    (E, F) FlowSchedule/FlowObjective (None = always on / the default
    objective). History windows and the GRU carry get a flow axis, so
    fleet-trained params drop into the per-flow live controller. Keywords
    as ``_rollout_flows``."""
    horizon = (None if tables is None
               else tables.tpt.shape[1] * tables.bin_seconds)       # (E,)
    return _rollout_flows(policy_net, env_params, dict(table=tables),
                          horizon, (fleet_reset, fleet_observe, fleet_step),
                          flows, objectives, generator, **kw)


def _rollout_topology(policy_net, env_params, topology: Topology, flows,
                      objectives, generator=None, **kw):
    """One topology episode in each of ``n_envs`` envs: the fleet rollout's
    multi-link twin. Flows traverse the link paths of ``topology`` (a
    batched Topology) and contend per link through the work-conserving
    solve; the per-flow policy, history and carry contracts are the fleet
    ones, so topology-trained params drop into the same live controller.
    The episode start span is the graphs' horizon, T * bin_seconds.
    Keywords as ``_rollout_flows``."""
    graph, paths = topology
    horizon = graph.tpt.shape[2] * graph.bin_seconds                 # (E,)
    return _rollout_flows(policy_net, env_params,
                          dict(graph=graph, paths=paths), horizon,
                          (topology_reset, topology_observe, topology_step),
                          flows, objectives, generator, **kw)


@torch.no_grad()
def _rollout_flows(policy_net, env_params, world, horizon, env_fns, flows,
                   objectives, generator=None, *, n_envs, n_flows, M,
                   substeps, spec, randomize_t0, policy="mlp",
                   fairness_coef=0.0, deadline_coef=1.0, max_active=None,
                   threads0=None, t0_draw=None, noise=None):
    """The multi-flow rollout both worlds share: ``env_fns`` is the
    (reset, observe, step) triple of the fleet or the topology core and
    ``world`` the keywords naming its conditions; ``horizon`` (E,) bounds
    the random episode start when ``randomize_t0``.

    Draws from ``generator`` unless given explicitly: ``threads0``
    (E, F, 3), ``t0_draw`` (E,) and ``noise`` (M, E, F, 3). Returns (obs
    (E, M, F, D), action (E, M, F, 3), reward (E, M), logp (E, M, F)). In a
    flow scope the draws are at full F and the outputs hold the rank's
    flows; the reward is the whole fleet's."""
    reset_fn, observe_fn, step_fn = env_fns
    device = env_params.tpt.device
    if randomize_t0:
        span = torch.clamp_min(horizon - (M + 1) * env_params.duration, 0.0)
        if t0_draw is None:
            t0_draw = torch.rand(n_envs, generator=generator, device=device)
        t0 = t0_draw * span
    else:
        t0 = 0.0
    fspec = spec._replace(history=1)
    state = reset_fn(env_params, n_envs, n_flows, t0, flows=flows,
                     substeps=substeps, objectives=objectives,
                     max_active=max_active, generator=generator,
                     threads=flow_rows(threads0, 1), **world)
    hist = history_init(spec, observe_fn(
        env_params, state, flows=flows, spec=fspec, objectives=objectives,
        max_active=max_active, **world))                  # (E, F, K, D)
    recurrent = policy == "gru"
    h = (nets.rnn_carry(policy_net, (n_envs, local_flows(n_flows)))
         if recurrent else None)
    traj = []
    for m in range(M):
        obs = history_flatten(hist)
        if recurrent:
            h, mean, std = policy_net(h, obs)
        else:
            mean, std = policy_net(obs)
        eps = flow_rows(noise[m] if noise is not None else torch.randn(
            (n_envs, n_flows) + mean.shape[2:], generator=generator,
            device=device), 1)
        action = mean + std * eps
        logp = nets.gaussian_logp(mean, std, action)
        state, obs_next, reward = step_fn(
            env_params, state, action, flows=flows, substeps=substeps,
            spec=fspec, fairness_coef=fairness_coef, objectives=objectives,
            deadline_coef=deadline_coef, max_active=max_active, **world)
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
    ``jnp.std``. In a flow scope the advantage's mean and std are the whole
    batch's, and each mean is this rank's share of the global one (its sum
    over the global count), so the ranks' gradients sum to the global
    loss's."""
    shard = current()
    if shard is None:
        mean = torch.mean
    else:
        n = ret.numel() * shard.size

        def mean(x):
            return x.sum() / n
    adv = ret - v.detach()
    if cfg.normalize_adv:
        if shard is None:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        else:
            mu = flow_all_reduce(adv.sum()) / n
            var = flow_all_reduce(((adv - mu) ** 2).sum()) / n
            adv = (adv - mu) / (torch.sqrt(var) + 1e-8)
    ratio = torch.exp(logp - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    actor = -mean(torch.minimum(surr1, surr2))
    critic = cfg.critic_coef * mean((ret - v) ** 2)
    entropy = mean(entropy)
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


def _per_flow_sequences(x):
    """(E, M, F, ...) -> (E*F, M, ...): one sequence per (env, flow)."""
    x = x.transpose(1, 2)
    return x.reshape((-1,) + x.shape[2:])


def _ppo_epoch(params, batch, opt, cfg: PPOConfig, loss_fn=_loss):
    """One PPO epoch on ``batch``: the loss's gradients and one AdamW step,
    computed functionally and copied into ``params`` in place. Returns
    (opt, loss, {name: gradient}). In a flow scope the gradients (and the
    loss) are summed over the ranks before the update, so the clip norm is
    the global one."""
    named = _named(params)
    loss, _ = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    if current() is not None:
        *grads, loss = flow_all_reduce(*grads, loss.detach())
    grads = dict(zip(named, grads))
    new, opt, _ = adamw_update({n: p.detach() for n, p in named.items()},
                               grads, opt, lr=cfg.lr, weight_decay=0.0,
                               max_grad_norm=cfg.max_grad_norm)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(new[n])
    return opt, loss, grads


def _make_episode_fn(env_params, cfg: PPOConfig, *, randomize_t0):
    """One call = n_envs episodes (one batched rollout) + ppo_epochs
    updates. With ``cfg.n_flows > 1`` the rollout is the fleet's, and given
    a ``topology`` (a batched Topology, which replaces ``tables`` as the
    world, for any n_flows >= 1) the multi-link twin's. In both, every
    (env, step, flow) sample trains against the SHARED return of its step:
    Monte-Carlo returns are broadcast over flows, GAE runs on each flow's
    own baseline, and the recurrent replay treats each (env, flow) pair as
    one carry sequence. The train state's modules are updated in place:
    AdamW computes the new values functionally and they are copied into
    the parameters, so the modules' identity survives the update.

    Flows, objectives and routes with DTensor leaves split over a mesh's
    "flows" axis (``train_ppo(mesh=)``) run the episode in their flow
    scope: explicit ``threads0`` and ``noise`` are given at full F."""
    spec = effective_obs_spec(cfg)
    recurrent = cfg.policy == "gru"
    loss_fn = _loss_recurrent if recurrent else _loss

    def episode(train_state, tables, generator=None, *, flows=None,
                objectives=None, topology=None, threads0=None, t0_draw=None,
                noise=None):
        world = (flows, objectives, topology)
        with flow_scope(scope_of(world)):
            return _episode(train_state, tables, generator, *to_local(world),
                            threads0, t0_draw, noise)

    def _episode(train_state, tables, generator, flows, objectives, topology,
                 threads0, t0_draw, noise):
        params, opt = train_state["params"], train_state["opt"]
        fleet = cfg.n_flows > 1 or topology is not None   # a flow axis
        if fleet:
            rollout, world = ((_rollout_topology, topology)
                              if topology is not None
                              else (_rollout_fleet, tables))
            obs, act, rew, logp = rollout(
                params["policy"], env_params, world, flows, objectives,
                generator, n_envs=cfg.n_envs, n_flows=cfg.n_flows,
                M=cfg.max_steps, substeps=cfg.substeps, spec=spec,
                randomize_t0=randomize_t0, policy=cfg.policy,
                fairness_coef=cfg.fairness_coef,
                deadline_coef=cfg.deadline_coef, max_active=cfg.max_active,
                threads0=threads0, t0_draw=t0_draw, noise=noise)
        else:
            obs, act, rew, logp = _rollout(
                params["policy"], env_params, tables, generator,
                n_envs=cfg.n_envs, M=cfg.max_steps, substeps=cfg.substeps,
                spec=spec, randomize_t0=randomize_t0, policy=cfg.policy,
                threads0=threads0, t0_draw=t0_draw, noise=noise)
        if cfg.gae_lambda == 1.0:  # the paper's Monte-Carlo path
            ret = _returns(rew, cfg.gamma)
            if fleet:
                ret = ret[:, :, None].expand_as(logp)           # (E, M, F)
        elif fleet:  # shared reward, per-flow baselines
            v = _values(params, _per_flow_sequences(obs), recurrent)
            E, M, F = logp.shape
            r = rew[:, None, :].expand(E, F, M).reshape(E * F, M)
            ret = _gae_returns(r, v, cfg.gamma, cfg.gae_lambda)
            ret = ret.reshape(E, F, M).transpose(1, 2)          # (E, M, F)
        else:
            ret = _gae_returns(rew, _values(params, obs, recurrent),
                               cfg.gamma, cfg.gae_lambda)
        if recurrent and fleet:
            batch = tuple(_per_flow_sequences(x)
                          for x in (obs, act, ret, logp))
        elif recurrent:  # the loss replays carries over episode sequences
            batch = (obs, act, ret, logp)
        else:
            batch = (obs.reshape(-1, spec.dim), act.reshape(-1, ACT_DIM),
                     ret.reshape(-1), logp.reshape(-1))
        for _ in range(cfg.ppo_epochs):
            opt, loss, _ = _ppo_epoch(params, batch, opt, cfg, loss_fn)
        return ({"params": params, "opt": opt}, rew.sum(dim=1),
                loss.detach())

    return episode


_LEGACY_KWARG_PAIRS = ("tables", "flows/resample_flows",
                       "objectives/resample_objectives",
                       "topology/resample_topology",
                       "faults/resample_faults")


class _Rounds:
    """Each round's Workload: ``resample`` (a Workload, or, deprecated,
    bare tables) and then the deprecated per-axis resamplers, in the
    reference's order and on its conditions (round 0 draws an axis only
    where the given workload lacks it)."""

    def __init__(self, resample, per_axis):
        self.resample, self.per_axis = resample, per_axis
        self.warned = False

    def __call__(self, rnd, wl):
        if self.resample is not None and (
                rnd > 0 or (wl.tables is None and wl.topology is None)):
            out = self.resample(rnd)
            if isinstance(out, Workload):
                wl = out
            else:   # legacy fn(round) -> batched tables
                if not self.warned:
                    self.warned = True
                    warnings.warn(
                        "train_ppo(resample=...) returning bare tables is "
                        "deprecated: return a repro_torch.core.Workload",
                        DeprecationWarning, stacklevel=3)
                wl = wl.replace(tables=out)
        for name, fn in self.per_axis.items():
            if fn is not None and (getattr(wl, name) is None or rnd > 0):
                wl = wl.replace(**{name: fn(rnd)})
        return wl


def train_ppo(env_params, cfg: PPOConfig = None, *, workload=None,
              resample=None, tables=None, flows=None, resample_flows=None,
              objectives=None, resample_objectives=None, topology=None,
              resample_topology=None, faults=None, resample_faults=None,
              r_max=None, mesh=None, generator=None):
    """Algorithm 2, schedule-native. Returns TrainResult with the BEST (not
    last) params.

    ``workload``: a ``Workload`` bundling the batched ScheduleTable
    (leading axis cfg.n_envs; None = the params' static conditions), and in
    fleet mode the batched FlowSchedule (None = every flow always on) and
    FlowObjective (None = the default objective), all on the config's
    device. ``repro_torch.scenarios.sample_fleet_batch`` returns one.
    With a batched ``Topology`` (``workload.topology``,
    ``sample_topology_batch``) the rollout is the topology's: the tables
    are ignored and episode start times randomize over the graphs'
    horizon. ``resample``: optional ``fn(round_index) -> Workload`` called
    before every episode batch to redraw the distribution; an explicitly
    passed ``workload`` with tables or a topology is honored for round 0,
    resampling starts at round 1. Round 0's workload fixes whether the
    rollout is the topology's. A workload's ``faults`` are compiled into
    its tables, flows and graphs each round, before any padding
    (``Workload.compiled()``). ``cfg.pad_flows`` pads the fleet (and every
    round's flows, objectives and routes) to ``flow_bucket(cfg.n_flows)``
    never-active, pathless flows. ``mesh``: optional DeviceMesh with a
    "flows" axis (``repro_torch.launch.mesh.make_fleet_mesh``): every
    round's flows, objectives and routes are split over it
    (``repro_torch.sharding.fleet``) and each rank steps its own flows;
    every rank of the mesh calls ``train_ppo`` alike and gets the same
    result. Combine with ``cfg.pad_flows`` so F divides the mesh: an F that
    does not, or a mesh of one rank, runs replicated, bit for bit the
    unsharded program. ``generator``: a ``torch.Generator`` on the env's
    device, the counterpart of the reference's ``key``: the rollouts draw
    from it and the initial weights from a CPU generator seeded with its
    ``initial_seed()``; None is a generator seeded with ``cfg.seed``.

    DEPRECATED, as in the reference (one cycle): the per-axis kwargs
    ``tables``, ``flows``/``resample_flows``, ``objectives``/
    ``resample_objectives``, ``topology``/``resample_topology`` and
    ``faults``/``resample_faults``, and a ``resample`` that returns bare
    tables, warn (DeprecationWarning) and fold into a Workload; they
    cannot be combined with ``workload=``."""
    cfg = cfg or PPOConfig()
    legacy = (tables, flows, objectives, topology, faults, resample_flows,
              resample_objectives, resample_topology, resample_faults)
    if any(v is not None for v in legacy):
        warnings.warn(
            "train_ppo's per-axis kwarg pairs "
            f"({', '.join(_LEGACY_KWARG_PAIRS)}) are deprecated: bundle "
            "the axes in a repro_torch.core.Workload and pass "
            "train_ppo(workload=..., resample=fn(round) -> Workload).",
            DeprecationWarning, stacklevel=2)
        if workload is not None:
            raise ValueError("pass workload= or the legacy per-axis "
                             "kwargs, not both")
        workload = Workload(tables=tables, flows=flows,
                            objectives=objectives, topology=topology,
                            faults=faults)
    rounds = _Rounds(resample, {"flows": resample_flows,
                                "objectives": resample_objectives,
                                "topology": resample_topology,
                                "faults": resample_faults})
    if cfg.pad_flows and cfg.n_flows > 1:
        cfg = dc_replace(cfg, n_flows=flow_bucket(cfg.n_flows))
    device = resolve_device(cfg.device)
    if env_params.tpt.device.type != device.type:
        raise ValueError(f"env params live on {env_params.tpt.device}, "
                         f"the config asks for {device}")
    if generator is None:
        generator = torch.Generator(device=env_params.tpt.device)
        generator.manual_seed(cfg.seed)
    elif generator.device.type != env_params.tpt.device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"env params on {env_params.tpt.device}")
    gen = generator
    wl = rounds(0, workload if workload is not None else Workload())
    topo_mode = wl.topology is not None   # round 0's draw fixes the world
    train_state = init_agent(cfg, torch.Generator().manual_seed(
        gen.initial_seed()))
    scheduled = wl.tables is not None or resample is not None or topo_mode
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
        if rnd > 0:
            wl = rounds(rnd, wl)
        rnd += 1
        run = wl.compiled()   # fault edits (no faults: wl itself)
        flows, objectives, topology = (run.flows, run.objectives,
                                       run.topology)
        if cfg.n_flows > 1 or topo_mode:
            if flows is None:
                flows = _always_on_batch(cfg.n_envs, cfg.n_flows,
                                         env_params.tpt.device)
            if cfg.pad_flows and cfg.n_flows > 1:
                flows = pad_flow_schedule(flows, cfg.n_flows)
                objectives = pad_flow_objectives(objectives, cfg.n_flows)
                if topology is not None:
                    topology = Topology(topology.graph, pad_path_spec(
                        topology.paths, cfg.n_flows))
        if mesh is not None:
            if flows is not None:
                flows = shard_flow_schedule(flows, mesh)
            objectives = shard_flow_objectives(objectives, mesh)
            if topology is not None:
                topology = Topology(topology.graph, shard_path_spec(
                    topology.paths, mesh))
        train_state, ep_rewards, loss = episode_fn(
            train_state, run.tables, gen, flows=flows, objectives=objectives,
            topology=topology)
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
