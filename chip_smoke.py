"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA H100 (sm_90a) and
the CUDA toolkit. It builds the port's CUDA kernels from ``src/repro_torch/
csrc`` and drives the paper's loop and the multi-flow fleet through the
port's entry points:

  1. device     the card's name and power limit (nvidia-smi)
  2. build      nvcc builds the kernel libraries from csrc/sim_step.cu and
                csrc/contention.cu, one nvcc each, started together
  3. parity     each kernel against its plain PyTorch version on the same
                CUDA tensors, at the main path's shapes (1 env for the
                probes, 32 for training) and at 16384 envs; kernel, plain
                and bound times
  4. main path  exploration on the simulator, PPO (quickstart's
                configuration: 2000 episodes, 32 envs) on the card, then the
                trained AutoMDTController steering a live threaded 3-stage
                TransferEngine; the kernels' launch counts over this phase
  5. agreement  the card's simulator, exploration and one PPO episode batch
                against the same functions on the CPU from the same inputs
  6. scale      three episode batches at 4096 envs, and a profile of one
                episode batch at 32 and at 4096 envs (device busy share,
                kernel launches, the sim kernel's share)
  7. contention the contention kernel against its plain version at the
                fleet's training shape (16 envs, 4 flows, objectives off
                and on), the scale-out shapes (4096 flows dense, 256
                compact) and a topology shape (3 links, 8 water-fill
                rounds); kernel, device, plain and bound times
  8. fleet      bench_fleet.py's configuration (4 flows, 16 envs, 1500
                episodes, domain-randomized arrivals) trained on the card,
                the shared policy and the static baseline scored on three
                arrival families, then FleetController steering four live
                engines on one SharedLink; both kernels' launch counts
  9. fleet agreement and scale: one fleet episode batch on the card
                against the CPU, fleet_step at 4096 flows dense and
                compact, and a profile of one fleet episode batch

It prints its findings on earlier lines, one JSON line with every kernel's
numbers, the nvidia-smi line, and ends with the line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Without CUDA, or without the repository beside it, it fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
SIM_OPS_PER_SUBSTEP = 16    # f32 ops of one substep of one env (K1)
# The dependent chain of one env: the sender buffer s carries 8 dependent
# f32 ops per substep (cap_s - s, min, max, + read, min, min, max, - net),
# each waiting for the last; 4 cycles is the dependent-issue latency of an
# f32 add/min/max on the SM, at the H100 SXM's maximum boost clock.
SIM_CHAIN_OPS_PER_SUBSTEP = 8
F32_DEP_LATENCY_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
MB = 1 << 20
# K3's f32 operations per (env, substep, flow, link, stage) element: the
# objective-free solve is eff (2 products), its sum, the share division,
# the two products and min of the link rate, the min over links and the
# activity product (8); with objectives the demand, floor and scaled-floor
# terms, their two sums, the residual split and the final min add 8 more,
# and each water-fill round 9 (spill, clip, weight, its sum, the update).
CONTENTION_OPS = 8
CONTENTION_OPS_OBJ = 16
CONTENTION_OPS_ROUND = 9
# K3's dependent chain: each sum over F flows is a reduction tree of
# ceil(log2 F) dependent adds (log2(F/32) across warps + 5 shuffle levels
# in a warp), and about 4 dependent element-wise ops lead from one sum to
# the next (product, division, min, product). The solve is 1 sum deep
# without objectives, 2 + rounds deep with them (the sums of eff and of the
# floors run side by side, then the scaled floors, then each round).
CONTENTION_OPS_BETWEEN_SUMS = 4
# bench_fleet.py's configuration (benchmarks/bench_fleet.py:38-46, 102-133)
FLEET_TPT = (0.2, 0.15, 0.2)
FLEET_BW = (1.0, 1.0, 1.0)
FLEET_N_MAX = 50
FLEET_FLOWS = 4
FLEET_ENVS = 16
FLEET_EPISODES = 1500
FLEET_HORIZON = 60.0
FLEET_ARRIVALS = ("staggered_start", "poisson_arrivals", "flash_crowd")
FLEET_LIVE_S = 15.0          # the live fleet's time limit
FLEET_LIVE_MB = 12           # each live flow's transfer
# fleet_scaling_rows' fleet (benchmarks/bench_training_time.py:99): Poisson
# arrivals, hold_frac 0.01, seed 7; fleet_step timed over SCALE_ITERS steps
SCALE_FLOWS = 4096
SCALE_ITERS = 20


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, *, samples=20, inner=20, warmup=5):
    """Median over ``samples`` of the CUDA-event time of ``inner``
    back-to-back calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_ms(torch, fn, kernel_name, n=20):
    """The kernel's own device time per launch from torch.profiler, or None
    where the profiler records no device time for it."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel_name in evt.key and evt.count and evt.device_time_total:
            return evt.device_time_total / evt.count / 1e3
    return None


def profile_round(torch, run_round, kernels):
    """One episode batch (``run_round()``: rollout + updates): its wall
    time unprofiled, and under torch.profiler the device's kernel time,
    kernel count and the named kernels' device time."""
    from torch.profiler import profile, ProfilerActivity
    run_round()   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_round()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_round()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    named = {k: sum(e.self_device_time_total for e in kern if k in e.key)
             / 1e3 for k in kernels}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return {"round_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kern),
            "kernel_ms": named,
            "kernel_share_of_busy": {k: v / busy_ms for k, v in
                                     named.items()},
            "top": [[e.key[:48], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def bound_ms(n_bytes, n_ops, chain_ops):
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations' time, which is the larger of all operations
    over the f32 rate and one env's dependent chain at one op per
    ``F32_DEP_LATENCY_CYCLES`` cycles. -> (ms, bound_by, terms in ms)."""
    terms = {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "ops_rate_ms": n_ops / F32_OPS_PER_S * 1e3,
             "chain_ms": chain_ops * F32_DEP_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3}
    t_ops = max(terms["ops_rate_ms"], terms["chain_ms"])
    return (max(terms["bytes_ms"], t_ops),
            "bytes" if terms["bytes_ms"] >= t_ops else "operations", terms)


def sim_inputs(torch, E, S, seed):
    rng = np.random.default_rng(seed)
    bufs = rng.uniform(0.0, 1.0, (E, 2)).astype(np.float32)
    cap = rng.uniform(1.0, 4.0, (E, 2)).astype(np.float32)
    rates_dt = rng.uniform(0.002, 0.06, (E, S, 3)).astype(np.float32)
    rate = rng.uniform(0.1, 3.0, (E, 3)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).cuda()
    return to(bufs), to(rates_dt), to(cap), to(rate)


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def contention_bound(E, S, F, L, rounds, objectives):
    """K3's bound at one shape: every input read once and the output
    written once, the element-wise f32 operations, and the dependent chain
    of the flow-axis sums (see the CONTENTION_* constants)."""
    n_bytes = 4 * (E * F * 3 + E * S * F + E * S * F * L + 2 * E * S * L * 3
                   + (2 * E * F if objectives else 0) + E * S * F * 3)
    per_elem = ((CONTENTION_OPS_OBJ + rounds * CONTENTION_OPS_ROUND)
                if objectives else CONTENTION_OPS)
    depth = 2 + rounds if objectives else 1
    chain = depth * (int(np.ceil(np.log2(max(F, 2))))
                     + CONTENTION_OPS_BETWEEN_SUMS)
    return bound_ms(n_bytes, per_elem * E * S * F * L * 3, chain)


def contention_operands(torch, E, S, F, L, *, p_active, seed):
    """Operands at the main path's value ranges: thread counts in [1, 50],
    activity masks with ``p_active`` of the flows live, the one-link
    embedding (onpath all ones) for L = 1 and random routes otherwise,
    per-stage conditions around bench_fleet.py's profile, floors and caps
    with half the flows uncapped."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    onpath = (np.ones((E, S, F, L)) if L == 1
              else rng.integers(0, 2, (E, S, F, L)))
    return dict(
        threads=f32(rng.integers(1, 51, (E, F, 3))),
        act=f32(rng.random((E, S, F)) < p_active),
        onpath=f32(onpath),
        tpt=f32(rng.uniform(0.1, 0.3, (E, S, L, 3))),
        bw=f32(rng.uniform(0.75, 1.25, (E, S, L, 3))),
        floor=f32(rng.uniform(0.0, 0.5, (E, F))),
        cap=f32(np.where(rng.random((E, F)) < 0.5, np.inf,
                         rng.uniform(0.05, 1.0, (E, F)))))


# name: (E, S, F, L, rounds, objectives, share of flows active). The fleet's
# training batch (bench_fleet.py: 16 envs, 4 flows, one link, no
# water-fill), the scale-out fleet at F = 4096 dense (Poisson arrivals,
# hold_frac 0.01: a few percent live) and its compact A = 256 slice, and a
# topology-shaped solve (3 links, F water-fill rounds, with objectives).
CONTENTION_SHAPES = {
    "fleet": (16, 50, 4, 1, 0, False, 0.8),
    "fleet_objectives": (16, 50, 4, 1, 0, True, 0.8),
    "scale_dense": (1, 50, 4096, 1, 0, False, 0.05),
    "scale_compact": (1, 50, 256, 1, 0, False, 0.8),
    "topology": (4, 50, 8, 3, 8, True, 0.8),
}


def phase_contention(torch):
    """7. K3 against its plain version at every shape of CONTENTION_SHAPES,
    with kernel (CUDA events), device (profiler), plain and bound times."""
    from repro_torch.kernels.contention import ops
    from repro_torch.kernels.contention.ref import contention_rates_reference
    rows = {}
    for i, (name, (E, S, F, L, rounds, obj, p)) in enumerate(
            CONTENTION_SHAPES.items()):
        x = contention_operands(torch, E, S, F, L, p_active=p, seed=i)
        args = [x[k] for k in ("threads", "act", "onpath", "tpt", "bw")]
        args += [x["floor"], x["cap"]] if obj else [None, None]
        kern = lambda: ops.contention_rates(*args, rounds=rounds)
        plain = lambda: contention_rates_reference(*args, rounds=rounds)
        got = kern()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        if not err <= 2e-5:
            fail(f"contention {name}: max abs err {err} > 2e-5")
        b_ms, b_by, terms = contention_bound(E, S, F, L, rounds, obj)
        row = dict(E=E, S=S, F=F, L=L, rounds=rounds, objectives=obj,
                   max_abs_err=err, ms=time_ms(torch, kern),
                   device_ms=device_ms(torch, kern, "contention_kernel"),
                   plain_ms=time_ms(torch, plain, samples=5, inner=3,
                                    warmup=1),
                   bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
                   library_ms=None)
        rows[name] = row
        print(f"[contention] {name} E={E} S={S} F={F} L={L} rounds={rounds} "
              f"objectives={obj}: max_abs_err={err:.3g} ms={row['ms']} "
              f"device_ms={row['device_ms']} plain_ms="
              f"{row['plain_ms']} bound_ms={b_ms:.3g} ({b_by}; "
              f"{json.dumps(terms)}) library_ms=null")
    return rows


def reset_launches():
    from repro_torch.kernels.sim_step import ops as sim_ops
    from repro_torch.kernels.contention import ops as k3_ops
    sim_ops.sim_interval_batch.launches = 0
    sim_ops.sim_step_batch.launches = 0
    k3_ops.contention_rates.launches = 0


def read_launches():
    from repro_torch.kernels.sim_step import ops as sim_ops
    from repro_torch.kernels.contention import ops as k3_ops
    return {"sim_interval": sim_ops.sim_interval_batch.launches,
            "sim_step": sim_ops.sim_step_batch.launches,
            "contention": k3_ops.contention_rates.launches}


def fleet_params(dev):
    from repro_torch.core import make_env_params
    return make_env_params(tpt=list(FLEET_TPT), bw=list(FLEET_BW),
                           cap=[2.0, 2.0], n_max=FLEET_N_MAX, device=dev)


def fleet_config(dev, *, episodes, n_envs, n_flows, seed=1, obs_spec=None):
    """bench_fleet.py's train_fleet_agent configuration."""
    from repro_torch.core import PPOConfig, FLEET_OBS
    return PPOConfig(max_episodes=episodes, n_envs=n_envs,
                     action_scale=FLEET_N_MAX / 4, seed=seed,
                     obs_spec=obs_spec or FLEET_OBS,
                     param_selection="batch_mean", n_flows=n_flows,
                     fairness_coef=0.5, device=dev)


def fleet_draw(n_envs, seed=1):
    """bench_fleet.py's per-round draw: domain randomization over the
    arrival families, objective-blind (the sampler's default objectives
    dropped)."""
    from repro_torch.scenarios import sample_fleet_batch

    def draw(rnd):
        wl = sample_fleet_batch(n_envs, FLEET_FLOWS, seed=seed * 7919 + rnd,
                                horizon=FLEET_HORIZON, base_tpt=FLEET_TPT,
                                base_bw=FLEET_BW, device="cuda")
        return wl.replace(objectives=None, specs=None)
    return draw


def phase_fleet(torch):
    """8. The fleet's main path: bench_fleet.py's shared policy trained
    through train_ppo, scored with run_fleet_in_dynamic_sim against the
    static baseline on three arrival families, then FleetController
    steering four live engines on one SharedLink. Asserts both kernels'
    launch counts over training and over evaluation."""
    from repro_torch.core import (train_ppo, effective_obs_spec, FleetPolicy,
                                  FleetController, GlobusController)
    from repro_torch.scenarios import (ScenarioSpec, arrival_schedule,
                                       run_fleet_in_dynamic_sim)
    from repro_torch.transfer import (SharedLink, SyntheticSource,
                                      ChecksumSink)
    n_envs, n_flows, horizon = FLEET_ENVS, FLEET_FLOWS, FLEET_HORIZON
    params = fleet_params("cuda")
    cfg = fleet_config("cuda", episodes=FLEET_EPISODES, n_envs=n_envs,
                       n_flows=n_flows)
    draw = fleet_draw(n_envs)
    wl0 = draw(0)
    reset_launches()
    res = train_ppo(params, cfg, workload=wl0, resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    rounds = res.episodes // n_envs
    hist = np.asarray(res.history, float)
    batch_means = hist[: rounds * n_envs].reshape(rounds, n_envs).mean(1)
    print(f"[fleet train] {res.episodes} episodes ({rounds} rounds of "
          f"{n_envs} envs x {n_flows} flows, {cfg.max_steps} steps) in "
          f"{res.wall_s:.3f} s = {res.episodes / res.wall_s:.1f} "
          f"episodes/s; best episode reward {res.best_reward:.4f}, best "
          f"batch-mean reward {batch_means.max():.4f}, last "
          f"{batch_means[-1]:.4f}; launches {json.dumps(train_launches)}")
    if not np.all(np.isfinite(hist)):
        fail("non-finite fleet training reward")
    expected = rounds * (cfg.max_steps + 1)
    if (train_launches["contention"] != expected
            or train_launches["sim_interval"] != expected):
        fail(f"fleet training launched {json.dumps(train_launches)}, "
             f"expected contention = sim_interval = {rounds} rounds x "
             f"{cfg.max_steps + 1} = {expected}")

    fleet = FleetPolicy(res.params["policy"], n_max=FLEET_N_MAX,
                        deterministic=True, obs_spec=effective_obs_spec(cfg),
                        device="cuda")
    spec = ScenarioSpec(family="static", seed=11, horizon=horizon,
                        base_tpt=FLEET_TPT, base_bw=FLEET_BW)
    reset_launches()
    evals, sim_steps = {}, 0
    for arrival in FLEET_ARRIVALS:
        flows = arrival_schedule(arrival, n_flows, horizon=horizon, seed=11,
                                 device="cuda")
        for label, actor in (("fleet", fleet), ("static", [
                GlobusController() for _ in range(n_flows)])):
            ev = run_fleet_in_dynamic_sim(spec, flows, params, actor, seed=7,
                                          label=label, arrival=arrival)
            sim_steps += 1 + ev.goodput.shape[0]   # reset + steps
            evals[(arrival, label)] = ev
            if not (np.isfinite(ev.utilization) and np.isfinite(ev.jain)):
                fail(f"non-finite fleet evaluation {arrival}/{label}")
        f, s = evals[(arrival, "fleet")], evals[(arrival, "static")]
        print(f"[fleet eval] {arrival}: fleet utilization "
              f"{f.utilization:.4f} Jain {f.jain:.4f}; static utilization "
              f"{s.utilization:.4f} Jain {s.jain:.4f}; fleet/static "
              f"{f.utilization / max(s.utilization, 1e-9):.3f}")
        if f.utilization <= 0.0:
            fail(f"the fleet policy moved nothing on {arrival}")
    torch.cuda.synchronize()
    eval_launches = read_launches()
    bar = all(evals[(a, "fleet")].utilization
              > evals[(a, "static")].utilization
              and evals[(a, "fleet")].jain >= 0.9 for a in FLEET_ARRIVALS)
    print(f"[fleet eval] launches {json.dumps(eval_launches)} over "
          f"{sim_steps} sim steps (resets included); the reference's bar "
          f"(fleet beats static on every family at Jain >= 0.9): "
          f"{'held' if bar else 'NOT held'}")
    if (eval_launches["contention"] != sim_steps
            or eval_launches["sim_interval"] != sim_steps):
        fail(f"fleet evaluation launched {json.dumps(eval_launches)}, "
             f"expected {sim_steps} of each")

    # live: one SharedLink of bench_fleet's profile, 1.0 sim Gbit/s = 8 MB/s
    unit = 8 * MB
    link = SharedLink(aggregate_bps=tuple(b * unit for b in FLEET_BW),
                      per_thread_bps=tuple(t * unit for t in FLEET_TPT))
    engines = [link.attach(SyntheticSource(FLEET_LIVE_MB * MB,
                                           chunk_bytes=128 * 1024, seed=f),
                           ChecksumSink(), sender_buf=2 * unit,
                           receiver_buf=2 * unit, initial_concurrency=(2, 2, 2),
                           n_max=FLEET_N_MAX, metric_interval=0.2)
               for f in range(n_flows)]
    interval = 0.5
    ctl = FleetController(res.params["policy"], n_flows=n_flows,
                          n_max=FLEET_N_MAX, bw_ref=max(FLEET_BW) * unit,
                          obs_spec=fleet.obs_spec, interval=interval,
                          deterministic=True, device="cuda")
    t0 = time.monotonic()
    try:
        trace = ctl.run(link, interval=interval,
                        max_steps=int(FLEET_LIVE_S / interval))
        live_wall = time.monotonic() - t0
        per_flow = [e.bytes_written() for e in engines]
        done = [e.done() for e in engines]
    finally:
        link.close()
    moved = sum(per_flow)
    print(f"[fleet live] {len(trace)} control intervals in {live_wall:.2f} s: "
          f"{moved / MB:.2f} MB moved = {moved / live_wall / MB:.3f} MB/s "
          f"(link {max(FLEET_BW) * unit / MB:.0f} MB/s); per flow MB "
          f"{[round(b / MB, 2) for b in per_flow]}; done {done}; final "
          f"threads {trace[-1][1] if trace else None}; "
          f"{ctl.fleet_policy.n_dispatch} policy dispatches")
    if moved == 0 or ctl.fleet_policy.n_dispatch == 0:
        fail("the live fleet moved no bytes under the port's controller")
    return dict(res=res, cfg=cfg, rounds=rounds,
                train_launches=train_launches, eval_launches=eval_launches,
                evals=evals, bar=bar)


def fleet_episode(torch, dev, *, n_envs, n_flows, seed, objectives):
    """One fleet episode batch (rollout + updates) from explicit draws:
    initial threads, start times and action noise made with NumPy, the
    workload drawn on ``dev``. Returns (rewards, {name: param})."""
    from repro_torch.core import OBJECTIVE_OBS
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import sample_fleet_batch
    cfg = fleet_config(dev, episodes=n_envs, n_envs=n_envs, n_flows=n_flows,
                       seed=seed, obs_spec=OBJECTIVE_OBS if objectives
                       else None)
    wl = sample_fleet_batch(n_envs, n_flows, seed=seed, horizon=FLEET_HORIZON,
                            base_tpt=FLEET_TPT, base_bw=FLEET_BW,
                            objective_mix=True if objectives else None,
                            device=dev)
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    draws = dict(threads0=to(rng.integers(1, 16, (n_envs, n_flows, 3))),
                 t0_draw=to(rng.random(n_envs)),
                 noise=to(rng.normal(size=(cfg.max_steps, n_envs, n_flows,
                                           3))))
    fn = _make_episode_fn(fleet_params(dev), cfg, randomize_t0=True)
    state, rew, _ = fn(init_agent(cfg), wl.tables, None, flows=wl.flows,
                       objectives=wl.objectives if objectives else None,
                       **draws)
    return rew.cpu(), {n: t.detach().cpu() for n, t in
                       state["params"].named_parameters()}


def phase_fleet_scale(torch):
    """9. One fleet episode batch on the card against the CPU (4 envs x 4
    flows, objectives off and on), fleet_step at SCALE_FLOWS flows dense and
    compact, and a profile of one fleet episode batch at FLEET_ENVS."""
    from repro_torch.core.fleet import (FleetState, FlowSchedule, fleet_step,
                                        flow_bucket, max_concurrent_flows)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios.families import poisson_arrivals
    for objectives in (False, True):
        out = {d: fleet_episode(torch, d, n_envs=4, n_flows=4, seed=5,
                                objectives=objectives)
               for d in ("cuda", "cpu")}
        err_rew = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        err_par = max(float((out["cuda"][1][n] - out["cpu"][1][n]).abs().max())
                      for n in out["cpu"][1])
        print(f"[fleet agree] card vs CPU, one fleet episode batch (4 envs "
              f"x 4 flows, objectives {objectives}): rewards {err_rew:.3g}, "
              f"params {err_par:.3g}")
        if not (err_rew <= 1e-4 and err_par <= 1e-4):
            fail("the card's fleet episode disagrees with the CPU's")

    F = SCALE_FLOWS
    params = fleet_params("cuda")
    ts, te = poisson_arrivals(F, FLEET_HORIZON, seed=7, hold_frac=0.01)
    flows = FlowSchedule(*(torch.from_numpy(x)[None].cuda()
                           for x in (ts, te)))
    A = min(flow_bucket(max_concurrent_flows(flows, window=1.0)), F)
    zeros = torch.zeros((1, F, 3), device="cuda")
    state0 = FleetState(buffers=torch.zeros((1, F, 2), device="cuda"),
                        threads=torch.full((1, F, 3), 8.0, device="cuda"),
                        throughputs=zeros, t=torch.zeros(1, device="cuda"),
                        prev_throughputs=zeros,
                        delivered=torch.zeros((1, F), device="cuda"))
    acts = torch.full((1, F, 3), 8.0, device="cuda")
    scale = {}
    for name, ma in (("dense", None), ("compact", A)):
        st = state0
        for _ in range(3):   # warm-up; the clock moves into the arrivals
            st, _, rew = fleet_step(params, st, acts, flows=flows,
                                    max_active=ma)
        first = (st, rew)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SCALE_ITERS):
            st, _, rew = fleet_step(params, st, acts, flows=flows,
                                    max_active=ma)
        torch.cuda.synchronize()
        scale[name] = ((time.perf_counter() - t0) / SCALE_ITERS * 1e3, first)
    (d_st, d_rew), (c_st, c_rew) = scale["dense"][1], scale["compact"][1]
    err_tps = float((d_st.throughputs - c_st.throughputs).abs().max())
    err_rew = float((d_rew - c_rew).abs().max() / d_rew.abs().clamp_min(1))
    print(f"[fleet scale] fleet_step at F={F} (Poisson, hold_frac 0.01, "
          f"seed 7): dense {scale['dense'][0]:.3f} ms/step, compact "
          f"A={A} {scale['compact'][0]:.3f} ms/step = "
          f"{scale['dense'][0] / scale['compact'][0]:.2f}x; dense vs "
          f"compact throughputs {err_tps:.3g}, reward (relative) "
          f"{err_rew:.3g}")
    if not (err_tps <= 2e-5 and err_rew <= 1e-5):
        fail("the compact fleet step disagrees with the dense one")
    cfg = fleet_config("cuda", episodes=FLEET_ENVS, n_envs=FLEET_ENVS,
                       n_flows=FLEET_FLOWS)
    wl = fleet_draw(FLEET_ENVS)(0)
    fn = _make_episode_fn(params, cfg, randomize_t0=True)
    state = init_agent(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    prof = profile_round(torch, lambda: fn(state, wl.tables, gen,
                                           flows=wl.flows),
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[fleet profile] n_envs={FLEET_ENVS} x {FLEET_FLOWS} flows: "
          + json.dumps(prof))
    return dict(A=A, dense_ms=scale["dense"][0],
                compact_ms=scale["compact"][0], profile=prof)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.sim_step import ops
    from repro_torch.kernels.sim_step.ref import (sim_interval_reference,
                                                  sim_step_reference)
    from repro_torch.core import (PPOConfig, train_ppo, make_env_params,
                                  SimEnv, explore, AutoMDTController)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.transfer import (TransferEngine, SyntheticSource,
                                      ChecksumSink, StageThrottle)

    # parity is held in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[device] {card}; SM clock now, max: {clocks}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sys.version.split()[0]}")

    # --- 2. build -----------------------------------------------------------
    t0 = time.monotonic()
    nvcc_s = build.build_all()
    print(f"[build] nvcc seconds per source (started together): "
          f"{json.dumps(nvcc_s)}; phase {time.monotonic() - t0:.2f} s")
    for name in build.SOURCES:
        for line in build.build_log.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}")

    # --- 3. kernel parity and times ------------------------------------------
    S = 50
    shapes = {}
    for E in (1, 32, 16384):   # probes, training, a wide batch
        bufs, rates_dt, cap, _ = sim_inputs(torch, E, S, seed=E)
        got = ops.sim_interval_batch(bufs, rates_dt, cap)
        torch.cuda.synchronize()
        err = max_err(got, sim_interval_reference(bufs, rates_dt, cap))
        if not err <= 1e-5:
            fail(f"sim_interval E={E}: max abs err {err} > 1e-5")
        n_bytes = 4 * (E * 4 + E * S * 3 + E * 5)
        b_ms, b_by, terms = bound_ms(n_bytes, SIM_OPS_PER_SUBSTEP * E * S,
                                     SIM_CHAIN_OPS_PER_SUBSTEP * S)
        shapes[("sim_interval", E)] = dict(
            E=E, S=S, max_abs_err=err,
            ms=time_ms(torch, lambda: ops.sim_interval_batch(bufs, rates_dt,
                                                             cap)),
            device_ms=device_ms(torch, lambda: ops.sim_interval_batch(
                bufs, rates_dt, cap), "sim_interval_kernel"),
            plain_ms=time_ms(torch, lambda: sim_interval_reference(
                bufs, rates_dt, cap), samples=5, inner=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
            library_ms=None)
    E = 16384
    bufs, _, cap, rate = sim_inputs(torch, E, S, seed=E + 1)
    got = ops.sim_step_batch(bufs, rate, cap, substeps=S)
    torch.cuda.synchronize()
    err = max_err(got, sim_step_reference(bufs, rate, cap, substeps=S))
    if not err <= 1e-4:
        fail(f"sim_step E={E}: max abs err {err} > 1e-4")
    # rate * dt is off the chain: it does not wait on the buffers
    b_ms, b_by, terms = bound_ms(4 * (E * 7 + E * 5),
                                 (SIM_OPS_PER_SUBSTEP + 3) * E * S,
                                 SIM_CHAIN_OPS_PER_SUBSTEP * S)
    shapes[("sim_step", E)] = dict(
        E=E, S=S, max_abs_err=err,
        ms=time_ms(torch, lambda: ops.sim_step_batch(bufs, rate, cap,
                                                     substeps=S)),
        device_ms=device_ms(torch, lambda: ops.sim_step_batch(
            bufs, rate, cap, substeps=S), "sim_interval_kernel"),
        plain_ms=time_ms(torch, lambda: sim_step_reference(
            bufs, rate, cap, substeps=S), samples=5, inner=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, bound_terms=terms, library_ms=None)
    for (name, E), row in shapes.items():
        print(f"[parity] {name} E={E} S={S}: max_abs_err={row['max_abs_err']:.3g} "
              f"ms={row['ms']:.5f} device_ms={row['device_ms']} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']}; {json.dumps(row['bound_terms'])})")

    # --- 4. main path: explore -> PPO -> live control -----------------------
    reset_launches()
    params = make_env_params(tpt=[0.08, 0.16, 0.2], bw=[1.0, 1.0, 1.0],
                             cap=[2.0, 2.0], n_max=40, device="cuda")
    env = SimEnv(params, seed=0)
    env.reset()
    ex = explore(env.probe, n_samples=150, n_max=40, seed=0)
    print(f"[explore] B={ex.bandwidth.round(4)} TPT={ex.tpt.round(4)} "
          f"b={ex.bottleneck:.4f} n*={ex.n_star_int()} R_max={ex.r_max:.4f}")
    cfg = PPOConfig(max_episodes=2000, n_envs=32, action_scale=10.0, seed=0,
                    device="cuda")
    res = train_ppo(params, cfg, r_max=ex.r_max)
    torch.cuda.synchronize()
    rounds = res.episodes // cfg.n_envs
    frac = res.best_reward / (ex.r_max * cfg.max_steps)
    print(f"[train] {res.episodes} episodes ({rounds} rounds of "
          f"{cfg.n_envs} envs) in {res.wall_s:.3f} s = "
          f"{res.episodes / res.wall_s:.1f} episodes/s; best reward "
          f"{res.best_reward:.4f} = {frac:.4f} of R_max*{cfg.max_steps}; "
          f"converged at {res.converged_at}")
    if not np.isfinite(res.best_reward) or frac <= 0.5:
        fail(f"training reached only {frac:.3f} of R_max")

    ctl = AutoMDTController(res.params["policy"], n_max=32,
                            bw_ref=float(ex.bandwidth.max()),
                            deterministic=True, device="cuda")
    src = SyntheticSource(24 * MB, chunk_bytes=128 * 1024)
    sink = ChecksumSink()
    eng = TransferEngine(
        src, sink, sender_buf=4 * MB, receiver_buf=4 * MB,
        throttles=(StageThrottle(10 * MB, int(0.8 * MB)),
                   StageThrottle(10 * MB, int(1.6 * MB)),
                   StageThrottle(10 * MB, int(2.0 * MB))),
        initial_concurrency=(1, 1, 1), n_max=32, metric_interval=0.3)
    t0 = time.monotonic()
    try:
        while not eng.done() and time.monotonic() - t0 < 15.0:
            eng.set_concurrency(ctl.step(eng.observe()))
            time.sleep(0.3)
        live_s = time.monotonic() - t0
        threads = eng.concurrency()
    finally:
        eng.close()
    print(f"[live] {sink.nbytes / MB:.2f} MB in {live_s:.2f} s = "
          f"{sink.nbytes / live_s / MB:.3f} MB/s; final threads {threads}; "
          f"{ctl.n_dispatch} policy dispatches; done={eng.done()}")
    if sink.nbytes == 0 or ctl.n_dispatch == 0:
        fail("the live engine moved no bytes under the port's controller")

    launches = read_launches()
    expected = 1 + 150 + rounds * (cfg.max_steps + 1)
    print(f"[launches] main path: {json.dumps(launches)}; sim_interval "
          f"expected 1 reset + 150 probes + {rounds} rounds x "
          f"{cfg.max_steps + 1} = {expected}")
    if launches["sim_interval"] != expected:
        fail(f"sim_interval launched {launches['sim_interval']} times on "
             f"the main path, expected {expected}")

    # --- 5. agreement with the plain path on the CPU --------------------------
    cpu_params = make_env_params(tpt=[0.08, 0.16, 0.2], bw=[1.0, 1.0, 1.0],
                                 cap=[2.0, 2.0], n_max=40, device="cpu")
    cpu_env = SimEnv(cpu_params, seed=0)
    cpu_env.reset(threads=[4.0, 4.0, 4.0])
    env.reset(threads=[4.0, 4.0, 4.0])
    ex_gpu = explore(env.probe, n_samples=40, n_max=40, seed=1)
    ex_cpu = explore(cpu_env.probe, n_samples=40, n_max=40, seed=1)
    err_explore = float(np.abs(np.asarray([r[1] for r in ex_gpu.log])
                               - np.asarray([r[1] for r in ex_cpu.log])).max())
    small = PPOConfig(max_episodes=8, n_envs=8, action_scale=10.0, seed=3)
    rng = np.random.default_rng(3)
    threads0 = torch.from_numpy(rng.integers(1, 16, (8, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(10, 8, 3)).astype(np.float32))
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        state = init_agent(dataclasses.replace(small, device=dev))
        fn = _make_episode_fn(p, small, randomize_t0=False)
        state, rew, _ = fn(state, None, threads0=threads0.to(dev),
                           noise=noise.to(dev))
        out[dev] = (rew.cpu(), {n: t.detach().cpu() for n, t in
                                state["params"].named_parameters()})
    err_rew = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    err_par = max(float((out["cuda"][1][n] - out["cpu"][1][n]).abs().max())
                  for n in out["cpu"][1])
    print(f"[agree] card vs CPU: explore throughputs max abs err "
          f"{err_explore:.3g}; one episode batch (8 envs, 4 updates): "
          f"rewards {err_rew:.3g}, params {err_par:.3g}")
    if not (err_explore <= 1e-5 and err_rew <= 1e-4 and err_par <= 1e-4):
        fail("the card's main path disagrees with the CPU's")

    # --- 6. scale: three episode batches at 4096 envs; where a round goes ---
    big = PPOConfig(max_episodes=3 * 4096, n_envs=4096, action_scale=10.0,
                    seed=0, device="cuda")
    res_big = train_ppo(params, big)
    torch.cuda.synchronize()
    print(f"[scale] n_envs=4096: {res_big.episodes} episodes in "
          f"{res_big.wall_s:.3f} s = {res_big.episodes / res_big.wall_s:.1f} "
          f"episodes/s ({res_big.wall_s / 3 * 1e3:.1f} ms per round)")
    if not np.isfinite(res_big.best_reward):
        fail("non-finite reward at 4096 envs")
    for n_envs in (32, 4096):
        prof_cfg = dataclasses.replace(cfg, n_envs=n_envs)
        fn = _make_episode_fn(params, prof_cfg, randomize_t0=False)
        state = init_agent(prof_cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        print(f"[profile] n_envs={n_envs}: " + json.dumps(profile_round(
            torch, lambda: fn(state, None, gen), ("sim_interval_kernel",))))

    # --- 7. contention kernel parity and times --------------------------------
    k3 = phase_contention(torch)
    # --- 8. the fleet's main path: train -> evaluate -> live control ---------
    fl = phase_fleet(torch)
    # --- 9. fleet agreement with the CPU, scale-out, profile ------------------
    phase_fleet_scale(torch)

    kernels = []
    for name, line, E in (("sim_interval", 54, 32), ("sim_step", 24, 16384)):
        row = shapes[(name, E)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sim_step.cu",
            "replaces": f"src/repro/kernels/sim_step/kernel.py:{line}",
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "E": E, "S": S,
            "device_ms": row["device_ms"], "bound_terms": row["bound_terms"],
        })
    for E in (1, 16384):
        kernels[0][f"at_E{E}"] = {k: shapes[("sim_interval", E)][k] for k in
                                  ("max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "bound_terms")}
    kernels[0]["launches_fleet"] = fl["train_launches"]["sim_interval"]
    row = k3["fleet"]
    kernels.append({
        "name": "contention", "route": "cuda",
        "source": "src/repro_torch/csrc/contention.cu",
        "replaces": "src/repro/kernels/contention/kernel.py:37",
        "launches": fl["train_launches"]["contention"],
        "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "E": row["E"], "S": row["S"], "F": row["F"],
        "device_ms": row["device_ms"], "bound_terms": row["bound_terms"],
        "launches_eval": fl["eval_launches"]["contention"],
    })
    for name, r in k3.items():
        if name != "fleet":
            kernels[-1][f"at_{name}"] = {
                k: r[k] for k in ("E", "S", "F", "L", "rounds", "objectives",
                                  "max_abs_err", "ms", "device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bound_terms")}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
