"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA H100 (sm_90a) and
the CUDA toolkit. It builds the port's CUDA kernels from ``src/repro_torch/
csrc`` and drives the paper's loop through the port's entry points:

  1. device     the card's name and power limit (nvidia-smi)
  2. build      nvcc builds the kernel library from csrc/sim_step.cu
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


def profile_round(torch, fn, state, params):
    """One episode batch (rollout + updates): its wall time unprofiled, and
    under torch.profiler the device's kernel time, kernel count and the
    sim kernel's share."""
    from torch.profiler import profile, ProfilerActivity
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fn(state, None, gen)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(state, None, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(state, None, gen)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    sim_ms = sum(e.self_device_time_total for e in kern
                 if "sim_interval_kernel" in e.key) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return {"round_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kern),
            "sim_kernel_ms": sim_ms,
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
    nvcc_s = build.build("sim_step")
    print(f"[build] sim_step.cu: nvcc {nvcc_s} s, phase "
          f"{time.monotonic() - t0:.2f} s")
    for line in build.build_log.get("sim_step", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] sim_step: {line.strip()}")

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
    ops.sim_interval_batch.launches = 0
    ops.sim_step_batch.launches = 0
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

    launches = {"sim_interval": ops.sim_interval_batch.launches,
                "sim_step": ops.sim_step_batch.launches}
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
        print(f"[profile] n_envs={n_envs}: " + json.dumps(
            profile_round(torch, fn, init_agent(prof_cfg), params)))

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
