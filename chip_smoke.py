"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA H100 (sm_90a) and
the CUDA toolkit. It builds the port's CUDA kernels from ``src/repro_torch/
csrc`` and drives the paper's loop and the multi-flow fleet through the
port's entry points:

  1. device     the card's name and power limit (nvidia-smi)
  2. build      nvcc builds the kernel libraries from csrc/*.cu (sim_step,
                contention, flash_attention, ssd_scan), one nvcc each,
                started together; the SASS of K4's and K5's bf16 kernels
                must hold tensor-core instructions (HMMA/HGMMA) and
                asynchronous copies (LDGSTS/UTMALDG); every K1 and K3
                instance's registers, shared memory and spills (ptxas),
                and no spill in any of them
  3. parity     the sim kernels (K1, K2) against their plain PyTorch
                version on the same CUDA tensors, bitwise, at the main
                path's shapes (1 env for the probes, 32 for training, 4096
                for phase 6) and at 16384 envs; kernel, plain and bound
                times
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
                compact), a topology shape (3 links, 8 water-fill rounds),
                2 links with 33 flows and 33 rounds, and 2100 flows on 4
                links, more than a cluster of blocks holds on chip; the
                same bits from two launches; kernel, device, plain and
                bound times
  8. fleet      bench_fleet.py's configuration (4 flows, 16 envs, 1500
                episodes, domain-randomized arrivals) trained on the card,
                the shared policy and the static baseline scored on three
                arrival families, then FleetController steering four live
                engines on one SharedLink; both kernels' launch counts
  9. fleet agreement and scale: one fleet episode batch on the card
                against the CPU, fleet_step at 4096 flows dense and
                compact, and a profile of one fleet episode batch
 10. attention  the flash-attention kernel against its plain version at
                smollm-135m's prefill shape (bf16 and float32), a ragged S,
                a sliding window and D=128; kernel, device, plain, library
                (scaled_dot_product_attention, timed only) and bound times,
                and at each bf16 shape the first design's (the float32
                route on the same inputs), which the bf16 kernel must beat
                at the path's shape
 11. serving    repro_torch.launch.serve at the full smollm-135m config
                with attn_backend="pallas" (8 prompts of 1024 tokens, 32
                greedy tokens each): prefill s, decode tokens/s, the
                kernel's launches (one per layer per prefill, none in
                decode); finite logits, agreement with the 'full' backend,
                decode against a longer prefill, and a profile of one
                prefill and one decode step
 12. ssd scan   the SSD chunked-scan kernel against its plain version at
                mamba2-1.3b's prefill shape (bf16 and float32), a ragged S,
                zamba2-1.2b's mixer shape and a grouped shape; y and final
                state errors, kernel, device, plain and bound times, and at
                each bf16 shape the first design's (the float32 route),
                which the bf16 kernel must beat at the path's shape
 13. mamba2     repro_torch.launch.serve at the full mamba2-1.3b config (8
                prompts of 1024 tokens, 32 greedy tokens each): the scan
                kernel launched once per layer in the prefill and never in
                decode; finite logits, agreement with a prefill through the
                plain scan, decode against a longer prefill, and a profile
                of one prefill and one decode step

It prints its findings on earlier lines, one JSON line with every kernel's
numbers, the nvidia-smi line, and ends with the line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Without CUDA, or without the repository beside it, it fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
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
# K4 (flash attention) shapes, name: (B, S, Hq, Hkv, D, window, dtype):
# smollm-135m's prefill in phase 11 (8 prompts of 1024 tokens, 9 q heads
# over 3 kv heads, head dim 64) in bf16 and in float32, a ragged S, a
# sliding window of 256 at S=2048, and D=128 with 32 q over 8 kv heads.
FA_SHAPES = {
    "smollm_bf16": (8, 1024, 9, 3, 64, None, "bfloat16"),
    "smollm_f32": (8, 1024, 9, 3, 64, None, "float32"),
    "ragged": (8, 1000, 9, 3, 64, None, "bfloat16"),
    "window": (8, 2048, 9, 3, 64, 256, "bfloat16"),
    "d128": (2, 2048, 32, 8, 128, None, "bfloat16"),
}
# kernel vs plain version. float32: the same float32 arithmetic summed in
# another order. bf16: the tensor-core route rounds each weight p to bf16
# (2^-9 relative) and sums l from the rounded weights, which moves the
# output by at most 2^-9 max|v| = 0.009 at |v| <= 4.5, and the output
# itself rounds to bf16 (one ulp, 0.0156, at |o| < 4); both fit in 2e-2
# (tests/test_torch_tc_rounding.py holds an emulation of these roundings
# against the reference at this limit)
FA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# phase 11: smollm-135m at full width, the reference serve's greedy loop
SERVE_ARCH = "smollm-135m"
SERVE_BATCH = 8
SERVE_PROMPT = 1024
SERVE_GEN = 32
SERVE_SEED = 0
# bf16 logits of two paths through 30 layers: the reference's own bf16
# prefill/decode consistency test (tests/test_models_smoke.py) allows
# atol 0.15 and rtol 0.15; the 'pallas' and 'full' backends differ by
# design (K4 rounds each weight against its tile's running max and
# divides by l once, 'full' rounds the normalized probabilities to bf16),
# and over 30 layers by more than the 5e-2 the 4-layer SMOKE tests allow
# (0.071 at this phase's shapes on an H100 with the first K4 design)
SERVE_ATOL = 0.15
SERVE_RTOL = 0.15
# K5 (SSD chunked scan) shapes, name: (b, s, h, p, g, n, dtype): mamba2-1.3b's
# prefill in phase 13 (8 prompts of 1024 tokens, 64 heads of 64, one B/C
# group, state 128) in bf16 and float32, a ragged S, zamba2-1.2b's mixer
# (state 64), and 4 B/C groups over 8 heads
SSD_SHAPES = {
    "mamba2_bf16": (8, 1024, 64, 64, 1, 128, "bfloat16"),
    "mamba2_f32": (8, 1024, 64, 64, 1, 128, "float32"),
    "ragged": (8, 1000, 64, 64, 1, 128, "bfloat16"),
    "zamba2": (8, 1024, 64, 64, 1, 64, "bfloat16"),
    "grouped": (8, 1024, 8, 64, 4, 128, "bfloat16"),
}
SSD_CHUNK = 128
# the reference's own SSD tolerances (tests/test_kernels.py), as atol and
# rtol: the same float32 math summed in another order; in bf16 y rounds
# once from float32 in both, and the tensor-core route also rounds three
# derived operands to bf16 (C B^T .* L * dt, x * decay * dt, h's copy; an
# emulation in tests/test_torch_tc_rounding.py holds them within this
# limit against the reference)
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase 13: mamba2-1.3b at full width, the same greedy loop as phase 11;
# its logit checks use the reference's bf16 model tolerance (SERVE_ATOL,
# SERVE_RTOL)
SSM_ARCH = "mamba2-1.3b"
# K5 against the plain scan over the whole 48-layer bf16 prefill: a bf16
# rounding of y that flips with the float32 summation order (one or two
# ulps, a layer's y within 0.11 of SSD_TOL) compounds through the layers,
# so two plain versions of the same function differ by as much: this
# phase's plain scan at chunk 64 and at chunk 128 gave logits 0.183 apart
# (mean 0.031, greedy tokens agreeing on 7 of 8 rows) where K5 and the
# plain scan gave 0.182 (mean 0.031, 8 of 8; an H100 at 700 W). The kernel
# is held per layer on the path's own activations at SSD_TOL; the logits
# within twice SERVE_ATOL, and the greedy token within SERVE_ATOL +
# SERVE_RTOL of the top logit
SSM_E2E_ATOL = 2 * SERVE_ATOL
# device kernel names: every kernel of a library carries its prefix (the
# float32 and bf16 routes alike); the main paths run the bf16 kernels
FA_PREFIX, FA_PATH_KERNEL = "flash_attention_", "flash_attention_bf16_kernel"
SSD_PREFIX, SSD_PATH_KERNEL = "ssd_scan_", "ssd_scan_bf16_kernel"


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


def device_ms(torch, fn, kernel_prefix, n=20):
    """The device time of one ``fn()`` call from torch.profiler, over ``n``
    calls: each device kernel whose name carries ``kernel_prefix`` adds its
    time per recorded launch, so a kernel split into parts (one launch of
    each per call), or named apart by its template, counts whole. Per
    recorded launch, not per call: late in this script's run the profiler
    drops the first launches of a window (7 of 10 recorded, on an H100),
    and a sum over calls would count the dropped ones as free. None where
    the profiler records no device time for it."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_call = sum(evt.device_time_total / evt.count
                   for evt in prof.key_averages()
                   if kernel_prefix in evt.key and evt.count
                   and evt.device_time_total)
    return per_call / 1e3 if per_call else None


def sass_counts(lib_path):
    """Per kernel function of a built library: its tensor-core instructions
    (HMMA for mma.sync, HGMMA for wgmma) and asynchronous copies into shared
    memory (LDGSTS for cp.async, UTMALDG for TMA), counted in the SASS that
    ``cuobjdump -sass`` prints."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"mma": 0, "async_copy": 0}
        elif fn is not None:  # the hex encodings hold no such word
            counts[fn]["mma"] += ("HMMA" in line) or ("HGMMA" in line)
            counts[fn]["async_copy"] += ("LDGSTS" in line) or ("UTMALDG" in line)
    return counts


def ptxas_report(log):
    """Per entry function of one nvcc build's ``-Xptxas -v`` output: its
    registers, static shared memory and spill bytes, names demangled with
    cu++filt where the toolkit has it."""
    rows, cur, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            rows[cur] = dict(function=cur, registers=None, smem_bytes=0,
                             spill_stores=0, spill_loads=0)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in rows:
            rows[props]["spill_stores"] = int(m.group(1))
            rows[props]["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in rows:
            rows[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[cur]["smem_bytes"] = int(sm.group(1)) if sm else 0
    from repro_torch.kernels import build
    filt = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    if rows and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(rows), text=True,
                               capture_output=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows.values(), names):
                r["function"] = name.replace("(anonymous namespace)::", "")
    return list(rows.values())


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


def fa_bound(B, S, Hq, Hkv, D, window, dtype):
    """K4's bound at one shape: q, k, v read once and o written once over
    the memory rate, and the live (causal, windowed) score and PV products,
    4 * D operations per live (query, key) pair of each head, over the
    peak rate of the inputs' type (bf16 tensor cores; float32 outside
    them, the rate at which float32 keeps its precision)."""
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = esize * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    w = min(window or S, S)
    live = w * (w + 1) // 2 + (S - w) * w
    n_ops = 4 * B * Hq * D * live
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    terms = {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": n_ops / rate * 1e3, "gflop": n_ops / 1e9,
             "mbytes": n_bytes / 1e6}
    by = "bytes" if terms["bytes_ms"] >= terms["ops_ms"] else "operations"
    return max(terms["bytes_ms"], terms["ops_ms"]), by, terms


def ssd_bound(b, s, h, p, g, n, dtype, chunk=SSD_CHUNK):
    """K5's bound at one shape: x, B, C, dt and A read once, y and the final
    state written once, over the memory rate; and the live products of
    this length over the peak rate of the inputs' type (bf16 tensor cores;
    float32 outside them): C B^T once per (batch, group, chunk) on its
    lower triangle, the masked product with x * dt on the lower triangle,
    C h^T past the first chunk (h is zero there) and the state update, 2
    operations a multiply-add."""
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = (esize * (2 * b * s * h * p + 2 * b * s * g * n)
               + 4 * (b * s * h + h + b * h * p * n))
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    tri = sum(q * (q + 1) // 2 for q in lens)
    n_ops = 2 * (b * g * tri * n + b * h * tri * p
                 + b * h * (s - lens[0]) * n * p + b * h * s * p * n)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    terms = {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": n_ops / rate * 1e3, "gflop": n_ops / 1e9,
             "mbytes": n_bytes / 1e6}
    by = "bytes" if terms["bytes_ms"] >= terms["ops_ms"] else "operations"
    return max(terms["bytes_ms"], terms["ops_ms"]), by, terms


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


def phase_sim(torch):
    """3. K1 (sim_interval) at the main path's env counts (1 for the
    probes, 32 for training, 4096 for phase 6) and at 16384, and K2
    (sim_step) at 16384, against the plain version: bitwise, with kernel
    (CUDA events), device (profiler), plain and bound times. Returns (S,
    {(name, E): row})."""
    from repro_torch.kernels.sim_step import ops
    from repro_torch.kernels.sim_step.ref import (sim_interval_reference,
                                                  sim_step_reference)
    S = 50
    shapes = {}
    for E in (1, 32, 4096, 16384):   # probes, training, phase 6, wide
        bufs, rates_dt, cap, _ = sim_inputs(torch, E, S, seed=E)
        kern = lambda: ops.sim_interval_batch(bufs, rates_dt, cap)
        plain = lambda: sim_interval_reference(bufs, rates_dt, cap)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = max_err(got, want)
        if not err <= 1e-5:
            fail(f"sim_interval E={E}: max abs err {err} > 1e-5")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"sim_interval E={E}: not bitwise equal to the plain "
                 f"version")
        n_bytes = 4 * (E * 4 + E * S * 3 + E * 5)
        b_ms, b_by, terms = bound_ms(n_bytes, SIM_OPS_PER_SUBSTEP * E * S,
                                     SIM_CHAIN_OPS_PER_SUBSTEP * S)
        shapes[("sim_interval", E)] = dict(
            E=E, S=S, max_abs_err=err, ms=time_ms(torch, kern),
            device_ms=device_ms(torch, kern, "sim_interval_kernel"),
            plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
            library_ms=None)
    E = 16384
    bufs, _, cap, rate = sim_inputs(torch, E, S, seed=E + 1)
    kern = lambda: ops.sim_step_batch(bufs, rate, cap, substeps=S)
    plain = lambda: sim_step_reference(bufs, rate, cap, substeps=S)
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    err = max_err(got, want)
    if not err <= 1e-4:
        fail(f"sim_step E={E}: max abs err {err} > 1e-4")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"sim_step E={E}: not bitwise equal to the plain version")
    # rate * dt is off the chain: it does not wait on the buffers
    b_ms, b_by, terms = bound_ms(4 * (E * 7 + E * 5),
                                 (SIM_OPS_PER_SUBSTEP + 3) * E * S,
                                 SIM_CHAIN_OPS_PER_SUBSTEP * S)
    shapes[("sim_step", E)] = dict(
        E=E, S=S, max_abs_err=err, ms=time_ms(torch, kern),
        device_ms=device_ms(torch, kern, "sim_interval_kernel"),
        plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, bound_terms=terms, library_ms=None)
    for (name, E), row in shapes.items():
        print(f"[parity] {name} E={E} S={S}: max_abs_err={row['max_abs_err']:.3g} "
              f"(bitwise) ms={row['ms']:.5f} device_ms={row['device_ms']} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']}; {json.dumps(row['bound_terms'])})")
    return S, shapes


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
# hold_frac 0.01: a few percent live) and its compact A = 256 slice, a
# topology-shaped solve (3 links, F water-fill rounds, with objectives),
# 2 links with F = 33 rounds (the first flow count past a lane group), and
# 2100 flows on 4 links, past the 2048 a cluster of 8 blocks holds on chip
# there (each thread walks its flows, and the water-fill carries prefixes).
CONTENTION_SHAPES = {
    "fleet": (16, 50, 4, 1, 0, False, 0.8),
    "fleet_objectives": (16, 50, 4, 1, 0, True, 0.8),
    "scale_dense": (1, 50, 4096, 1, 0, False, 0.05),
    "scale_compact": (1, 50, 256, 1, 0, False, 0.8),
    "topology": (4, 50, 8, 3, 8, True, 0.8),
    "two_links": (4, 50, 33, 2, 33, True, 0.8),
    "many_flows": (1, 50, 2100, 4, 8, True, 0.8),
}


def phase_contention(torch):
    """7. K3 against its plain version at every shape of CONTENTION_SHAPES,
    bit-identical across two launches, with kernel (CUDA events), device
    (profiler), plain and bound times."""
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
        again = kern()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        if not err <= 2e-5:
            fail(f"contention {name}: max abs err {err} > 2e-5")
        if not torch.equal(got, again):
            fail(f"contention {name}: two launches gave different bits")
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
              f"{json.dumps(terms)}) library_ms=null; bitwise across two "
              f"launches")
    return rows


def reset_launches():
    from repro_torch.kernels.sim_step import ops as sim_ops
    from repro_torch.kernels.contention import ops as k3_ops
    from repro_torch.kernels.flash_attention import ops as k4_ops
    from repro_torch.kernels.ssd_scan import ops as k5_ops
    sim_ops.sim_interval_batch.launches = 0
    sim_ops.sim_step_batch.launches = 0
    k3_ops.contention_rates.launches = 0
    k4_ops.flash_attention.launches = 0
    k5_ops.ssd_scan.launches = 0


def read_launches():
    from repro_torch.kernels.sim_step import ops as sim_ops
    from repro_torch.kernels.contention import ops as k3_ops
    from repro_torch.kernels.flash_attention import ops as k4_ops
    from repro_torch.kernels.ssd_scan import ops as k5_ops
    return {"sim_interval": sim_ops.sim_interval_batch.launches,
            "sim_step": sim_ops.sim_step_batch.launches,
            "contention": k3_ops.contention_rates.launches,
            "flash_attention": k4_ops.flash_attention.launches,
            "ssd_scan": k5_ops.ssd_scan.launches}


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


def phase_attention(torch):
    """10. K4 against its plain version at every shape of FA_SHAPES, with
    kernel (CUDA events), device (profiler), plain, library and bound
    times. The library call, scaled_dot_product_attention, is timed as a
    yardstick only: the port never calls it."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_reference
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for i, (name, (B, S, Hq, Hkv, D, window, dtype)) in enumerate(
            FA_SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(i)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, S, h, D), generator=gen,
                               device="cuda").to(dt)
                   for h in (Hq, Hkv, Hkv))
        kern = lambda: ops.flash_attention(q, k, v, window=window)
        plain = lambda: attention_reference(q, k, v, window=window)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device="cuda")
            band = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))
            lib = lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
        got = kern()
        torch.cuda.synchronize()
        err = float((got.float() - plain().float()).abs().max())
        if not err <= FA_TOL[dtype]:
            fail(f"flash_attention {name}: max abs err {err} > "
                 f"{FA_TOL[dtype]}")
        b_ms, b_by, terms = fa_bound(B, S, Hq, Hkv, D, window, dtype)
        row = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, window=window,
                   dtype=dtype, max_abs_err=err,
                   ms=time_ms(torch, kern, samples=10, inner=10),
                   device_ms=device_ms(torch, kern, FA_PREFIX, n=10),
                   plain_ms=time_ms(torch, plain, samples=5, inner=3,
                                    warmup=1),
                   library_ms=time_ms(torch, lib, samples=10, inner=10),
                   bound_ms=b_ms, bound_by=b_by, bound_terms=terms)
        if dtype == "bfloat16":
            # the first design, which the float32 route keeps, on
            # the same inputs in float32: its time does not depend on dtype
            q32, k32, v32 = (x.float() for x in (q, k, v))
            first = lambda: ops.flash_attention(q32, k32, v32, window=window)
            row.update(first_design_ms=time_ms(torch, first, samples=5,
                                               inner=5),
                       first_design_device_ms=device_ms(torch, first,
                                                        FA_PREFIX, n=5))
        rows[name] = row
        print(f"[attention] {name} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"window={window} {dtype}: max_abs_err={err:.3g} "
              f"ms={row['ms']} device_ms={row['device_ms']} "
              f"first_design_device_ms={row.get('first_design_device_ms')} "
              f"plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
              f"bound_ms={b_ms:.4g} ({b_by}; {json.dumps(terms)}); "
              f"kernel/library {row['ms'] / row['library_ms']:.2f}x, "
              f"kernel/bound {row['ms'] / b_ms:.1f}x")
    faster_than_first(rows["smollm_bf16"], "flash_attention smollm_bf16")
    return rows


def faster_than_first(row, what):
    """Fail unless the bf16 kernel's device time (event time where the
    profiler records none) is below the first design's in the same run."""
    new, old = row["device_ms"], row["first_design_device_ms"]
    if new is None or old is None:
        new, old = row["ms"], row["first_design_ms"]
    if not new < old:
        fail(f"{what}: the bf16 kernel takes {new} ms, the first design "
             f"{old} ms")


def phase_serve(torch):
    """11. LM serving: serve() at the full smollm-135m config with the
    'pallas' backend, counting K4's launches, then checks on the same
    weights (the init is seeded) and prompts: finite logits, the greedy
    token serve() chose, K4 launched once per layer per prefill and never
    in decode, agreement with the 'full' backend, decode against a longer
    prefill, and a profile of one prefill and one decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    cfg = get_config(SERVE_ARCH).replace(attn_backend="pallas")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    reset_launches()
    toks, info = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SERVE_SEED)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[serve] {SERVE_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
          f"{cfg.vocab}, bf16, attn_backend=pallas): {B} prompts x {P} "
          f"tokens, {G} greedy tokens each; prefill {info['prefill_s']:.4f} "
          f"s, decode {info['decode_s']:.4f} s = {info['tok_per_s']:.1f} "
          f"tokens/s; launches {json.dumps(launches)}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"serve returned tokens {tuple(toks.shape)} out of range")
    if launches != {**{k: 0 for k in launches},
                    "flash_attention": cfg.n_layers}:
        fail(f"serving launched {json.dumps(launches)}, expected "
             f"flash_attention = {cfg.n_layers} (one prefill) and no other")

    model = get_model(cfg)
    full = get_model(cfg.replace(attn_backend="full"))
    params = model.init(SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P),
                                           dtype=np.int32)).cuda()
    batch = {"tokens": tokens}
    with torch.inference_mode():
        reset_launches()
        logits, cache = model.prefill(params, batch,
                                      model.init_cache(B, P + G))
        torch.cuda.synchronize()
        n_prefill = read_launches()["flash_attention"]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        reset_launches()
        step_logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        n_decode = read_launches()["flash_attention"]
        logits_full, _ = full.prefill(params, batch,
                                      full.init_cache(B, P + G))
        short, c2 = model.prefill(params, {"tokens": tokens[:, :-1]},
                                  model.init_cache(B, P + G))
        consist, _ = model.decode_step(params, c2, tokens[:, -1:])
        torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (logits, step_logits, logits_full, short, consist))
    same_first = bool(torch.equal(tok[:, 0], toks[:, 0]))
    d_full = (logits - logits_full).abs()
    d_step = (consist - logits).abs()
    # argmax agreement, or a near-tie: the step's choice scores within the
    # tolerance of the longer prefill's top logit
    top = logits.max(dim=-1).values
    chosen = logits.gather(1, consist.argmax(dim=-1, keepdim=True))[:, 0]
    step_ok = bool(torch.all(d_step <= SERVE_ATOL + SERVE_RTOL
                             * logits.abs()))
    argmax_ok = bool(torch.all(top - chosen
                               <= SERVE_ATOL + SERVE_RTOL * top.abs()))
    print(f"[serve check] logits finite {finite}; prefill launches "
          f"{n_prefill}, decode step launches {n_decode}; serve's first "
          f"tokens reproduced {same_first}; pallas vs full backend: max abs "
          f"diff {float(d_full.max()):.4g}, mean {float(d_full.mean()):.4g},"
          f" argmax agree {float((logits.argmax(-1) == logits_full.argmax(-1)).float().mean()):.3f}"
          f" (|logit| max {float(logits.abs().max()):.3g}); prefill({P}) vs "
          f"prefill({P - 1}) + decode: max abs diff "
          f"{float(d_step.max()):.4g}, argmax agree "
          f"{float((logits.argmax(-1) == consist.argmax(-1)).float().mean()):.3f}")
    if not finite:
        fail("non-finite logits in serving")
    if n_prefill != cfg.n_layers or n_decode != 0:
        fail(f"flash_attention launched {n_prefill} times in a prefill and "
             f"{n_decode} in a decode step, expected {cfg.n_layers} and 0")
    if not same_first:
        fail("the same weights and prompts did not reproduce serve's first "
             "tokens")
    if not float(d_full.max()) <= SERVE_ATOL:
        fail(f"the pallas and full backends differ by "
             f"{float(d_full.max())} > {SERVE_ATOL}")
    if not (step_ok and argmax_ok):
        fail("a decode step disagrees with the longer prefill")

    def one_prefill():
        with torch.inference_mode():
            model.prefill(params, batch, model.init_cache(B, P + G))

    def one_decode():
        with torch.inference_mode():
            model.decode_step(params, cache, tok)

    prof = {"prefill": profile_round(torch, one_prefill, (FA_PATH_KERNEL,)),
            "decode_step": profile_round(torch, one_decode,
                                         (FA_PATH_KERNEL,))}
    for name, pr in prof.items():
        print(f"[serve profile] {name}: " + json.dumps(pr))
    return dict(info=info, launches=launches, profile=prof,
                max_diff_full=float(d_full.max()),
                max_diff_step=float(d_step.max()))


def ssd_operands(torch, b, s, h, p, g, n, dtype, seed):
    """The reference test's distributions (tests/test_kernels.py): x, B, C
    standard normal in ``dtype``, dt in [0.001, 0.1] and A in [-2, -0.5]
    in float32, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)
    normal = lambda *shape: torch.randn(shape, generator=gen,
                                        device="cuda").to(dt_)
    uniform = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device="cuda")
    return (normal(b, s, h, p), uniform(0.001, 0.1, b, s, h),
            -uniform(0.5, 2.0, h), normal(b, s, g, n), normal(b, s, g, n))


def allclose_ratio(torch, got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 where the
    reference's assert_allclose(atol=tol, rtol=tol) holds."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def phase_ssd(torch):
    """12. K5 against its plain version at every shape of SSD_SHAPES: y and
    final state within the reference's tolerances, kernel (CUDA events),
    device (profiler), plain and bound times. No single PyTorch call
    computes the scan, so there is no library time."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    rows = {}
    for i, (name, (b, s, h, p, g, n, dtype)) in enumerate(SSD_SHAPES.items()):
        args = ssd_operands(torch, b, s, h, p, g, n, dtype, seed=i)
        kern = lambda: ops.ssd_scan(*args, chunk=SSD_CHUNK, return_state=True)
        plain = lambda: ssd_reference(*args, chunk=SSD_CHUNK)
        y, state = kern()
        torch.cuda.synchronize()
        want_y, want_state = plain()
        tol = SSD_TOL[dtype]
        err_y = float((y.float() - want_y.float()).abs().max())
        err_state = float((state - want_state).abs().max())
        ratio = max(allclose_ratio(torch, y, want_y, tol),
                    allclose_ratio(torch, state, want_state, tol))
        if not (ratio <= 1.0 and np.isfinite(err_y)
                and np.isfinite(err_state)):
            fail(f"ssd_scan {name}: y err {err_y}, state err {err_state}, "
                 f"{ratio:.3g} of the tolerance {tol} (atol and rtol)")
        b_ms, b_by, terms = ssd_bound(b, s, h, p, g, n, dtype)
        row = dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=SSD_CHUNK,
                   dtype=dtype, max_abs_err=err_y,
                   max_abs_err_state=err_state, tol_ratio=ratio,
                   max_abs_y=float(want_y.float().abs().max()),
                   ms=time_ms(torch, kern, samples=10, inner=10),
                   device_ms=device_ms(torch, kern, SSD_PREFIX, n=10),
                   plain_ms=time_ms(torch, plain, samples=5, inner=3,
                                    warmup=1),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   bound_terms=terms)
        if dtype == "bfloat16":
            # the first design, which the float32 route keeps, on
            # the same inputs with x, B, C in float32
            x, dt_, A, B, C = args
            args32 = (x.float(), dt_, A, B.float(), C.float())
            first = lambda: ops.ssd_scan(*args32, chunk=SSD_CHUNK,
                                         return_state=True)
            row.update(first_design_ms=time_ms(torch, first, samples=5,
                                               inner=5),
                       first_design_device_ms=device_ms(torch, first,
                                                        SSD_PREFIX, n=5))
        rows[name] = row
        print(f"[ssd] {name} b={b} s={s} h={h} p={p} g={g} n={n} {dtype}: "
              f"y max_abs_err={err_y:.3g} (|y| max {row['max_abs_y']:.3g}), "
              f"state max_abs_err={err_state:.3g}, {ratio:.3g} of the "
              f"tolerance; ms={row['ms']} device_ms={row['device_ms']} "
              f"first_design_device_ms={row.get('first_design_device_ms')} "
              f"plain_ms={row['plain_ms']} bound_ms={b_ms:.4g} ({b_by}; "
              f"{json.dumps(terms)}) library_ms=null; kernel/bound "
              f"{row['ms'] / b_ms:.1f}x, plain/kernel "
              f"{row['plain_ms'] / row['ms']:.2f}x")
    faster_than_first(rows["mamba2_bf16"], "ssd_scan mamba2_bf16")
    return rows


def phase_mamba2(torch):
    """13. Mamba2 serving: serve() at the full mamba2-1.3b config, counting
    K5's launches, then checks on the same weights (the init is seeded)
    and prompts: finite logits, the greedy token serve() chose, K5
    launched once per layer per prefill and never in decode, K5 against
    the plain scan on every layer's own inputs, the logits against a
    prefill through the plain scan (beside the gap between two plain
    scans, at chunk 128 and 64), decode against a longer prefill, and a
    profile of one prefill and one decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.nn.ssd import ssd_chunked
    cfg = get_config(SSM_ARCH)
    layer_ratios = []

    def held_against_plain(x, dt, A, B, C, *, chunk):
        """K5 on a layer's own inputs, held against the plain scan."""
        y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                return_state=True)
        want_y, want_state = ssd_chunked(x, dt, A, B, C, chunk=chunk)
        tol = SSD_TOL[str(x.dtype).split(".")[-1]]
        layer_ratios.append(max(allclose_ratio(torch, y, want_y, tol),
                                allclose_ratio(torch, state, want_state,
                                               tol)))
        return y, state

    def plain_half_chunk(x, dt, A, B, C, *, chunk):
        """The plain scan at half the chunk: the same function, summed in
        another order."""
        return ssd_chunked(x, dt, A, B, C, chunk=chunk // 2)

    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    reset_launches()
    t0 = time.perf_counter()
    toks, info = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SERVE_SEED)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[mamba2] {SSM_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.d_inner // cfg.ssm_headdim} heads of {cfg.ssm_headdim}, "
          f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, "
          f"bf16): {B} prompts x {P} tokens, {G} greedy tokens each; "
          f"prefill {info['prefill_s']:.4f} s, decode {info['decode_s']:.4f}"
          f" s = {info['tok_per_s']:.1f} tokens/s; serve() {serve_s:.2f} s "
          f"with the init; launches {json.dumps(launches)}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"serve returned tokens {tuple(toks.shape)} out of range")
    if launches != {**{k: 0 for k in launches}, "ssd_scan": cfg.n_layers}:
        fail(f"mamba2 serving launched {json.dumps(launches)}, expected "
             f"ssd_scan = {cfg.n_layers} (one prefill) and no other")

    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SERVE_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P),
                                           dtype=np.int32)).cuda()
    batch = {"tokens": tokens}
    with torch.inference_mode():
        reset_launches()
        logits, cache = model.prefill(params, batch,
                                      model.init_cache(B, P + G))
        torch.cuda.synchronize()
        n_prefill = read_launches()["ssd_scan"]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        reset_launches()
        step_logits, _ = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        n_decode = read_launches()["ssd_scan"]
        logits_plain, _ = model.prefill(params, batch,
                                        model.init_cache(B, P + G),
                                        ssd_fn=ssd_chunked)
        logits_half, _ = model.prefill(params, batch,
                                       model.init_cache(B, P + G),
                                       ssd_fn=plain_half_chunk)
        logits_held, _ = model.prefill(params, batch,
                                       model.init_cache(B, P + G),
                                       ssd_fn=held_against_plain)
        short, c2 = model.prefill(params, {"tokens": tokens[:, :-1]},
                                  model.init_cache(B, P + G))
        consist, _ = model.decode_step(params, c2, tokens[:, -1:])
        torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (logits, step_logits, logits_plain, short, consist))
    same_first = bool(torch.equal(tok[:, 0], toks[:, 0]))
    live = slice(0, cfg.vocab)   # the padded rows are -1e30 in both
    d_plain = (logits - logits_plain)[:, live].abs()
    d_half = (logits_half - logits_plain)[:, live].abs()
    d_step = (consist - logits)[:, live].abs()
    tol = SERVE_ATOL + SERVE_RTOL * logits[:, live].abs()
    top = logits.max(dim=-1).values
    near_top = lambda other: bool(torch.all(
        top - logits.gather(1, other.argmax(dim=-1, keepdim=True))[:, 0]
        <= SERVE_ATOL + SERVE_RTOL * top.abs()))
    plain_ratio = float((d_plain / tol).max())
    step_ratio = float((d_step / tol).max())
    step_ok = step_ratio <= 1.0 and near_top(consist)
    plain_ok = (float(d_plain.max()) <= SSM_E2E_ATOL
                and near_top(logits_plain))
    held_same = bool(torch.equal(logits_held, logits))
    agree_half = float((logits_half.argmax(-1) == logits_plain.argmax(-1))
                       .float().mean())
    agree_plain = float((logits.argmax(-1) == logits_plain.argmax(-1))
                        .float().mean())
    agree_step = float((logits.argmax(-1) == consist.argmax(-1))
                       .float().mean())
    print(f"[mamba2 check] init {init_s:.2f} s for {n_params} parameters; "
          f"logits finite {finite}; prefill launches {n_prefill}, decode "
          f"step launches {n_decode}; serve's first tokens reproduced "
          f"{same_first}; K5 vs the plain scan on each layer's inputs: "
          f"at most {max(layer_ratios):.3g} of SSD_TOL over "
          f"{len(layer_ratios)} layers; K5 vs plain-scan prefill: max abs "
          f"diff {float(d_plain.max()):.4g}, mean "
          f"{float(d_plain.mean()):.4g}, {plain_ratio:.3g} of atol+rtol, "
          f"argmax agree {agree_plain:.3f} (|logit| max "
          f"{float(logits[:, live].abs().max()):.3g}); plain scan at chunk "
          f"{cfg.ssm_chunk // 2} vs {cfg.ssm_chunk}: max abs diff "
          f"{float(d_half.max()):.4g}, mean {float(d_half.mean()):.4g}, "
          f"argmax agree {agree_half:.3f}; "
          f"prefill({P}) vs prefill({P - 1}) + decode: max abs diff "
          f"{float(d_step.max()):.4g}, {step_ratio:.3g} of atol+rtol, "
          f"argmax agree {agree_step:.3f}")
    if not finite:
        fail("non-finite logits in mamba2 serving")
    if n_prefill != cfg.n_layers or n_decode != 0:
        fail(f"ssd_scan launched {n_prefill} times in a prefill and "
             f"{n_decode} in a decode step, expected {cfg.n_layers} and 0")
    if not same_first:
        fail("the same weights and prompts did not reproduce serve's first "
             "tokens")
    if len(layer_ratios) != cfg.n_layers or not max(layer_ratios) <= 1.0:
        fail(f"K5 disagrees with the plain scan on a layer's inputs: "
             f"{max(layer_ratios)} of SSD_TOL")
    if not held_same:
        fail("a prefill through K5 held against the plain scan gave other "
             "logits than the plain K5 prefill")
    if not plain_ok:
        fail(f"the K5 and plain-scan prefills differ by "
             f"{float(d_plain.max())} (limit {SSM_E2E_ATOL}), or their "
             f"greedy tokens are no near-tie")
    if not step_ok:
        fail("a decode step disagrees with the longer prefill")

    def one_prefill():
        with torch.inference_mode():
            model.prefill(params, batch, model.init_cache(B, P + G))

    def one_decode():
        with torch.inference_mode():
            model.decode_step(params, cache, tok)

    prof = {"prefill": profile_round(torch, one_prefill, (SSD_PATH_KERNEL,)),
            "decode_step": profile_round(torch, one_decode,
                                         (SSD_PATH_KERNEL,))}
    for name, pr in prof.items():
        print(f"[mamba2 profile] {name}: " + json.dumps(pr))
    return dict(info=info, launches=launches, profile=prof, init_s=init_s,
                layer_tol_ratio=max(layer_ratios),
                max_diff_plain=float(d_plain.max()),
                max_diff_half=float(d_half.max()),
                max_diff_step=float(d_step.max()))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
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
        for line in build.nvcc_output(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}")
    # every K1/K3 instance: registers, static shared memory, spills (none)
    ptxas = {name: ptxas_report(build.nvcc_output(name))
             for name in ("sim_step", "contention")}
    for name, rows in ptxas.items():
        if not rows:
            fail(f"no ptxas report for {name}: was it built in this run?")
        for r in rows:
            print(f"[ptxas] {name}: {r['function']}: {r['registers']} "
                  f"registers, {r['smem_bytes']} bytes smem, spill stores "
                  f"{r['spill_stores']}, loads {r['spill_loads']}")
        spilled = [r["function"] for r in rows
                   if r["spill_stores"] or r["spill_loads"]]
        if spilled:
            fail(f"{name}: registers spilled in {spilled}")
    # the bf16 routes of K4 and K5 run on the tensor cores and copy into
    # shared memory asynchronously: count both in the built SASS
    sass = {}
    for name, kernel in (("flash_attention", FA_PATH_KERNEL),
                         ("ssd_scan", SSD_PATH_KERNEL)):
        counts = sass_counts(build.library_path(name))
        for fn, c in counts.items():
            print(f"[sass] {name}: {fn}: {c['mma']} HMMA/HGMMA, "
                  f"{c['async_copy']} LDGSTS/UTMALDG")
        path = {fn: c for fn, c in counts.items() if kernel in fn}
        sass[name] = {"mma": sum(c["mma"] for c in path.values()),
                      "async_copy": sum(c["async_copy"]
                                        for c in path.values()),
                      "functions": len(path)}
        print(f"[sass] {name}: {kernel}: {json.dumps(sass[name])}")
        if not path or min(min(c["mma"], c["async_copy"])
                           for c in path.values()) == 0:
            fail(f"{kernel} in lib{name} has no tensor-core instruction or "
                 f"no asynchronous copy in some instance: {json.dumps(path)}")

    # --- 3. kernel parity and times ------------------------------------------
    S, shapes = phase_sim(torch)

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
    # --- 10. flash-attention kernel parity and times ---------------------------
    k4 = phase_attention(torch)
    # --- 11. LM serving: smollm-135m prefill and greedy decode ----------------
    sv = phase_serve(torch)
    # --- 12. SSD chunked-scan kernel parity and times --------------------------
    k5 = phase_ssd(torch)
    # --- 13. mamba2-1.3b serving: prefill through K5, greedy decode ------------
    mb = phase_mamba2(torch)

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
    for E in (1, 4096, 16384):
        kernels[0][f"at_E{E}"] = {k: shapes[("sim_interval", E)][k] for k in
                                  ("max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "bound_terms")}
    kernels[0]["ptxas"] = ptxas["sim_step"]
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
    kernels[-1]["ptxas"] = ptxas["contention"]
    row = k4["smollm_bf16"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": sv["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        **{k: row[k] for k in ("B", "S", "Hq", "Hkv", "D", "window",
                               "dtype", "device_ms", "first_design_ms",
                               "first_design_device_ms", "bound_terms")},
        "sass": sass["flash_attention"],
    })
    for name, r in k4.items():
        if name != "smollm_bf16":
            kernels[-1][f"at_{name}"] = r
    row = k5["mamba2_bf16"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:27",
        "launches": mb["launches"]["ssd_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in k5.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        **{k: row[k] for k in ("b", "s", "h", "p", "g", "n", "chunk",
                               "dtype", "device_ms", "first_design_ms",
                               "first_design_device_ms", "max_abs_err_state",
                               "bound_terms")},
        "sass": sass["ssd_scan"],
    })
    for name, r in k5.items():
        if name != "mamba2_bf16":
            kernels[-1][f"at_{name}"] = r
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
