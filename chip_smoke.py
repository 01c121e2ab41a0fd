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
                must hold wgmma (HGMMA) and TMA loads (UTMALDG) and no
                mma.sync (HMMA) in every instance, and ptxas must report
                no spill in them; every K1 and K3 instance's registers,
                shared memory and spills (ptxas), and no spill in any of
                them
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
                at the path's shape; then the rest of its domain in bf16
                and in float32 (FA_DOMAIN_SHAPES: SMOKE smollm's D = 24 and
                granite's D = 16, D = 80 and 96 at smollm's path shape,
                causal=False at seamless's cross shape and a ragged Skv =
                600, the 256-column instance at gemma-7b's attention,
                gemma-2-9b's sliding layer and D = 136, and D = 100, padded
                by the wrapper), and head dims past 256 refused
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
                state errors, kernel, device (the median of at least 20
                profiler samples, with their least and most), plain and
                bound times, and at each bf16 shape the first design's
                (the float32 route), which the bf16 kernel must beat at
                the path's shape; then SMOKE mamba2's mixer at chunk 16 and
                the path's shape at chunk 64 and 256, Mamba-Codestral-7B's
                mixer at chunk 256, p = 128 at chunk 128 and 256, and p =
                12, n = 20 (padded by the wrapper), in bf16 and in float32
                (SSD_DOMAIN_SHAPES), and widths and chunks off the domain
                refused
 13. mamba2     repro_torch.launch.serve at the full mamba2-1.3b config (8
                prompts of 1024 tokens, 32 greedy tokens each): the scan
                kernel launched once per layer in the prefill and never in
                decode; finite logits, agreement with a prefill through the
                plain scan, decode against a longer prefill, and a profile
                of one prefill and one decode step
 29. chunk 256  phase 13's model and weights with ssm_chunk=256 (mamba_ssm's
                default chunk): serve(), K5 once per layer per prefill (each
                chunk one chunk in two row tiles) and never in decode, K5
                against the plain scan on every layer's own inputs, the
                logits against a prefill through the plain scan at chunk
                256 at phase 13's limits (run right after phase 13)
 14. scenarios  bench_scenarios.py's context agent (1500 episodes, 32 envs,
                all seven condition families) trained on the card, scored
                with evaluate_scenario against the static and
                exploration-only baselines on every family, then the step
                family replayed on a live TransferEngine by ScenarioDriver
                under the trained AutoMDTController; K1's launch counts and
                a profile of one episode batch
 15. topology   bench_topology.py's policy (4 flows over 3 links, 16 envs,
                1500 episodes) trained on the card, scored with
                run_topology_in_dynamic_sim against phase 8's fleet policy
                and static Globus on the three topology families, then a
                TopologyController steering four live engines on a
                MultiLink through link_failover (a ScenarioDriver per link,
                re-routed at the route bin); one topology episode batch
                against the CPU; the one-link topology solve against the
                fleet's, bitwise; K3 at the path's shape with rounds = F;
                both kernels' launch counts and a profile of one episode
                batch
 16. faults     bench_faults.py's fault-randomized fleet policy (4 flows,
                16 envs, 1500 episodes, a fault draw compiled into every
                round's tables and flows) and its fault-blind single-flow
                baseline trained on the card, both and static scored on
                eval_world (a kill, a stage hang, a restart): recovery,
                deficit, completion, deadline hits, utilization; a
                FaultInjector replaying a hang, a kill and a restart
                against a CheckpointedFlow under the port's
                AutoMDTController (no byte lost or replayed, checksum
                intact); K1 and K3 held on the training's and the scoring's
                own operands and on an all-down substep
 17. online     bench_online.py's frozen fleet policy (1500 episodes over
                the families outside the hold-out) scored on the held-out
                step collapse with and without the online residual head
                and against static; FleetController(online=) steering four
                live engines on one SharedLink
 18. topology faults: topology PPO over floors and fault draws with link
                blackouts, one such episode batch against the CPU; phase
                15's policy scored with two flows capped, the caps held,
                the card run's actions replayed on the CPU through the
                plain water-fill and on the card without caps; K3 held on
                the training's and the capped scoring's own operands
 19. topology scale-out: the compact-active-set path (max_active < F) at
                phase 9's 4096 Poisson flows over 3 links, topology_step
                dense and compact without and with floors and caps (ms per
                step, agreement at phase 9's limits); K3 and K1 held on the
                compact operands the path gave them, K3's capped solve
                (A rounds) and the dense capped one (F rounds) against the
                sorted water-fill's fixed point, with and without the
                rounds timed; one compact topology PPO episode batch (4
                envs x 64 flows, max_active 16) against the CPU, profiled
 20. zamba2     repro_torch.launch.serve at the full zamba2-1.2b config (8
                prompts of 1024 tokens, 32 greedy tokens each): K5 on each
                of the 38 Mamba2 layers and K4 on each of the 6 shared-
                block invocations per prefill, neither in decode; finite
                logits, agreement with the 'full' backend and with a
                prefill through the plain scan, decode against a longer
                prefill; K4 and K5 held on the operands the path gave them
                (every call of one prefill) and timed on the first; a
                profile of one prefill and one decode step
 21. mixtral    the same at mixtral-8x22b's full width, 1 of its 56 layers
                (2 prompts of 6144 tokens, past its 4096 window, so K4
                masks and the ring cache wraps); against the 'chunked'
                backend; the capacity dispatch of moe_apply with nothing
                dropped against moe_apply_dense_reference on a layer input
                the path gave it
 22. dense      the same for deepseek-7b (MHA), granite-34b (MQA, the GELU
                MLP) and chatglm3-6b (GQA 16:1, partial rope, qkv biases),
                each at full width with 4 layers (8 prompts of 1024 tokens)
 23. training   repro_torch.launch.train at smollm-135m's full width on
                random weights (8 x 1024 tokens a step, 20 steps): the
                AutoMDT controller trained by PPO on the card (K1) tuning
                the input pipeline, async checkpoints through the transfer
                engine every 10 steps, one injected WorkerFailure after the
                first; the losses finite, the resumed run equal to an
                uninterrupted one over the same batches, step ms and
                tokens/s, one step profiled, each save's seconds and MB/s;
                the loss on one fixed batch falling at warmup 2; one SMOKE
                float32 step per family (dense, MoE, ssm, hybrid) on the
                card against the CPU; K1 held on the controller's operands
 24. last archs phase 20's checks for seamless-m4t-large-v2 (enc-dec, 24 +
                24 layers as published: K4 on the decoder's self-attention,
                24 launches a prefill, 8 x 256 frames), qwen2-vl-72b (2 of
                80 layers at full width, the first 256 of 1024 tokens
                vision embeddings; K4 at 64 q over 8 kv heads of 128; one
                more prefill with a real 16 x 16 (t, h, w) grid against
                'full') and deepseek-v2-236b (1 of 60 layers at full width:
                MLA on its own 'chunked' backend, no K4, against 'full'; a
                'pallas' MLA config raises; the capacity dispatch of 160
                experts, top-6, against the dense oracle)
 25. training last: the three archs of phase 24 trained at full width on
                phase 24's weights with concrete_inputs' train_4k batches
                at scale 16 (16 x 256 tokens; qwen2-vl's first 128 vision
                embeddings and (3, B, S) positions, seamless's 16 x 64
                frames), each config's 'chunked': qwen2-vl cut to 1 of 80
                layers and deepseek-v2 to 1 of 60 (MLA) take the loss's
                forward and backward, seamless as published the whole
                make_train_step (10 steps on one fixed batch, the loss
                falling, then 3 through the int8 error-feedback hook); every
                loss and gradient finite, none all zero, no kernel on the
                path, a loss under 'pallas' refused; ms, tokens/s, peak
                memory, one profile each; then smollm-135m's loss and
                gradients under 'chunked_tri' against 'chunked' (8 x 1024
                tokens, chunk 256) and ssd_chunked(bf16=True) against the
                float32 scan at mamba2-1.3b's layer shape. Phase 23 holds
                one SMOKE float32 step of these archs on the card against
                the CPU, and the int8 codes of its gradients
 26. sharding   one rank: make_fleet_mesh() on the card, train_ppo at
                bench_fleet's configuration for 3 rounds with mesh= equal
                to mesh=None bit for bit with the same K1/K3 launches; the
                SMOKE smollm-135m train state re-laid onto
                make_smoke_mesh() by reshard_state, saved and restored by
                load_checkpoint(shardings=), bit for bit on the card. Two
                ranks spawned on the one card (gloo over CUDA tensors, the
                kernels phase 2 built): fleet_step at 4096 flows (phase 9's
                world), topology_step at 4096 flows over 3 links (phase
                19's, no objectives) and the reference's F = 8 step with
                floors and caps, the flow axis split 2 ways, against the
                unsharded call within 1e-6 (obs, buffers, throughputs) and
                1e-5 (reward); K3 on the assembled operands bit for bit;
                one episode batch (16 envs x 4 flows) within 1e-4 of
                mesh=None; per rank the round wall ms, K1 and K3 launches
                and flow_all_reduce calls and bytes per step and per round
 27. dry run    repro_torch.launch.dryrun's CLI in a subprocess per cell
                (started together) on smollm-135m and mixtral-8x22b at
                train_4k, full width, on both production meshes (a fake
                world of 256 and 512 ranks, meta DTensors): every cell
                ok, each line as the reference's CLI prints it; then
                phase 23's step (smollm-135m, 8 x 1024 tokens) traced on
                a 1 x 1 mesh and run on the card: the traced state bytes
                against the bytes init_state's tensors requested of the
                allocator (512 a tensor), analyze_ops' FLOPs of the real
                step equal
                to the trace's, the step's median against its roofline
                bound (never below it), the traced peak beside
                max_memory_allocated; no kernel runs
 28. smoke      serve --smoke for every arch (README.md's command, 2
                prompts of 64 tokens, 8 greedy tokens), one subprocess per
                arch started together, each exiting 0; in process,
                serve() on each SMOKE config: K4 once per causal
                self-attention layer of the prefill (none for MLA, none
                for seamless's encoder and cross layers), K5 once per
                Mamba2 layer, neither in a decode step, and the prefill
                logits on the card (the kernels) against the CPU (their
                plain versions) from the same weights, within 1e-4 in
                float32 and 5e-2 atol and rtol in bf16

It prints each phase's wall time, its findings on earlier lines, one JSON
line with every kernel's numbers, the nvidia-smi line, and ends with the
line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Without CUDA, or without the repository beside it, it fails.
"""

from __future__ import annotations

import dataclasses
import gc
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
# phase 14: bench_scenarios.py's configuration (benchmarks/
# bench_scenarios.py:41-47, train_dynamic_agent :49, main :80): the context
# agent trained over all seven families, resampled every round
SCEN_TPT = (0.2, 0.15, 0.2)
SCEN_BW = (1.0, 1.0, 1.0)
SCEN_N_MAX = 50
SCEN_ENVS = 32
SCEN_EPISODES = 1500
SCEN_HORIZON = 60.0
SCEN_TOTAL_GBIT = 40.0
SCEN_LIVE_FAMILY = "step"
SCEN_LIVE_SCALE = 10.0       # sim seconds per wall second of the replay
SCEN_LIVE_STEPS = 12         # control intervals of the live replay
# phase 15: bench_topology.py's configuration (benchmarks/
# bench_topology.py:52-84): 4 flows over 3 links, 16 envs, 1500 episodes,
# TOPOLOGY_OBS, fairness 0.5, domain-randomized over the three families;
# its fleet_1link baseline is bench_fleet's train_fleet_agent at the same
# size and seed, phase 8's policy
TOPO_FLOWS = 4
TOPO_LINKS = 3
TOPO_ENVS = 16
TOPO_EPISODES = 1500
TOPO_HORIZON = 60.0
TOPO_FAMILIES = ("regional_diurnal", "link_failover", "cross_traffic")
TOPO_LIVE_SCALE = 10.0
TOPO_LIVE_STEPS = 12
# K3 at every shape the topology path gives it, rounds = F: training's
# E=16 envs of 50 substeps, 4 flows over 3 links, objectives off (the
# path's) and on; the evaluation's one env (run_topology_in_dynamic_sim's
# reset and steps); and topology_achievable's one substep with every flow
# at n_max on every stage (TOPO_PATH_THREADS)
TOPO_PATH_SHAPES = {"topology_path": (16, 50, 4, 3, 4, False, 0.8),
                    "topology_path_objectives": (16, 50, 4, 3, 4, True,
                                                 0.8),
                    "topology_eval": (1, 50, 4, 3, 4, False, 0.8),
                    "topology_achievable": (1, 1, 4, 3, 4, False, 1.0)}
TOPO_PATH_THREADS = {"topology_achievable": FLEET_N_MAX}
# phase 16: bench_faults.py's configuration (benchmarks/bench_faults.py:
# 44-60, train_fault_agent :63, main :184 at quick=False): 4 flows, 16
# envs, 1500 episodes, horizon 60 s, thread-tight per-thread rates, every
# round a fresh fault draw, objectives dropped; its automdt_frozen
# baseline is bench_fleet.py's train_independent_agent (:75) at 1500
# episodes and 16 envs, one single-flow CONTEXT_OBS agent per flow
FAULT_TPT = (0.08, 0.05, 0.08)
FAULT_BW = (1.0, 1.0, 1.0)
FAULT_N_MAX = 50
FAULT_FLOWS = 4
FAULT_ENVS = 16
FAULT_EPISODES = 1500
FAULT_HORIZON = 60.0
FAULT_RECOVERY_FRAC = 0.9
FAULT_COMPLETION_FRAC = 0.6
FAULT_MIX = dict(kill_prob=0.7, restart_prob=0.9, hang_prob=0.6)
# the live replay: a hang, then a kill and a restart, in sim seconds of the
# 60 s horizon, replayed FAULT_LIVE_SCALE times faster than the wall clock
FAULT_LIVE_EVENTS = (dict(kind="stage_hang", t=6.0, until=12.0, stage=1),
                     dict(kind="kill_flow", t=18.0, flow=0),
                     dict(kind="restart_flow", t=27.0, flow=0))
FAULT_LIVE_SCALE = 20.0
FAULT_LIVE_MB = 12
# phase 17: bench_online.py's configuration (benchmarks/bench_online.py:
# 37-52, train_frozen_agent :55, main :122 at quick=False): the frozen
# fleet policy trained on the families outside HOLDOUT (4 flows, 16 envs,
# 1500 episodes, horizon 90 s), scored on the held-out step collapse
ONLINE_TPT = (0.2, 0.15, 0.2)
ONLINE_BW = (1.0, 1.0, 1.0)
ONLINE_N_MAX = 50
ONLINE_FLOWS = 4
ONLINE_ENVS = 16
ONLINE_EPISODES = 1500
ONLINE_HORIZON = 90.0
HOLDOUT = ("step", "brownout", "random_walk")
COLLAPSE = 0.1
AT_FRAC = 1.0 / 3.0
ONLINE_RECOVERY_FRAC = 0.85
# bench_online.py's ONLINE_CFG, the OnlineConfig fields
ONLINE_CFG = dict(step=3.0, max_residual=32.0, buffer=192, explore=0.5,
                  beta=0.35, warmup=2, fallback=-0.6, re_engage=-0.1,
                  cooldown=2)
ONLINE_LIVE_STEPS = 8
# phase 18: topology PPO at bench_topology's width over a world with rate
# floors (20% of the link for every deadline flow) and faults with link
# blackouts, TOPO_FAULT_ROUNDS rounds; then phase 15's policy scored on one
# bench_topology family with two of the four flows capped at a quarter of
# the link's base bandwidth
TOPO_FAULT_ROUNDS = 10
TOPO_FLOOR_FRAC = 0.2
TOPO_FAULT_MIX = dict(FAULT_MIX, blackout_prob=0.5)
TOPO_CAP_FAMILY = "cross_traffic"
TOPO_CAP_FRAC = 0.25
TOPO_CAPPED = (0, 2)
# phase 19: the topology's compact-active-set path at phase 9's scale-out
# (SCALE_FLOWS Poisson arrivals, seed 7, hold_frac 0.01, E = 1) over
# TOPO_LINKS links scaled from the fleet's schedule (tpt x1, x0.8, x0.6;
# bw x1, x1.2, x1.4); with objectives, TOPO_SCALE_CAPPED of the flows get a
# floor and a finite cap below a fair share of a link at the arrivals' peak
# concurrency, so K3's rounds move bandwidth. Then one topology PPO episode
# batch of TOPO_COMPACT_ENVS envs x TOPO_COMPACT_FLOWS Poisson flows
# (hold_frac TOPO_COMPACT_HOLD) with max_active = TOPO_COMPACT_ACTIVE.
TOPO_SCALE_TPT = (1.0, 0.8, 0.6)
TOPO_SCALE_BW = (1.0, 1.2, 1.4)
TOPO_SCALE_CAPPED = 0.25
TOPO_COMPACT_ENVS = 4
TOPO_COMPACT_FLOWS = 64
TOPO_COMPACT_ACTIVE = 16
TOPO_COMPACT_HOLD = 0.05
TOPO_COMPACT_SEED = 4
# the episode batches phase 18 holds on the card against the CPU. Seed 3's
# whole episode is held in float32. Seed 9's float32 update sits on a ReLU
# kink (a block-2 LayerNorm output within float32 rounding of 0, on whose
# side the devices may differ), so its rollout is held through the rewards
# and its update from one batch in float64, at phase 5's 1e-4 scaled by
# float64's unit roundoff over float32's (2**-29)
TOPO_AGREE_SEED = 3
TOPO_UPDATE_GAP_SEED = 9
TOPO_UPDATE_F64_LIMIT = 1e-4 * 2.0 ** -29
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
# K4 over the rest of its domain, name: (B, S, Skv, Hq, Hkv, D, causal,
# window): each in bf16 and in float32 (phase 10's rows ``<name>_bf16``,
# ``<name>_f32``). SMOKE smollm-135m's and granite-34b's prefill shapes at
# serve --smoke's request (2 prompts of 64 tokens: D = 24, GQA 3:1, and
# D = 16, MQA 6:1); phi-2's and phi-3-mini's published head dims (80 and
# 96, their config.json on the Hugging Face hub) at smollm's path shape,
# one per padded instance (64 columns up to D = 64, 128 above); and
# causal=False at seamless-m4t-large-v2's cross-attention shape (1024
# decoder positions over 256 frames, 16 heads of 64) and at a ragged
# Skv = 600 (the library time there is sdpa(is_causal=False)). The
# 256-column instance: gemma-7b's attention (16 heads and 16 kv heads of
# 256) at 8 prompts of 1024 tokens, gemma-2-9b's sliding layer (16 q over
# 8 kv heads of 256, a 4096 window) at one prompt of 8192 tokens (their
# config.json on the Hugging Face hub), and D = 136 through it with zero
# columns at smollm's path shape; and D = 100, off the bf16 step of 8,
# which the wrapper pads to 104.
FA_DOMAIN_SHAPES = {
    "smoke_smollm": (2, 64, 64, 3, 1, 24, True, None),
    "smoke_granite": (2, 64, 64, 6, 1, 16, True, None),
    "d80": (8, 1024, 1024, 9, 3, 80, True, None),
    "d96": (8, 1024, 1024, 9, 3, 96, True, None),
    "cross": (8, 1024, 256, 16, 16, 64, False, None),
    "cross_ragged": (8, 1024, 600, 16, 16, 64, False, None),
    "gemma7b": (8, 1024, 1024, 16, 16, 256, True, None),
    "gemma2_sliding": (1, 8192, 8192, 16, 8, 256, True, 4096),
    "d136": (8, 1024, 1024, 9, 3, 136, True, None),
    "d100": (8, 1024, 1024, 9, 3, 100, True, None),
}
# head dims past the widest instance, refused on the card without a launch
FA_REFUSED_DIMS = (("bfloat16", 264), ("bfloat16", 257), ("float32", 260),
                   ("float32", 258))
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
# K5 over the rest of its domain, name: (b, s, h, p, g, n, chunk): SMOKE
# mamba2-1.3b's mixer at serve --smoke's request (p = n = 16, chunk 16)
# and mamba2's path shape at chunk 64, each in bf16 and in float32 (phase
# 12's rows ``<name>_bf16``, ``<name>_f32``). Chunks of two row tiles:
# mamba2's path shape at chunk 256 (Mamba2's own default chunk_size in
# mamba_ssm, phase 29's path) and Mamba-Codestral-7B's mixer (128 heads of
# 64, 8 B/C groups, state 128, chunk 256; its config on the Hugging Face
# hub) at 8 prompts of 1024 tokens; a head dim of 128 (two 64-column
# blocks a head) at chunk 128 and 256; and p = 12, n = 20, off the step of
# 8, which the wrapper pads to 16 and 24.
SSD_DOMAIN_SHAPES = {
    "smoke_mamba2": (2, 64, 8, 16, 1, 16, 16),
    "mamba2_chunk64": (8, 1024, 64, 64, 1, 128, 64),
    "mamba2_chunk256": (8, 1024, 64, 64, 1, 128, 256),
    "codestral": (8, 1024, 128, 64, 8, 128, 256),
    "p128_chunk128": (8, 1024, 32, 128, 1, 128, 128),
    "p128_chunk256": (8, 1024, 32, 128, 1, 128, 256),
    "p12_n20": (8, 1024, 16, 12, 1, 20, 128),
}
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
# phase 29: phase 13's model and weights with one field changed, the chunk
# of mamba_ssm's own default (and Mamba-Codestral-7B's), held at phase
# 13's limits against a prefill through the plain scan at the same chunk
SSM_LONG_CHUNK = 256
# phases 20-22: the serving families at full width through serve(), 32
# greedy tokens per request like phase 11: arch -> (layers kept (None: the
# published depth), prompts, prompt tokens, the backend the 'pallas'
# logits are held against). Depth is cut where the weights drawn on the
# host in float32 would take minutes (mixtral: 1 of 56 layers, 141e9
# parameters in all; the dense configs 4 layers each; mixtral cut from 2
# layers, the dense configs from 8 and qwen2-vl from 4 to keep the run in
# its time limit with phase 29); mixtral's prompts
# are longer than its 4096 window, and its reference backend is its
# config's 'chunked', since 'full' would hold every layer's 6144 x 6144
# scores. Phase 24: seamless as published (24 + 24 layers, 1.6e9
# parameters), qwen2-vl cut to 2 of 80 layers and deepseek-v2 to 1 of 60
# (6.0e9 and 5.0e9 parameters at full width; neither fits the card whole)
FAMILY_SERVE = {
    20: {"zamba2-1.2b": (None, 8, 1024, "full")},
    21: {"mixtral-8x22b": (1, 2, 6144, "chunked")},
    22: {"deepseek-7b": (4, 8, 1024, "full"),
         "granite-34b": (4, 8, 1024, "full"),
         "chatglm3-6b": (4, 8, 1024, "full")},
    24: {"seamless-m4t-large-v2": (None, 8, 1024, "full"),
         "qwen2-vl-72b": (2, 8, 1024, "full"),
         "deepseek-v2-236b": (1, 8, 1024, "full")},
}
# phase 28: every arch's SMOKE config served as ``serve --smoke`` serves it
# (README.md): 2 prompts of 64 tokens, 8 greedy tokens, in process and
# through the command line; its prefill logits on the card through the
# kernels against the CPU through their plain versions on the same
# parameters, within the SMOKE CPU tests' limits: 1e-4 in float32
# (tests/test_torch_lm_families.py) and 5e-2 atol and rtol in bf16
# (tests/test_torch_hybrid_serve.py)
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_GEN = 2, 64, 8
SMOKE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SMOKE_CLI_TIMEOUT_S = 300
# phase 24: qwen2-vl's vision tokens as a VLM_GRID x VLM_GRID (h, w) grid
# at t = 0, the text going on from the grid's largest id + 1 on all three
# M-RoPE sections
VLM_GRID = 16
# the plain K4 version materializes (B, Hq, S, Skv) float32 scores; above
# this many bytes it runs one kv head's group of q heads at a time (the
# same function: no head reads another's keys)
FA_PLAIN_SCORE_BYTES = 4e9
# moe_apply with capacity_factor = E/top_k (nothing dropped) against
# moe_apply_dense_reference on the same bf16 input: the same expert
# products in the same type, so any gap is bf16 rounding of the products
# (an ulp of the largest output, 2^-7 relative, gives room for two)
MOE_TOL = 2.0 ** -6
# a bf16 MoE compared across two paths (two attention backends, or a decode
# step against a longer prefill) routes a token to other experts where its
# k-th and (k+1)-th router logits nearly tie: the paths' bf16 roundings
# move the router's input, and the swapped expert moves that token's
# logits by O(1). A row whose last token is routed otherwise in some layer
# is left out of the logit comparison if, at the first such layer, those
# two logits lie within MOE_TIE of each other on both paths; a flip at a
# wider gap fails. MOE_TIE is far below the typical gap between
# neighbouring logits of 8 experts at unit scale (order 0.3), and the
# gaps at the flips are printed
MOE_TIE = 0.05
# phase 23: LM training at smollm-135m's full width on random weights,
# through repro_torch.launch.train: 8 x 1024 tokens a step, TRAIN_STEPS
# steps, the AutoMDT controller (PPO on the simulator: K1) tuning the input
# pipeline, async checkpoints through the engine every TRAIN_CKPT_EVERY
# steps and one WorkerFailure injected at TRAIN_FAIL_AT, after the first
# checkpoint
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 13
TRAIN_WARM_STEPS = 2         # the first steps (allocator, cuBLAS) left out
# of the steady step time
TRAIN_MEMO_STEPS, TRAIN_MEMO_WARMUP = 10, 2   # R3's sanity floor: the loss
# on one fixed batch must fall over these steps at this warmup
# card against CPU: one SMOKE train step in float32 per family, loss and
# parameters within TRAIN_AGREE_TOL (TF32 off, as for every phase); the
# last three archs' batches come from concrete_inputs (their frames and
# vision inputs; the enc-dec's fixed bf16 lifted to float32, as its CPU
# tests lift it), and on their card gradients quantize_dequantize_int8 is
# held against the CPU's on the same values, codes and scales equal
TRAIN_LAST = ("qwen2-vl-72b", "deepseek-v2-236b", "seamless-m4t-large-v2")
TRAIN_AGREE_ARCHS = ("smollm-135m", "mixtral-8x22b", "mamba2-1.3b",
                     "zamba2-1.2b") + TRAIN_LAST
TRAIN_AGREE_TOL = 1e-4
TRAIN_AGREE_SCALE = 128      # concrete_inputs' train_4k / 128: 2 x 32 tokens
# phase 25: the last three archs trained at full width on the weights
# phase 24 drew (qwen2-vl cut to its first layer, deepseek-v2 its one
# layer, seamless as published), on concrete_inputs(cfg, "train_4k",
# scale=TRAIN_LAST_SCALE) batches of 16 x 256 tokens, each config's own
# backend ('chunked'). seamless takes the whole make_train_step:
# TRAIN_MEMO_STEPS steps at warmup TRAIN_MEMO_WARMUP on one fixed batch
# (the loss must fall), then TRAIN_LAST_EF_STEPS more through the int8
# error-feedback hook; qwen2-vl and deepseek-v2, whose AdamW moments alone
# pass the card, take the loss's forward and backward TRAIN_LAST_RUNS
# times (the first TRAIN_WARM_STEPS left out of the median)
TRAIN_LAST_SCALE = 16
TRAIN_LAST_LAYERS = {"qwen2-vl-72b": 1, "deepseek-v2-236b": 1}
TRAIN_LAST_EF_STEPS = 3
TRAIN_LAST_RUNS = 5
# chunked_tri at full width: one smollm-135m loss and gradient of
# TRI_BATCH x TRI_SEQ tokens at attn_chunk TRI_CHUNK against 'chunked' (and
# layer 0's attention on the path's operands against sdpa_chunked), within
# the reference's bf16-probability tolerance (tests/test_kernels.py:
# atol = rtol = 2e-2); 'chunked' at chunk TRI_SEQ gives the gap between two
# plain versions for scale
TRI_ARCH, TRI_BATCH, TRI_SEQ, TRI_CHUNK = "smollm-135m", 8, 1024, 256
TRI_TOL = 2e-2
# ssd_chunked(bf16=True) at mamba2-1.3b's layer shape against the float32
# scan on the same inputs: max |y16 - y32| within 2% of max |y32| (the
# reference's own test's bound)
SSD_BF16_SHAPE = "mamba2_bf16"
SSD_BF16_REL = 0.02
# K1's operands are captured from this call of the controller's training:
# 1 reset + 100 exploration probes, then two rounds of 11 and 5 steps in
TRAIN_K1_CALL = 1 + 100 + 2 * 11 + 5

# device kernel names: every kernel of a library carries its prefix (the
# float32 and bf16 routes alike); the main paths run the bf16 kernels
FA_PREFIX, FA_PATH_KERNEL = "flash_attention_", "flash_attention_wgmma_kernel"
SSD_PREFIX, SSD_PATH_KERNEL = "ssd_scan_", "ssd_scan_wgmma_kernel"


SHARD_RANKS = 2              # phase 26: ranks sharing the one card over gloo
SHARD_ROUNDS = 3             # phase 26: train_ppo rounds, mesh= against None
SHARD_FLOOR_FLOWS = 8        # the reference's floors-and-caps world
# the reference's limits for a sharded step (tests/test_fleet_scaleout.py:
# 467-473) and PERF.md section 2's for one episode batch
SHARD_TOL = {"state": 1e-6, "reward": 1e-5, "episode": 1e-4}
SHARD_TIMEOUT_S = 300        # the spawned ranks' join limit
# phase 27: the dry run. (a) the CLI on DRYRUN_CELLS at full width on
# both production meshes (256 and 512 ranks of a fake world, meta
# DTensors), a subprocess per cell, all started together, within
# DRYRUN_CLI_TIMEOUT_S; (b) on the card, phase
# 23's step (smollm-135m, 8 x 1024 tokens, remat, 'chunked') traced on a
# 1 x 1 mesh and run for real: the state's bytes against the bytes the
# allocator's tensors requested (within DRYRUN_ALLOC_ROUND a tensor), the
# FLOPs of the real step against the trace's, the step's median over
# DRYRUN_STEPS steps after a warm-up against its roofline bound
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("mixtral-8x22b", "train_4k"))
DRYRUN_CLI_TIMEOUT_S = 400
DRYRUN_ALLOC_ROUND = 512
DRYRUN_STEPS = 5

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


def device_spread(torch, fn, kernel_prefix, n=20):
    """The device time of one ``fn()`` call from torch.profiler: its median,
    least and most over the recorded launches, and their number. Each
    device kernel whose name carries ``kernel_prefix`` gives one sample per
    recorded launch, and a call's time sums over those names, so a kernel
    split into parts (one launch of each per call), or named apart by its
    template, counts whole. Windows of ``n`` calls are recorded until every
    such kernel has ``n`` samples, up to three: late in this script's run
    the profiler drops the first launches of a window (7 of 10 recorded, on
    an H100), and a window can come back with no device time at all (each
    such window is printed and counted in ``PROFILER_WINDOWS``). None where
    all three came back empty; ``samples`` below ``n`` where the three
    recorded fewer."""
    from torch.profiler import profile, ProfilerActivity
    PROFILER_WINDOWS["calls"] += 1
    ms = {}
    for window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        got = [(evt.name, evt.device_time_total / 1e3)
               for evt in prof.events() if kernel_prefix in evt.name
               and evt.device_type == torch.autograd.DeviceType.CUDA]
        for name, t in got:
            ms.setdefault(name, []).append(t)
        if not got:
            PROFILER_WINDOWS["empty"] += 1
            print(f"[profiler] {kernel_prefix}: window {window + 1} of 3 "
                  f"recorded no device time")
        elif min(map(len, ms.values())) >= n:
            break
    if not ms:
        return None
    return {"median": sum(float(np.median(v)) for v in ms.values()),
            "min": sum(map(min, ms.values())),
            "max": sum(map(max, ms.values())),
            "samples": min(map(len, ms.values()))}


def device_ms(torch, fn, kernel_prefix, n=20):
    """``device_spread``'s median, or None."""
    spread = device_spread(torch, fn, kernel_prefix, n)
    return spread and spread["median"]


# device_spread's profiler windows over the run: calls, and windows that
# came back with no device time
PROFILER_WINDOWS = {"calls": 0, "empty": 0}


SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG")


def sass_counts(lib_path):
    """Per kernel function of a built library: its tensor-core instructions
    (HMMA for mma.sync, HGMMA for wgmma) and asynchronous copies into shared
    memory (LDGSTS for cp.async, UTMALDG for TMA), each counted apart in the
    SASS that ``cuobjdump -sass`` prints."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    ops = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:  # the hex encodings hold no such word
            for op in set(ops.findall(line)):
                counts[fn][op] += 1
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


def fa_bound(B, S, Hq, Hkv, D, window, dtype, *, Skv=None, causal=True):
    """K4's bound at one shape: q, k, v read once and o written once over
    the memory rate, and the live (causal, windowed; without the causal
    mask every one of the S x Skv) score and PV products, 4 * D operations
    per live (query, key) pair of each head at the true head dim, over the
    peak rate of the inputs' type (bf16 tensor cores; float32 outside
    them, the rate at which float32 keeps its precision)."""
    Skv = S if Skv is None else Skv
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = esize * (2 * B * S * Hq * D + 2 * B * Skv * Hkv * D)
    w = min(window or S, S)
    live = (w * (w + 1) // 2 + (S - w) * w) if causal else S * Skv
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


def sim_check(torch, name, bufs, rates_dt, cap):
    """K1 (sim_interval) on the operands ``bufs`` (E, 2), ``rates_dt``
    (E, S, 3), ``cap`` (E, 2): bitwise equal to its plain version, with
    kernel (CUDA events), device (profiler), plain and bound times."""
    from repro_torch.kernels.sim_step import ops
    from repro_torch.kernels.sim_step.ref import sim_interval_reference
    E, S = rates_dt.shape[:2]
    kern = lambda: ops.sim_interval_batch(bufs, rates_dt, cap)
    plain = lambda: sim_interval_reference(bufs, rates_dt, cap)
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    err = max_err(got, want)
    if not err <= 1e-5:
        fail(f"sim_interval {name}: max abs err {err} > 1e-5")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"sim_interval {name}: not bitwise equal to the plain version")
    n_bytes = 4 * (E * 4 + E * S * 3 + E * 5)
    b_ms, b_by, terms = bound_ms(n_bytes, SIM_OPS_PER_SUBSTEP * E * S,
                                 SIM_CHAIN_OPS_PER_SUBSTEP * S)
    return dict(E=E, S=S, max_abs_err=err, ms=time_ms(torch, kern),
                device_ms=device_ms(torch, kern, "sim_interval_kernel"),
                plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
                library_ms=None)


def phase_sim(torch):
    """3. K1 (sim_interval) at the main path's env counts (1 for the
    probes, 32 for training, 4096 for phase 6) and at 16384, and K2
    (sim_step) at 16384, against the plain version: bitwise, with kernel
    (CUDA events), device (profiler), plain and bound times. Returns (S,
    {(name, E): row})."""
    from repro_torch.kernels.sim_step import ops
    from repro_torch.kernels.sim_step.ref import sim_step_reference
    S = 50
    shapes = {}
    for E in (1, 32, 4096, 16384):   # probes, training, phase 6, wide
        bufs, rates_dt, cap, _ = sim_inputs(torch, E, S, seed=E)
        shapes[("sim_interval", E)] = sim_check(torch, f"E={E}", bufs,
                                                rates_dt, cap)
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


def contention_operands(torch, E, S, F, L, *, p_active, seed,
                        threads_at=None):
    """Operands at the main path's value ranges: thread counts in [1, 50]
    (or all ``threads_at``), activity masks with ``p_active`` of the flows live, the one-link
    embedding (onpath all ones) for L = 1 and random routes otherwise,
    per-stage conditions around bench_fleet.py's profile, floors and caps
    with half the flows uncapped."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    onpath = (np.ones((E, S, F, L)) if L == 1
              else rng.integers(0, 2, (E, S, F, L)))
    threads = rng.integers(1, 51, (E, F, 3))
    if threads_at is not None:
        threads = np.full((E, F, 3), threads_at)
    return dict(
        threads=f32(threads),
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


def contention_row(torch, name, shape, seed, threads_at=None):
    """K3 at one shape (E, S, F, L, rounds, objectives, share active) on
    operands made at the main path's value ranges (``contention_operands``;
    ``threads_at``: every thread count at that value), held and timed by
    ``contention_check``."""
    E, S, F, L, rounds, obj, p = shape
    x = contention_operands(torch, E, S, F, L, p_active=p, seed=seed,
                            threads_at=threads_at)
    args = [x[k] for k in ("threads", "act", "onpath", "tpt", "bw")]
    args += [x["floor"], x["cap"]] if obj else [None, None]
    return contention_check(torch, name, args, rounds)


def contention_check(torch, name, args, rounds, samples=20):
    """K3 on the operands ``args`` (threads, act, onpath, tpt, bw, floor,
    cap) on the card: within 2e-5 of its plain version on the same
    operands and the same bits from two launches, with kernel (CUDA
    events, median of ``samples``), device (profiler), plain and bound
    times."""
    from repro_torch.kernels.contention import ops
    from repro_torch.kernels.contention.ref import contention_rates_reference
    E, S, F = args[1].shape
    L = args[2].shape[-1]
    obj = args[5] is not None or args[6] is not None
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
    empty0 = PROFILER_WINDOWS["empty"]
    dev_ms = device_ms(torch, kern, "contention_kernel")
    row = dict(E=E, S=S, F=F, L=L, rounds=rounds, objectives=obj,
               max_abs_err=err, ms=time_ms(torch, kern, samples=samples,
                                           inner=min(samples, 20)),
               device_ms=dev_ms,
               device_windows_empty=PROFILER_WINDOWS["empty"] - empty0,
               plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
               bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
               library_ms=None)
    print(f"[contention] {name} E={E} S={S} F={F} L={L} rounds={rounds} "
          f"objectives={obj}: max_abs_err={err:.3g} ms={row['ms']} "
          f"device_ms={row['device_ms']} (empty profiler windows "
          f"{row['device_windows_empty']}) plain_ms={row['plain_ms']} "
          f"bound_ms={b_ms:.3g} ({b_by}; {json.dumps(terms)}) "
          f"library_ms=null; bitwise across two launches")
    return row


def phase_contention(torch):
    """7. K3 at every shape of CONTENTION_SHAPES (``contention_row``)."""
    return {name: contention_row(torch, name, shape, i)
            for i, (name, shape) in enumerate(CONTENTION_SHAPES.items())}


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
    return dict(res=res, cfg=cfg, rounds=rounds, policy=fleet,
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


def fa_plain(torch, q, k, v, window, causal=True):
    """K4's plain version; above FA_PLAIN_SCORE_BYTES of scores, one kv
    head's group of q heads at a time."""
    from repro_torch.kernels.flash_attention.ref import attention_reference
    B, S, Hq, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if 4 * B * Hq * S * Skv <= FA_PLAIN_SCORE_BYTES:
        return attention_reference(q, k, v, causal=causal, window=window)
    g = Hq // Hkv
    return torch.cat([attention_reference(
        q[:, :, h * g:(h + 1) * g].contiguous(), k[:, :, h:h + 1].contiguous(),
        v[:, :, h:h + 1].contiguous(), causal=causal, window=window)
        for h in range(Hkv)], dim=2)


def fa_row(torch, name, q, k, v, window, *, first_design=False,
           causal=True):
    """K4 on (q, k, v) against its plain version (within FA_TOL), with
    kernel (CUDA events), device (profiler), plain, library and bound
    times; ``first_design``: also the float32 route's on the same inputs.
    The library call, scaled_dot_product_attention, is timed as a
    yardstick only: the port never calls it. With a window it takes a
    boolean band mask; for S above 4096 the kv heads are repeated to the q
    heads outside the timed call, so that the memory-efficient backend
    (which takes a mask but not enable_gqa) runs instead of the math one.
    ``causal=False``: every key (Skv may differ from S), the library call
    sdpa(is_causal=False)."""
    from repro_torch.kernels.flash_attention import ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dtype = str(q.dtype).split(".")[-1]
    kern = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)
    plain = lambda: fa_plain(torch, q, k, v, window, causal)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not causal:
        lib = lambda: sdpa(qt, kt, vt, is_causal=False, enable_gqa=True)
        lib_call = "sdpa(is_causal=False, enable_gqa=True)"
    elif window is None:
        lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_call = "sdpa(is_causal=True, enable_gqa=True)"
    else:
        pos = torch.arange(S, device=q.device)
        band = ((pos[:, None] >= pos[None, :])
                & (pos[:, None] - pos[None, :] < window))
        if S > 4096:
            ke, ve = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kt, vt))
            lib = lambda: sdpa(qt, ke, ve, attn_mask=band)
            lib_call = "sdpa(attn_mask=band), kv heads repeated before"
        else:
            lib = lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
            lib_call = "sdpa(attn_mask=band, enable_gqa=True)"
    got = kern()
    torch.cuda.synchronize()
    err = float((got.float() - plain().float()).abs().max())
    if not err <= FA_TOL[dtype]:
        fail(f"flash_attention {name}: max abs err {err} > {FA_TOL[dtype]}")
    b_ms, b_by, terms = fa_bound(B, S, Hq, Hkv, D, window, dtype, Skv=Skv,
                                 causal=causal)
    # the device time: the median of the profiler's samples, with their
    # least and most
    spread = device_spread(torch, kern, FA_PREFIX, n=10)
    row = dict(B=B, S=S, Skv=Skv, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
               window=window, dtype=dtype, max_abs_err=err,
               ms=time_ms(torch, kern, samples=10, inner=10),
               device_ms=spread and spread["median"],
               device_ms_min=spread and spread["min"],
               device_ms_max=spread and spread["max"],
               device_samples=spread and spread["samples"],
               plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
               library_ms=time_ms(torch, lib, samples=10, inner=10),
               library_call=lib_call, bound_ms=b_ms, bound_by=b_by,
               bound_terms=terms)
    if first_design and dtype == "bfloat16":
        # the first design, which the float32 route keeps, on the same
        # inputs in float32: its time does not depend on dtype
        q32, k32, v32 = (x.float() for x in (q, k, v))
        first = lambda: ops.flash_attention(q32, k32, v32, window=window)
        row.update(first_design_ms=time_ms(torch, first, samples=5, inner=5),
                   first_design_device_ms=device_ms(torch, first, FA_PREFIX,
                                                    n=5))
    print(f"[attention] {name} B={B} S={S} Skv={Skv} Hq={Hq} Hkv={Hkv} "
          f"D={D} causal={causal} window={window} {dtype}: "
          f"max_abs_err={err:.3g} "
          f"ms={row['ms']} device_ms={row['device_ms']} (median of "
          f"{row['device_samples']}, {row['device_ms_min']}-"
          f"{row['device_ms_max']}) "
          f"first_design_device_ms={row.get('first_design_device_ms')} "
          f"plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
          f"({lib_call}) bound_ms={b_ms:.4g} ({b_by}; {json.dumps(terms)}); "
          f"kernel/library {row['ms'] / row['library_ms']:.2f}x, "
          f"kernel/bound {row['ms'] / b_ms:.1f}x")
    return row


def phase_attention(torch):
    """10. K4 against its plain version at every shape of FA_SHAPES
    (``fa_row``), with the first design's times at each bf16 shape; then at
    every shape of FA_DOMAIN_SHAPES in bf16 and in float32; and head dims
    off the domain refused on the card without a launch."""
    from repro_torch.kernels.flash_attention import ops
    rows = {}
    for i, (name, (B, S, Hq, Hkv, D, window, dtype)) in enumerate(
            FA_SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(i)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, S, h, D), generator=gen,
                               device="cuda").to(dt)
                   for h in (Hq, Hkv, Hkv))
        rows[name] = fa_row(torch, name, q, k, v, window, first_design=True)
    faster_than_first(rows["smollm_bf16"], "flash_attention smollm_bf16")
    for i, (name, (B, S, Skv, Hq, Hkv, D, causal, window)) in enumerate(
            FA_DOMAIN_SHAPES.items()):
        for dtype in ("bfloat16", "float32"):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            q, k, v = (torch.randn((B, n, h, D), generator=gen,
                                   device="cuda").to(getattr(torch, dtype))
                       for n, h in ((S, Hq), (Skv, Hkv), (Skv, Hkv)))
            tag = f"{name}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
            rows[tag] = fa_row(torch, tag, q, k, v, window, causal=causal)
    for dtype, D in FA_REFUSED_DIMS:
        q = torch.zeros((1, 16, 2, D), dtype=getattr(torch, dtype),
                        device="cuda")
        before = ops.flash_attention.launches
        try:
            ops.flash_attention(q, q, q)
        except ValueError:
            pass
        else:
            fail(f"flash_attention took head dim {D} in {dtype}, off its "
                 f"domain")
        if ops.flash_attention.launches != before:
            fail(f"flash_attention launched at head dim {D}")
    print("[attention] head dims " + ", ".join(
        f"{D} ({dtype})" for dtype, D in FA_REFUSED_DIMS)
        + " refused with ValueError, no launch")
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


def ssd_row(torch, name, args, *, first_design=False, chunk=SSD_CHUNK):
    """K5 on ``args`` (x, dt, A, B, C) against its plain version: y and
    final state within the reference's tolerances, kernel (CUDA events),
    device (profiler), plain and bound times; ``first_design``: also the
    float32 route's on the same inputs. No single PyTorch call computes
    the scan, so there is no library time."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    x, dt_, A, B, C = args
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dtype = str(x.dtype).split(".")[-1]
    kern = lambda: ops.ssd_scan(*args, chunk=chunk, return_state=True)
    plain = lambda: ssd_reference(*args, chunk=chunk)
    y, state = kern()
    torch.cuda.synchronize()
    want_y, want_state = plain()
    tol = SSD_TOL[dtype]
    err_y = float((y.float() - want_y.float()).abs().max())
    err_state = float((state - want_state).abs().max())
    ratio = max(allclose_ratio(torch, y, want_y, tol),
                allclose_ratio(torch, state, want_state, tol))
    if not (ratio <= 1.0 and np.isfinite(err_y) and np.isfinite(err_state)):
        fail(f"ssd_scan {name}: y err {err_y}, state err {err_state}, "
             f"{ratio:.3g} of the tolerance {tol} (atol and rtol)")
    b_ms, b_by, terms = ssd_bound(b, s, h, p, g, n, dtype, chunk)
    row = dict(b=b, s=s, h=h, p=p, g=g, n=n, chunk=chunk,
               dtype=dtype, max_abs_err=err_y,
               max_abs_err_state=err_state, tol_ratio=ratio,
               max_abs_y=float(want_y.float().abs().max()),
               ms=time_ms(torch, kern, samples=10, inner=10),
               plain_ms=time_ms(torch, plain, samples=5, inner=3, warmup=1),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               bound_terms=terms)
    # the device time: the median of at least 20 profiler samples, with
    # their spread
    spread = device_spread(torch, kern, SSD_PREFIX)
    row.update(device_ms=spread and spread["median"],
               device_ms_min=spread and spread["min"],
               device_ms_max=spread and spread["max"],
               device_samples=spread and spread["samples"])
    if first_design and dtype == "bfloat16":
        # the first design, which the float32 route keeps, on the same
        # inputs with x, B, C in float32
        args32 = (x.float(), dt_, A, B.float(), C.float())
        first = lambda: ops.ssd_scan(*args32, chunk=chunk,
                                     return_state=True)
        row.update(first_design_ms=time_ms(torch, first, samples=5, inner=5),
                   first_design_device_ms=device_ms(torch, first, SSD_PREFIX))
    print(f"[ssd] {name} b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} "
          f"{dtype}: "
          f"y max_abs_err={err_y:.3g} (|y| max {row['max_abs_y']:.3g}), "
          f"state max_abs_err={err_state:.3g}, {ratio:.3g} of the "
          f"tolerance; ms={row['ms']} device_ms={row['device_ms']} "
          f"(median of {row['device_samples']}, {row['device_ms_min']}-"
          f"{row['device_ms_max']}) "
          f"first_design_device_ms={row.get('first_design_device_ms')} "
          f"plain_ms={row['plain_ms']} bound_ms={b_ms:.4g} ({b_by}; "
          f"{json.dumps(terms)}) library_ms=null; kernel/bound "
          f"{row['ms'] / b_ms:.1f}x, plain/kernel "
          f"{row['plain_ms'] / row['ms']:.2f}x")
    return row


def phase_ssd(torch):
    """12. K5 against its plain version at every shape of SSD_SHAPES
    (``ssd_row``), with the first design's times at each bf16 shape; then
    at every shape of SSD_DOMAIN_SHAPES in bf16 and in float32; and widths
    and chunks off the domain refused on the card without a launch."""
    from repro_torch.kernels.ssd_scan import ops
    rows = {name: ssd_row(torch, name, ssd_operands(torch, *shape, seed=i),
                          first_design=True)
            for i, (name, shape) in enumerate(SSD_SHAPES.items())}
    faster_than_first(rows["mamba2_bf16"], "ssd_scan mamba2_bf16")
    for i, (name, (*dims, chunk)) in enumerate(SSD_DOMAIN_SHAPES.items()):
        for dtype in ("bfloat16", "float32"):
            tag = f"{name}_{'bf16' if dtype == 'bfloat16' else 'f32'}"
            rows[tag] = ssd_row(torch, tag, ssd_operands(
                torch, *dims, dtype, seed=100 + i), chunk=chunk)
    x, dt_, A, B, C = ssd_operands(torch, 1, 64, 2, 64, 1, 64, "bfloat16",
                                   seed=0)
    for what, args, chunk in (
            ("chunk 40", (x, dt_, A, B, C), 40),
            ("chunk 272", (x, dt_, A, B, C), 272),
            ("head dim 136", (torch.cat([x, x, x[..., :8]], -1), dt_, A, B,
                              C), 128),
            ("state dim 264", (x, dt_, A,
                               torch.cat([B] * 4 + [B[..., :8]], -1),
                               torch.cat([C] * 4 + [C[..., :8]], -1)),
             128)):
        before = ops.ssd_scan.launches
        try:
            ops.ssd_scan(*args, chunk=chunk)
        except ValueError:
            pass
        else:
            fail(f"ssd_scan took {what}, off its domain")
        if ops.ssd_scan.launches != before:
            fail(f"ssd_scan launched at {what}")
    print("[ssd] chunks 40 and 272, head dim 136 and state dim 264 refused "
          "with ValueError, no launch")
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
    # the weights serve() would draw from the seed, drawn once on the host
    # and passed in (phase 11 and phase 28's CLI run serve()'s own init)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    toks, info = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SERVE_SEED,
                       params=params)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[mamba2] {SSM_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.d_inner // cfg.ssm_headdim} heads of {cfg.ssm_headdim}, "
          f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, "
          f"bf16): {B} prompts x {P} tokens, {G} greedy tokens each; "
          f"prefill {info['prefill_s']:.4f} s, decode {info['decode_s']:.4f}"
          f" s = {info['tok_per_s']:.1f} tokens/s; serve() {serve_s:.2f} s; "
          f"launches {json.dumps(launches)}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"serve returned tokens {tuple(toks.shape)} out of range")
    if launches != {**{k: 0 for k in launches}, "ssd_scan": cfg.n_layers}:
        fail(f"mamba2 serving launched {json.dumps(launches)}, expected "
             f"ssd_scan = {cfg.n_layers} (one prefill) and no other")

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
                params=params, layer_tol_ratio=max(layer_ratios),
                max_diff_plain=float(d_plain.max()),
                max_diff_half=float(d_half.max()),
                max_diff_step=float(d_step.max()))


def phase_mamba2_long_chunk(torch, params):
    """29. Mamba2 serving at chunk 256: serve() at the full mamba2-1.3b
    config with ssm_chunk=SSM_LONG_CHUNK and phase 13's weights (the same
    seed; passed in, not drawn again), counting K5's launches; then on the
    same weights and prompts: finite logits, K5 launched once per layer
    per prefill and never in decode, K5 against the plain scan at chunk
    256 on every layer's own inputs, and the logits against a prefill
    through the plain scan at chunk 256, at phase 13's limits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.nn.ssd import ssd_chunked
    cfg = get_config(SSM_ARCH).replace(ssm_chunk=SSM_LONG_CHUNK)
    layer_ratios, chunks = [], []

    def held_against_plain(x, dt, A, B, C, *, chunk):
        """K5 on a layer's own inputs, held against the plain scan."""
        chunks.append(chunk)
        y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                return_state=True)
        want_y, want_state = ssd_chunked(x, dt, A, B, C, chunk=chunk)
        tol = SSD_TOL[str(x.dtype).split(".")[-1]]
        layer_ratios.append(max(allclose_ratio(torch, y, want_y, tol),
                                allclose_ratio(torch, state, want_state,
                                               tol)))
        return y, state

    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    reset_launches()
    toks, info = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SERVE_SEED,
                       params=params)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[mamba2 chunk {SSM_LONG_CHUNK}] {SSM_ARCH} at chunk "
          f"{cfg.ssm_chunk} (phase 13's weights): {B} prompts x {P} tokens, "
          f"{G} greedy tokens each; prefill {info['prefill_s']:.4f} s, decode "
          f"{info['decode_s']:.4f} s = {info['tok_per_s']:.1f} tokens/s; "
          f"launches {json.dumps(launches)}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"serve returned tokens {tuple(toks.shape)} out of range")
    if launches != {**{k: 0 for k in launches}, "ssd_scan": cfg.n_layers}:
        fail(f"mamba2 serving at chunk {cfg.ssm_chunk} launched "
             f"{json.dumps(launches)}, expected ssd_scan = {cfg.n_layers} "
             f"(one prefill) and no other")

    model = get_model(cfg)
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
        model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        n_decode = read_launches()["ssd_scan"]
        logits_plain, _ = model.prefill(params, batch,
                                        model.init_cache(B, P + G),
                                        ssd_fn=ssd_chunked)
        logits_held, _ = model.prefill(params, batch,
                                       model.init_cache(B, P + G),
                                       ssd_fn=held_against_plain)
        torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(logits_plain).all())
    same_first = bool(torch.equal(tok[:, 0], toks[:, 0]))
    live = slice(0, cfg.vocab)
    d_plain = (logits - logits_plain)[:, live].abs()
    tol = SERVE_ATOL + SERVE_RTOL * logits[:, live].abs()
    top = logits.max(dim=-1).values
    near_top = bool(torch.all(
        top - logits.gather(1, logits_plain.argmax(dim=-1, keepdim=True))[:, 0]
        <= SERVE_ATOL + SERVE_RTOL * top.abs()))
    plain_ok = float(d_plain.max()) <= SSM_E2E_ATOL and near_top
    agree = float((logits.argmax(-1) == logits_plain.argmax(-1))
                  .float().mean())
    print(f"[mamba2 chunk {SSM_LONG_CHUNK} check] logits finite {finite}; "
          f"prefill launches {n_prefill}, decode step launches {n_decode}; "
          f"serve's first tokens reproduced {same_first}; K5 vs the plain "
          f"scan on each layer's inputs: at most {max(layer_ratios):.3g} of "
          f"SSD_TOL over {len(layer_ratios)} layers at chunks "
          f"{sorted(set(chunks))}; K5 vs plain-scan prefill at chunk "
          f"{cfg.ssm_chunk}: max abs diff {float(d_plain.max()):.4g}, mean "
          f"{float(d_plain.mean()):.4g}, "
          f"{float((d_plain / tol).max()):.3g} of atol+rtol, argmax agree "
          f"{agree:.3f}")
    if not finite:
        fail(f"non-finite logits in mamba2 serving at chunk {cfg.ssm_chunk}")
    if n_prefill != cfg.n_layers or n_decode != 0:
        fail(f"ssd_scan launched {n_prefill} times in a prefill and "
             f"{n_decode} in a decode step at chunk {cfg.ssm_chunk}, "
             f"expected {cfg.n_layers} and 0")
    if not same_first:
        fail("the same weights and prompts did not reproduce serve's first "
             f"tokens at chunk {cfg.ssm_chunk}")
    if (len(layer_ratios) != cfg.n_layers or not max(layer_ratios) <= 1.0
            or set(chunks) != {SSM_LONG_CHUNK}):
        fail(f"K5 disagrees with the plain scan on a layer's inputs at chunk "
             f"{cfg.ssm_chunk}: {max(layer_ratios)} of SSD_TOL")
    if not bool(torch.equal(logits_held, logits)):
        fail("a prefill through K5 held against the plain scan gave other "
             f"logits than the plain K5 prefill at chunk {cfg.ssm_chunk}")
    if not plain_ok:
        fail(f"the K5 and plain-scan prefills at chunk {cfg.ssm_chunk} "
             f"differ by {float(d_plain.max())} (limit {SSM_E2E_ATOL}), or "
             f"their greedy tokens are no near-tie")
    return dict(info=info, launches=launches, chunk=cfg.ssm_chunk,
                layer_tol_ratio=max(layer_ratios),
                max_diff_plain=float(d_plain.max()),
                mean_diff_plain=float(d_plain.mean()), argmax_agree=agree)


def phase_scenarios(torch):
    """14. Single-flow evaluation: bench_scenarios.py's domain-randomized
    context agent trained through train_ppo, scored with evaluate_scenario
    against the static and exploration-only baselines on all seven
    families, then replaying the step family on a live TransferEngine
    through ScenarioDriver under the trained AutoMDTController."""
    from repro_torch.core import (PPOConfig, train_ppo, make_env_params,
                                  AutoMDTController, Workload, CONTEXT_OBS)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import (FAMILIES, ScenarioSpec,
                                       sample_scenario_batch,
                                       evaluate_scenario, ScenarioDriver)
    from repro_torch.transfer import (TransferEngine, SyntheticSource,
                                      ChecksumSink, StageThrottle)
    params = make_env_params(tpt=list(SCEN_TPT), bw=list(SCEN_BW),
                             cap=[2.0, 2.0], n_max=SCEN_N_MAX, device="cuda")

    def draw(rnd, seed=1):
        _, tables = sample_scenario_batch(
            SCEN_ENVS, seed=seed * 7919 + rnd, horizon=SCEN_HORIZON,
            base_tpt=SCEN_TPT, base_bw=SCEN_BW, device="cuda")
        return Workload(tables=tables)

    cfg = PPOConfig(max_episodes=SCEN_EPISODES, n_envs=SCEN_ENVS,
                    action_scale=SCEN_N_MAX / 4, seed=1, obs_spec=CONTEXT_OBS,
                    param_selection="batch_mean", device="cuda")
    reset_launches()
    res = train_ppo(params, cfg, workload=draw(0), resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    rounds = res.episodes // SCEN_ENVS
    hist = np.asarray(res.history, float)
    print(f"[scenarios train] {res.episodes} episodes ({rounds} rounds of "
          f"{SCEN_ENVS} envs over {len(FAMILIES)} families, "
          f"{cfg.max_steps} steps) in {res.wall_s:.3f} s = "
          f"{res.episodes / res.wall_s:.1f} episodes/s; best episode reward "
          f"{res.best_reward:.4f}; launches {json.dumps(train_launches)}")
    if not np.all(np.isfinite(hist)):
        fail("non-finite single-flow training reward")
    expected = rounds * (cfg.max_steps + 1)
    if train_launches["sim_interval"] != expected:
        fail(f"scenario training launched {json.dumps(train_launches)}, "
             f"expected sim_interval = {rounds} rounds x "
             f"{cfg.max_steps + 1} = {expected}")

    ctrl = AutoMDTController(res.params["policy"], n_max=SCEN_N_MAX,
                             bw_ref=float(max(SCEN_BW)), deterministic=True,
                             obs_spec=CONTEXT_OBS, device="cuda")
    reset_launches()
    evals, beats, sim_steps = {}, {}, 0
    for family in FAMILIES:
        spec = ScenarioSpec(family=family, seed=11, horizon=SCEN_HORIZON,
                            base_tpt=SCEN_TPT, base_bw=SCEN_BW)
        ev = evaluate_scenario(spec, ctrl, params=params,
                               total_gbit=SCEN_TOTAL_GBIT)
        # the exploration probe's reset and 120 probes, each run's reset
        # and steps
        sim_steps += 1 + 120 + sum(1 + len(r.tput) for r in ev.values())
        evals[family] = ev
        for label, r in ev.items():
            if not (np.isfinite(r.utilization) and np.isfinite(r.mean_utility)
                    and np.all(np.isfinite(r.tput))):
                fail(f"non-finite scenario evaluation {family}/{label}")
            if r.delivered <= 0.0:
                fail(f"{label} delivered nothing on {family}")
        beats[family] = all(ev["automdt"].utilization > ev[b].utilization
                            for b in ("static", "exploration_only"))
        print(f"[scenarios eval] {family}: " + "; ".join(
            f"{label} utilization {r.utilization:.4f} convergence "
            f"{r.convergence_steps} mean utility {r.mean_utility:.4f} "
            f"completion {r.completion_s}" for label, r in ev.items()))
    torch.cuda.synchronize()
    eval_launches = read_launches()
    print(f"[scenarios eval] launches {json.dumps(eval_launches)} over "
          f"{sim_steps} sim steps (probes and resets included)")
    print(f"[scenarios eval] the agent's utilization beats both baselines: "
          + json.dumps(beats))
    if eval_launches["sim_interval"] != sim_steps:
        fail(f"scenario evaluation launched {json.dumps(eval_launches)}, "
             f"expected sim_interval = {sim_steps}")

    # live: the step family replayed on a throttled engine, 1.0 sim Gbit/s
    # = 8 MB/s, the scenario clock SCEN_LIVE_SCALE times the wall clock
    unit = 8 * MB
    spec = ScenarioSpec(family=SCEN_LIVE_FAMILY, seed=11,
                        horizon=SCEN_HORIZON, base_tpt=SCEN_TPT,
                        base_bw=SCEN_BW)
    tpt0, bw0 = (x[0] for x in spec.tables())
    eng = TransferEngine(
        SyntheticSource(512 * MB, chunk_bytes=128 * 1024), ChecksumSink(),
        sender_buf=2 * unit, receiver_buf=2 * unit,
        throttles=tuple(StageThrottle(float(b) * unit, float(t) * unit)
                        for t, b in zip(tpt0, bw0)),
        initial_concurrency=(2, 2, 2), n_max=SCEN_N_MAX, metric_interval=0.2)
    interval = 0.5
    live = AutoMDTController(res.params["policy"], n_max=SCEN_N_MAX,
                             bw_ref=max(SCEN_BW) * unit, deterministic=True,
                             obs_spec=CONTEXT_OBS, interval=interval,
                             device="cuda")
    t0 = time.monotonic()
    try:
        with ScenarioDriver(eng, spec.table(device="cuda"),
                            bytes_per_unit=unit,
                            time_scale=SCEN_LIVE_SCALE) as drv:
            trace = live.run(eng, interval=interval,
                             max_steps=SCEN_LIVE_STEPS)
            sim_t = drv.sim_time()
        live_wall = time.monotonic() - t0
        moved = eng.bytes_written()
    finally:
        eng.close()
    print(f"[scenarios live] {SCEN_LIVE_FAMILY} replayed through "
          f"ScenarioDriver to sim t={sim_t:.1f} s in {live_wall:.2f} s: "
          f"{moved / MB:.2f} MB moved = {moved / live_wall / MB:.3f} MB/s; "
          f"network MB/s per interval "
          f"{[round(r[2][1] / MB, 2) for r in trace]}; final threads "
          f"{trace[-1][1] if trace else None}; {live.n_dispatch} policy "
          f"dispatches")
    if moved == 0 or live.n_dispatch == 0:
        fail("the live replay moved no bytes under the port's controller")

    fn = _make_episode_fn(params, cfg, randomize_t0=True)
    state = init_agent(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tables = draw(0).tables
    prof = profile_round(torch, lambda: fn(state, tables, gen),
                         ("sim_interval_kernel",))
    print(f"[scenarios profile] n_envs={SCEN_ENVS}: " + json.dumps(prof))
    return dict(res=res, train_launches=train_launches,
                eval_launches=eval_launches, beats=beats, profile=prof)


def topology_draw(n_envs, seed=1, device="cuda"):
    """bench_topology.py's per-round draw: graphs and routes over the three
    families, arrivals over the arrival families, objectives dropped."""
    from repro_torch.scenarios import sample_topology_batch

    def draw(rnd):
        wl = sample_topology_batch(n_envs, TOPO_FLOWS, n_links=TOPO_LINKS,
                                   seed=seed * 7919 + rnd,
                                   horizon=TOPO_HORIZON, base_tpt=FLEET_TPT,
                                   base_bw=FLEET_BW, device=device)
        return wl.replace(objectives=None, specs=None)
    return draw


def topology_config(dev, *, episodes, n_envs, seed=1):
    """bench_topology.py's train_topology_agent configuration."""
    from repro_torch.core import PPOConfig, TOPOLOGY_OBS
    return PPOConfig(max_episodes=episodes, n_envs=n_envs,
                     action_scale=FLEET_N_MAX / 4, seed=seed,
                     obs_spec=TOPOLOGY_OBS, param_selection="batch_mean",
                     n_flows=TOPO_FLOWS, fairness_coef=0.5, device=dev)


def topology_episode(torch, dev, *, seed, objectives, n_envs=4,
                     faults=False):
    """One topology episode batch (rollout + updates, ``n_envs`` envs x 4
    flows over 3 links) from explicit draws made with NumPy, the workload
    drawn on ``dev``; ``faults``: phase 18's world (floors and a compiled
    fault draw with link blackouts). Returns (rewards, {name: param})."""
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import sample_topology_batch
    cfg = topology_config(dev, episodes=n_envs, n_envs=n_envs, seed=seed)
    if faults:
        mix = dict(objective_mix=dict(floor_deadline_frac=TOPO_FLOOR_FRAC),
                   fault_mix=TOPO_FAULT_MIX)
    else:
        mix = dict(objective_mix=True if objectives else None)
    wl = sample_topology_batch(n_envs, TOPO_FLOWS, n_links=TOPO_LINKS,
                               seed=seed, horizon=TOPO_HORIZON,
                               base_tpt=FLEET_TPT, base_bw=FLEET_BW,
                               device=dev, **mix).compiled()
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    draws = dict(threads0=to(rng.integers(1, 16, (n_envs, TOPO_FLOWS, 3))),
                 t0_draw=to(rng.random(n_envs)),
                 noise=to(rng.normal(size=(cfg.max_steps, n_envs,
                                           TOPO_FLOWS, 3))))
    fn = _make_episode_fn(fleet_params(dev), cfg, randomize_t0=True)
    state, rew, _ = fn(init_agent(cfg), None, flows=wl.flows,
                       objectives=wl.objectives if objectives else None,
                       topology=wl.topology, **draws)
    return rew.cpu(), {n: t.detach().cpu() for n, t in
                       state["params"].named_parameters()}


def phase_topology(torch, fleet_policy):
    """15. The topology path: bench_topology.py's policy trained through
    train_ppo over link graphs, scored with run_topology_in_dynamic_sim on
    the three families against phase 8's single-link fleet policy and
    static Globus, then a TopologyController steering four live engines on
    a MultiLink through link_failover (one ScenarioDriver per link, the
    engines re-routed at the route bin); one topology episode batch on the
    card against the CPU; the one-link topology solve against the fleet's,
    bitwise; K3 held and timed at the path's shape."""
    from repro_torch.core import (train_ppo, effective_obs_spec, FleetPolicy,
                                  TopologyController, GlobusController)
    from repro_torch.core.fleet import _solve_fleet_rates
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.core.topology import (PathSpec, single_link_graph,
                                           _solve_topology_rates)
    from repro_torch.scenarios import (TopologySpec, arrival_schedule,
                                       run_topology_in_dynamic_sim,
                                       sample_fleet_batch, ScenarioDriver)
    from repro_torch.transfer import MultiLink, SyntheticSource, ChecksumSink
    params = fleet_params("cuda")
    cfg = topology_config("cuda", episodes=TOPO_EPISODES, n_envs=TOPO_ENVS)
    draw = topology_draw(TOPO_ENVS)
    reset_launches()
    res = train_ppo(params, cfg, workload=draw(0), resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    rounds = res.episodes // TOPO_ENVS
    hist = np.asarray(res.history, float)
    batch_means = hist[: rounds * TOPO_ENVS].reshape(rounds, TOPO_ENVS).mean(1)
    print(f"[topology train] {res.episodes} episodes ({rounds} rounds of "
          f"{TOPO_ENVS} envs x {TOPO_FLOWS} flows over {TOPO_LINKS} links, "
          f"{cfg.max_steps} steps) in {res.wall_s:.3f} s = "
          f"{res.episodes / res.wall_s:.1f} episodes/s; best batch-mean "
          f"reward {batch_means.max():.4f}, last {batch_means[-1]:.4f}; "
          f"launches {json.dumps(train_launches)}")
    if not np.all(np.isfinite(hist)):
        fail("non-finite topology training reward")
    expected = rounds * (cfg.max_steps + 1)
    if (train_launches["contention"] != expected
            or train_launches["sim_interval"] != expected):
        fail(f"topology training launched {json.dumps(train_launches)}, "
             f"expected contention = sim_interval = {rounds} rounds x "
             f"{cfg.max_steps + 1} = {expected}")

    topo = FleetPolicy(res.params["policy"], n_max=FLEET_N_MAX,
                       deterministic=True, obs_spec=effective_obs_spec(cfg),
                       device="cuda")
    reset_launches()
    evals, runs = {}, 0
    for family in TOPO_FAMILIES:
        tspec = TopologySpec(family=family, seed=11, n_links=TOPO_LINKS,
                             n_flows=TOPO_FLOWS, horizon=TOPO_HORIZON,
                             base_tpt=FLEET_TPT, base_bw=FLEET_BW)
        flows = arrival_schedule("staggered_start", TOPO_FLOWS,
                                 horizon=TOPO_HORIZON, seed=11,
                                 device="cuda")
        actors = {"topology": topo, "fleet_1link": fleet_policy,
                  "static": [GlobusController() for _ in range(TOPO_FLOWS)]}
        for label, actor in actors.items():
            ev = run_topology_in_dynamic_sim(tspec, flows, params, actor,
                                             seed=7, label=label)
            runs += 1
            evals[(family, label)] = ev
            if not (np.isfinite(ev.utilization) and np.isfinite(ev.jain)
                    and np.all(np.isfinite(ev.goodput))):
                fail(f"non-finite topology evaluation {family}/{label}")
            if ev.utilization <= 0.0:
                fail(f"{label} moved nothing on {family}")
        t, f1, st = (evals[(family, k)] for k in actors)
        print(f"[topology eval] {family}: " + "; ".join(
            f"{k} utilization {evals[(family, k)].utilization:.4f} Jain "
            f"{evals[(family, k)].jain:.4f} recovery_s "
            f"{evals[(family, k)].recovery_s}" for k in actors)
            + f"; topology/fleet_1link "
            f"{t.utilization / max(f1.utilization, 1e-9):.3f}, "
            f"topology/static {t.utilization / max(st.utilization, 1e-9):.3f}")
    torch.cuda.synchronize()
    eval_launches = read_launches()
    steps = int(round(TOPO_HORIZON / float(params.duration)))
    # each run: the reset's solve, then per step the step's solve and the
    # achievable's; one sim_step launch per reset and step
    want_k3, want_k1 = runs * (1 + 2 * steps), runs * (1 + steps)
    print(f"[topology eval] launches {json.dumps(eval_launches)} over {runs} "
          f"runs of {steps} steps; expected contention {want_k3}, "
          f"sim_interval {want_k1}")
    if (eval_launches["contention"] != want_k3
            or eval_launches["sim_interval"] != want_k1):
        fail("topology evaluation launched the kernels an unexpected "
             "number of times")

    # live: link_failover on a MultiLink, 1.0 sim Gbit/s = 8 MB/s per link,
    # each link's schedule replayed by its own ScenarioDriver
    unit = 8 * MB
    tspec = TopologySpec(family="link_failover", seed=11, n_links=TOPO_LINKS,
                         n_flows=TOPO_FLOWS, horizon=TOPO_HORIZON,
                         base_tpt=FLEET_TPT, base_bw=FLEET_BW)
    tpt, bw, onpath, route_bin = tspec.arrays()
    fail_wall = route_bin / TOPO_LIVE_SCALE
    interval = 0.5
    net = MultiLink(TOPO_LINKS)
    drivers = [ScenarioDriver(net.link(e), (tpt[e], bw[e], tspec.bin_seconds),
                              bytes_per_unit=unit,
                              time_scale=TOPO_LIVE_SCALE).start()
               for e in range(TOPO_LINKS)]
    _, paths = tspec.compile(device="cuda")
    ctl = TopologyController(
        res.params["policy"], n_flows=TOPO_FLOWS, n_max=FLEET_N_MAX,
        obs_spec=topo.obs_spec, interval=interval, deterministic=True,
        paths=PathSpec(paths.onpath, torch.tensor(fail_wall)),
        link_bw_ref=bw.max(axis=(1, 2)) * unit, bw_ref=float(bw.max()) * unit,
        device="cuda")
    rerouted = []
    t0 = time.monotonic()
    try:
        engines = [net.attach(SyntheticSource(512 * MB,
                                              chunk_bytes=128 * 1024,
                                              seed=f),
                              ChecksumSink(), path=np.flatnonzero(onpath[0][f]),
                              sender_buf=2 * unit, receiver_buf=2 * unit,
                              initial_concurrency=(2, 2, 2),
                              n_max=FLEET_N_MAX, metric_interval=0.2)
                   for f in range(TOPO_FLOWS)]

        def on_step(row):
            if row[0] >= fail_wall and not rerouted:
                for f, eng in enumerate(engines):
                    net.reroute(eng, np.flatnonzero(onpath[1][f]))
                rerouted.append(row[0])

        trace = ctl.run(net, interval=interval, max_steps=TOPO_LIVE_STEPS,
                        on_step=on_step)
        live_wall = time.monotonic() - t0
        per_flow = net.bytes_written_all()
        paths_now = [net.path_of(e) for e in engines]
    finally:
        for d in drivers:
            d.stop()
        net.close()
    print(f"[topology live] {len(trace)} control intervals in "
          f"{live_wall:.2f} s over {TOPO_LINKS} links; re-routed at "
          f"{rerouted} s (route bin {fail_wall:.2f} s wall): per flow MB "
          f"{[round(b / MB, 2) for b in per_flow]}; paths now {paths_now}; "
          f"final threads {trace[-1][1] if trace else None}; "
          f"{ctl.fleet_policy.n_dispatch} policy dispatches")
    if (min(per_flow) == 0 or ctl.fleet_policy.n_dispatch == 0
            or not rerouted):
        fail("the live MultiLink did not move bytes on every flow under "
             "the port's TopologyController, or was never re-routed")

    for objectives in (False, True):
        out = {d: topology_episode(torch, d, seed=5, objectives=objectives)
               for d in ("cuda", "cpu")}
        err_rew = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        err_par = max(float((out["cuda"][1][n] - out["cpu"][1][n]).abs().max())
                      for n in out["cpu"][1])
        print(f"[topology agree] card vs CPU, one topology episode batch (4 "
              f"envs x 4 flows over 3 links, objectives {objectives}): "
              f"rewards {err_rew:.3g}, params {err_par:.3g}")
        if not (err_rew <= 1e-4 and err_par <= 1e-4):
            fail("the card's topology episode disagrees with the CPU's")

    # the one-link embedding: topology equals fleet bit for bit on the card
    wl = sample_fleet_batch(FLEET_ENVS, FLEET_FLOWS, seed=3,
                            horizon=FLEET_HORIZON, base_tpt=FLEET_TPT,
                            base_bw=FLEET_BW, objective_mix={
                                "floor_deadline_frac": 0.1}, device="cuda")
    graph = single_link_graph(wl.tables)
    ones = PathSpec(torch.ones((FLEET_ENVS, 1, FLEET_FLOWS, 1),
                               device="cuda"),
                    torch.full((FLEET_ENVS,), float("inf"), device="cuda"))
    rng = np.random.default_rng(3)
    threads = torch.from_numpy(rng.integers(
        1, 51, (FLEET_ENVS, FLEET_FLOWS, 3)).astype(np.float32)).cuda()
    t0s = torch.from_numpy(rng.uniform(0, 50, FLEET_ENVS).astype(
        np.float32)).cuda()
    floors = wl.objectives._replace(rate_cap=torch.full_like(
        wl.objectives.rate_cap, float("inf")))
    same = {}
    for name, objs in (("no objectives", None), ("floors", floors)):
        a = _solve_fleet_rates(params, wl.tables, threads, wl.flows, t0s, 50,
                               objs)
        b = _solve_topology_rates(params, graph, ones, threads, wl.flows, t0s,
                                  50, objs)
        same[name] = bool(torch.equal(a, b))
    print(f"[topology e1] one link, every flow routed, no finite cap: "
          f"topology == fleet bitwise {json.dumps(same)}")
    if not all(same.values()):
        fail("the one-link topology solve differs from the fleet's on the "
             "card")

    k3 = {name: contention_row(torch, name, shape, 40 + i,
                               threads_at=TOPO_PATH_THREADS.get(name))
          for i, (name, shape) in enumerate(TOPO_PATH_SHAPES.items())}
    # the main path's launches at each shape: the training total read above;
    # the evaluation's total, read and checked above, is one reset and one
    # step per run at E = 1, S = 50 and one achievable solve per step
    k3["topology_path"]["launches"] = train_launches["contention"]
    k3["topology_path_objectives"]["launches"] = 0
    k3["topology_eval"]["launches"] = runs * (1 + steps)
    k3["topology_achievable"]["launches"] = runs * steps
    fn_cfg = topology_config("cuda", episodes=TOPO_ENVS, n_envs=TOPO_ENVS)
    fn = _make_episode_fn(params, fn_cfg, randomize_t0=True)
    state = init_agent(fn_cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wl0 = draw(0)
    prof = profile_round(torch, lambda: fn(state, None, gen, flows=wl0.flows,
                                           topology=wl0.topology),
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[topology profile] n_envs={TOPO_ENVS} x {TOPO_FLOWS} flows over "
          f"{TOPO_LINKS} links: " + json.dumps(prof))
    return dict(res=res, train_launches=train_launches,
                eval_launches=eval_launches, k3=k3, profile=prof,
                policy=topo)


class Recorder:
    """Records the operands of the calls of a kernel wrapper as a path's
    module holds it (``module.name``) and passes each call on, so the
    kernel can be held on the operands the path gave it. ``keep``: the
    indices of the calls whose operands are kept (None: every call);
    ``n`` counts every call."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.calls, self.n = [], 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*args, **kw):
            if self.keep is None or self.n in self.keep:
                self.calls.append(([a.clone() if hasattr(a, "clone") else a
                                    for a in args], dict(kw)))
            self.n += 1
            return self.real(*args, **kw)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def fault_start_times(faults, capacity_kinds):
    """(E,) interval start per env of a fault draw: the floor of a kill
    that restarts (its down window opens inside the interval) on even envs,
    of a capacity fault of ``capacity_kinds`` (its bins are dark) on odd
    ones, else whichever the env has; 0 for a fault-free env."""
    t0 = np.zeros(len(faults), np.float32)
    for i, spec in enumerate(faults):
        if spec is None:
            continue
        outs = spec.outages()
        kills = [t for t, back in outs.values() if np.isfinite(back)]
        dark = [e.t for e in spec.events if e.kind in capacity_kinds]
        pick = (kills if i % 2 == 0 else dark) or kills or dark
        if pick:
            t0[i] = np.floor(min(pick))
    return t0


def down_mid_interval(act):
    """Whether some (env, flow) is active at the interval's first substep
    and down at a later one: a down window that opens mid-interval."""
    return bool(((act[:, :1] == 1.0) & (act[:, 1:] == 0.0)).any())


def all_down(args, env=0, substeps=slice(10, 20)):
    """``args`` with every flow of ``env`` down over ``substeps``."""
    args = [a.clone() if a is not None else None for a in args]
    args[1][env, substeps] = 0.0
    return args


def integrate_operands(torch, params, rates):
    """K1's operands for the rates (E, S, F, 3) of one interval, as
    ``core.fleet._integrate_fleet_rates`` forms them, from empty buffers."""
    E, S, F = rates.shape[:3]
    dt = params.duration / S
    rates_dt = (rates * dt).permute(0, 2, 1, 3).reshape(E * F, S, 3)
    return (torch.zeros((E * F, 2), device=rates.device),
            rates_dt.contiguous(), params.cap.expand(E * F, 2).contiguous())


class FaultedSpec:
    """bench_faults.py's _FaultedSpec: ScenarioSpec-shaped, handing back the
    fault-compiled table."""

    def __init__(self, name, table, horizon):
        self.name = name
        self.horizon = horizon
        self._table = table

    def table(self, *, device=None):
        return type(self._table)(*(x.to(device) for x in self._table))


def eval_world(horizon, n_flows):
    """bench_faults.py's eval_world, on the card: a kill of the last flow at
    0.25 h (its share released), a stage-1 hang over 0.45-0.55 h and the
    restart at 0.65 h. Returns (spec-like, flows, t_fail, t_back)."""
    from repro_torch.scenarios import (ScenarioSpec, FaultEvent, FaultSpec,
                                       arrival_schedule,
                                       apply_faults_to_table,
                                       apply_faults_to_flows)
    base = ScenarioSpec(family="static", seed=11, horizon=horizon,
                        base_tpt=FAULT_TPT, base_bw=FAULT_BW)
    flows = arrival_schedule("always_on", n_flows, horizon=horizon, seed=11,
                             device="cuda")
    t_fail = 0.25 * horizon
    t_back = 0.65 * horizon
    spec = FaultSpec(name="bench", events=[
        FaultEvent(kind="kill_flow", t=t_fail, flow=n_flows - 1),
        FaultEvent(kind="stage_hang", t=0.45 * horizon,
                   until=0.55 * horizon, stage=1),
        FaultEvent(kind="restart_flow", t=t_back, flow=n_flows - 1)])
    table = apply_faults_to_table(spec, base.table(device="cuda"))
    flows = apply_faults_to_flows(spec, flows)
    return (FaultedSpec(f"faulted-{base.name}", table, horizon), flows,
            t_fail, t_back)


def fault_metrics(ev, duration, t_fail, t_back, *,
                  recovery_frac=FAULT_RECOVERY_FRAC,
                  completion_frac=FAULT_COMPLETION_FRAC):
    """bench_faults.py's fault_metrics: (recovery_s, deficit_s,
    completion_s) from a goodput trace. recovery_s: sim-seconds from the
    capacity's return (t_back) until the aggregate goodput is back at
    ``recovery_frac`` of its pre-fault mean; deficit_s: the integrated
    shortfall below that mean from the failure on, in seconds of
    pre-fault goodput; completion_s: sim-seconds until ``completion_frac``
    of the faulted world's achievable volume is delivered."""
    agg = ev.goodput.sum(axis=1)
    t_mid = (np.arange(len(agg)) + 0.5) * duration
    pre = agg[t_mid < t_fail]
    pre_mean = float(pre.mean()) if len(pre) else 0.0
    target = recovery_frac * pre_mean
    recovery = None
    for t, g in zip(t_mid, agg):
        if t >= t_back and g >= target:
            recovery = float(t - t_back) + 0.5 * duration
            break
    post = agg[t_mid >= t_fail]
    deficit = (float(np.maximum(pre_mean - post, 0.0).sum() * duration
                     / max(pre_mean, 1e-9)) if len(post) else 0.0)
    achievable = ev.delivered / max(ev.utilization, 1e-9)
    cum = np.cumsum(agg) * duration
    hit = np.nonzero(cum >= completion_frac * achievable)[0]
    completion = float((hit[0] + 1) * duration) if len(hit) else None
    return recovery, deficit, completion


def held_out_spec(horizon, *, seed=23):
    """bench_online.py's held_out_spec: the held-out ``step`` collapse of
    the network stage's per-thread share to COLLAPSE at AT_FRAC of the
    horizon."""
    from repro_torch.scenarios import ScenarioSpec
    return ScenarioSpec(family="step", seed=seed, horizon=horizon,
                        base_tpt=ONLINE_TPT, base_bw=ONLINE_BW,
                        params=dict(stage=1, at_frac=AT_FRAC,
                                    factor=COLLAPSE, mode="tpt"))


def recovery_metrics(ev, duration, t_fail):
    """bench_online.py's recovery_metrics: (recovery_s, deficit_s) from
    the onset: seconds until the aggregate goodput is back at
    ONLINE_RECOVERY_FRAC of its pre-onset mean, and the integrated
    post-onset shortfall in seconds of pre-onset goodput."""
    agg = ev.goodput.sum(axis=1)
    j_fail = max(int(round(t_fail / duration)) - 1, 1)
    pre = float(agg[:j_fail].mean())
    post = agg[j_fail:]
    deficit_s = float(np.maximum(pre - post, 0.0).sum() * duration
                      / max(pre, 1e-9))
    back = np.nonzero(post >= ONLINE_RECOVERY_FRAC * pre)[0]
    recovery_s = ((back[0] + 1) * duration if back.size
                  else post.size * duration)
    return recovery_s, deficit_s


def k1_k3_rows(torch, tag, k3_args, rounds, k1_args, *, launches=None):
    """K3 and K1 held and timed on one interval's operands from a path;
    returns ({name: K3 row}, {name: K1 row})."""
    k3 = contention_check(torch, tag, k3_args, rounds)
    k1 = sim_check(torch, tag, *k1_args)
    k3["launches"] = k1["launches"] = launches
    print(f"[sim_interval] {tag} E={k1['E']} S={k1['S']}: bitwise; "
          f"ms={k1['ms']} device_ms={k1['device_ms']} plain_ms="
          f"{k1['plain_ms']} bound_ms={k1['bound_ms']:.3g} "
          f"({k1['bound_by']})")
    return {tag: k3}, {tag: k1}


def phase_faults(torch):
    """16. Faults: bench_faults.py's fault-randomized fleet policy trained
    through train_ppo (each round's fault draw compiled into its tables
    and flows), the fault-blind single-flow agent trained as
    train_independent_agent does it, the three actors scored on
    eval_world; then a FaultInjector replaying a hang, a kill and a restart
    against a CheckpointedFlow that the port's AutoMDTController steers.
    K1 and K3 held on the training's and the scoring's own operands."""
    import tempfile
    from repro_torch.core import (PPOConfig, train_ppo, make_env_params,
                                  effective_obs_spec, FleetPolicy,
                                  AutoMDTController, GlobusController,
                                  FLEET_OBS, CONTEXT_OBS)
    from repro_torch.core import fleet as fleet_mod, simulator as sim_mod
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.kernels.contention.ref import contention_rates_reference
    from repro_torch.scenarios import (sample_fleet_batch, sample_objectives,
                                       run_fleet_in_dynamic_sim, FaultEvent,
                                       FaultSpec, FaultInjector,
                                       compile_fault_batch)
    from repro_torch.transfer import (TransferEngine, SyntheticSource,
                                      ChecksumSink, StageThrottle,
                                      RetryPolicy, CheckpointedFlow)
    n_envs, n_flows, horizon = FAULT_ENVS, FAULT_FLOWS, FAULT_HORIZON
    params = make_env_params(tpt=list(FAULT_TPT), bw=list(FAULT_BW),
                             cap=[2.0, 2.0], n_max=FAULT_N_MAX,
                             device="cuda")

    def draw(rnd, seed=1):
        wl = sample_fleet_batch(n_envs, n_flows, seed=seed * 7919 + rnd,
                                horizon=horizon, base_tpt=FAULT_TPT,
                                base_bw=FAULT_BW, fault_mix=FAULT_MIX,
                                device="cuda")
        return wl.replace(objectives=None, specs=None)

    cfg = PPOConfig(max_episodes=FAULT_EPISODES, n_envs=n_envs,
                    action_scale=FAULT_N_MAX / 4, seed=1, obs_spec=FLEET_OBS,
                    param_selection="batch_mean", n_flows=n_flows,
                    fairness_coef=0.5, device="cuda")
    copies0 = compile_fault_batch.host_copies
    reset_launches()
    res = train_ppo(params, cfg, workload=draw(0), resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    rounds = res.episodes // n_envs
    copies = compile_fault_batch.host_copies - copies0
    hist = np.asarray(res.history, float)
    batch_means = hist[: rounds * n_envs].reshape(rounds, n_envs).mean(1)
    print(f"[faults train] {res.episodes} fault-randomized episodes "
          f"({rounds} rounds of {n_envs} envs x {n_flows} flows, "
          f"{cfg.max_steps} steps) in {res.wall_s:.3f} s = "
          f"{res.episodes / res.wall_s:.1f} episodes/s; best batch-mean "
          f"reward {batch_means.max():.4f}, last {batch_means[-1]:.4f}; "
          f"host copies of the fault compile {copies} "
          f"({copies / rounds:.2f} a round, one to the host and one back "
          f"per edited structure); launches {json.dumps(train_launches)}")
    if not np.all(np.isfinite(hist)):
        fail("non-finite fault training reward")
    expected = rounds * (cfg.max_steps + 1)
    if (train_launches["contention"] != expected
            or train_launches["sim_interval"] != expected):
        fail(f"fault training launched {json.dumps(train_launches)}, "
             f"expected contention = sim_interval = {rounds} rounds x "
             f"{cfg.max_steps + 1} = {expected}")
    fault_pol = FleetPolicy(res.params["policy"], n_max=FAULT_N_MAX,
                            deterministic=True,
                            obs_spec=effective_obs_spec(cfg), device="cuda")

    icfg = PPOConfig(max_episodes=FAULT_EPISODES, n_envs=n_envs,
                     action_scale=FAULT_N_MAX / 4, seed=1,
                     obs_spec=CONTEXT_OBS, param_selection="batch_mean",
                     device="cuda")
    # K1's operands from one step in the middle of this training: the
    # single-flow simulator's 16 rows
    mid = (-(-icfg.max_episodes // n_envs) // 2 * (icfg.max_steps + 1)
           + icfg.max_steps // 2)
    reset_launches()
    with Recorder(sim_mod, "sim_interval_batch", keep=(mid,)) as blind_rec:
        indep = train_ppo(params, icfg)
    torch.cuda.synchronize()
    frozen_launches = read_launches()
    irounds = indep.episodes // n_envs
    print(f"[faults train] the fault-blind single-flow agent: "
          f"{indep.episodes} episodes in {indep.wall_s:.3f} s = "
          f"{indep.episodes / indep.wall_s:.1f} episodes/s; best reward "
          f"{indep.best_reward:.4f}; launches "
          f"{json.dumps(frozen_launches)}")
    if not np.all(np.isfinite(indep.history)):
        fail("non-finite single-flow training reward")
    if (frozen_launches["sim_interval"] != irounds * (icfg.max_steps + 1)
            or frozen_launches["contention"] != 0
            or blind_rec.n != frozen_launches["sim_interval"]
            or len(blind_rec.calls) != 1):
        fail(f"the single-flow agent's training launched "
             f"{json.dumps(frozen_launches)}")

    spec, flows, t_fail, t_back = eval_world(horizon, n_flows)
    # demands scaled to what the faulted, contended link can move per flow
    objectives = sample_objectives(n_flows, seed=11, horizon=horizon,
                                   base_bw=tuple(b / n_flows
                                                 for b in FAULT_BW),
                                   device="cuda")
    duration = float(params.duration)
    actors = {
        "fault_trained": fault_pol,
        "automdt_frozen": [AutoMDTController(
            indep.params["policy"], n_max=FAULT_N_MAX,
            bw_ref=float(max(FAULT_BW)), deterministic=True,
            obs_spec=CONTEXT_OBS, device="cuda") for _ in range(n_flows)],
        "static": [GlobusController() for _ in range(n_flows)]}
    reset_launches()
    evals, metrics = {}, {}
    with Recorder(fleet_mod, "contention_rates") as k3_rec, \
            Recorder(fleet_mod, "sim_interval_batch") as k1_rec:
        for label, actor in actors.items():
            ev = run_fleet_in_dynamic_sim(spec, flows, params, actor, seed=7,
                                          label=label, objectives=objectives,
                                          apply_floors=False)
            evals[label] = ev
            metrics[label] = fault_metrics(ev, duration, t_fail, t_back)
            if not (np.isfinite(ev.utilization) and np.isfinite(ev.jain)
                    and np.all(np.isfinite(ev.goodput))
                    and np.isfinite(metrics[label][1])):
                fail(f"non-finite fault scoring of {label}")
    torch.cuda.synchronize()
    eval_launches = read_launches()
    steps = int(round(horizon / duration))
    runs = len(actors)
    for label, ev in evals.items():
        rec, deficit, completion = metrics[label]
        print(f"[faults eval] {label}: recovery_s {rec} deficit_s "
              f"{deficit:.4f} completion_s {completion} deadline hit rate "
              f"{ev.deadline_hit_rate:.4f} ({ev.deadline_hits}/"
              f"{ev.deadline_total}) utilization {ev.utilization:.4f}")
    ratios = {}
    for base in ("automdt_frozen", "static"):
        ours = max(metrics["fault_trained"][1], duration / 2)
        ratios[base] = max(metrics[base][1], duration / 2) / ours
    bar = ratios["automdt_frozen"] > 1.0
    print(f"[faults eval] deficit ratio fault_trained vs automdt_frozen "
          f"{ratios['automdt_frozen']:.4f}, vs static "
          f"{ratios['static']:.4f}; the reference's bar (fault_trained "
          f"recovers faster than automdt_frozen): "
          f"{'held' if bar else 'NOT held'}")
    print(f"[faults eval] launches {json.dumps(eval_launches)} over {runs} "
          f"runs of 1 reset + {steps} steps; expected {runs * (1 + steps)} "
          f"of each (fleet_achievable launches none)")
    if (eval_launches["contention"] != runs * (1 + steps)
            or eval_launches["sim_interval"] != runs * (1 + steps)):
        fail("fault scoring launched the kernels an unexpected number of "
             "times")

    # K1 and K3 on the path's own operands: one interval of the training
    # world (a compiled fault draw, each env's interval opening where a
    # down window or a dark bin falls) and a scoring step inside the hang
    for rnd in range(8):
        raw = draw(rnd)
        run = raw.compiled()
        t0 = torch.from_numpy(fault_start_times(
            raw.faults, ("stage_hang",))).cuda()
        rng = np.random.default_rng(16)
        threads = torch.from_numpy(rng.integers(
            1, 51, (n_envs, n_flows, 3)).astype(np.float32)).cuda()
        bufs, _ = fleet_mod.fleet_interval(
            params, torch.zeros((n_envs, n_flows, 2), device="cuda"),
            threads, t0 - 1.0, flows=run.flows, table=run.tables)
        with Recorder(fleet_mod, "contention_rates") as r3, \
                Recorder(fleet_mod, "sim_interval_batch") as r1:
            fleet_mod.fleet_interval(params, bufs, threads, t0,
                                     flows=run.flows, table=run.tables)
        train_k3, train_k1 = r3.calls[0][0], r1.calls[0][0]
        if (down_mid_interval(train_k3[1])
                and bool((train_k3[3] == 0.0).any())):
            break
    else:
        fail("no fault draw gave an interval with a down window opening "
             "mid-interval and a dark table bin")
    print(f"[faults kernels] training operands from round {rnd}'s draw: "
          f"{int((train_k3[3] == 0.0).any(dim=-1).sum())} dark (env, "
          f"substep) bins, {int((1.0 - train_k3[1]).sum())} down (env, "
          f"substep, flow) entries")
    hang = [i for i, c in enumerate(k3_rec.calls)
            if bool((c[0][3] == 0.0).any())]
    if not hang:
        fail("no scoring step ran inside the hang")
    i = hang[len(hang) // 2]
    k3_rows, k1_rows = k1_k3_rows(torch, "fault_train", train_k3, 0,
                                  train_k1,
                                  launches=train_launches["contention"])
    for tag, k3a, k1a, n in (
            ("fault_eval", k3_rec.calls[i][0], k1_rec.calls[i][0],
             eval_launches["contention"]),
            ("fault_all_down", all_down(train_k3), None, None)):
        if k1a is None:   # K1 on the rates of the all-down solve
            k1a = integrate_operands(torch, params,
                                     contention_rates_reference(*k3a))
        r3, r1 = k1_k3_rows(torch, tag, k3a, 0, k1a, launches=n)
        k3_rows.update(r3)
        k1_rows.update(r1)
    blind = sim_check(torch, "fault_blind_train", *blind_rec.calls[0][0])
    blind["launches"] = frozen_launches["sim_interval"]
    k1_rows["fault_blind_train"] = blind
    print(f"[sim_interval] fault_blind_train E={blind['E']} S={blind['S']} "
          f"(call {mid} of the fault-blind agent's training): bitwise; "
          f"ms={blind['ms']} device_ms={blind['device_ms']} plain_ms="
          f"{blind['plain_ms']} bound_ms={blind['bound_ms']:.3g} "
          f"({blind['bound_by']})")

    # live: a hang, a kill and a restart replayed by FaultInjector against
    # a CheckpointedFlow, steered by the fault-blind agent; 1.0 sim Gbit/s
    # = 8 MB/s
    unit = 8 * MB
    total, chunk = FAULT_LIVE_MB * MB, 128 * 1024
    throttles = tuple(StageThrottle(b * unit, t * unit)
                      for t, b in zip(FAULT_TPT, FAULT_BW))
    interval = 0.3
    ctl = AutoMDTController(indep.params["policy"], n_max=FAULT_N_MAX,
                            bw_ref=max(FAULT_BW) * unit, deterministic=True,
                            obs_spec=CONTEXT_OBS, interval=interval,
                            device="cuda")
    live_spec = FaultSpec(name="live", events=[
        FaultEvent(**e) for e in FAULT_LIVE_EVENTS])
    sink = ChecksumSink()
    steered = 0
    with tempfile.TemporaryDirectory() as ckpt:
        flow = CheckpointedFlow(total, sink, ckpt_dir=ckpt,
                                chunk_bytes=chunk, seed=5,
                                engine_kwargs=dict(
                                    throttles=throttles, retry=RetryPolicy(),
                                    sender_buf=2 * unit,
                                    receiver_buf=2 * unit,
                                    initial_concurrency=(2, 2, 2),
                                    n_max=FAULT_N_MAX, metric_interval=0.2))
        flow.start()
        inj = FaultInjector(flow.engine, live_spec,
                            on_kill=lambda f: flow.kill(),
                            on_restart=lambda f: flow.restart(), tick=0.02,
                            time_scale=FAULT_LIVE_SCALE)
        t0 = time.monotonic()
        try:
            with inj:
                while (not flow.done()
                       and time.monotonic() - t0 < 45.0):
                    eng = flow.engine
                    if eng is not None and eng.alive:
                        eng.set_concurrency(ctl.step(eng.observe()))
                        steered += 1
                    time.sleep(interval)
                fired = len(inj._fired)
        finally:
            flow.close()
        live_wall = time.monotonic() - t0
    ref = ChecksumSink()
    eng = TransferEngine(SyntheticSource(total, chunk_bytes=chunk, seed=5),
                         ref, initial_concurrency=(8, 8, 8))
    deadline = time.monotonic() + 30.0
    while not eng.done() and time.monotonic() < deadline:
        time.sleep(0.02)
    eng.close()
    intact = sink.digest == ref.digest and sink.nbytes == total
    print(f"[faults live] FaultInjector replayed {fired} of "
          f"{len(live_spec.events)} events (hang, kill, restart; "
          f"{FAULT_LIVE_SCALE:.0f} sim s per wall s) in {live_wall:.2f} s; "
          f"{sink.nbytes / MB:.2f} of {total / MB:.0f} MB, done "
          f"{flow.done()}, replayed bytes {flow.cursor.replayed}, checksum "
          f"{'intact' if intact else 'DIFFERS'}; {steered} controller "
          f"steps, {ctl.n_dispatch} policy dispatches")
    if not (flow.done() and flow.cursor.replayed == 0 and intact
            and fired == len(live_spec.events) and ctl.n_dispatch > 0):
        fail("the live fault replay lost, replayed or corrupted bytes, or "
             "did not replay every event under the port's controller")

    fn = _make_episode_fn(params, cfg, randomize_t0=True)
    state = init_agent(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wl0 = draw(0)

    def one_round():
        run = wl0.compiled()
        return fn(state, run.tables, gen, flows=run.flows)

    prof = profile_round(torch, one_round,
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[faults profile] n_envs={n_envs} x {n_flows} flows, the fault "
          f"compile included: " + json.dumps(prof))
    return dict(res=res, train_launches=train_launches,
                frozen_launches=frozen_launches,
                eval_launches=eval_launches, k3=k3_rows, k1=k1_rows,
                ratios=ratios, bar=bar, profile=prof,
                copies_per_round=copies / rounds)


def phase_online(torch):
    """17. Online adaptation: bench_online.py's frozen fleet policy trained
    on the families outside HOLDOUT, scored on the held-out step collapse
    as the online policy (OnlineFleetPolicy with ONLINE_CFG), frozen and
    static; then FleetController(online=) steering four live engines on
    one SharedLink."""
    from repro_torch.core import (PPOConfig, train_ppo, make_env_params,
                                  effective_obs_spec, FleetPolicy,
                                  FleetController, GlobusController,
                                  OnlineConfig, OnlineFleetPolicy, FLEET_OBS)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import (holdout_families, sample_fleet_batch,
                                       arrival_schedule,
                                       run_fleet_in_dynamic_sim)
    from repro_torch.transfer import (SharedLink, SyntheticSource,
                                      ChecksumSink)
    n_envs, n_flows, horizon = ONLINE_ENVS, ONLINE_FLOWS, ONLINE_HORIZON
    params = make_env_params(tpt=list(ONLINE_TPT), bw=list(ONLINE_BW),
                             cap=[2.0, 2.0], n_max=ONLINE_N_MAX,
                             device="cuda")
    duration = float(params.duration)
    train_families, held = holdout_families(HOLDOUT)

    def draw(rnd, seed=1):
        wl = sample_fleet_batch(n_envs, n_flows,
                                families=tuple(train_families),
                                seed=seed * 7919 + rnd, horizon=horizon,
                                base_tpt=ONLINE_TPT, base_bw=ONLINE_BW,
                                device="cuda")
        return wl.replace(objectives=None, specs=None)

    cfg = PPOConfig(max_episodes=ONLINE_EPISODES, n_envs=n_envs,
                    action_scale=ONLINE_N_MAX / 4, seed=1,
                    obs_spec=FLEET_OBS, param_selection="batch_mean",
                    n_flows=n_flows, fairness_coef=0.5, device="cuda")
    reset_launches()
    res = train_ppo(params, cfg, workload=draw(0), resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    rounds = res.episodes // n_envs
    print(f"[online train] {res.episodes} episodes on "
          f"{'/'.join(train_families)} (held out: {'/'.join(held)}) in "
          f"{res.wall_s:.3f} s = {res.episodes / res.wall_s:.1f} "
          f"episodes/s; best reward {res.best_reward:.4f}; launches "
          f"{json.dumps(train_launches)}")
    if not np.all(np.isfinite(res.history)):
        fail("non-finite online-phase training reward")
    expected = rounds * (cfg.max_steps + 1)
    if (train_launches["contention"] != expected
            or train_launches["sim_interval"] != expected):
        fail(f"online-phase training launched {json.dumps(train_launches)}"
             f", expected {expected} of each")
    fleet = FleetPolicy(res.params["policy"], n_max=ONLINE_N_MAX,
                        deterministic=True, obs_spec=effective_obs_spec(cfg),
                        device="cuda")
    spec = held_out_spec(horizon)
    flows = arrival_schedule("always_on", n_flows, horizon=horizon, seed=11,
                             device="cuda")
    t_fail = AT_FRAC * horizon
    online = OnlineFleetPolicy(fleet, OnlineConfig(**ONLINE_CFG),
                               n_flows=n_flows)
    actors = {"online": online, "frozen": fleet,
              "static": [GlobusController() for _ in range(n_flows)]}
    reset_launches()
    evals, deficits = {}, {}
    for label, actor in actors.items():
        ev = run_fleet_in_dynamic_sim(spec, flows, params, actor, seed=7,
                                      label=label)
        evals[label] = ev
        rec_s, deficit_s = recovery_metrics(ev, duration, t_fail)
        deficits[label] = deficit_s
        if not (np.isfinite(ev.utilization) and np.isfinite(deficit_s)
                and np.all(np.isfinite(ev.goodput))):
            fail(f"non-finite online-phase scoring of {label}")
        print(f"[online eval] {label}: recovery_s {rec_s} deficit_s "
              f"{deficit_s:.4f} utilization {ev.utilization:.4f}")
    torch.cuda.synchronize()
    eval_launches = read_launches()
    steps = int(round(horizon / duration))
    ratios = {b: deficits[b] / max(deficits["online"], duration / 2.0)
              for b in ("frozen", "static")}
    ad = online.adapter
    bar = deficits["online"] < deficits["frozen"]
    print(f"[online eval] deficit ratio online vs frozen "
          f"{ratios['frozen']:.4f}, vs static {ratios['static']:.4f}; "
          f"adapter mode {ad.mode}, fallbacks {ad.n_fallbacks}, buffer "
          f"{len(ad.buffer)}, fed {ad._fed}, mean network residual "
          f"{ad.residual[:, 1].mean():+.1f}; the reference's bar (online's "
          f"deficit below frozen's): {'held' if bar else 'NOT held'}")
    print(f"[online eval] launches {json.dumps(eval_launches)}; expected "
          f"{len(actors)} x (1 + {steps}) = {len(actors) * (1 + steps)} of "
          f"each")
    if (eval_launches["contention"] != len(actors) * (1 + steps)
            or eval_launches["sim_interval"] != len(actors) * (1 + steps)):
        fail("online-phase scoring launched the kernels an unexpected "
             "number of times")

    # live: FleetController with the online head on one SharedLink
    unit = 8 * MB
    link = SharedLink(aggregate_bps=tuple(b * unit for b in ONLINE_BW),
                      per_thread_bps=tuple(t * unit for t in ONLINE_TPT))
    for f in range(n_flows):
        link.attach(SyntheticSource(1 << 40, chunk_bytes=128 * 1024, seed=f),
                    ChecksumSink(), sender_buf=2 * unit,
                    receiver_buf=2 * unit, initial_concurrency=(2, 2, 2),
                    n_max=ONLINE_N_MAX, metric_interval=0.1)
    interval = 0.25
    ctl = FleetController(res.params["policy"], n_flows=n_flows,
                          n_max=ONLINE_N_MAX, bw_ref=max(ONLINE_BW) * unit,
                          obs_spec=fleet.obs_spec, interval=interval,
                          deterministic=True,
                          online=OnlineConfig(**ONLINE_CFG), device="cuda")
    t0 = time.monotonic()
    try:
        trace = ctl.run(link, interval=interval, max_steps=ONLINE_LIVE_STEPS)
        live_wall = time.monotonic() - t0
        moved = sum(link.bytes_written_all())
    finally:
        link.close()
    lad = ctl._online
    in_range = all(1 <= n <= ONLINE_N_MAX for _, threads, _ in trace
                   for n3 in threads for n in n3)
    print(f"[online live] {len(trace)} control intervals in "
          f"{live_wall:.2f} s, {moved / MB:.2f} MB moved; adapter fed "
          f"{lad._fed}, buffer {len(lad.buffer) if lad.buffer else 0}, mode "
          f"{lad.mode}; every applied action in [1, {ONLINE_N_MAX}]: "
          f"{in_range}; {ctl.fleet_policy.n_dispatch} policy dispatches")
    if not (len(trace) == ONLINE_LIVE_STEPS
            and lad._fed >= ONLINE_LIVE_STEPS - 1 and lad.buffer
            and len(lad.buffer) > 0 and lad.mode in ("on", "off")
            and in_range and moved > 0):
        fail("the live online controller missed one of the reference's "
             "four points (fed every interval, buffer filled, warmup left, "
             "actions in range)")

    fn = _make_episode_fn(params, cfg, randomize_t0=True)
    state = init_agent(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wl0 = draw(0)
    prof = profile_round(torch, lambda: fn(state, wl0.tables, gen,
                                           flows=wl0.flows),
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[online profile] n_envs={n_envs} x {n_flows} flows: "
          + json.dumps(prof))
    return dict(res=res, train_launches=train_launches,
                eval_launches=eval_launches, deficits=deficits,
                ratios=ratios, bar=bar, profile=prof)


def update_gap(torch, seed, n_envs):
    """The PPO update alone of one phase-18 episode batch: the rollout made
    on the CPU, then ``ppo_epochs`` epochs of ``ppo._ppo_epoch`` from the
    same parameters on each device, in float32 and in float64 (the
    moments' dtype is AdamW's arithmetic). No port kernel runs in the
    update. Returns ({comparison: [max parameter gap after each epoch]}
    for the card against the CPU in each dtype and float32 against
    float64 on each device; [per-leaf rows of the first float32 epoch,
    card against CPU]; {device: (ReLU inputs of the first epoch's policy
    whose float32 sign differs from float64's, the smallest |input| among
    them)})."""
    import copy
    import inspect
    from repro_torch.core.ppo import (init_agent, _rollout_topology,
                                      effective_obs_spec, _returns,
                                      _ppo_epoch)
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.scenarios import sample_topology_batch
    adam = {k: v.default for k, v in
            inspect.signature(adamw_update).parameters.items()
            if k in ("b1", "b2", "eps")}
    cfg = topology_config("cpu", episodes=n_envs, n_envs=n_envs, seed=seed)
    wl = sample_topology_batch(
        n_envs, TOPO_FLOWS, n_links=TOPO_LINKS, seed=seed,
        horizon=TOPO_HORIZON, base_tpt=FLEET_TPT, base_bw=FLEET_BW,
        objective_mix=dict(floor_deadline_frac=TOPO_FLOOR_FRAC),
        fault_mix=TOPO_FAULT_MIX, device="cpu").compiled()
    rng = np.random.default_rng(seed)   # topology_episode's draws
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    draws = dict(threads0=to(rng.integers(1, 16, (n_envs, TOPO_FLOWS, 3))),
                 t0_draw=to(rng.random(n_envs)),
                 noise=to(rng.normal(size=(cfg.max_steps, n_envs,
                                           TOPO_FLOWS, 3))))
    state = init_agent(cfg)
    obs, act, rew, logp = _rollout_topology(
        state["params"]["policy"], fleet_params("cpu"), wl.topology,
        wl.flows, wl.objectives, n_envs=n_envs, n_flows=TOPO_FLOWS,
        M=cfg.max_steps, substeps=cfg.substeps, spec=effective_obs_spec(cfg),
        randomize_t0=True, fairness_coef=cfg.fairness_coef,
        deadline_coef=cfg.deadline_coef, **draws)
    ret = _returns(rew, cfg.gamma)[:, :, None].expand_as(logp)
    batch = (obs.reshape(-1, obs.shape[-1]), act.reshape(-1, 3),
             ret.reshape(-1), logp.reshape(-1))
    after, first, relu_in = {}, {}, {}
    for dtype in ("float32", "float64"):
        for dev in ("cuda", "cpu"):
            dt = getattr(torch, dtype)
            params = copy.deepcopy(state["params"]).to(dev, dt)
            opt = {k: {n: t.to(dev, dt) for n, t in state["opt"][k].items()}
                   for k in ("m", "v")}
            opt["step"] = state["opt"]["step"].to(dev)
            b = tuple(x.to(dev, dt) for x in batch)
            snaps = after[dtype, dev] = []
            # the policy's ReLUs take its blocks' LayerNorm outputs
            ins = relu_in[dtype, dev] = {}

            def keep(module, inputs, out, ins=ins):
                ins[module] = out.detach().cpu().double()
            hooks = [m.register_forward_hook(keep)
                     for name, m in params["policy"].named_modules()
                     if name.split(".")[-1] in ("ln1", "ln2")]
            for epoch in range(cfg.ppo_epochs):
                opt, _, grads = _ppo_epoch(params, b, opt, cfg)
                for h in hooks:   # the first epoch's inputs only
                    h.remove()
                hooks = []
                snaps.append({n: q.detach().cpu().double().clone()
                              for n, q in params.named_parameters()})
                if epoch == 0 and dtype == "float32":
                    # Adam's first step: m-hat / (sqrt(v-hat) + eps)
                    mhat = {n: (m / (1 - adam["b1"])).cpu()
                            for n, m in opt["m"].items()}
                    den = {n: (torch.sqrt(v / (1 - adam["b2"]))
                               + adam["eps"]).cpu()
                           for n, v in opt["v"].items()}
                    first[dev] = ({n: g.cpu() for n, g in grads.items()},
                                  mhat, den, snaps[0])
    pairs = {"card_vs_cpu_float32": (("float32", "cuda"), ("float32", "cpu")),
             "card_vs_cpu_float64": (("float64", "cuda"), ("float64", "cpu")),
             "cpu_float32_vs_float64": (("float32", "cpu"),
                                        ("float64", "cpu")),
             "card_float32_vs_float64": (("float32", "cuda"),
                                         ("float64", "cuda"))}
    gaps = {name: [max(float((x[n] - y[n]).abs().max()) for n in x)
                   for x, y in zip(after[a], after[b])]
            for name, (a, b) in pairs.items()}
    rows = []
    for n in first["cpu"][0]:
        (g_c, m_c, d_c, p_c), (g_g, m_g, d_g, p_g) = (first["cpu"],
                                                      first["cuda"])
        gap = (p_c[n] - p_g[n]).abs().flatten()
        j = int(gap.argmax())
        at = lambda t: float(t[n].flatten()[j])
        rows.append(dict(
            leaf=n, abs_g=float(g_c[n].abs().max()),
            g_gap=float((g_c[n] - g_g[n]).abs().max()),
            param_gap=float(gap[j]), g=(at(g_c), at(g_g)),
            denom=(at(d_c), at(d_g)),
            step=(at(m_c) / at(d_c), at(m_g) / at(d_g))))
    kinks = {}
    for dev in ("cuda", "cpu"):
        x32, x64 = (list(relu_in[t, dev].values())
                    for t in ("float32", "float64"))
        flip = [(a > 0) != (b > 0) for a, b in zip(x32, x64)]
        near = [float(b[f].abs().min()) for b, f in zip(x64, flip)
                if bool(f.any())]
        kinks[dev] = (sum(int(f.sum()) for f in flip),
                      min(near) if near else None)
    return gaps, rows, kinks


def phase_topology_faults(torch, topo_policy):
    """18. The topology under faults, and capped scoring: topology PPO at
    bench_topology's width over a world with floors and fault draws with
    link blackouts; one episode batch of that world on the card against
    the CPU; phase 15's policy scored by run_topology_in_dynamic_sim with
    two flows capped, the caps held at every step, the card run's actions
    replayed open-loop on the CPU (the water-fill against its plain
    version) and without caps on the card (what the spill moved). K3 held
    on the training's and the capped scoring's own operands."""
    from repro_torch.core import (train_ppo, FlowObjective,
                                  make_flow_objective)
    from repro_torch.core import topology as topo_mod, fleet as fleet_mod
    from repro_torch.core.topology import (topology_reset, topology_step,
                                           _batched_topology)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import (TopologySpec, arrival_schedule,
                                       sample_topology_batch,
                                       run_topology_in_dynamic_sim,
                                       compile_fault_batch)
    from repro_torch.device import as_f32
    params = fleet_params("cuda")
    n_envs, F = TOPO_ENVS, TOPO_FLOWS
    rounds = TOPO_FAULT_ROUNDS

    def draw(rnd, seed=1):
        wl = sample_topology_batch(
            n_envs, F, n_links=TOPO_LINKS, seed=seed * 7919 + rnd,
            horizon=TOPO_HORIZON, base_tpt=FLEET_TPT, base_bw=FLEET_BW,
            objective_mix=dict(floor_deadline_frac=TOPO_FLOOR_FRAC),
            fault_mix=TOPO_FAULT_MIX, device="cuda")
        return wl.replace(specs=None)

    cfg = topology_config("cuda", episodes=rounds * n_envs, n_envs=n_envs)
    copies0 = compile_fault_batch.host_copies
    reset_launches()
    res = train_ppo(params, cfg, workload=draw(0), resample=draw)
    torch.cuda.synchronize()
    train_launches = read_launches()
    copies = compile_fault_batch.host_copies - copies0
    got_rounds = res.episodes // n_envs
    print(f"[topology faults train] {res.episodes} episodes ({got_rounds} "
          f"rounds of {n_envs} envs x {F} flows over {TOPO_LINKS} links, "
          f"floors {TOPO_FLOOR_FRAC} of the link per deadline flow, faults "
          f"{json.dumps(TOPO_FAULT_MIX)}) in {res.wall_s:.3f} s = "
          f"{res.episodes / res.wall_s:.1f} episodes/s; host copies of the "
          f"fault compile {copies} ({copies / got_rounds:.2f} a round); "
          f"launches {json.dumps(train_launches)}")
    if not np.all(np.isfinite(res.history)):
        fail("non-finite faulted topology training reward")
    expected = got_rounds * (cfg.max_steps + 1)
    if (got_rounds < TOPO_FAULT_ROUNDS
            or train_launches["contention"] != expected
            or train_launches["sim_interval"] != expected):
        fail(f"faulted topology training launched "
             f"{json.dumps(train_launches)}, expected {expected} of each")

    gaps = {}
    for seed in (TOPO_AGREE_SEED, TOPO_UPDATE_GAP_SEED):
        out = {d: topology_episode(torch, d, seed=seed, objectives=True,
                                   n_envs=n_envs, faults=True)
               for d in ("cuda", "cpu")}
        gaps[seed] = (
            float((out["cuda"][0] - out["cpu"][0]).abs().max()),
            max(float((out["cuda"][1][n] - out["cpu"][1][n]).abs().max())
                for n in out["cpu"][1]))
    err_rew, err_par = gaps[TOPO_AGREE_SEED]
    upd, leaves, kinks = update_gap(torch, TOPO_UPDATE_GAP_SEED, n_envs)
    print(f"[topology faults agree] card vs CPU, one episode batch of this "
          f"world ({n_envs} envs x {F} flows over {TOPO_LINKS} links, "
          f"floors and blackouts), seed {TOPO_AGREE_SEED}: rewards "
          f"{err_rew:.3g}, params {err_par:.3g} (limits 1e-4); seed "
          f"{TOPO_UPDATE_GAP_SEED}: rewards "
          f"{gaps[TOPO_UPDATE_GAP_SEED][0]:.3g} (limit 1e-4), params "
          f"{gaps[TOPO_UPDATE_GAP_SEED][1]:.3g} in float32 (not held)")
    for name, per_epoch in upd.items():
        print(f"[topology faults update] seed {TOPO_UPDATE_GAP_SEED}'s "
              f"update alone from one batch, {name}: max parameter gap "
              f"after each epoch {['%.3g' % x for x in per_epoch]}")
    for dev, (n_flip, near) in kinks.items():
        print(f"[topology faults update] {dev}: {n_flip} ReLU inputs of the "
              f"first epoch's policy on the other side of 0 in float32 "
              f"than in float64 (smallest |input| {near})")
    for r in sorted(leaves, key=lambda r: -r["param_gap"]):
        print(f"[topology faults update] epoch 0, float32, {r['leaf']}: "
              f"|g| max {r['abs_g']:.3g}, gradient gap {r['g_gap']:.3g}; "
              f"largest parameter gap {r['param_gap']:.3g} where g = "
              f"{r['g'][0]:.3g} (CPU) / {r['g'][1]:.3g} (card), "
              f"sqrt(v-hat)+eps {r['denom'][0]:.3g} / {r['denom'][1]:.3g}, "
              f"step / lr {r['step'][0]:.3g} / {r['step'][1]:.3g}")
    err_f64 = upd["card_vs_cpu_float64"][-1]
    print(f"[topology faults agree] seed {TOPO_UPDATE_GAP_SEED}'s update "
          f"in float64, card vs CPU: {err_f64:.3g} (limit "
          f"{TOPO_UPDATE_F64_LIMIT:.3g})")
    if not (err_rew <= 1e-4 and err_par <= 1e-4
            and gaps[TOPO_UPDATE_GAP_SEED][0] <= 1e-4
            and err_f64 <= TOPO_UPDATE_F64_LIMIT):
        fail("the card's faulted topology episode disagrees with the CPU's")

    # K3 on one interval of the training world: each env's interval opens
    # where a blackout or a down window falls
    for rnd in range(8):
        raw = draw(rnd)
        run = raw.compiled()
        t0 = torch.from_numpy(fault_start_times(
            raw.faults, ("link_blackout",))).cuda()
        rng = np.random.default_rng(18)
        threads = torch.from_numpy(rng.integers(
            1, 51, (n_envs, F, 3)).astype(np.float32)).cuda()
        world = dict(graph=run.topology.graph, paths=run.topology.paths,
                     flows=run.flows, objectives=run.objectives)
        bufs, _ = topo_mod.topology_interval(
            params, torch.zeros((n_envs, F, 2), device="cuda"), threads,
            t0 - 1.0, **world)
        with Recorder(topo_mod, "contention_rates") as r3, \
                Recorder(fleet_mod, "sim_interval_batch") as r1:
            topo_mod.topology_interval(params, bufs, threads, t0, **world)
        topo_k3, topo_k1 = r3.calls[0][0], r1.calls[0][0]
        dark_links = (topo_k3[4] == 0.0).all(dim=-1)          # (E, S, L)
        if bool(dark_links.any()) and bool((topo_k3[5] > 0.0).any()):
            break
    else:
        fail("no fault draw gave an interval with a dark link and floors")
    print(f"[topology faults kernels] training operands from round {rnd}'s "
          f"draw: {int(dark_links.sum())} dark (env, substep, link) "
          f"entries, {int((topo_k3[5] > 0).sum())} flows with a floor, "
          f"{int((1.0 - topo_k3[1]).sum())} down (env, substep, flow) "
          f"entries")

    # capped scoring: phase 15's policy on one bench_topology family, two
    # of the four flows capped at a quarter of the link's base bandwidth
    tspec = TopologySpec(family=TOPO_CAP_FAMILY, seed=11, n_links=TOPO_LINKS,
                         n_flows=F, horizon=TOPO_HORIZON, base_tpt=FLEET_TPT,
                         base_bw=FLEET_BW)
    flows = arrival_schedule("staggered_start", F, horizon=TOPO_HORIZON,
                             seed=11, device="cuda")
    cap = TOPO_CAP_FRAC * min(FLEET_BW)
    caps = [cap if f in TOPO_CAPPED else float("inf") for f in range(F)]
    objs = make_flow_objective(rate_cap=caps, device="cuda")
    reset_launches()
    with Recorder(topo_mod, "contention_rates") as rec:
        ev = run_topology_in_dynamic_sim(tspec, flows, params, topo_policy,
                                         seed=7, label="capped",
                                         objectives=objs)
    torch.cuda.synchronize()
    capped_launches = read_launches()
    steps = ev.goodput.shape[0]
    if not (np.all(np.isfinite(ev.goodput)) and np.isfinite(ev.utilization)):
        fail("non-finite capped topology scoring")
    over = max(float(ev.goodput[:, f].max()) - cap for f in TOPO_CAPPED)
    print(f"[topology capped] {TOPO_CAP_FAMILY}, flows {list(TOPO_CAPPED)} "
          f"capped at {cap} Gbit/s: utilization {ev.utilization:.4f} Jain "
          f"{ev.jain:.4f}; the capped flows' largest goodput less the cap "
          f"{over:.3g} (limit 1e-6); launches {json.dumps(capped_launches)} "
          f"(expected contention 1 + 2 x {steps}, sim_interval 1 + {steps})")
    if over > 1e-6:
        fail("a capped flow's goodput exceeded its cap")
    if (capped_launches["contention"] != 1 + 2 * steps
            or capped_launches["sim_interval"] != 1 + steps):
        fail("capped scoring launched the kernels an unexpected number of "
             "times")

    # the card run's actions replayed open-loop: on the CPU through the
    # plain water-fill, and on the card without caps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)   # run_topology_in_dynamic_sim's initial threads
    threads0 = torch.randint(1, 16, (1, F, 3), generator=gen, device="cuda")

    def replay(dev, objectives):
        p = fleet_params(dev)
        graph, paths = _batched_topology(tspec.topology(device=dev))
        world = dict(graph=graph, paths=paths,
                     flows=fleet_mod._map_schedule(
                         lambda x: as_f32(x, dev)[None], flows),
                     objectives=None if objectives is None else FlowObjective(
                         *(as_f32(x, dev)[None] for x in objectives)))
        st = topology_reset(p, 1, F, threads=threads0.to(dev), **world)
        good = []
        for k in range(steps):
            act = torch.from_numpy(ev.threads[k].astype(np.float32))[None]
            st, _, _ = topology_step(p, st, act.to(dev), **world)
            good.append(st.throughputs[0, :, 2].cpu().numpy())
        return np.asarray(good)

    cpu_good = replay("cpu", objs)
    err = float(np.abs(cpu_good - ev.goodput).max())
    free = replay("cuda", None)
    others = [f for f in range(F) if f not in TOPO_CAPPED]
    gain = ev.goodput[:, others].sum(1) - free[:, others].sum(1)
    spilled = int((gain > 1e-6).sum())
    print(f"[topology capped] open-loop replay of the card's actions on the "
          f"CPU (plain water-fill): goodput max abs err {err:.3g} over "
          f"{steps} steps (limit 1e-5); the uncapped flows' total goodput "
          f"above the same actions without caps at {spilled} of {steps} "
          f"steps (largest gain {float(gain.max()):.4g} Gbit/s): the spill "
          f"rounds {'moved' if spilled else 'did NOT move'} bandwidth")
    if not err <= 1e-5:
        fail("the capped water-fill on the card disagrees with its plain "
             "version on the CPU")

    # the capped run's reset and steps (S = 50) and its achievable solves
    # (S = 1, every thread count at n_max), each held on the call with the
    # most flows active; both run with finite caps
    steps_k3 = [c[0] for c in rec.calls if c[0][1].shape[1] > 1]
    ach_k3 = [c[0] for c in rec.calls if c[0][1].shape[1] == 1]
    if len(steps_k3) != 1 + steps or len(ach_k3) != steps:
        fail(f"capped scoring made {len(steps_k3)} solves of 50 substeps "
             f"and {len(ach_k3)} of one, expected {1 + steps} and {steps}")
    busiest = lambda calls: max(calls, key=lambda a: float(a[1].sum()))
    rows = {}
    for tag, args, n in (
            ("topology_faults", topo_k3, train_launches["contention"]),
            ("topology_capped", busiest(steps_k3), len(steps_k3)),
            ("topology_capped_achievable", busiest(ach_k3), len(ach_k3)),
            ("topology_all_down", all_down(topo_k3), None)):
        rows[tag] = contention_check(torch, tag, args, F)
        rows[tag]["launches"] = n
    k1_row = sim_check(torch, "topology_faults", *topo_k1)
    k1_row["launches"] = train_launches["sim_interval"]

    fn = _make_episode_fn(params, cfg, randomize_t0=True)
    state = init_agent(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wl0 = draw(0)

    def one_round():
        run = wl0.compiled()
        return fn(state, None, gen, flows=run.flows,
                  objectives=run.objectives, topology=run.topology)

    prof = profile_round(torch, one_round,
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[topology faults profile] n_envs={n_envs} x {F} flows over "
          f"{TOPO_LINKS} links, floors and faults, the fault compile "
          f"included: " + json.dumps(prof))
    return dict(res=res, train_launches=train_launches,
                capped_launches=capped_launches, k3=rows,
                k1={"topology_faults": k1_row}, profile=prof,
                spilled=spilled, replay_err=err,
                copies_per_round=copies / got_rounds)


def topology_scale_world(torch, F):
    """Phase 19's world on the card, E = 1: phase 9's arrivals at F flows,
    TOPO_LINKS constant links scaled from the fleet's schedule, static
    routes from a NumPy seed with every flow on at least one link, and the
    capped objectives (``TOPO_SCALE_CAPPED`` of the flows with a floor and a
    finite cap below a fair share at the peak concurrency). Returns (world
    keywords without objectives, the capped objectives, the peak
    concurrency)."""
    from repro_torch.core.fleet import (FlowSchedule, make_flow_objective,
                                        max_concurrent_flows)
    from repro_torch.core.topology import LinkGraph, PathSpec
    from repro_torch.scenarios.families import poisson_arrivals
    ts, te = poisson_arrivals(F, FLEET_HORIZON, seed=7, hold_frac=0.01)
    peak = max_concurrent_flows(FlowSchedule(ts, te), window=1.0)
    L = TOPO_LINKS
    rng = np.random.default_rng(19)
    onpath = rng.integers(0, 2, (F, L))
    onpath[np.arange(F), rng.integers(0, L, F)] = 1
    capped = rng.random(F) < TOPO_SCALE_CAPPED
    floor = np.where(capped, rng.uniform(0.0, 0.1, F) / peak, 0.0)
    cap = np.where(capped, rng.uniform(0.1, 0.5, F) / peak, np.inf)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].cuda()
    scale = lambda base, k: (np.asarray(base)[None, None]
                             * np.asarray(k)[:L, None, None])   # (L, 1, 3)
    world = dict(
        graph=LinkGraph(to(scale(FLEET_TPT, TOPO_SCALE_TPT)),
                        to(scale(FLEET_BW, TOPO_SCALE_BW)),
                        to(FLEET_HORIZON)),
        paths=PathSpec(to(onpath[None]), to(np.inf)),
        flows=FlowSchedule(to(ts), to(te)))
    objs = make_flow_objective(rate_floor=floor, rate_cap=cap, device="cuda")
    return world, type(objs)(*(x[None] for x in objs)), peak


def compact_topology_episode(torch, dev, *, seed):
    """One topology episode batch (rollout + updates) on the compact path:
    TOPO_COMPACT_ENVS envs x TOPO_COMPACT_FLOWS Poisson flows over
    TOPO_LINKS links, objectives with floors and a quarter of the flows
    capped, ``max_active = TOPO_COMPACT_ACTIVE``, from explicit draws made
    with NumPy; the workload drawn on ``dev``. Returns (rewards,
    {name: param}, the episode fn and its inputs for a profile)."""
    from repro_torch.core.fleet import (stack_flow_schedules,
                                        max_concurrent_flows)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.scenarios import (sample_topology_batch,
                                       arrival_schedule)
    from repro_torch.device import as_f32
    n, F = TOPO_COMPACT_ENVS, TOPO_COMPACT_FLOWS
    cfg = dataclasses.replace(
        topology_config(dev, episodes=n, n_envs=n, seed=seed), n_flows=F,
        max_active=TOPO_COMPACT_ACTIVE)
    wl = sample_topology_batch(
        n, F, n_links=TOPO_LINKS, seed=seed, horizon=TOPO_HORIZON,
        base_tpt=FLEET_TPT, base_bw=FLEET_BW,
        objective_mix=dict(floor_deadline_frac=TOPO_FLOOR_FRAC / 10),
        device=dev)
    flows = stack_flow_schedules([
        arrival_schedule("poisson_arrivals", F, horizon=TOPO_HORIZON,
                         seed=seed * 100 + i, hold_frac=TOPO_COMPACT_HOLD,
                         device=dev) for i in range(n)])
    if max_concurrent_flows(flows, window=1.0) > TOPO_COMPACT_ACTIVE:
        fail("the compact PPO batch's arrivals exceed max_active")
    rng = np.random.default_rng(seed)
    cap = np.where(rng.random((n, F)) < TOPO_SCALE_CAPPED,
                   rng.uniform(0.02, 0.2, (n, F)), np.inf)
    objectives = wl.objectives._replace(rate_cap=as_f32(cap, dev))
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    draws = dict(threads0=to(rng.integers(1, 16, (n, F, 3))),
                 t0_draw=to(rng.random(n)),
                 noise=to(rng.normal(size=(cfg.max_steps, n, F, 3))))
    fn = _make_episode_fn(fleet_params(dev), cfg, randomize_t0=True)
    inputs = dict(flows=flows, objectives=objectives, topology=wl.topology)
    state, rew, _ = fn(init_agent(cfg), None, **inputs, **draws)
    return (rew.cpu(), {k: t.detach().cpu() for k, t in
                        state["params"].named_parameters()},
            (fn, init_agent(cfg), inputs))


def rounds_to_fixed_point(torch, args, full, rounds):
    """The fewest water-fill rounds after which K3 on ``args`` gives the
    bits ``full`` it gives with ``rounds``: a round after the fixed point
    is an exact no-op, so the count is found by doubling, then bisection."""
    from repro_torch.kernels.contention import ops
    same = lambda r: torch.equal(ops.contention_rates(*args, rounds=r), full)
    hi = 1
    while hi < rounds and not same(hi):
        hi *= 2
    lo, hi = hi // 2, min(hi, rounds)   # same(hi), not same(lo) (lo >= 1)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if same(mid) else (mid, hi)
    return hi if lo or not same(0) else 0


def phase_topology_scale(torch):
    """19. The topology's compact-active-set path: topology_step at
    SCALE_FLOWS flows over TOPO_LINKS links, dense and compact, without
    and with floors and caps (their agreement at phase 9's limits, ms per
    step); K3 and K1 on the compact operands the path gave them, held
    against their plain versions and K3's capped solve against the sorted
    water-fill's fixed point, and K3 at the dense capped shape (F rounds);
    one compact topology PPO episode batch on the card against the CPU
    and its profile."""
    from repro_torch.core import topology as topo_mod, fleet as fleet_mod
    from repro_torch.core.fleet import flow_bucket, max_concurrent_flows
    from repro_torch.core.topology import (TopologyState, topology_step,
                                           _sorted_water_fill)
    from repro_torch.kernels import build
    from repro_torch.kernels.contention import ops as k3_ops
    from repro_torch.kernels.contention.ref import contention_rates_reference
    F = SCALE_FLOWS
    params = fleet_params("cuda")
    world, capped_objs, peak = topology_scale_world(torch, F)
    A = min(flow_bucket(max_concurrent_flows(world["flows"], window=1.0)), F)
    zeros = torch.zeros((1, F, 3), device="cuda")
    state0 = TopologyState(buffers=torch.zeros((1, F, 2), device="cuda"),
                           threads=torch.full((1, F, 3), 8.0, device="cuda"),
                           throughputs=zeros,
                           t=torch.zeros(1, device="cuda"),
                           prev_throughputs=zeros,
                           delivered=torch.zeros((1, F), device="cuda"))
    acts = torch.full((1, F, 3), 8.0, device="cuda")

    def step(st, ma, objs):
        return topology_step(params, st, acts, objectives=objs,
                             max_active=ma, **world)

    scale, launches, captured = {}, {}, {}
    for label, objs in (("plain", None), ("capped", capped_objs)):
        runs = {}
        for name, ma in (("dense", None), ("compact", A)):
            reset_launches()
            st = state0
            for _ in range(3):   # warm-up; the clock moves into the arrivals
                st, _, rew = step(st, ma, objs)
            first = (st, rew)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SCALE_ITERS):
                st, _, rew = step(st, ma, objs)
            torch.cuda.synchronize()
            runs[name] = ((time.perf_counter() - t0) / SCALE_ITERS * 1e3,
                          first)
            launches[(label, name)] = read_launches()
            with Recorder(topo_mod, "contention_rates") as r3, \
                    Recorder(fleet_mod, "sim_interval_batch") as r1:
                step(first[0], ma, objs)
            captured[(label, name)] = (r3.calls[0], r1.calls[0][0])
        (d_st, d_rew), (c_st, c_rew) = runs["dense"][1], runs["compact"][1]
        err_tps = float((d_st.throughputs - c_st.throughputs).abs().max())
        err_rew = float((d_rew - c_rew).abs().max()
                        / d_rew.abs().clamp_min(1))
        d_ms, c_ms = runs["dense"][0], runs["compact"][0]
        scale[label] = dict(dense_ms=d_ms, compact_ms=c_ms,
                            err_tps=err_tps, err_rew=err_rew)
        what = ("no objectives" if objs is None else
                f"floors and caps on {TOPO_SCALE_CAPPED} of the flows")
        print(f"[topology scale] topology_step at F={F} over {TOPO_LINKS} "
              f"links ({what}; peak concurrency {peak}): dense "
              f"{d_ms:.3f} ms/step, compact A={A} {c_ms:.3f} ms/step = "
              f"{d_ms / c_ms:.2f}x; dense vs compact throughputs "
              f"{err_tps:.3g} (limit 2e-5), reward (relative) {err_rew:.3g} "
              f"(limit 1e-5); launches dense "
              f"{json.dumps(launches[(label, 'dense')])}, compact "
              f"{json.dumps(launches[(label, 'compact')])}")
        if not (err_tps <= 2e-5 and err_rew <= 1e-5):
            fail(f"the compact topology step ({label}) disagrees with the "
                 f"dense one")
        want = 3 + SCALE_ITERS
        for name in ("dense", "compact"):
            got = launches[(label, name)]
            if got["contention"] != want or got["sim_interval"] != want:
                fail(f"the {name} topology steps ({label}) launched "
                     f"{json.dumps(got)}, expected {want} of K3 and of K1")

    # K3 and K1 on the operands the path gave them
    ptxas = [r for r in ptxas_report(build.nvcc_output("contention"))
             if any(k in r["function"] for k in (
                 "block<(int)3, (bool)1>", "block<3, true>",
                 "blockILi3ELb1E"))]
    k3_rows, k1_rows = {}, {}
    for tag, key in (("topology_compact", ("plain", "compact")),
                     ("topology_compact_capped", ("capped", "compact")),
                     ("topology_dense_capped", ("capped", "dense"))):
        (args, kw), k1_args = captured[key]
        rounds = kw["rounds"]
        # the dense capped solve takes about 0.1 s: fewer timed calls
        row = contention_check(torch, tag, args, rounds,
                               samples=3 if key[1] == "dense" else 20)
        row["launches"] = launches[key]["contention"]
        if args[5] is not None:
            got = k3_ops.contention_rates(*args, rounds=rounds)
            oracle = contention_rates_reference(*args,
                                                fill=_sorted_water_fill)
            moved = k3_ops.contention_rates(*args, rounds=0)
            torch.cuda.synchronize()
            row["sorted_fill_err"] = float((got - oracle).abs().max())
            row["rounds_moved"] = float((got - moved).abs().max())
            row["rounds_to_fixed_point"] = rounds_to_fixed_point(
                torch, args, got, rounds)
            row["device_ms_no_rounds"] = device_ms(
                torch, lambda: k3_ops.contention_rates(*args, rounds=0),
                "contention_kernel")
            row["ptxas"] = ptxas
            print(f"[topology scale] K3 {tag}: against the sorted "
                  f"water-fill's fixed point {row['sorted_fill_err']:.3g} "
                  f"(limit 1e-5); the {rounds} rounds moved up to "
                  f"{row['rounds_moved']:.4g} and reached their fixed "
                  f"point, bit for bit, after "
                  f"{row['rounds_to_fixed_point']}; device ms with the rounds "
                  f"{row['device_ms']}, without {row['device_ms_no_rounds']}"
                  f"; ptxas {json.dumps(ptxas)}")
            if not row["sorted_fill_err"] <= 1e-5:
                fail(f"K3 {tag} misses the sorted water-fill's fixed point")
            if not row["rounds_moved"] > 1e-6:
                fail(f"K3 {tag}: the water-fill rounds moved nothing")
        k3_rows[tag] = row
        if key == ("capped", "compact"):
            k1 = sim_check(torch, tag, *k1_args)
            k1["launches"] = launches[key]["sim_interval"]
            k1_rows[tag] = k1
            print(f"[sim_interval] {tag} E={k1['E']} S={k1['S']}: bitwise; "
                  f"ms={k1['ms']} device_ms={k1['device_ms']} plain_ms="
                  f"{k1['plain_ms']} bound_ms={k1['bound_ms']:.3g} "
                  f"({k1['bound_by']})")

    # one compact topology PPO episode batch, card against CPU
    reset_launches()
    cuda_out = compact_topology_episode(torch, "cuda",
                                        seed=TOPO_COMPACT_SEED)
    torch.cuda.synchronize()
    ppo_launches = read_launches()
    cpu_out = compact_topology_episode(torch, "cpu", seed=TOPO_COMPACT_SEED)
    err_rew = float((cuda_out[0] - cpu_out[0]).abs().max())
    err_par = max(float((cuda_out[1][n] - cpu_out[1][n]).abs().max())
                  for n in cpu_out[1])
    steps = topology_config("cuda", episodes=1, n_envs=1).max_steps
    print(f"[topology compact agree] card vs CPU, one compact topology "
          f"episode batch ({TOPO_COMPACT_ENVS} envs x {TOPO_COMPACT_FLOWS} "
          f"Poisson flows over {TOPO_LINKS} links, floors and caps, "
          f"max_active={TOPO_COMPACT_ACTIVE}): rewards {err_rew:.3g}, "
          f"params {err_par:.3g} (limits 1e-4); launches "
          f"{json.dumps(ppo_launches)} (expected {steps + 1} of K3 and K1)")
    if not (err_rew <= 1e-4 and err_par <= 1e-4):
        fail("the card's compact topology episode disagrees with the CPU's")
    if (ppo_launches["contention"] != steps + 1
            or ppo_launches["sim_interval"] != steps + 1):
        fail("the compact topology episode launched the kernels an "
             "unexpected number of times")
    fn, state, inputs = cuda_out[2]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    prof = profile_round(torch, lambda: fn(state, None, gen, **inputs),
                         ("contention_kernel", "sim_interval_kernel"))
    print(f"[topology compact profile] n_envs={TOPO_COMPACT_ENVS} x "
          f"{TOPO_COMPACT_FLOWS} flows over {TOPO_LINKS} links, max_active="
          f"{TOPO_COMPACT_ACTIVE}: " + json.dumps(prof))
    return dict(A=A, peak=peak, scale=scale,
                launches={f"{label}_{name}": v
                          for (label, name), v in launches.items()},
                ppo_launches=ppo_launches, k3=k3_rows, k1=k1_rows,
                agree=(err_rew, err_par), profile=prof)


def expected_prefill_launches(cfg):
    """K4 and K5 launches of one prefill: K4 once per attention layer (the
    hybrid: once per shared-block invocation; the enc-dec: once per decoder
    layer, whose causal self-attention alone runs it; MLA never), K5 once
    per Mamba2 layer."""
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "ssd_scan": cfg.n_layers}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_scan": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_dec_layers, "ssd_scan": 0}
    if cfg.use_mla:
        return {"flash_attention": 0, "ssd_scan": 0}
    return {"flash_attention": cfg.n_layers, "ssd_scan": 0}


def vlm_grid_positions(torch, B, P, grid):
    """(3, B, P) M-RoPE ids: t = 0 and (h, w) over a grid x grid block for
    the first grid² tokens, then text from grid on all three sections."""
    V = grid * grid
    i = torch.arange(P, dtype=torch.int32, device="cuda")
    text = grid + i - V
    ids = torch.stack([torch.where(i < V, 0, text),
                       torch.where(i < V, i // grid, text),
                       torch.where(i < V, i % grid, text)])
    return ids[:, None].expand(3, B, P)


def fa_path_errors(torch, calls, real):
    """K4 (``real``) on every recorded call's operands against its plain
    version: the max abs error of each."""
    return [float((real(q, k, v, **kw).float() - fa_plain(
        torch, q, k, v, kw.get("window")).float()).abs().max())
        for (q, k, v), kw in calls]


def near_top(torch, logits, other):
    """Each row's greedy token of ``other`` scores within SERVE_ATOL +
    SERVE_RTOL of ``logits``' top logit (the argmax, or a near-tie)."""
    top = logits.max(dim=-1).values
    chosen = logits.gather(1, other.argmax(dim=-1, keepdim=True))[:, 0]
    return bool(torch.all(top - chosen
                          <= SERVE_ATOL + SERVE_RTOL * top.abs()))


def moe_dropped(torch, p, h, top_k, capacity_factor):
    """The (token, choice) pairs past their expert's capacity in one
    moe_apply call on ``h``, and the capacity C."""
    xf = h.reshape(-1, h.shape[-1]).float()
    _, top_idx = torch.topk(torch.softmax(xf @ p.router.w, -1), top_k)
    E = p.router.w.shape[1]
    C = int(np.ceil(xf.shape[0] * top_k / E * capacity_factor))
    counts = torch.bincount(top_idx.reshape(-1), minlength=E)
    return int(torch.clamp_min(counts - C, 0).sum()), C


def last_routes(torch, calls, top_k):
    """Per MoE layer of one forward (``Recorder`` calls of moe_apply): the
    last position's top_k experts per row, sorted, and the gap between its
    k-th and (k+1)-th router logits."""
    out = []
    for (p, h), _ in calls:
        with torch.no_grad():
            logits = h[:, -1].float() @ p.router.w
        top = torch.topk(logits, top_k + 1)
        out.append((top.indices[:, :top_k].sort(-1).values,
                    top.values[:, top_k - 1] - top.values[:, top_k]))
    return out


def routing_flips(torch, a, b, rows):
    """Rows whose last token ``last_routes`` a and b send to other experts
    in some layer, and per such row the larger of the two paths' router
    gaps at its first such layer."""
    flipped = torch.zeros(rows, dtype=torch.bool)
    gaps = {}
    for (ia, ga), (ib, gb) in zip(a, b):
        differ = (ia != ib).any(-1).cpu()
        for r in (differ & ~flipped).nonzero()[:, 0].tolist():
            gaps[r] = max(float(ga[r]), float(gb[r]))
        flipped |= differ
    return flipped, gaps


def phase_family(torch, card, arch, layers, B, P, ref_backend, *,
                 keep_params=False):
    """20-22, 24. One arch of FAMILY_SERVE served through serve() at full
    width with the backend the command line serves (``served_config``:
    'pallas', or an MLA config's own) on weights drawn from SERVE_SEED and
    serve()'s prompts (``draw_prompts``: tokens, and the enc-dec's frames
    or the VLM's vision embeddings), counting K4's and K5's launches; then,
    on the same weights and prompts: finite
    logits, the greedy token serve() chose, the launches of one prefill
    (K4 and K5 held on every call's operands, timed on the first) and of
    one decode step (none), agreement with ``ref_backend``, decode against
    a longer prefill; the hybrid's K5 held on every Mamba2 layer's inputs
    and its logits against a prefill through the plain scan; the MoE's
    capacity dispatch with nothing dropped against the dense oracle on a
    layer input of the path; the VLM's prefill on a real (t, h, w) grid
    through K4 against ``ref_backend``; an MLA config under 'pallas'
    refused; a profile of one prefill and one decode step. With
    ``keep_params`` the result holds the weights (``params``) for a later
    phase."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (draw_prompts, prompts_on, serve,
                                          served_config)
    from repro_torch.models import get_model, ssm as ssm_model
    from repro_torch.nn import attention as attn_mod, moe as moe_mod
    from repro_torch.nn.ssd import ssd_chunked
    from repro_torch.kernels.ssd_scan import ops as k5_ops
    cfg = served_config(get_config(arch))
    if layers:
        cfg = cfg.replace(n_layers=layers)
    G = SERVE_GEN
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    expect = expected_prefill_launches(cfg)
    reset_launches()
    toks, info = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SERVE_SEED,
                       params=params)
    torch.cuda.synchronize()
    launches = read_launches()
    depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers"
             if cfg.family == "encdec" else
             f"{cfg.n_layers} layers (published "
             f"{get_config(arch).n_layers})")
    heads = (f"MLA: {cfg.n_heads} heads, q/k {cfg.nope_head_dim} + "
             f"{cfg.rope_head_dim}, v {cfg.v_head_dim}, kv_lora "
             f"{cfg.kv_lora}" if cfg.use_mla else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}")
    print(f"[{arch}] {cfg.family}, {depth}, d_model {cfg.d_model}, "
          f"{heads}, window "
          f"{cfg.window or None}, vocab {cfg.vocab}, {n_params} parameters "
          f"drawn on the host in {init_s:.2f} s, bf16, attn_backend="
          f"{cfg.attn_backend}:"
          f" {B} prompts x {P} tokens, {G} greedy tokens each; prefill "
          f"{info['prefill_s']:.4f} s, decode {info['decode_s']:.4f} s = "
          f"{info['tok_per_s']:.1f} tokens/s on {card}; launches "
          f"{json.dumps(launches)}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        fail(f"{arch}: serve returned tokens {tuple(toks.shape)} out of "
             f"range")
    if launches != {**{k: 0 for k in launches}, **expect}:
        fail(f"{arch}: serving launched {json.dumps(launches)}, expected "
             f"{json.dumps(expect)} (one prefill) and no other")

    batch = prompts_on(draw_prompts(cfg, B, P, SERVE_SEED), "cuda")
    tokens = batch["tokens"]
    short_batch = {**batch, "tokens": tokens[:, :-1]}
    layer_ratios = []

    def held_against_plain(x, dt, A, B_, C, *, chunk):
        """K5 on a layer's own inputs, held against the plain scan."""
        y, state = k5_ops.ssd_scan(x, dt, A, B_, C, chunk=chunk,
                                   return_state=True)
        want_y, want_state = ssd_chunked(x, dt, A, B_, C, chunk=chunk)
        tol = SSD_TOL[str(x.dtype).split(".")[-1]]
        layer_ratios.append(max(allclose_ratio(torch, y, want_y, tol),
                                allclose_ratio(torch, state, want_state,
                                               tol)))
        return y, state

    hybrid = cfg.family == "hybrid"
    moe_cfg = None
    with torch.inference_mode():
        reset_launches()
        with Recorder(attn_mod, "flash_attention") as fa_rec, \
                Recorder(ssm_model, "ssd_scan", keep=(0,)) as ssd_rec, \
                Recorder(moe_mod, "moe_apply") as moe_rec:
            logits, cache = model.prefill(params, batch,
                                          model.init_cache(B, P + G))
            torch.cuda.synchronize()
        n_prefill = read_launches()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        reset_launches()
        step_logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        n_decode = read_launches()
        ref = get_model(cfg.replace(attn_backend=ref_backend))
        with Recorder(moe_mod, "moe_apply") as ref_rec:
            logits_ref, _ = ref.prefill(params, batch,
                                        ref.init_cache(B, P + G))
        # decode against a longer prefill. An MoE decode step routes B
        # tokens, and at capacity_factor 1.25 its capacity is
        # ceil(2 B / E * 1.25) = 1 slot an expert: tokens drop by the
        # reference's semantics where the prefill keeps them. The check is
        # of the cache, so here both sides route with nothing dropped
        # (capacity_factor E / top_k)
        if cfg.n_experts:
            moe_cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        cm = get_model(moe_cfg or cfg)
        with Recorder(moe_mod, "moe_apply") as long_rec:
            long_ = (cm.prefill(params, batch, cm.init_cache(B, P + G))[0]
                     if moe_cfg else logits)
        short, c2 = cm.prefill(params, short_batch, cm.init_cache(B, P + G))
        with Recorder(moe_mod, "moe_apply") as dec_rec:
            consist, _ = cm.decode_step(params, c2, tokens[:, -1:])
        if moe_cfg is not None:   # the path's own capacity, for the record
            short_p, c3 = model.prefill(params, short_batch,
                                        model.init_cache(B, P + G))
            consist_path, _ = model.decode_step(params, c3, tokens[:, -1:])
        if hybrid:
            logits_plain, _ = model.prefill(params, batch,
                                            model.init_cache(B, P + G),
                                            ssd_fn=ssd_chunked)
            logits_held, _ = model.prefill(params, batch,
                                           model.init_cache(B, P + G),
                                           ssd_fn=held_against_plain)
        torch.cuda.synchronize()
    live = slice(0, cfg.vocab)   # the padded rows are -1e30 in both
    checked = [logits, step_logits, logits_ref, long_, short, consist]
    finite = all(bool(torch.isfinite(x).all()) for x in checked)
    same_first = bool(torch.equal(tok[:, 0], toks[:, 0]))
    k = cfg.top_k
    ref_flips, ref_gaps = routing_flips(
        torch, last_routes(torch, moe_rec.calls, k),
        last_routes(torch, ref_rec.calls, k), B)
    step_flips, step_gaps = routing_flips(
        torch, last_routes(torch, long_rec.calls, k),
        last_routes(torch, dec_rec.calls, k), B)
    del ref_rec, long_rec, dec_rec
    if (max([*ref_gaps.values(), *step_gaps.values(), 0.0]) > MOE_TIE
            or bool(ref_flips.all()) or bool(step_flips.all())):
        fail(f"{arch}: rows were routed apart at router gaps {ref_gaps} (vs "
             f"{ref_backend}) and {step_gaps} (decode), above {MOE_TIE}, or "
             f"every row was")
    rk, sk = (~ref_flips).to(logits.device), (~step_flips).to(logits.device)
    d_ref = (logits - logits_ref)[rk][:, live].abs()
    d_step = (consist - long_)[sk][:, live].abs()
    step_ratio = float((d_step / (SERVE_ATOL + SERVE_RTOL
                                  * long_[sk][:, live].abs())).max())
    step_ok = step_ratio <= 1.0 and near_top(torch, long_[sk], consist[sk])
    out = dict(arch=arch, n_layers=cfg.n_layers, batch=B, prompt=P, gen=G,
               info=info, init_s=init_s, n_params=n_params,
               launches=launches, prefill_launches=n_prefill,
               decode_launches=n_decode, ref_backend=ref_backend,
               max_diff_ref=float(d_ref.max()),
               max_diff_step=float(d_step.max()), step_tol_ratio=step_ratio,
               routed_apart_ref=ref_gaps, routed_apart_step=step_gaps)
    print(f"[{arch} check] logits finite {finite}; prefill launches "
          f"{json.dumps(n_prefill)}, decode step launches "
          f"{json.dumps(n_decode)}; serve's first tokens reproduced "
          f"{same_first}; {cfg.attn_backend} vs {ref_backend}: max abs diff "
          f"{out['max_diff_ref']:.4g}, mean {float(d_ref.mean()):.4g}, "
          f"argmax agree "
          f"{float((logits.argmax(-1) == logits_ref.argmax(-1)).float().mean()):.3f}"
          f" (|logit| max {float(logits[:, live].abs().max()):.3g}); "
          f"prefill({P}) vs prefill({P - 1}) + decode"
          f"{' (capacity_factor E/top_k)' if moe_cfg else ''}: max abs diff "
          f"{out['max_diff_step']:.4g}, {step_ratio:.3g} of atol+rtol"
          + (f"; rows whose last token was routed to other experts, with "
             f"the router gap at the first such layer (left out; near-ties "
             f"within {MOE_TIE}): vs {ref_backend} {ref_gaps}, decode "
             f"{step_gaps}" if cfg.n_experts else ""))
    if not finite:
        fail(f"non-finite logits in {arch} serving")
    if n_prefill != {**{k: 0 for k in n_prefill}, **expect} or any(
            n_decode.values()):
        fail(f"{arch}: a prefill launched {json.dumps(n_prefill)} and a "
             f"decode step {json.dumps(n_decode)}, expected "
             f"{json.dumps(expect)} and none")
    if not same_first:
        fail(f"{arch}: the same weights and prompts did not reproduce "
             f"serve's first tokens")
    if not out["max_diff_ref"] <= SERVE_ATOL:
        fail(f"{arch}: the {cfg.attn_backend} and {ref_backend} backends "
             f"differ by {out['max_diff_ref']} > {SERVE_ATOL}")
    if not step_ok:
        fail(f"{arch}: a decode step disagrees with the longer prefill")
    if moe_cfg is not None:
        d_path = (consist_path - logits)[:, live].abs()
        out["max_diff_step_path_capacity"] = float(d_path.max())
        print(f"[{arch} check] at the path's capacity_factor "
              f"{cfg.capacity_factor} (decode drops by design): prefill({P})"
              f" vs prefill({P - 1}) + decode max abs diff "
              f"{float(d_path.max()):.4g} (recorded, not held)")

    if hybrid:
        d_plain = (logits - logits_plain)[:, live].abs()
        held_same = bool(torch.equal(logits_held, logits))
        out.update(layer_tol_ratio=max(layer_ratios),
                   max_diff_plain=float(d_plain.max()))
        print(f"[{arch} check] K5 vs the plain scan on each layer's inputs:"
              f" at most {max(layer_ratios):.3g} of SSD_TOL over "
              f"{len(layer_ratios)} layers; K5 vs plain-scan prefill: max "
              f"abs diff {out['max_diff_plain']:.4g}, mean "
              f"{float(d_plain.mean()):.4g}; held prefill identical "
              f"{held_same}")
        if len(layer_ratios) != cfg.n_layers or not max(layer_ratios) <= 1:
            fail(f"{arch}: K5 disagrees with the plain scan on a layer's "
                 f"inputs: {max(layer_ratios)} of SSD_TOL")
        if not held_same:
            fail(f"{arch}: a prefill through K5 held against the plain scan"
                 f" gave other logits than the plain K5 prefill")
        if not (out["max_diff_plain"] <= SSM_E2E_ATOL
                and near_top(torch, logits_plain, logits)):
            fail(f"{arch}: the K5 and plain-scan prefills differ by "
                 f"{out['max_diff_plain']} (limit {SSM_E2E_ATOL}), or their"
                 f" greedy tokens are no near-tie")
        (x, dt, A, B_, C), _ = ssd_rec.calls[0]
        out["k5"] = ssd_row(torch, f"{arch}_path", (x, dt, A, B_, C))

    if cfg.n_experts:
        (p_ffn, h), _ = moe_rec.calls[0]
        cf = cfg.n_experts / cfg.top_k
        with torch.inference_mode():
            cap, _ = moe_mod.moe_apply(p_ffn, h, top_k=cfg.top_k,
                                       capacity_factor=cf,
                                       normalize_weights=cfg.moe_normalize)
            dense = moe_mod.moe_apply_dense_reference(
                p_ffn, h, top_k=cfg.top_k,
                normalize_weights=cfg.moe_normalize)
            torch.cuda.synchronize()
        err = float((cap.float() - dense.float()).abs().max())
        scale = float(dense.float().abs().max())
        dropped, C = moe_dropped(torch, p_ffn, h, cfg.top_k,
                                 cfg.capacity_factor)
        out.update(moe_max_abs_err=err, moe_max_abs=scale,
                   moe_dropped=dropped, moe_capacity=C)
        print(f"[{arch} moe] layer 0's input {tuple(h.shape)}: moe_apply at "
              f"capacity_factor {cf} vs moe_apply_dense_reference: max abs "
              f"err {err:.4g} (|y| max {scale:.4g}, limit "
              f"{MOE_TOL * scale:.4g}); at the path's capacity_factor "
              f"{cfg.capacity_factor}: C = {C}, {dropped} of "
              f"{h.shape[0] * h.shape[1] * cfg.top_k} choices dropped")
        if not (np.isfinite(err) and err <= MOE_TOL * scale):
            fail(f"{arch}: moe_apply differs from its dense oracle by {err}")

    if cfg.use_mla:
        try:
            get_model(cfg.replace(attn_backend="pallas")).init_cache(B, P)
        except NotImplementedError as e:
            print(f"[{arch} check] MLA under 'pallas' refused: {e}")
        else:
            fail(f"{arch}: MLA under 'pallas' was not refused")

    fa_errs = fa_path_errors(torch, fa_rec.calls, fa_rec.real)
    print(f"[{arch} attention] K4 vs its plain version on the "
          f"{len(fa_errs)} calls of one prefill: max abs err "
          f"{max(fa_errs, default=0.0):.3g} (limit {FA_TOL['bfloat16']})")
    if (len(fa_errs) != expect["flash_attention"]
            or not max(fa_errs, default=0.0) <= FA_TOL["bfloat16"]):
        fail(f"{arch}: K4 disagrees with its plain version on the path's "
             f"operands: {fa_errs}")
    if fa_errs:
        (q, k, v), kw = fa_rec.calls[0]
        out["k4"] = fa_row(torch, f"{arch}_path", q, k, v, kw.get("window"))
        out["k4"]["max_abs_err_path"] = max(fa_errs)
    del fa_rec, ssd_rec, moe_rec

    if cfg.family == "vlm":
        # serve()'s text ids are equal on the three sections, where M-RoPE
        # is the standard rope; a real grid makes each section count
        grid = {**batch, "positions_thw": vlm_grid_positions(
            torch, B, P, VLM_GRID)}
        ref_m = get_model(cfg.replace(attn_backend=ref_backend))
        with torch.inference_mode():
            reset_launches()
            with Recorder(attn_mod, "flash_attention") as grid_rec:
                g_logits, _ = model.prefill(params, grid,
                                            model.init_cache(B, P + G))
                torch.cuda.synchronize()
            n_grid = read_launches()["flash_attention"]
            g_ref, _ = ref_m.prefill(params, grid, ref_m.init_cache(B, P + G))
            torch.cuda.synchronize()
        g_errs = fa_path_errors(torch, grid_rec.calls, grid_rec.real)
        del grid_rec
        d_grid = (g_logits - g_ref)[:, live].abs()
        moved = float((g_logits - logits)[:, live].abs().max())
        out.update(grid_launches=n_grid, max_diff_grid=float(d_grid.max()),
                   grid_vs_text=moved, k4_err_grid=max(g_errs))
        print(f"[{arch} grid] {VLM_GRID} x {VLM_GRID} (t, h, w) grid for the"
              f" first {VLM_GRID ** 2} tokens: K4 launched {n_grid} times, "
              f"within {max(g_errs):.3g} of its plain version on every call;"
              f" pallas vs {ref_backend}: max abs diff "
              f"{out['max_diff_grid']:.4g}; the grid moved the logits by up "
              f"to {moved:.4g} from the text positions'")
        if not (n_grid == expect["flash_attention"] == len(g_errs)
                and max(g_errs) <= FA_TOL["bfloat16"]
                and out["max_diff_grid"] <= SERVE_ATOL
                and bool(torch.isfinite(g_logits).all())):
            fail(f"{arch}: the grid prefill launched K4 {n_grid} times, "
                 f"errors {g_errs}, or differs from {ref_backend} by "
                 f"{out['max_diff_grid']}")

    def one_prefill():
        with torch.inference_mode():
            model.prefill(params, batch, model.init_cache(B, P + G))

    def one_decode():
        with torch.inference_mode():
            model.decode_step(params, cache, tok)

    kernels = (FA_PATH_KERNEL, SSD_PATH_KERNEL) if hybrid else (
        FA_PATH_KERNEL,)
    out["profile"] = {"prefill": profile_round(torch, one_prefill, kernels),
                      "decode_step": profile_round(torch, one_decode,
                                                   kernels)}
    for name, pr in out["profile"].items():
        print(f"[{arch} profile] {name}: " + json.dumps(pr))
    if keep_params:
        out["params"] = params
    return out


def max_state_diff(torch, a, b):
    """Max abs difference between two {name: tensor} trees, in float32."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def smoke_step_agree(torch, arch):
    """One SMOKE train step in float32 on the card and on the CPU from the
    same state and batch: the gaps of the loss and of the new parameters;
    for the last three archs also quantize_dequantize_int8 on the card's
    gradients of that step against the CPU's on the same values (codes
    and scales equal bit for bit, ``int8_equal``)."""
    from unittest import mock
    from repro_torch.configs import concrete_inputs, get_smoke_config
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import encdec
    from repro_torch.runtime import compress
    scfg = get_smoke_config(arch)
    if arch in TRAIN_LAST:
        batch = concrete_inputs(scfg, "train_4k", scale=TRAIN_AGREE_SCALE,
                                seed=3, device="cpu")
    else:
        rows = np.random.default_rng(3).integers(0, scfg.vocab, (2, 33),
                                                 dtype=np.int32)
        batch = {"tokens": torch.from_numpy(rows[:, :-1].copy()),
                 "labels": torch.from_numpy(rows[:, 1:].copy())}
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    init = init_state(scfg, 0, device="cpu")
    init["params"] = {n: p.float() for n, p in init["params"].items()}
    grads = {}

    def keep(g):
        grads.setdefault("g", g)
        return g

    fn = make_train_step(scfg, warmup_steps=2, total_steps=10,
                         compress_fn=keep)
    out = {}
    with mock.patch.object(encdec, "ACT_DTYPE", torch.float32):
        for dev in ("cuda", "cpu"):
            grads.clear()
            st = {"params": {n: p.to(dev) for n, p in init["params"].items()},
                  "opt": {k: ({n: t.to(dev) for n, t in v.items()}
                              if isinstance(v, dict) else v.to(dev))
                          for k, v in init["opt"].items()}}
            new, m = fn(st, {k: v.to(dev) for k, v in batch.items()})
            out[dev] = (float(m["loss"]), {n: p.cpu() for n, p in
                                           new["params"].items()},
                        grads["g"])
    gaps = {"loss": abs(out["cuda"][0] - out["cpu"][0]),
            "params": max_state_diff(torch, out["cuda"][1], out["cpu"][1])}
    if arch in TRAIN_LAST:
        g_card = out["cuda"][2]
        codes, scales = compress.int8_codes(g_card)
        want_codes, want_scales = compress.int8_codes(
            {n: g.cpu() for n, g in g_card.items()})
        dq = compress.quantize_dequantize_int8(g_card)
        want_dq = compress.quantize_dequantize_int8(
            {n: g.cpu() for n, g in g_card.items()})
        gaps["int8_equal"] = all(
            torch.equal(codes[n].cpu(), want_codes[n])
            and torch.equal(scales[n].cpu(), want_scales[n])
            and torch.equal(dq[n].cpu(), want_dq[n]) for n in g_card)
        gaps["int8_roundtrip_error"] = float(
            compress.int8_roundtrip_error(g_card))
    return gaps


def phase_train(torch, card):
    """Phase 23: full-width smollm-135m training through the port's
    ``train()``; returns its numbers and K1's row on the controller's
    operands."""
    import shutil
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.core import simulator as sim_mod
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.runtime import WorkerFailure

    cfg = get_config(TRAIN_ARCH)
    ckpt_dir = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fired = []

    def chaos(step):
        if step == TRAIN_FAIL_AT and not fired:
            fired.append(step)
            raise WorkerFailure(f"injected at step {step}")

    reset_launches()
    with Recorder(sim_mod, "sim_interval_batch",
                  keep=(TRAIN_K1_CALL,)) as rec:
        state, info = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                            seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                            controller="autotmdt",
                            ckpt_every=TRAIN_CKPT_EVERY, log_every=0,
                            seed=0, device="cuda", chaos=chaos)
    torch.cuda.synchronize()
    launches = read_launches()
    rep, losses = info["report"], info["losses"]
    tag = f"[train] ({card})"
    print(f"{tag} {TRAIN_ARCH} full width, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step, {TRAIN_STEPS} steps: controller (explore + PPO "
          f"on the card) {info['controller_s']:.3f} s; launches "
          f"{json.dumps(launches)} ({rec.n} sim_interval calls)")
    print(f"{tag} losses {json.dumps(losses)}")
    if not np.all(np.isfinite(losses)):
        fail("a non-finite training loss")
    if (rep.steps_run < TRAIN_STEPS or int(state["opt"]["step"]) != TRAIN_STEPS
            or latest_step(ckpt_dir) != TRAIN_STEPS or not info["saves"]):
        fail(f"training ran {rep.steps_run} steps to optimizer step "
             f"{int(state['opt']['step'])} of {TRAIN_STEPS}, latest "
             f"checkpoint {latest_step(ckpt_dir)}")
    if fired != [TRAIN_FAIL_AT] or rep.restarts != 1:
        fail(f"the injected failure did not restart the run once: "
             f"{fired}, {rep.restarts} restarts")
    if launches["sim_interval"] != rec.n or rec.n < TRAIN_K1_CALL + 1:
        fail(f"K1 launched {launches['sim_interval']} times for {rec.n} "
             f"calls: the controller's training did not run on the card")
    if launches["flash_attention"] or launches["ssd_scan"] or \
            launches["contention"]:
        fail("a forward-only kernel or K3 ran on the training path")

    steady = info["step_s"][TRAIN_WARM_STEPS:]
    step_ms = float(np.median(steady)) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"{tag} step wall ms over {len(steady)} steady steps: median "
          f"{step_ms}, min {min(steady) * 1e3}, max {max(steady) * 1e3}; "
          f"{tok_s} tokens/s; every step's s {json.dumps(info['step_s'])}")
    for sv in info["saves"]:
        print(f"{tag} async save step {sv['step']}: {sv['bytes']} bytes, "
              f"snapshot {sv['snapshot_s']} s inline, {sv['seconds']} s on "
              f"the worker (serialize, sha256, engine, rename) = "
              f"{sv['bytes'] / MB / sv['seconds']} MB/s")
    print(f"{tag} restarts {rep.restarts}, checkpoints {rep.checkpoints}, "
          f"steps run {rep.steps_run}; the pipeline's final threads "
          f"{info['threads']}")

    # the resumed run against an uninterrupted one over the same batches
    step_fn = make_train_step(cfg, total_steps=TRAIN_STEPS)
    ref = init_state(cfg, 0, device="cuda")
    for c in range(TRAIN_STEPS):
        ref, _ = step_fn(ref, info["batches"][c])
    torch.cuda.synchronize()
    gaps = {part: max_state_diff(torch, a, b) for part, a, b in (
        ("params", state["params"], ref["params"]),
        ("m", state["opt"]["m"], ref["opt"]["m"]),
        ("v", state["opt"]["v"], ref["opt"]["v"]))}
    # bf16 parameters: a float32 rounding apart in an update may round to
    # the next bf16 value, one ulp (2^-7 of the value) at most
    ulps = max(float(((state["params"][n].float() - ref["params"][n].float())
                      .abs() / (ref["params"][n].float().abs() * 2.0 ** -7
                                + 1e-30)).max())
               for n in ref["params"])
    print(f"{tag} resumed against uninterrupted over the same cursor: max "
          f"abs diff {json.dumps(gaps)}; params at most {ulps} bf16 ulps")
    if ulps > 1.0 or gaps["m"] > 1e-6 or gaps["v"] > 1e-9:
        fail(f"the resumed run differs from the uninterrupted one: {gaps}")

    # one step's profile
    batch = info["batches"][0]
    prof = profile_round(torch, lambda: step_fn(ref, batch), ())
    print(f"{tag} one step profiled: " + json.dumps(prof))
    del ref
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # R3's sanity floor: one fixed batch, a short warmup
    memo_fn = make_train_step(cfg, warmup_steps=TRAIN_MEMO_WARMUP,
                              total_steps=TRAIN_MEMO_STEPS)
    st = init_state(cfg, 1, device="cuda")
    memo = []
    for _ in range(TRAIN_MEMO_STEPS):
        st, m = memo_fn(st, batch)
        memo.append(float(m["loss"]))
    print(f"{tag} one fixed batch, warmup {TRAIN_MEMO_WARMUP}: losses "
          f"{json.dumps(memo)}")
    if not memo[-1] < memo[0]:
        fail("the loss on one fixed batch did not fall")
    del st

    # one SMOKE step per family, card against CPU, float32
    agree = {arch: smoke_step_agree(torch, arch)
             for arch in TRAIN_AGREE_ARCHS}
    print(f"[train agree] ({card}) one SMOKE float32 step, card vs CPU: "
          f"{json.dumps(agree)}")
    bad = {a: g for a, g in agree.items()
           if not max(g["loss"], g["params"]) <= TRAIN_AGREE_TOL
           or g.get("int8_equal") is False}
    if bad:
        fail(f"a SMOKE train step on the card disagrees with the CPU, or "
             f"its int8 codes do: {bad}")

    args, _ = rec.calls[0]
    k1 = sim_check(torch, "train_controller", *args)
    k1["launches"] = launches["sim_interval"]
    print(f"[sim_interval] train_controller E={k1['E']} S={k1['S']}: "
          f"bitwise; ms={k1['ms']} device_ms={k1['device_ms']} plain_ms="
          f"{k1['plain_ms']} bound_ms={k1['bound_ms']:.3g} ({k1['bound_by']})")
    return {"launches": launches, "k1": k1, "step_ms": step_ms,
            "tokens_per_s": tok_s, "profile": prof, "agree": agree}


def grad_checks(torch, grads):
    """(every gradient finite, the names of those that are all zero)."""
    names = list(grads)
    finite = bool(torch.stack([torch.isfinite(grads[n]).all()
                               for n in names]).all())
    amax = torch.stack([grads[n].abs().amax().float() for n in names])
    return finite, [n for n, a in zip(names, amax.tolist()) if a == 0]


def phase_train_last(torch, card, kept):
    """Phase 25: the last three archs trained at full width on the weights
    phase 24 drew (``kept``: arch -> params, cut to TRAIN_LAST_LAYERS),
    then chunked_tri on smollm-135m's loss and ssd_bf16 at mamba2-1.3b's
    layer shape. Returns each part's numbers."""
    out = {}
    for arch in TRAIN_LAST:
        out[arch] = train_last_arch(torch, card, arch, kept.pop(arch))
        gc.collect()
        torch.cuda.empty_cache()
    out["chunked_tri"] = tri_check(torch, card)
    out["ssd_bf16"] = ssd_bf16_check(torch, card)
    return out


def train_last_arch(torch, card, arch, params):
    """One arch of phase 25 on its full-width ``params``: seamless's
    whole train step, or qwen2-vl's and deepseek-v2's loss forward and
    backward; every loss and gradient finite, no gradient all zero, no
    kernel launched, the fixed-batch loss falling (seamless), a loss under
    'pallas' refused; ms, tokens/s, peak memory and a profile."""
    from repro_torch.configs import concrete_inputs, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import (int8_roundtrip_error,
                                     make_int8_compressor)
    cfg = get_config(arch)
    if TRAIN_LAST_LAYERS.get(arch):
        cfg = cfg.replace(n_layers=TRAIN_LAST_LAYERS[arch])
    model = get_model(cfg)
    batch = concrete_inputs(cfg, "train_4k", scale=TRAIN_LAST_SCALE)
    B, S = batch["tokens"].shape
    n_params = sum(p.numel() for p in params.parameters())
    shapes = {k: list(v.shape) for k, v in batch.items()}
    tag = f"[train25 {arch}] ({card})"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    wall, checks, losses, state = [], [], [], None
    if cfg.family == "encdec":
        # the whole train step: a fixed batch, then the int8 hook
        steps_n = TRAIN_MEMO_STEPS + TRAIN_LAST_EF_STEPS
        state = {"params": {n: p.detach()
                            for n, p in params.named_parameters()}}
        state["opt"] = adamw_init(state["params"])
        ef = make_int8_compressor(error_feedback=True)
        seen = {}

        def check(g):
            checks.append(grad_checks(torch, g))
            return g

        def compress(g):
            if not seen:
                seen["err"] = float(int8_roundtrip_error(g))
            return ef(check(g))

        plain_step, hooked_step = (make_train_step(
            cfg, warmup_steps=TRAIN_MEMO_WARMUP, total_steps=steps_n,
            compress_fn=hook) for hook in (check, compress))
        for i in range(steps_n):
            t0 = time.perf_counter()
            state, m = (plain_step if i < TRAIN_MEMO_STEPS
                        else hooked_step)(state, batch)
            losses.append(float(m["loss"]))
            wall.append(time.perf_counter() - t0)
        what = (f"make_train_step, {TRAIN_MEMO_STEPS} steps at warmup "
                f"{TRAIN_MEMO_WARMUP} on one fixed batch + "
                f"{TRAIN_LAST_EF_STEPS} with the int8 error-feedback hook")
        run = lambda: plain_step(state, batch)
        res = dict(int8_roundtrip_error=seen["err"])
    else:
        # the loss's forward and backward, as make_train_step takes it
        leaves = list(params.parameters())
        names = [n for n, _ in params.named_parameters()]

        def run():
            loss, metrics = model.loss_fn(params, batch)
            g = torch.autograd.grad(loss, leaves)
            return loss.detach(), metrics, dict(zip(names, g))

        for _ in range(TRAIN_LAST_RUNS):
            t0 = time.perf_counter()
            loss, metrics, g = run()
            losses.append(float(loss))
            checks.append(grad_checks(torch, g))
            wall.append(time.perf_counter() - t0)
            del g
        what = f"loss_fn + torch.autograd.grad, {TRAIN_LAST_RUNS} times"
        res = dict(metrics={k: float(v.detach()) for k, v in
                            metrics.items()})
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steady = wall[TRAIN_WARM_STEPS:]
    ms = float(np.median(steady)) * 1e3
    res.update(losses=losses, n_layers=(
        cfg.n_enc_layers + cfg.n_dec_layers if cfg.family == "encdec"
        else cfg.n_layers), n_params=n_params, batch=shapes,
        backend=cfg.attn_backend, ms=ms, tokens_per_s=B * S / (ms / 1e3),
        wall_s=wall, max_memory_allocated=peak, held_before=held,
        launches=launches)
    finite = all(c[0] for c in checks) and bool(np.all(np.isfinite(losses)))
    zero = sorted({n for c in checks for n in c[1]})
    print(f"{tag} {res['n_layers']} layers at full width, {n_params} "
          f"parameters (phase 24's), batch {json.dumps(shapes)}, "
          f"attn_backend={cfg.attn_backend}; {what}: losses "
          f"{json.dumps(losses)}; every loss and gradient finite {finite}, "
          f"parameters with an all-zero gradient {zero}; ms {ms} (median "
          f"after {TRAIN_WARM_STEPS}; every one's s {json.dumps(wall)}) = "
          f"{res['tokens_per_s']} tokens/s; max_memory_allocated {peak} "
          f"bytes ({held} held before: these weights and those of the "
          f"archs still to run); launches {json.dumps(launches)}"
          + (f"; metrics {json.dumps(res['metrics'])}"
             if "metrics" in res else
             f"; int8_roundtrip_error of the first hooked step's gradients "
             f"{res['int8_roundtrip_error']}"))
    if not finite or zero:
        fail(f"{arch}: a non-finite loss or gradient, or all-zero "
             f"gradients: {zero}")
    if any(launches.values()):
        fail(f"{arch}: a kernel ran on the loss path: "
             f"{json.dumps(launches)}")
    if cfg.family == "encdec" and not losses[TRAIN_MEMO_STEPS - 1] < losses[0]:
        fail(f"{arch}: the loss on one fixed batch did not fall")
    try:
        get_model(cfg.replace(attn_backend="pallas")).loss_fn(params, batch)
    except NotImplementedError as e:
        res["pallas_refused"] = str(e)
        print(f"{tag} a loss under 'pallas' refused: {e}")
    else:
        fail(f"{arch}: a loss under 'pallas' was not refused")
    res["profile"] = profile_round(torch, run, ())
    print(f"{tag} one {'step' if state is not None else 'loss+grad'} "
          f"profiled: "
          + json.dumps(res["profile"]))
    return res


def tri_check(torch, card):
    """chunked_tri at full width (TRI_*): smollm-135m's loss and gradients
    under 'chunked_tri' and 'chunked' (and 'chunked' at one chunk, two
    plain versions' gap for scale) on the same weights and tokens, held at
    TRI_TOL; layer 0's attention on the path's operands against
    sdpa_chunked at the same chunk; no kernel launched; each loss and
    gradient timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.nn import attention as attn_mod
    cfg = get_config(TRI_ARCH)
    params = get_model(cfg).init(SERVE_SEED)
    rows = np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab, (TRI_BATCH, TRI_SEQ + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(rows[:, :-1].copy()).cuda(),
             "labels": torch.from_numpy(rows[:, 1:].copy()).cuda()}
    leaves = list(params.parameters())

    def loss_grad(backend, chunk=TRI_CHUNK):
        m = get_model(cfg.replace(attn_backend=backend, attn_chunk=chunk))
        loss, _ = m.loss_fn(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    reset_launches()
    with Recorder(attn_mod, "sdpa_chunked_tri", keep=(0,)) as rec:
        tri = loss_grad("chunked_tri")
        torch.cuda.synchronize()
    launches = read_launches()
    plain = loss_grad("chunked")
    other = loss_grad("chunked", TRI_SEQ)
    (q, k, v, q_pos, k_pos), kw = rec.calls[0]
    q, k, v = (t.detach() for t in (q, k, v))
    with torch.no_grad():
        a_tri = attn_mod.sdpa_chunked_tri(q, k, v, q_pos, k_pos, **kw)
        a_plain = attn_mod.sdpa_chunked(q, k, v, q_pos, k_pos, **kw)
    attn_ratio = allclose_ratio(torch, a_tri, a_plain, TRI_TOL)

    def gaps(a, b):
        """(loss gap, max over tensors of the allclose ratio at TRI_TOL,
        relative L2 of the whole gradient)."""
        ratio = max(allclose_ratio(torch, x, y, TRI_TOL)
                    for x, y in zip(a[1], b[1]))
        num = sum(float(((x.float() - y.float()) ** 2).sum())
                  for x, y in zip(a[1], b[1]))
        den = sum(float((y.float() ** 2).sum()) for y in b[1])
        return abs(float(a[0]) - float(b[0])), ratio, (num / den) ** 0.5

    ms = {be: time_ms(torch, lambda be=be: loss_grad(be), samples=3,
                      inner=1, warmup=1)
          for be in ("chunked_tri", "chunked")}
    d_tri, r_tri, l2_tri = gaps(tri, plain)
    d_one, r_one, l2_one = gaps(other, plain)
    out = dict(batch=TRI_BATCH, seq=TRI_SEQ, chunk=TRI_CHUNK,
               loss_tri=float(tri[0]), loss_chunked=float(plain[0]),
               loss_gap=d_tri, grad_tol_ratio=r_tri, grad_rel_l2=l2_tri,
               attn_tol_ratio=attn_ratio, calls=rec.n,
               plain_chunk_gap={"loss": d_one, "grad_tol_ratio": r_one,
                                "grad_rel_l2": l2_one},
               ms=ms, launches=launches)
    print(f"[train25 chunked_tri] ({card}) {TRI_ARCH} full width, "
          f"{TRI_BATCH} x {TRI_SEQ} tokens, attn_chunk {TRI_CHUNK}: loss "
          f"{out['loss_tri']} vs 'chunked' {out['loss_chunked']} (gap "
          f"{d_tri}); gradients at most {r_tri} of atol = rtol = {TRI_TOL},"
          f" relative L2 {l2_tri} ('chunked' at chunk {TRI_SEQ} vs "
          f"{TRI_CHUNK}: loss {d_one}, {r_one} of the tolerance, relative "
          f"L2 {l2_one}); layer 0's attention on the path's operands vs "
          f"sdpa_chunked: {attn_ratio} of the tolerance; sdpa_chunked_tri "
          f"called {rec.n} times (remat recomputes each layer); loss + "
          f"grad ms {json.dumps(ms)}; launches {json.dumps(launches)}")
    if not (d_tri <= TRI_TOL * (1 + abs(out["loss_chunked"]))
            and r_tri <= 1 and attn_ratio <= 1
            and np.isfinite(out["loss_tri"])):
        fail(f"chunked_tri disagrees with 'chunked' beyond {TRI_TOL}: "
             f"{json.dumps(out)}")
    if any(launches.values()) or rec.n < cfg.n_layers:
        fail(f"chunked_tri: launches {launches}, {rec.n} calls")
    return out


def ssd_bf16_check(torch, card):
    """ssd_chunked(bf16=True) at mamba2-1.3b's layer shape against the
    float32 scan on the same operands, within SSD_BF16_REL of max |y32|;
    both timed."""
    from repro_torch.nn.ssd import ssd_chunked
    b, s, h, p, g, n, dtype = SSD_SHAPES[SSD_BF16_SHAPE]
    args = ssd_operands(torch, b, s, h, p, g, n, dtype, seed=5)
    with torch.no_grad():
        y16, st16 = ssd_chunked(*args, chunk=SSD_CHUNK, bf16=True)
        y32, st32 = ssd_chunked(*args, chunk=SSD_CHUNK)
        rel = float((y16.float() - y32.float()).abs().max()
                    / y32.float().abs().max())
        st_rel = float((st16 - st32).abs().max() / st32.abs().max())
        ms = {name: time_ms(torch, lambda bf=bf: ssd_chunked(
            *args, chunk=SSD_CHUNK, bf16=bf), samples=5, inner=2, warmup=1)
            for name, bf in (("bf16", True), ("float32", False))}
    out = dict(shape=[b, s, h, p, g, n], dtype=dtype, rel=rel,
               state_rel=st_rel, ms=ms)
    print(f"[train25 ssd_bf16] ({card}) ssd_chunked(bf16=True) at "
          f"{SSD_BF16_SHAPE} {out['shape']} {dtype}: max |y16 - y32| / max "
          f"|y32| = {rel} (limit {SSD_BF16_REL}), the final state's "
          f"{st_rel}; ms {json.dumps(ms)}")
    if not (rel <= SSD_BF16_REL and np.isfinite(st_rel)):
        fail(f"ssd_bf16 parts from the float32 scan by {rel}")
    return out


# ---------------------------------------------------------------------------
# Phase 26: sharding (flow-sharded fleets on a DeviceMesh, the LM meshes)
# ---------------------------------------------------------------------------


def shard_max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def shard_step(torch, mesh, name, fn, params, state, acts, world, per_flow):
    """``fn`` (fleet_step or topology_step) unsharded, then with the flow
    axis split over ``mesh`` (DTensor state and per-flow keywords), from
    the same inputs: the errors of the gathered outputs, both calls' ms,
    the sharded call's K1/K3 launches and its flow_all_reduce calls and
    bytes."""
    from repro_torch.sharding import (shard_fleet_state, shard_flow_schedule,
                                      shard_flow_objectives, shard_path_spec)
    from repro_torch.sharding.fleet import FLOW_COLLECTIVES, full_flows
    sharders = {"flows": shard_flow_schedule,
                "objectives": shard_flow_objectives,
                "paths": shard_path_spec}
    sharded = {k: sharders[k](v, mesh) for k, v in per_flow.items()}
    sstate = shard_fleet_state(state, mesh)

    def call(sharded_call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (fn(params, sstate, acts, **world, **sharded) if sharded_call
               else fn(params, state, acts, **world, **per_flow))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    ref, plain_first = call(False)
    before = dict(FLOW_COLLECTIVES)
    reset_launches()
    out, first = call(True)
    launches = read_launches()
    calls = FLOW_COLLECTIVES["calls"] - before["calls"]
    n_bytes = FLOW_COLLECTIVES["bytes"] - before["bytes"]
    _, again = call(True)
    _, plain_again = call(False)
    got = {"obs": full_flows(out[1], -2),
           "buffers": full_flows(out[0].buffers, -2),
           "throughputs": full_flows(out[0].throughputs, -2)}
    want = {"obs": ref[1], "buffers": ref[0].buffers,
            "throughputs": ref[0].throughputs}
    return {"name": name, "F": int(acts.shape[1]),
            "placement": str(out[1].placements),
            "err": {k: shard_max_err(torch, got[k], want[k]) for k in got},
            "err_reward": shard_max_err(torch, out[2].to_local(), ref[2]),
            "ms": [first, again], "plain_ms": [plain_first, plain_again],
            "k1": launches["sim_interval"], "k3": launches["contention"],
            "calls": calls, "bytes": n_bytes}


def shard_floor_world(torch):
    """The reference's F = 8 world with floors and caps
    (tests/test_fleet_scaleout.py:430-446) on the card, E = 1."""
    from repro_torch.core.fleet import (FlowSchedule, make_flow_objective,
                                        stack_flow_objectives)
    from repro_torch.core.schedule import ScheduleTable
    F = SHARD_FLOOR_FLOWS
    rng = np.random.default_rng(0)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].cuda()
    table = ScheduleTable(to(rng.uniform(0.05, 0.5, (2, 3))),
                          to(rng.uniform(0.5, 2.0, (2, 3))), to(0.5))
    ts = rng.uniform(0.0, 1.0, F)
    flows = FlowSchedule(to(ts), to(ts + rng.uniform(0.5, 2.0, F)))
    obj = stack_flow_objectives([make_flow_objective(
        rate_floor=rng.uniform(0, 1, F),
        rate_cap=np.where(rng.random(F) < 0.5, np.inf, 0.8), device="cuda")])
    return table, flows, obj


def shard_checks(torch, rank):
    """Phase 26's checks on one rank of SHARD_RANKS sharing the card (each
    rank holds the same inputs, drawn from seeds)."""
    from repro_torch.core.fleet import (FleetState, FlowSchedule, fleet_reset,
                                        fleet_step, _solve_fleet_rates)
    from repro_torch.core.ppo import init_agent, _make_episode_fn
    from repro_torch.core.simulator import _table_or_params
    from repro_torch.core.topology import topology_step
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.scenarios.families import poisson_arrivals
    from repro_torch.sharding import shard_flow_schedule
    from repro_torch.sharding.fleet import (FLOW_COLLECTIVES, flow_gather,
                                            flow_rows, flow_scope, scope_of,
                                            to_local)
    mesh = make_fleet_mesh()
    res = {"rank": rank, "mesh": list(mesh.shape),
           "device": mesh.device_type}
    params = fleet_params("cuda")
    F = SCALE_FLOWS
    # phase 9's world, its clock moved into the arrivals by 3 steps
    ts, te = poisson_arrivals(F, FLEET_HORIZON, seed=7, hold_frac=0.01)
    flows = FlowSchedule(*(torch.from_numpy(x)[None].cuda()
                           for x in (ts, te)))
    zeros = torch.zeros((1, F, 3), device="cuda")
    acts = torch.full((1, F, 3), 8.0, device="cuda")
    state = FleetState(buffers=torch.zeros((1, F, 2), device="cuda"),
                       threads=acts.clone(), throughputs=zeros,
                       t=torch.zeros(1, device="cuda"),
                       prev_throughputs=zeros,
                       delivered=torch.zeros((1, F), device="cuda"))
    topo, _, _ = topology_scale_world(torch, F)
    tstate = state
    for _ in range(3):
        state, _, _ = fleet_step(params, state, acts, flows=flows)
        tstate, _, _ = topology_step(params, tstate, acts, **topo)
    res["fleet"] = shard_step(torch, mesh, "fleet_step", fleet_step, params,
                              state, acts, {}, {"flows": flows})
    res["topology"] = shard_step(
        torch, mesh, "topology_step", topology_step, params, tstate, acts,
        {"graph": topo["graph"]}, {"flows": topo["flows"],
                                   "paths": topo["paths"]})
    table, fflows, obj = shard_floor_world(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fstate = fleet_reset(params, 1, SHARD_FLOOR_FLOWS, flows=fflows,
                         table=table, substeps=6, objectives=obj,
                         generator=gen)
    res["floors"] = shard_step(
        torch, mesh, "fleet_step floors+caps", fleet_step, params, fstate,
        torch.full((1, SHARD_FLOOR_FLOWS, 3), 8.0, device="cuda"),
        {"table": table, "substeps": 6, "fairness_coef": 0.5},
        {"flows": fflows, "objectives": obj})
    # K3 on the operands each rank assembles, against the unsharded launch
    tab = _table_or_params(params, None, 1)
    sflows = shard_flow_schedule(flows, mesh)
    full = _solve_fleet_rates(params, tab, acts, flows, state.t, 50, None)
    with flow_scope(scope_of(sflows)):
        rows = _solve_fleet_rates(params, tab, flow_rows(acts, 1),
                                  to_local(sflows), state.t, 50, None)
        res["k3_bitwise"] = bool(torch.equal(flow_gather((rows, 2))[0],
                                             full))
    # one PPO episode batch at bench_fleet's configuration, then its round
    cfg = fleet_config("cuda", episodes=FLEET_ENVS, n_envs=FLEET_ENVS,
                       n_flows=FLEET_FLOWS, seed=5)
    wl = fleet_draw(FLEET_ENVS)(0)
    rng = np.random.default_rng(5)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    draws = dict(threads0=to(rng.integers(1, 16, (FLEET_ENVS, FLEET_FLOWS,
                                                  3))),
                 t0_draw=to(rng.random(FLEET_ENVS)),
                 noise=to(rng.normal(size=(cfg.max_steps, FLEET_ENVS,
                                           FLEET_FLOWS, 3))))
    episode = {}
    for name in ("warm-up", "none", "sharded", "sharded_again", "none_again"):
        fl = (shard_flow_schedule(wl.flows, mesh) if name.startswith("sh")
              else wl.flows)
        fn = _make_episode_fn(params, cfg, randomize_t0=True)
        before = dict(FLOW_COLLECTIVES)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rew, _ = fn(init_agent(cfg), wl.tables, None, flows=fl, **draws)
        torch.cuda.synchronize()
        episode[name] = dict(
            ms=(time.perf_counter() - t0) * 1e3, rew=rew.cpu(),
            params={n: t.detach().cpu() for n, t in
                    st["params"].named_parameters()},
            launches=read_launches(),
            calls=FLOW_COLLECTIVES["calls"] - before["calls"],
            bytes=FLOW_COLLECTIVES["bytes"] - before["bytes"])
    a, b = episode["none"], episode["sharded"]
    res["episode"] = {
        "err_rewards": shard_max_err(torch, b["rew"], a["rew"]),
        "err_params": max(shard_max_err(torch, b["params"][n], a["params"][n])
                          for n in a["params"]),
        "round_ms": [episode[k]["ms"] for k in ("sharded", "sharded_again")],
        "round_ms_unsharded": [episode[k]["ms"] for k in ("none",
                                                          "none_again")],
        "k1": b["launches"]["sim_interval"], "k3": b["launches"]["contention"],
        "k1_unsharded": a["launches"]["sim_interval"],
        "k3_unsharded": a["launches"]["contention"],
        "calls_per_round": b["calls"], "bytes_per_round": b["bytes"]}
    return res


def shard_rank(rank, world, d):
    """Phase 26's rank ``rank`` of ``world`` in a spawned process: joins a
    gloo group on a FileStore in ``d`` over CUDA tensors on the one card,
    runs ``shard_checks`` and writes ``d/rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        res = shard_checks(torch, rank)
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_sharding(torch, card):
    """26. Sharding. One rank: make_fleet_mesh() on the card, train_ppo at
    bench_fleet's configuration for SHARD_ROUNDS rounds with mesh= equal
    to mesh=None bit for bit with the same K1/K3 launches; the SMOKE
    smollm-135m train state re-laid onto make_smoke_mesh() by
    reshard_state, saved and restored by load_checkpoint(shardings=),
    bit for bit on the card. Two ranks sharing the card (spawned, gloo over
    CUDA tensors, kernels built by phase 2): fleet_step at SCALE_FLOWS,
    topology_step at SCALE_FLOWS over 3 links and the reference's
    floors-and-caps step against the unsharded call within 1e-6 (obs,
    buffers, throughputs) and 1e-5 (reward); K3 on assembled operands bit
    for bit; one episode batch within 1e-4 of mesh=None."""
    import multiprocessing
    import shutil
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import train_ppo
    from repro_torch.launch.mesh import make_fleet_mesh, make_smoke_mesh
    from repro_torch.launch.steps import init_state
    from repro_torch.runtime import reshard_state
    from repro_torch.sharding import param_specs, to_shardings
    from repro_torch.sharding.fleet import FLOW_COLLECTIVES
    out = {}
    torch.cuda.set_device(0)
    mesh = make_fleet_mesh()
    if tuple(mesh.shape) != (1,) or mesh.device_type != "cuda":
        fail(f"make_fleet_mesh() is {mesh}, not one rank on the card")
    params = fleet_params("cuda")
    cfg = fleet_config("cuda", episodes=SHARD_ROUNDS * FLEET_ENVS,
                       n_envs=FLEET_ENVS, n_flows=FLEET_FLOWS)
    runs = {}
    for name, m in (("none", None), ("mesh", mesh), ("mesh_again", mesh),
                    ("none_again", None)):
        before = FLOW_COLLECTIVES["calls"]
        reset_launches()
        t0 = time.perf_counter()
        r = train_ppo(params, cfg, resample=fleet_draw(FLEET_ENVS), mesh=m)
        torch.cuda.synchronize()
        runs[name] = (r, read_launches(), FLOW_COLLECTIVES["calls"] - before,
                      time.perf_counter() - t0)
    (a, la, _, _), (b, lb, cb, _) = runs["none"], runs["mesh"]
    same = a.history == b.history and all(
        torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                          b.params.parameters()))
    sb = [runs[k][3] for k in ("mesh", "mesh_again")]
    sa = [runs[k][3] for k in ("none", "none_again")]
    out["one_rank"] = dict(launches=lb, launches_none=la, calls=cb,
                           bitwise=same, s=sb, s_none=sa)
    print(f"[sharding] ({card}) one rank: train_ppo(mesh=make_fleet_mesh()) "
          f"{SHARD_ROUNDS} rounds of {FLEET_ENVS} envs x {FLEET_FLOWS} flows "
          f"against mesh=None: bit for bit {same}; launches {json.dumps(lb)} "
          f"(mesh=None {json.dumps(la)}); flow_all_reduce calls {cb}; "
          f"s {json.dumps(sb)} against {json.dumps(sa)} (in turns: none, "
          f"mesh, mesh, none)")
    if not same or lb != la or cb != 0 or not (lb["sim_interval"]
                                               and lb["contention"]):
        fail("train_ppo on a one-rank mesh is not the unsharded run")
    lm_cfg = get_smoke_config(TRAIN_ARCH)
    state = init_state(lm_cfg, 0)
    smoke = make_smoke_mesh()
    pspecs = param_specs(lm_cfg, state["params"], smoke)
    shardings = to_shardings(smoke, {"params": pspecs, "opt": {
        "m": pspecs, "v": pspecs, "step": ()}})
    laid = reshard_state(state, lm_cfg, smoke)
    ckpt = os.path.join(ROOT, "build", "shard_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        save_checkpoint(ckpt, laid, 1, use_engine=False)
        loaded, step = load_checkpoint(ckpt, state, shardings=shardings)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    leaves = [(loaded["params"][n], laid["params"][n], t)
              for n, t in state["params"].items()]
    leaves += [(loaded["opt"][k][n], laid["opt"][k][n], state["opt"][k][n])
               for k in ("m", "v") for n in state["params"]]
    ok = all(isinstance(x, DTensor) and isinstance(y, DTensor)
             and x.to_local().device.type == "cuda"
             and torch.equal(x.to_local(), t) and torch.equal(y.to_local(), t)
             for x, y, t in leaves)
    out["lm"] = dict(leaves=len(leaves), bitwise=ok, step=step)
    print(f"[sharding] ({card}) make_smoke_mesh() {tuple(smoke.shape)} "
          f"{smoke.mesh_dim_names} on {smoke.device_type}: reshard_state and "
          f"load_checkpoint(shardings=) of SMOKE {TRAIN_ARCH}'s train state, "
          f"{len(leaves)} leaves, bit for bit on the card {ok}")
    if not ok or step != 1:
        fail("the re-laid or restored LM state is not the state")
    dist.destroy_process_group()

    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, SHARD_RANKS, d))
             for r in range(SHARD_RANKS)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=SHARD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * SHARD_RANKS:
        shutil.rmtree(d, ignore_errors=True)
        fail(f"the sharded ranks exited with {codes}")
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(d, ignore_errors=True)
    for res in ranks:
        for key in ("fleet", "topology", "floors"):
            s = res[key]
            print(f"[sharding] ({card}) rank {res['rank']} of "
                  f"{SHARD_RANKS} on one card: {s['name']} F={s['F']} "
                  f"{s['placement']}: max err {json.dumps(s['err'])}, reward "
                  f"{s['err_reward']}; ms sharded {json.dumps(s['ms'])}, "
                  f"unsharded {json.dumps(s['plain_ms'])} (in turns: "
                  f"unsharded, sharded, sharded, unsharded); K1 {s['k1']}, "
                  f"K3 {s['k3']}; flow_all_reduce per step {s['calls']} "
                  f"calls, {s['bytes']} bytes")
            if not (max(s["err"].values()) <= SHARD_TOL["state"]
                    and s["err_reward"] <= SHARD_TOL["reward"]
                    and s["k1"] == 1 and s["k3"] == 1 and s["calls"] > 0
                    and "Shard" in s["placement"]):
                fail(f"rank {res['rank']}: the sharded {s['name']} "
                     f"disagrees with the unsharded one or skipped a kernel")
        e = res["episode"]
        print(f"[sharding] ({card}) rank {res['rank']}: K3 on the assembled "
              f"operands bit for bit {res['k3_bitwise']}; one episode batch "
              f"({FLEET_ENVS} envs x {FLEET_FLOWS} flows sharded "
              f"{SHARD_RANKS} ways) against mesh=None: rewards "
              f"{e['err_rewards']}, params {e['err_params']}; round wall ms "
              f"{json.dumps(e['round_ms'])} (unsharded "
              f"{json.dumps(e['round_ms_unsharded'])}; after a warm-up "
              f"round, in turns); K1 {e['k1']}, K3 {e['k3']} "
              f"(unsharded {e['k1_unsharded']}, {e['k3_unsharded']}); "
              f"flow_all_reduce per round {e['calls_per_round']} calls, "
              f"{e['bytes_per_round']} bytes (the gradients' sums "
              f"included)")
        if not (res["k3_bitwise"] and e["err_rewards"] <= SHARD_TOL["episode"]
                and e["err_params"] <= SHARD_TOL["episode"]
                and e["k1"] == e["k1_unsharded"] > 0
                and e["k3"] == e["k3_unsharded"] > 0):
            fail(f"rank {res['rank']}: the sharded episode batch or K3 "
                 f"disagrees")
    out["ranks"] = ranks
    return out


def phase_dryrun(torch, card):
    """Phase 27: the dry run (``repro_torch.launch.dryrun``). (a) Its CLI
    on DRYRUN_CELLS, one subprocess per cell, both meshes: every cell
    ``ok``, each line printed as the reference's CLI prints it. (b) Phase
    23's step on the card against its trace on a 1 x 1 mesh. No kernel
    runs: the dry run traces 'chunked'."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import mesh_over
    from repro_torch.launch.steps import init_state, make_train_step

    reset_launches()
    out_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.monotonic()
    runs = [(arch, shape, mesh) for arch, shape in DRYRUN_CELLS
            for mesh in ("single", "multi")]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", mesh, "--out-dir", out_dir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for arch, shape, mesh in runs]
    cells = {}
    for p, (arch, shape, mesh) in zip(procs, runs):
        try:
            stdout, stderr = p.communicate(
                timeout=max(1.0, DRYRUN_CLI_TIMEOUT_S
                            - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            fail(f"the dry-run CLI took over {DRYRUN_CLI_TIMEOUT_S} s")
        for line in stdout.splitlines():
            if line.startswith("[dryrun]"):
                print(line)
        if p.returncode:
            fail(f"the dry-run CLI failed on {arch} {mesh}: "
                 f"{stderr[-2000:]}")
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")) as f:
            cells[(arch, mesh)] = json.load(f)
    cli_s = time.monotonic() - t0
    for (arch, mesh), r in cells.items():
        print(f"[dryrun] {arch} {r['shape']} {mesh}: {r['chips']} ranks, "
              f"traced in {r['lower_s']} s; per device {r['hlo_flops'] / r['chips']:.6g} "
              f"FLOPs, {r['hlo_bytes'] / r['chips']:.6g} bytes, "
              f"{r['collective_bytes'] / r['chips']:.6g} collective bytes "
              f"{json.dumps(r['collective_counts'])}; state "
              f"{r['state_bytes_per_device']:.6g} bytes a device, peak live "
              f"{r['memory_analysis']['peak_live_bytes']}; roofline "
              f"{r['roofline_step_s']:.6g} s ({r['dominant']}); H100 "
              f"constants ({card})")
        if r["status"] != "ok" or r["chips"] != (512 if mesh == "multi"
                                                 else 256):
            fail(f"the dry-run cell {arch} {mesh} is not ok: {r}")
    print(f"[dryrun] CLI: {len(cells)} full-width cells in {cli_s:.2f} s")

    # (b) phase 23's step: the trace on a 1 x 1 mesh, then the card
    cfg = get_config(TRAIN_ARCH)
    meta = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
    t0 = time.monotonic()
    with dryrun.fake_world(1):
        mesh = mesh_over((1, 1), ("data", "model"), device="cuda")
        traced, state_bytes, fc_flops, mem, _ = dryrun.trace_step(
            cfg, "train", meta, mesh)
    trace_s = time.monotonic() - t0
    bound = hlo_analysis.roofline_terms(
        hlo_flops=traced.flops, hlo_bytes=traced.bytes_accessed,
        coll_bytes=traced.collective_bytes, chips=1)

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()

    def held():
        """(bytes the tensors asked for, bytes of the blocks they got)."""
        st = torch.cuda.memory_stats()
        return (st["requested_bytes.all.current"],
                st["allocated_bytes.all.current"])

    before = held()
    state = init_state(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    grown, blocks = (a - b for a, b in zip(held(), before))
    n_leaves = 2 * len(state["params"]) + len(state["opt"]["m"]) + 1
    print(f"[dryrun] ({card}) {TRAIN_ARCH} state: dry run "
          f"{state_bytes:.0f} bytes a device; after init_state the card's "
          f"allocator holds {grown} more bytes requested by {n_leaves} "
          f"tensors, in {blocks} bytes of blocks (a block of the large "
          f"pool is not split when under 1 MiB would remain)")
    if abs(grown - state_bytes) > DRYRUN_ALLOC_ROUND * n_leaves:
        fail(f"the state's bytes {state_bytes} are not the card's "
             f"{grown} within {DRYRUN_ALLOC_ROUND} bytes a tensor")

    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=gen, device="cuda",
                              dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    real, _ = hlo_analysis.analyze_ops(step, state, batch)
    torch.cuda.synchronize()
    print(f"[dryrun] ({card}) FLOPs of the real step {real.flops:.0f} "
          f"({real.dot_count} matmuls), of the meta trace "
          f"{traced.flops:.0f} ({traced.dot_count}), FlopCounterMode "
          f"{fc_flops}; bytes real {real.bytes_accessed:.0f}, traced "
          f"{traced.bytes_accessed:.0f}; trace {trace_s:.2f} s")
    if real.flops != traced.flops or fc_flops != traced.flops:
        fail("the real step's FLOPs are not the meta trace's")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_WARM_STEPS + DRYRUN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    step_s = float(np.median(times[TRAIN_WARM_STEPS:]))
    peak = torch.cuda.max_memory_allocated()
    print(f"[dryrun] ({card}) step median {step_s * 1e3:.3f} ms over "
          f"{DRYRUN_STEPS} steps (each s {json.dumps(times)}); roofline "
          f"{bound['roofline_step_s'] * 1e3:.3f} ms, dominant "
          f"{bound['dominant']} (compute {bound['compute_s'] * 1e3:.3f} ms, "
          f"memory {bound['memory_s'] * 1e3:.3f} ms); measured / bound "
          f"{step_s / bound['roofline_step_s']:.3f}")
    print(f"[dryrun] ({card}) peak memory: dry run "
          f"{mem['peak_live_bytes']} bytes live, the card's "
          f"max_memory_allocated {peak} bytes")
    if step_s < bound["roofline_step_s"]:
        fail("a measured step is faster than its roofline bound")
    launches = read_launches()
    if any(launches.values()):
        fail(f"a kernel ran in the dry-run phase: {launches}")
    del state
    return {"cells": {f"{a}|{m}": {k: r[k] for k in (
        "hlo_flops", "collective_bytes", "dominant", "roofline_step_s",
        "lower_s")} for (a, m), r in cells.items()},
        "cli_s": cli_s, "state_bytes": state_bytes, "grown": grown,
        "flops": traced.flops, "step_ms": step_s * 1e3,
        "bound_ms": bound["roofline_step_s"] * 1e3,
        "peak_traced": mem["peak_live_bytes"], "peak_card": peak}


def smoke_cli(arch):
    """``serve --smoke`` for ``arch`` as README.md gives it, started in a
    process of its own (the kernels phase 2 built)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--batch", str(SMOKE_BATCH), "--prompt-len",
         str(SMOKE_PROMPT), "--gen", str(SMOKE_GEN)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def smoke_logit_gaps(torch, cfg, params):
    """The prefill logits of ``cfg`` on the card (through K4 and K5) and on
    the CPU (their plain versions) from the same ``params`` and serve()'s
    prompts, in bf16 as drawn and in float32 (the parameters lifted; the
    enc-dec's fixed bf16 activations lifted too, as
    tests/test_torch_encdec_serve.py lifts both packages'): per dtype the
    max abs gap, its ratio to SMOKE_TOL (atol and rtol in bf16, atol in
    float32), and the launches of the card's prefill."""
    import copy
    from unittest import mock
    from repro_torch.launch.serve import draw_prompts, prompts_on
    from repro_torch.models import encdec, get_model
    model = get_model(cfg)
    draws = draw_prompts(cfg, SMOKE_BATCH, SMOKE_PROMPT, SERVE_SEED)
    out = {}
    for dtype in ("bfloat16", "float32"):
        p_card = params if dtype == "bfloat16" else copy.deepcopy(
            params).float()
        act = torch.float32 if dtype == "float32" else encdec.ACT_DTYPE
        logits = {}
        with mock.patch.object(encdec, "ACT_DTYPE", act), \
                torch.inference_mode():
            for dev in ("cuda", "cpu"):
                p_dev = p_card if dev == "cuda" else copy.deepcopy(
                    p_card).cpu()
                if dev == "cuda":
                    reset_launches()
                logits[dev], _ = model.prefill(
                    p_dev, prompts_on(draws, dev),
                    model.init_cache(SMOKE_BATCH, SMOKE_PROMPT + SMOKE_GEN,
                                     device=dev))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches = read_launches()
        got, want = logits["cuda"].float().cpu(), logits["cpu"].float()
        tol = SMOKE_TOL[dtype]
        rtol = tol if dtype == "bfloat16" else 0.0
        gap = (got - want).abs()
        out[dtype] = dict(
            max_abs_diff=float(gap.max()),
            tol_ratio=float((gap / (tol + rtol * want.abs())).max()),
            finite=bool(torch.isfinite(got).all()),
            argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                               .float().mean()),
            launches=launches)
    return out


def phase_smoke_serving(torch, card):
    """28. Every arch's SMOKE config served as ``serve --smoke`` serves it:
    the command line in a subprocess per arch (started together, each
    must exit 0), and in process serve(served_config(SMOKE config)) at
    its request (SMOKE_BATCH prompts of SMOKE_PROMPT tokens, SMOKE_GEN
    greedy tokens) with K4 and K5 counted: K4 once per causal
    self-attention layer of a prefill (none for MLA, none for seamless's
    encoder and cross layers), K5 once per Mamba2 layer, neither in a
    decode step; then the prefill logits on the card against the CPU from
    the same weights within SMOKE_TOL (``smoke_logit_gaps``)."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.launch.serve import (draw_prompts, prompts_on, serve,
                                          served_config)
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    clis = {arch: smoke_cli(arch) for arch in ARCHS}
    rows, launches = {}, {}
    for arch in ARCHS:
        cfg = served_config(get_smoke_config(arch))
        want = expected_prefill_launches(cfg)
        model = get_model(cfg)
        params = model.init(SERVE_SEED)
        reset_launches()
        toks, info = serve(cfg, batch=SMOKE_BATCH, prompt_len=SMOKE_PROMPT,
                           gen=SMOKE_GEN, seed=SERVE_SEED, params=params)
        torch.cuda.synchronize()
        launches[arch] = read_launches()
        if launches[arch] != {**{k: 0 for k in launches[arch]}, **want}:
            fail(f"smoke serving {arch} launched "
                 f"{json.dumps(launches[arch])}, expected {json.dumps(want)}"
                 f" (one prefill)")
        if tuple(toks.shape) != (SMOKE_BATCH, SMOKE_GEN) or not (
                0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
            fail(f"smoke serving {arch} returned tokens "
                 f"{tuple(toks.shape)} out of range")
        # one decode step launches neither kernel
        with torch.inference_mode():
            draws = draw_prompts(cfg, SMOKE_BATCH, SMOKE_PROMPT, SERVE_SEED)
            logits, cache = model.prefill(
                params, prompts_on(draws, "cuda"),
                model.init_cache(SMOKE_BATCH, SMOKE_PROMPT + SMOKE_GEN))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            reset_launches()
            model.decode_step(params, cache, tok)
            torch.cuda.synchronize()
            n_decode = read_launches()
        if any(n_decode.values()):
            fail(f"a decode step of smoke {arch} launched "
                 f"{json.dumps(n_decode)}")
        if not torch.equal(tok[:, 0], toks[:, 0]):
            fail(f"smoke {arch}: the same weights and prompts did not give "
                 f"serve's first tokens")
        gaps = smoke_logit_gaps(torch, cfg, params)
        for dtype, g in gaps.items():
            if g["launches"] != {**{k: 0 for k in g["launches"]}, **want}:
                fail(f"smoke {arch} {dtype} prefill launched "
                     f"{json.dumps(g['launches'])}, expected "
                     f"{json.dumps(want)}")
            if not (g["finite"] and g["tol_ratio"] <= 1.0):
                fail(f"smoke {arch} {dtype}: card against CPU logits "
                     f"{json.dumps(g)}, limit {SMOKE_TOL[dtype]}")
        rows[arch] = dict(family=cfg.family, n_layers=cfg.n_layers,
                          head_dim=cfg.head_dim, launches=launches[arch],
                          expected=want, info=info, logits=gaps)
        print(f"[smoke serve] {arch} ({cfg.family}, attn_backend="
              f"{cfg.attn_backend}): launches {json.dumps(launches[arch])}; "
              f"prefill {info['prefill_s']:.4f} s, decode "
              f"{info['decode_s']:.4f} s; card vs CPU prefill logits "
              + json.dumps({d: {k: g[k] for k in ("max_abs_diff",
                                                   "tol_ratio",
                                                   "argmax_agree")}
                            for d, g in gaps.items()}))
        del params, model
    failed = {}
    for arch, proc in clis.items():
        try:
            out, err = proc.communicate(timeout=max(
                1.0, SMOKE_CLI_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failed[arch] = f"no exit within {SMOKE_CLI_TIMEOUT_S} s"
            continue
        line = (out.strip().splitlines() or [""])[-1]
        print(f"[smoke cli] {arch}: exit {proc.returncode}: {line}")
        want = f"[serve] generated ({SMOKE_BATCH}, {SMOKE_GEN}) tokens"
        if proc.returncode != 0 or not line.startswith(want):
            failed[arch] = f"exit {proc.returncode}: {err.strip()[-600:]}"
    if failed:
        fail(f"serve --smoke failed: {json.dumps(failed)}")
    print(f"[smoke serve] {len(ARCHS)} archs served in process and by the "
          f"command line on {card}; K4 launches "
          f"{sum(n['flash_attention'] for n in launches.values())}, K5 "
          f"{sum(n['ssd_scan'] for n in launches.values())}")
    return dict(rows=rows, launches=launches)


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
    walls, lap_t = {}, [time.monotonic()]

    def lap(phase):
        """Print and keep the wall seconds since the last lap."""
        now = time.monotonic()
        walls[phase] = now - lap_t[0]
        lap_t[0] = now
        print(f"[wall] phase {phase}: {walls[phase]:.2f} s")

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
    lap(1)

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
    # the bf16 routes of K4 and K5 are wgmma routes fed by TMA: count both
    # in the built SASS (HGMMA and UTMALDG, no HMMA), and no spill
    sass = {}
    for name, kernel in (("flash_attention", FA_PATH_KERNEL),
                         ("ssd_scan", SSD_PATH_KERNEL)):
        counts = sass_counts(build.library_path(name))
        for fn, c in counts.items():
            print(f"[sass] {name}: {fn}: " + ", ".join(
                f"{c[op]} {op}" for op in SASS_OPS))
        path = {fn: c for fn, c in counts.items() if kernel in fn}
        sass[name] = {op: sum(c[op] for c in path.values())
                      for op in SASS_OPS}
        sass[name]["functions"] = len(path)
        print(f"[sass] {name}: {kernel}: {json.dumps(sass[name])}")
        if not path:
            fail(f"no {kernel} in lib{name}")
        bad = {fn: c for fn, c in path.items()
               if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]}
        if bad:
            fail(f"{kernel} is not the wgmma/TMA route in some instance "
                 f"(HGMMA > 0, UTMALDG > 0, HMMA = 0 wanted): "
                 f"{json.dumps(bad)}")
        rows = [r for r in ptxas_report(build.nvcc_output(name))
                if kernel in r["function"]]
        for r in rows:
            print(f"[ptxas] {name}: {r['function']}: {r['registers']} "
                  f"registers, {r['smem_bytes']} bytes smem, spill stores "
                  f"{r['spill_stores']}, loads {r['spill_loads']}")
        if not rows:
            fail(f"no ptxas report for {kernel}: was it built in this run?")
        spilled = [r["function"] for r in rows
                   if r["spill_stores"] or r["spill_loads"]]
        if spilled:
            fail(f"{name}: registers spilled in {spilled}")
    lap(2)

    # --- 3. kernel parity and times ------------------------------------------
    S, shapes = phase_sim(torch)
    lap(3)

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
    lap(4)

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
    lap(5)

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
    lap(6)

    # --- 7. contention kernel parity and times --------------------------------
    k3 = phase_contention(torch)
    lap(7)
    # --- 8. the fleet's main path: train -> evaluate -> live control ---------
    fl = phase_fleet(torch)
    lap(8)
    # --- 9. fleet agreement with the CPU, scale-out, profile ------------------
    phase_fleet_scale(torch)
    lap(9)
    # --- 10. flash-attention kernel parity and times ---------------------------
    k4 = phase_attention(torch)
    lap(10)
    # --- 11. LM serving: smollm-135m prefill and greedy decode ----------------
    sv = phase_serve(torch)
    lap(11)
    # --- 12. SSD chunked-scan kernel parity and times --------------------------
    k5 = phase_ssd(torch)
    lap(12)
    # --- 13. mamba2-1.3b serving: prefill through K5, greedy decode ------------
    mb = phase_mamba2(torch)
    lap(13)
    # --- 29. mamba2-1.3b at chunk 256: phase 13's weights, K5's two row tiles
    mb_long = phase_mamba2_long_chunk(torch, mb.pop("params"))
    gc.collect()
    torch.cuda.empty_cache()
    lap(29)
    # --- 14. single-flow evaluation: train -> evaluate_scenario -> replay ----
    sc = phase_scenarios(torch)
    lap(14)
    # --- 15. topology: train -> evaluate -> MultiLink control, K3 at F rounds
    tp = phase_topology(torch, fl["policy"])
    lap(15)
    # --- 16. faults: fault-randomized training -> eval_world -> live replay --
    ft = phase_faults(torch)
    lap(16)
    # --- 17. online: frozen policy + residual head on a held-out collapse ----
    on = phase_online(torch)
    lap(17)
    # --- 18. topology under faults and floors; capped scoring --------------
    tpf = phase_topology_faults(torch, tp["policy"])
    lap(18)
    # --- 19. topology scale-out: the compact-active-set path ----------------
    tsc = phase_topology_scale(torch)
    lap(19)
    fam, kept = {}, {}

    def family_phase(phase):
        for arch, spec in FAMILY_SERVE[phase].items():
            fam[arch] = phase_family(torch, card, arch, *spec,
                                     keep_params=arch in TRAIN_LAST)
            if arch in TRAIN_LAST:   # phase 25's weights, cut to its depth
                kept[arch] = fam[arch].pop("params")
                n = TRAIN_LAST_LAYERS.get(arch)
                if n:
                    kept[arch].layers = kept[arch].layers[:n]
            gc.collect()
            torch.cuda.empty_cache()
        lap(phase)

    # --- 20-22. serving families: zamba2 (K4 + K5), mixtral, dense D=128 ---
    for phase in (20, 21, 22):
        family_phase(phase)
    # --- 23. LM training: smollm-135m, AutoMDT input, async checkpoints ----
    tr = phase_train(torch, card)
    lap(23)
    gc.collect()
    torch.cuda.empty_cache()
    # --- 24. seamless (enc-dec), qwen2-vl (M-RoPE), deepseek-v2 (MLA) -----
    family_phase(24)
    # --- 25. their training at full width; chunked_tri; ssd_bf16 ----------
    tl = phase_train_last(torch, card, kept)
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()
    lap(25)
    # --- 26. sharding: flow-sharded fleets on a DeviceMesh, the LM meshes --
    sh = phase_sharding(torch, card)
    lap(26)
    # --- 27. the dry run: meta DTensors on a fake world, then the card -----
    dr = phase_dryrun(torch, card)
    lap(27)
    # --- 28. serve --smoke: every arch's SMOKE config through K4 and K5 ----
    sm = phase_smoke_serving(torch, card)
    lap(28)
    print(f"[wall] per phase s {json.dumps(walls)}; total "
          f"{sum(walls.values()):.2f} s")
    print(f"[profiler] device_spread windows: {PROFILER_WINDOWS['calls']} "
          f"calls, {PROFILER_WINDOWS['empty']} windows empty")

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
    kernels[0]["launches_scenarios"] = sc["train_launches"]["sim_interval"]
    kernels[0]["launches_topology"] = tp["train_launches"]["sim_interval"]
    kernels[0]["launches_faults"] = ft["train_launches"]["sim_interval"]
    kernels[0]["launches_faults_frozen"] = (
        ft["frozen_launches"]["sim_interval"])
    kernels[0]["launches_faults_eval"] = ft["eval_launches"]["sim_interval"]
    kernels[0]["launches_online"] = on["train_launches"]["sim_interval"]
    kernels[0]["launches_online_eval"] = on["eval_launches"]["sim_interval"]
    kernels[0]["launches_topology_faults"] = (
        tpf["train_launches"]["sim_interval"])
    kernels[0]["launches_topology_capped"] = (
        tpf["capped_launches"]["sim_interval"])
    kernels[0]["launches_topology_compact"] = sum(
        tsc["launches"][f"{label}_compact"]["sim_interval"]
        for label in ("plain", "capped"))
    kernels[0]["launches_topology_compact_ppo"] = (
        tsc["ppo_launches"]["sim_interval"])
    kernels[0]["launches_train"] = tr["launches"]["sim_interval"]
    kernels[0]["launches_sharding"] = (
        sh["one_rank"]["launches"]["sim_interval"])
    kernels[0]["launches_sharding_ranks"] = [
        r["episode"]["k1"] for r in sh["ranks"]]
    for name, r in {**ft["k1"], **tpf["k1"], **tsc["k1"],
                    "train_controller": tr["k1"]}.items():
        kernels[0][f"at_{name}"] = {k: r[k] for k in (
            "E", "S", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_terms", "launches")}
    row = k3["fleet"]
    kernels.append({
        "name": "contention", "route": "cuda",
        "source": "src/repro_torch/csrc/contention.cu",
        "replaces": "src/repro/kernels/contention/kernel.py:37",
        "launches": fl["train_launches"]["contention"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in [*k3.values(), *tp["k3"].values(),
                                     *ft["k3"].values(),
                                     *tpf["k3"].values(),
                                     *tsc["k3"].values()]),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "E": row["E"], "S": row["S"], "F": row["F"],
        "device_ms": row["device_ms"], "bound_terms": row["bound_terms"],
        "launches_eval": fl["eval_launches"]["contention"],
        "launches_topology": tp["train_launches"]["contention"],
        "launches_topology_eval": tp["eval_launches"]["contention"],
        "launches_faults": ft["train_launches"]["contention"],
        "launches_faults_eval": ft["eval_launches"]["contention"],
        "launches_online": on["train_launches"]["contention"],
        "launches_online_eval": on["eval_launches"]["contention"],
        "launches_topology_faults": tpf["train_launches"]["contention"],
        "launches_topology_capped": tpf["capped_launches"]["contention"],
        "launches_topology_compact": sum(
            tsc["launches"][f"{label}_compact"]["contention"]
            for label in ("plain", "capped")),
        "launches_topology_compact_ppo": tsc["ppo_launches"]["contention"],
        "launches_topology_dense_scale": sum(
            tsc["launches"][f"{label}_dense"]["contention"]
            for label in ("plain", "capped")),
        "launches_sharding": sh["one_rank"]["launches"]["contention"],
        "launches_sharding_ranks": [r["episode"]["k3"] for r in sh["ranks"]],
    })
    for name, r in {**k3, **tp["k3"], **ft["k3"], **tpf["k3"],
                    **tsc["k3"]}.items():
        if name != "fleet":
            kernels[-1][f"at_{name}"] = {
                k: r[k] for k in ("E", "S", "F", "L", "rounds", "objectives",
                                  "max_abs_err", "ms", "device_ms",
                                  "device_windows_empty", "plain_ms",
                                  "bound_ms", "bound_by", "bound_terms",
                                  "launches", "sorted_fill_err",
                                  "rounds_moved", "rounds_to_fixed_point",
                                  "device_ms_no_rounds", "ptxas")
                if k in r}
    kernels[-1]["ptxas"] = ptxas["contention"]
    row = k4["smollm_bf16"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": sv["launches"]["flash_attention"] + sum(
            f["launches"]["flash_attention"] for f in fam.values()) + sum(
            n["flash_attention"] for n in sm["launches"].values()),
        "launches_smollm": sv["launches"]["flash_attention"],
        **{f"launches_smoke_{a}": n["flash_attention"]
           for a, n in sm["launches"].items()},
        **{f"launches_{a}": f["launches"]["flash_attention"]
           for a, f in fam.items()},
        "max_abs_err": max([r["max_abs_err"] for r in k4.values()]
                           + [f["k4"]["max_abs_err_path"]
                              for f in fam.values() if "k4" in f]),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        **{k: row[k] for k in ("B", "S", "Hq", "Hkv", "D", "window",
                               "dtype", "device_ms", "first_design_ms",
                               "first_design_device_ms", "bound_terms")},
        "sass": sass["flash_attention"], "card": card,
    })
    for name, r in k4.items():
        if name != "smollm_bf16":
            kernels[-1][f"at_{name}"] = r
    for a, f in fam.items():
        if "k4" in f:
            kernels[-1][f"at_{a}_path"] = f["k4"]
    k5_path = {a: f["k5"] for a, f in fam.items() if "k5" in f}
    row = k5["mamba2_bf16"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:27",
        "launches": mb["launches"]["ssd_scan"]
        + mb_long["launches"]["ssd_scan"] + sum(
            f["launches"]["ssd_scan"] for f in fam.values()) + sum(
            n["ssd_scan"] for n in sm["launches"].values()),
        "launches_mamba2": mb["launches"]["ssd_scan"],
        "launches_mamba2_chunk256": mb_long["launches"]["ssd_scan"],
        **{f"launches_smoke_{a}": n["ssd_scan"]
           for a, n in sm["launches"].items() if n["ssd_scan"]},
        **{f"launches_{a}": fam[a]["launches"]["ssd_scan"] for a in k5_path},
        "max_abs_err": max(r["max_abs_err"] for r in
                           [*k5.values(), *k5_path.values()]),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        **{k: row[k] for k in ("b", "s", "h", "p", "g", "n", "chunk",
                               "dtype", "device_ms", "device_ms_min",
                               "device_ms_max", "device_samples",
                               "first_design_ms", "first_design_device_ms",
                               "max_abs_err_state", "bound_terms")},
        "sass": sass["ssd_scan"], "card": card,
    })
    for name, r in k5.items():
        if name != "mamba2_bf16":
            kernels[-1][f"at_{name}"] = r
    for a, r in k5_path.items():
        kernels[-1][f"at_{a}_path"] = r
    print("[serving] " + json.dumps({a: {k: f[k] for k in (
        "n_layers", "batch", "prompt", "gen", "info", "init_s", "n_params",
        "max_diff_ref", "max_diff_step", "max_diff_grid") if k in f}
        for a, f in fam.items()}))
    print("[training last] " + json.dumps({a: {k: r[k] for k in (
        "n_layers", "n_params", "batch", "ms", "tokens_per_s",
        "max_memory_allocated", "losses") if k in r}
        for a, r in tl.items() if a in TRAIN_LAST}))
    print("[dryrun] " + json.dumps(dr))
    print(f"[mamba2 chunk {SSM_LONG_CHUNK}] " + json.dumps(mb_long))
    print("[smoke serving] " + json.dumps(sm["rows"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
