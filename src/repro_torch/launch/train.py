"""End-to-end training (port of ``repro.launch.train``): the
AutoMDT-tuned input pipeline, the fault-tolerant loop and async
checkpoints through the transfer engine, on the CUDA device unless
``device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke --steps 50 --batch 8 --seq 128 --device cpu

The trainer keeps every batch it has handed out by cursor, so a restart
from a checkpoint replays the cursor's own batch (the reference's
``train`` pops each batch and reads fresh rows after a restart).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (AutoMDTController, GlobusController,
                              MarlinOptimizer, PPOConfig, train_ppo,
                              make_env_params, SimEnv, explore)
from repro_torch.data import InputPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step, init_state
from repro_torch.runtime import FaultTolerantTrainer


def make_controller(kind, *, seed=0, n_max=32, device=None):
    """Train an AutoMDT policy offline in the simulator on ``device`` (the
    sim kernel K1 on the card), or return a baseline controller."""
    if kind == "globus":
        return GlobusController()
    if kind == "marlin":
        return MarlinOptimizer(n_max=n_max)
    if kind == "static":
        return None
    # AutoMDT: explore a generic host profile, train PPO offline
    device = resolve_device(device)
    params = make_env_params(tpt=[0.4, 0.8, 0.6], bw=[4.0, 4.0, 4.0],
                             cap=[4.0, 4.0], n_max=n_max, device=device)
    env = SimEnv(params, seed=seed)
    env.reset()
    ex = explore(env.probe, n_samples=100, n_max=n_max, seed=seed)
    res = train_ppo(params, PPOConfig(max_episodes=1500, seed=seed,
                                      action_scale=n_max / 4, n_envs=32,
                                      device=str(device)),
                    r_max=ex.r_max)
    return AutoMDTController(res.params["policy"], n_max=n_max,
                             bw_ref=float(ex.bandwidth.max()), device=device)


def train(cfg, *, steps=50, batch=8, seq=128, ckpt_dir="runs/train_ckpt",
          controller="autotmdt", ckpt_every=20, log_every=10, seed=0,
          device=None, chaos=None):
    """Train ``cfg`` from ``seed`` for ``steps`` steps. ``chaos`` is the
    trainer's failure injection (fn(step) that may raise WorkerFailure).
    Returns (final state, info): info holds the losses, the trainer's
    report, the wall seconds, the controller's setup seconds, each step's
    wall seconds, the pipeline's final threads, the saver's records and the
    batches by cursor."""
    device = resolve_device(device)
    state = init_state(cfg, seed, device=device)
    step_fn = make_train_step(cfg, total_steps=steps)

    t0 = time.time()
    ctrl = make_controller(controller, seed=seed, device=device)
    controller_s = time.time() - t0
    pipe = InputPipeline(vocab=cfg.vocab, batch=batch, seq=seq,
                         total_rows=(steps + 8) * batch, controller=ctrl)
    trainer = FaultTolerantTrainer(ckpt_dir, ckpt_every=ckpt_every)

    batches = {}

    def batch_fn(cursor):
        # the cursor's batch, drawn from the pipeline the first time
        while cursor not in batches:
            batches[len(batches)] = pipe.next_batch(device=device)
        return batches[cursor]

    losses, step_s = [], []
    t0 = time.time()

    def wrapped_step(state, b):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        if log_every and len(losses) % log_every == 0:
            print(f"[train] step={len(losses)} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/len(losses):.2f}s/step) "
                  f"pipeline={pipe.observe()['threads']}", flush=True)
        return state, metrics

    try:
        final_state, report = trainer.run(wrapped_step, state, batch_fn,
                                          steps, chaos=chaos)
        threads = pipe.observe()["threads"]
    finally:
        pipe.close()
    return final_state, {"losses": losses, "report": report,
                         "wall_s": time.time() - t0,
                         "controller_s": controller_s, "step_s": step_s,
                         "threads": threads, "saves": trainer.saver.saves,
                         "batches": batches}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--controller", default="autotmdt",
                    choices=["autotmdt", "marlin", "globus", "static"])
    ap.add_argument("--ckpt-dir", default="runs/train_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, info = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    ckpt_dir=args.ckpt_dir, controller=args.controller,
                    device=args.device)
    print(f"[train] done: {len(info['losses'])} steps, "
          f"loss {info['losses'][0]:.3f} -> {info['losses'][-1]:.3f}, "
          f"{info['wall_s']:.1f}s, restarts={info['report'].restarts}")


if __name__ == "__main__":
    main()
