"""The port's training loop end to end on the CPU
(``repro_torch.launch.train``): ``train()`` on the SMOKE smollm-135m
through the input pipeline, the fault-tolerant loop with one injected
failure and async checkpoints through the engine, resuming to the same
parameters as an uninterrupted run over the same batches; the AutoMDT
controller trained on the simulator and tuning the pipeline;
``make_controller``'s baselines; the command line; and no silent fall back
to the CPU. Nothing asserts on wall-clock time."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_smoke_config
from repro_torch.core import GlobusController, MarlinOptimizer
from repro_torch.launch import steps
from repro_torch.launch.train import make_controller, train
from repro_torch.runtime import WorkerFailure

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = get_smoke_config("smollm-135m")


def test_train_survives_a_failure_and_resumes_exactly(tmp_path):
    fired = []

    def chaos(step):
        if step == 5 and not fired:
            fired.append(step)
            raise WorkerFailure("injected preemption at step 5")

    state, info = train(CFG, steps=8, batch=4, seq=32, ckpt_every=3,
                        ckpt_dir=str(tmp_path), controller="static",
                        log_every=0, seed=1, device="cpu", chaos=chaos)
    rep = info["report"]
    assert fired == [5] and rep.restarts == 1
    assert rep.steps_run == len(info["losses"]) == 8 + 2   # 3, 4 replayed
    assert rep.checkpoints == 3 and latest_step(str(tmp_path)) == 8
    assert info["saves"][0]["step"] == 3 and info["saves"][-1]["step"] == 8
    assert all(s["bytes"] > 0 for s in info["saves"])
    assert all(torch.isfinite(torch.tensor(info["losses"])))
    assert info["losses"][3:5] == info["losses"][5:7]   # the same batches
    assert len(info["batches"]) == 8 and info["threads"] == [2, 2, 2]

    # an uninterrupted run over the same cursor's batches
    ref = steps.init_state(CFG, 1, device="cpu")
    step_fn = steps.make_train_step(CFG, total_steps=8)
    for c in range(8):
        ref, _ = step_fn(ref, info["batches"][c])
    for n, p in ref["params"].items():
        assert torch.equal(p, state["params"][n]), n
    assert int(state["opt"]["step"]) == 8


def test_make_controller_maps_the_reference_kinds():
    assert isinstance(make_controller("globus"), GlobusController)
    assert isinstance(make_controller("marlin"), MarlinOptimizer)
    assert make_controller("static") is None


def test_the_autotmdt_controller_tunes_the_pipeline(tmp_path):
    """PPO on the simulator (on the CPU here, K1 on the card), then the
    trained controller steering the input pipeline's engine."""
    state, info = train(CFG, steps=3, batch=2, seq=16, ckpt_every=10,
                        ckpt_dir=str(tmp_path), controller="autotmdt",
                        log_every=0, device="cpu")
    threads = info["threads"]
    assert len(threads) == 3 and all(1 <= t <= 32 for t in threads)
    assert len(info["losses"]) == 3 and info["report"].restarts == 0
    assert latest_step(str(tmp_path)) == 3


def test_train_needs_a_device_when_cuda_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(CFG, steps=1, ckpt_dir=str(tmp_path), controller="static")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_controller("autotmdt")
    assert latest_step(str(tmp_path)) is None


def test_the_command_line_trains_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--controller", "globus",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done: 3 steps" in out.stdout
    assert latest_step(str(tmp_path / "ckpt")) == 3
