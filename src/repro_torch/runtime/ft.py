"""Fault tolerance (port of ``repro.runtime.ft``).

HeartbeatRegistry / StragglerDetector: every worker posts (step, step_time)
heartbeats; a worker is a STRAGGLER when its rolling step time exceeds
``slow_factor`` x the fleet median, and DEAD when its last heartbeat is older
than ``dead_after``. ``FleetController.run(registry=...)`` beats
``flow<i>`` for every engine that made byte progress and masks the flows
whose last beat is too old.

FaultTolerantTrainer: wraps a train loop with periodic async checkpoints and
restart-from-latest on failure (simulated via chaos injection; a preemption
lands as a process restart that takes the same resume path). The
data-pipeline cursor (rows consumed) is checkpointed with the model state
so restarts don't replay or skip data; it comes back as a Python int.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field

from repro_torch.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                    latest_step)


class WorkerFailure(RuntimeError):
    """Injected/encountered worker failure (preemption, OOM, link flap)."""


class HeartbeatRegistry:
    def __init__(self):
        self._hb = {}
        self._lock = threading.Lock()

    def beat(self, worker, step, step_time):
        with self._lock:
            self._hb[worker] = (time.monotonic(), step, step_time)

    def snapshot(self):
        with self._lock:
            return dict(self._hb)


class StragglerDetector:
    def __init__(self, registry, *, slow_factor=1.5, dead_after=10.0):
        self.reg = registry
        self.slow_factor = slow_factor
        self.dead_after = dead_after

    def report(self):
        now = time.monotonic()
        snap = self.reg.snapshot()
        if not snap:
            return {"stragglers": [], "dead": [], "median_step_time": None}
        times = [v[2] for v in snap.values()]
        med = statistics.median(times)
        stragglers = [w for w, v in snap.items()
                      if med > 0 and v[2] > self.slow_factor * med]
        dead = [w for w, v in snap.items() if now - v[0] > self.dead_after]
        return {"stragglers": stragglers, "dead": dead,
                "median_step_time": med}


@dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    history: list = field(default_factory=list)


def _restore(ckpt_dir, like):
    state, step = load_checkpoint(ckpt_dir, like)
    return {"model": state["model"], "cursor": int(state["cursor"])}, step


class FaultTolerantTrainer:
    """run(step_fn, state, batches) with checkpoint/restart semantics.

    step_fn(state, batch) -> (state, metrics); ``batch_fn(cursor)`` supplies
    deterministic batches so the data cursor can resume exactly. The model
    state is a tree the checkpointer takes (dicts of tensors); a restored
    one lands on the devices of ``init_state``'s tensors.
    """

    def __init__(self, ckpt_dir, *, ckpt_every=20, keep=3, registry=None,
                 worker="worker0"):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.saver = AsyncCheckpointer(ckpt_dir, keep=keep)
        self.registry = registry or HeartbeatRegistry()
        self.worker = worker

    def run(self, step_fn, init_state, batch_fn, total_steps, *,
            chaos=None, max_restarts=10):
        """chaos: optional fn(step) -> None that may raise WorkerFailure."""
        report = TrainerReport()
        state = {"model": init_state, "cursor": 0}
        start = 0
        if latest_step(self.ckpt_dir) is not None:
            state, start = _restore(self.ckpt_dir, state)
        restarts = 0
        step = start
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if chaos is not None:
                    chaos(step)
                batch = batch_fn(state["cursor"])
                new_model, metrics = step_fn(state["model"], batch)
                state = {"model": new_model, "cursor": state["cursor"] + 1}
                step += 1
                self.registry.beat(self.worker, step, time.monotonic() - t0)
                report.steps_run += 1
                report.history.append(metrics)
                if step % self.ckpt_every == 0 or step == total_steps:
                    self.saver.save(state, step)
                    report.checkpoints += 1
            except WorkerFailure:
                restarts += 1
                report.restarts += 1
                if restarts > max_restarts:
                    raise
                try:
                    self.saver.wait()  # drain any in-flight save first
                except Exception:
                    # a FAILED save must not kill the restart path — fall
                    # back to the latest checkpoint that did land on disk
                    pass
                if latest_step(self.ckpt_dir) is not None:
                    state, step = _restore(self.ckpt_dir, state)
                else:
                    state, step = {"model": init_state, "cursor": 0}, 0
        self.saver.wait()
        return state["model"], report
