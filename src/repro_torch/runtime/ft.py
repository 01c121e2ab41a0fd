"""Worker liveness (the part of ``repro.runtime.ft`` the fleet controller
needs): ``HeartbeatRegistry`` records each worker's last (monotonic time,
step, step time) heartbeat, and ``WorkerFailure`` is the failure a worker
raises. ``FleetController.run(registry=...)`` beats ``flow<i>`` for every
engine that made byte progress and masks the flows whose last beat is too
old. The straggler detector and the checkpoint-restart trainer belong to
the LM slice of the port.
"""

from __future__ import annotations

import threading
import time


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
