"""Paper Algorithm 1, faithful: the event-driven I/O + network dynamics
simulator with a time-sorted priority queue.

Each popped task represents one thread's unit of work (one chunk). A read
task needs free sender-buffer space; a network task needs sender bytes and
free receiver space; a write task needs receiver bytes. A blocked task is
re-queued at t + eps. Task duration d_task = chunk / effective_rate, where
the effective per-thread rate is min(TPT_i, B_i / n_i) — per-thread speed
capped by the stage's aggregate bandwidth share.

This is the correctness ORACLE for the dense simulator
(repro_torch.core.simulator) and the paper-faithful cost model for the
"online vs offline training time" accounting. Units: bytes and seconds
(throughputs are bytes/s; the benchmarks use Gbit/s at the edges).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

R, N, W = 0, 1, 2  # stage indices: read, network, write
STAGES = ("read", "network", "write")


@dataclass
class EventSimState:
    sender_buf: float = 0.0
    receiver_buf: float = 0.0


class EventSimulator:
    def __init__(self, *, tpt, bandwidth, buffer_capacity, chunk=None,
                 eps=1e-3, duration=1.0, schedule=None):
        """tpt/bandwidth: per-stage (read, network, write); buffer_capacity:
        (sender, receiver). chunk defaults to min(tpt)*duration/8 so a thread
        completes several chunks per simulated second.

        ``schedule``: optional piecewise-constant conditions — either a
        ``repro_torch.core.schedule.ScheduleTable`` or the raw
        ``(tpt_table[T,3], bw_table[T,3], bin_seconds)`` tuple. When set,
        tpt/bandwidth are looked up at each task's ABSOLUTE start time — the
        clock accumulates ``duration`` per get_utility() call — making this
        the oracle for the schedule-aware dense simulator. A task straddling
        a bin boundary keeps its start-bin rate (chunk-granularity artifact,
        shrinking with chunk size like every other event-model artifact)."""
        self.tpt = [float(x) for x in tpt]
        self.bw = [float(x) for x in bandwidth]
        self.cap = [float(x) for x in buffer_capacity]
        self.chunk = float(chunk) if chunk else min(self.tpt) * duration / 8.0
        self.eps = eps
        self.duration = duration
        self.state = EventSimState()
        self.t_global = 0.0
        self.schedule = None
        if schedule is not None:
            if hasattr(schedule, "tpt"):  # ScheduleTable (core or scenarios)
                from repro_torch.core.schedule import table_to_numpy
                schedule = table_to_numpy(schedule)
            tpt_tab, bw_tab, bin_s = schedule
            self.schedule = ([[float(x) for x in row] for row in tpt_tab],
                             [[float(x) for x in row] for row in bw_tab],
                             float(bin_s))

    def _conditions(self, stage, t_abs):
        """(tpt_i, bw_i) at absolute sim time t_abs."""
        if self.schedule is None:
            return self.tpt[stage], self.bw[stage]
        tpt_tab, bw_tab, bin_s = self.schedule
        idx = min(max(int(t_abs / bin_s), 0), len(tpt_tab) - 1)
        return tpt_tab[idx][stage], bw_tab[idx][stage]

    # -- Algorithm 1, TASK ------------------------------------------------
    def _task(self, t, stage, n_threads, moved, retries):
        d_task = 0.0
        tpt_i, bw_i = self._conditions(stage, self.t_global + t)
        rate = min(tpt_i, bw_i / max(n_threads[stage], 1))
        rate = max(rate, 1e-12)
        ch = self.chunk
        s = self.state
        if stage == R:
            space = self.cap[0] - s.sender_buf
            if space > 1e-12:
                take = min(ch, space)
                d_task = take / rate
                moved[R] += take
                s.sender_buf += take
            else:
                retries[R] += 1
                return t + self.eps, False
        elif stage == N:
            space = self.cap[1] - s.receiver_buf
            if s.sender_buf > 1e-12 and space > 1e-12:
                take = min(ch, s.sender_buf, space)
                d_task = take / rate
                moved[N] += take
                s.sender_buf -= take
                s.receiver_buf += take
            else:
                retries[N] += 1
                return t + self.eps, False
        else:  # write
            if s.receiver_buf > 1e-12:
                take = min(ch, s.receiver_buf)
                d_task = take / rate
                moved[W] += take
                s.receiver_buf -= take
            else:
                retries[W] += 1
                return t + self.eps, False
        return t + d_task + 1e-9, True

    # -- Algorithm 1, GET_UTILITY -----------------------------------------
    def get_utility(self, new_threads, *, k=1.02):
        """Simulate ``duration`` seconds with thread counts (n_r, n_n, n_w).
        Returns (reward, info)."""
        from repro_torch.core.utility import utility

        n = [max(int(round(x)), 0) for x in new_threads]
        moved = [0.0, 0.0, 0.0]
        retries = [0, 0, 0]
        finish = [self.duration] * 3  # per-stage last task completion
        q = []
        counter = itertools.count()  # tie-break for equal times
        for stage in (R, N, W):
            for _ in range(n[stage]):
                heapq.heappush(q, (0.0, next(counter), stage))
        t_end = self.duration
        while q:
            t, _, stage = heapq.heappop(q)
            t_next, ok = self._task(t, stage, n, moved, retries)
            if ok:
                finish[stage] = max(finish[stage], t_next)
            if t_next < t_end:
                heapq.heappush(q, (t_next, next(counter), stage))
        # Algorithm 1 line 37: normalize throughputs by their finish times
        throughputs = [m / f for m, f in zip(moved, finish)]
        reward = float(utility(throughputs, n, k=k))
        info = {
            "throughputs": throughputs,
            "moved": list(moved),    # raw bytes this interval (wall-second
            "finish": list(finish),  # rate = moved / finish; see tests)
            "threads": n,
            "sender_buf": self.state.sender_buf,
            "receiver_buf": self.state.receiver_buf,
            "retries": retries,
        }
        self.t_global += self.duration  # schedule clock: one call = duration s
        return reward, info

    def reset(self):
        self.state = EventSimState()
        self.t_global = 0.0
