"""ScenarioDriver — replay a scenario against the REAL transfer pipeline.

The same ScheduleTable that trains the agent in simulation retunes the live
``TransferEngine``'s StageThrottles on a background ticker: at each tick the
driver looks up the current bin (wall-clock, optionally time-scaled so a
60-simulated-second scenario replays in 6 real seconds) and calls the
thread-safe ``StageThrottle.set_rates``. Sim units (Gbit/s in the bundled
scenarios) map to engine bytes/s through ``bytes_per_unit``.

    spec = ScenarioSpec(family="step", seed=3)
    eng = TransferEngine(src, sink, throttles=(StageThrottle(), ...))
    with ScenarioDriver(eng, spec, bytes_per_unit=4 << 20, time_scale=10):
        controller.run(eng, ...)

The target only needs a retunable ``throttles`` triple, so a fleet's
``SharedLink`` drives the same way — one driver retunes the conditions
every attached engine contends under:

    link = SharedLink()
    engines = [link.attach(src_i, sink_i) for ...]
    with ScenarioDriver(link, spec, bytes_per_unit=4 << 20, time_scale=10):
        fleet_controller.run(engines, ...)
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.scenarios.schedule import ScheduleTable, table_to_numpy


class ScenarioDriver:
    def __init__(self, engine, scenario, *, bytes_per_unit=1 << 20,
                 tick=0.05, time_scale=1.0, loop=False):
        """``scenario``: a ScenarioSpec, a ScheduleTable, or raw
        ``(tpt[T,3], bw[T,3], bin_seconds)``. ``time_scale``: simulated
        seconds per wall second. ``loop``: wrap past the horizon instead of
        holding the last bin."""
        self.engine = engine
        if hasattr(scenario, "table"):        # ScenarioSpec
            scenario = scenario.table()
        if isinstance(scenario, ScheduleTable):
            scenario = table_to_numpy(scenario)
        tpt, bw, bin_s = scenario
        self.tpt = np.asarray(tpt, float)
        self.bw = np.asarray(bw, float)
        self.bin_seconds = float(bin_s)
        self.bytes_per_unit = float(bytes_per_unit)
        self.tick = tick
        self.time_scale = float(time_scale)
        self.loop = loop
        self._stop = threading.Event()
        self._thread = None
        self._t0 = None
        self._applied_idx = -1

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._t0 = time.monotonic()
        self._apply(0)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- ticker -----------------------------------------------------------
    def sim_time(self):
        """Current position on the scenario clock, in simulated seconds."""
        if self._t0 is None:
            return 0.0
        return (time.monotonic() - self._t0) * self.time_scale

    def _index_at(self, sim_t):
        idx = int(sim_t / self.bin_seconds)
        T = len(self.tpt)
        return idx % T if self.loop else min(max(idx, 0), T - 1)

    def _apply(self, idx):
        scale = self.bytes_per_unit
        for stage, throttle in enumerate(self.engine.throttles):
            throttle.set_rates(
                aggregate_bps=float(self.bw[idx, stage]) * scale,
                per_thread_bps=float(self.tpt[idx, stage]) * scale)
        self._applied_idx = idx

    def _run(self):
        while not self._stop.wait(self.tick):
            idx = self._index_at(self.sim_time())
            if idx != self._applied_idx:
                self._apply(idx)


class FaultInjector:
    """Replay a ``FaultSpec``'s LIVENESS events against the real pipeline —
    the fault twin of ScenarioDriver (same background ticker, same scaled
    scenario clock; run both for rates + faults together):

      stage_hang      the target's stage throttle drops to rate 0 at ``t``
                      (acquire() parks — the live outage bin) and is
                      RE-ASSERTED every tick until ``until``, so a
                      concurrent ScenarioDriver bin change cannot lift the
                      hang early; at ``until`` the rates captured at hang
                      time are restored (a running ScenarioDriver corrects
                      them at its next bin boundary).
      link_blackout   same, for every stage throttle of ``MultiLink.link(e)``
                      (on a SharedLink/TransferEngine target, all stages —
                      the single bottleneck IS the link).
      kill_flow       ``on_kill(flow)`` if given, else ``engines[flow]``
                      is ``close()``d — in-flight buffers are dropped on
                      the floor exactly like a real crash (the
                      checkpointed-restart machinery in
                      repro.transfer.recovery is what makes this safe).
      restart_flow    ``on_restart(flow)`` — the harness decides how to
                      resurrect (typically ``CheckpointedFlow.restart()``).

    ``target``: a MultiLink (per-link throttles), or anything with a
    ``throttles`` triple (SharedLink, TransferEngine). ``engines``: optional
    flow-index -> engine mapping for the default kill action."""

    def __init__(self, target, faults, *, engines=None, on_kill=None,
                 on_restart=None, tick=0.05, time_scale=1.0):
        self.target = target
        self.events = sorted(faults.events if hasattr(faults, "events")
                             else list(faults), key=lambda e: e.t)
        self.engines = engines or {}
        self.on_kill = on_kill
        self.on_restart = on_restart
        self.tick = tick
        self.time_scale = float(time_scale)
        self._stop = threading.Event()
        self._thread = None
        self._t0 = None
        self._fired = set()     # event ids whose onset has run
        self._outages = []      # (until, throttles, saved_rates) to restore

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("injector already started")
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def sim_time(self):
        if self._t0 is None:
            return 0.0
        return (time.monotonic() - self._t0) * self.time_scale

    # -- event actions ----------------------------------------------------
    def _victim_throttles(self, event):
        if event.kind == "link_blackout" and hasattr(self.target, "link"):
            return list(self.target.link(event.link).throttles)
        if event.kind == "link_blackout":
            return list(self.target.throttles)
        return [self.target.throttles[event.stage]]

    def _fire(self, event):
        if event.kind in ("stage_hang", "link_blackout"):
            throttles = self._victim_throttles(event)
            saved = [t.rates() for t in throttles]
            for t in throttles:
                t.set_rates(aggregate_bps=0, per_thread_bps=0)
            self._outages.append((event.until, throttles, saved))
        elif event.kind == "kill_flow":
            if self.on_kill is not None:
                self.on_kill(event.flow)
            else:
                eng = self.engines.get(event.flow) \
                    if hasattr(self.engines, "get") \
                    else self.engines[event.flow]
                if eng is not None:
                    eng.close()
        elif event.kind == "restart_flow" and self.on_restart is not None:
            self.on_restart(event.flow)

    def _tick_once(self, now):
        for i, e in enumerate(self.events):
            if i not in self._fired and e.t <= now:
                self._fired.add(i)
                self._fire(e)
        still = []
        for until, throttles, saved in self._outages:
            if now >= until:
                for t, (agg, per) in zip(throttles, saved):
                    t.set_rates(aggregate_bps=agg, per_thread_bps=per)
            else:  # re-assert the outage over any concurrent retune
                for t in throttles:
                    t.set_rates(aggregate_bps=0, per_thread_bps=0)
                still.append((until, throttles, saved))
        self._outages = still

    def _run(self):
        while not self._stop.wait(self.tick):
            self._tick_once(self.sim_time())
            if len(self._fired) == len(self.events) and not self._outages:
                return  # everything replayed and recovered
