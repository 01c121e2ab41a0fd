"""FaultSpec — liveness faults as a scenario axis (port of
``repro.scenarios.faults``).

Scenario families vary RATES; fault specs vary LIVENESS: a flow's endpoint
crashes mid-transfer and (maybe) comes back, one pipeline stage hangs, a
whole link blacks out and recovers. A ``FaultSpec`` is a small, seeded,
JSON-serializable event list with three consumers:

  * the simulator: ``compile_fault_batch`` folds the events into the
    ``ScheduleTable`` / ``FlowSchedule`` / ``LinkGraph`` tensors as
    activity-window and capacity EDITS, so ``fleet_step`` and
    ``topology_step`` run unchanged on the edited operands (shapes never
    change; an env without faults passes through bitwise);
  * training: ``sample_fault_batch`` draws per-env fault schedules from
    their own NumPy stream (``seed + 0xFA17``), so adding faults never
    perturbs the table, arrival or objective draws;
  * the live engine: ``repro_torch.scenarios.driver.FaultInjector``
    replays the same events in wall-clock time.

Event kinds and their compilation:

  ``kill_flow``      flow f dies at t. With no matching restart the flow's
                     ``t_end`` truncates to t; with one, the pair becomes a
                     ``FlowSchedule`` down window [t_kill, t_restart).
  ``restart_flow``   flow f comes back at t (requires an earlier kill).
  ``stage_hang``     stage s delivers nothing on [t, until): its tpt/bw
                     table bins covering the window drop to zero (on a
                     LinkGraph: that stage on EVERY link).
  ``link_blackout``  link l delivers nothing on [t, until): all three
                     stages of link l's bins drop to zero (on a plain
                     fleet ScheduleTable the single bottleneck IS the
                     link: all stages drop).

The edits are made on the host in NumPy, the bin edges in Python float64
as the reference computes them, and go back to each input's device and
dtype. ``compile_fault_batch`` moves each batched structure to the host and
back once, whatever the batch size, and counts those copies in
``compile_fault_batch.host_copies``.

File format (``.faults.json``)::

    {"name": "evening-outage", "seed": 7,
     "events": [{"kind": "kill_flow", "t": 12.0, "flow": 1},
                {"kind": "restart_flow", "t": 20.0, "flow": 1},
                {"kind": "link_blackout", "t": 30.0, "until": 35.0,
                 "link": 0}]}
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, asdict

import numpy as np
import torch

from repro_torch.core.fleet import FlowSchedule
from repro_torch.core.topology import LinkGraph, Topology
from repro_torch.scenarios.schedule import ScheduleTable

FAULT_KINDS = ("kill_flow", "restart_flow", "stage_hang", "link_blackout")


@dataclass
class FaultEvent:
    """One liveness event. ``t`` is the sim-clock time it fires; ``until``
    is the recovery time for the windowed kinds (stage_hang /
    link_blackout; inf = never recovers). ``flow``/``stage``/``link``
    address the victim for the kinds that need each."""

    kind: str
    t: float
    until: float = math.inf   # stage_hang / link_blackout recovery
    flow: int = 0             # kill_flow / restart_flow target
    stage: int = 0            # stage_hang target (0 read, 1 net, 2 write)
    link: int = 0             # link_blackout target

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind in ("stage_hang", "link_blackout") \
                and self.until <= self.t:
            raise ValueError(f"{self.kind} needs until > t "
                             f"({self.until} <= {self.t})")
        if self.kind == "stage_hang" and self.stage not in (0, 1, 2):
            raise ValueError(f"stage must be 0..2, got {self.stage}")

    def to_dict(self):
        d = {"kind": self.kind, "t": self.t}
        if math.isfinite(self.until):
            d["until"] = self.until
        if self.kind in ("kill_flow", "restart_flow"):
            d["flow"] = self.flow
        if self.kind == "stage_hang":
            d["stage"] = self.stage
        if self.kind == "link_blackout":
            d["link"] = self.link
        return d


@dataclass
class FaultSpec:
    """A seeded, serializable fault schedule. Validation enforces the
    one-outage-per-flow contract a down window can express: at most one
    kill per flow, each restart after a kill of the same flow."""

    name: str = ""
    seed: int = 0
    events: list = field(default_factory=list)

    def __post_init__(self):
        self.events = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
                       for e in self.events]
        if not self.name:
            self.name = f"faults-{self.seed}"
        kills, restarts = {}, {}
        for e in self.events:
            if e.kind == "kill_flow":
                if e.flow in kills:
                    raise ValueError(f"flow {e.flow} killed twice: the "
                                     "down-window encoding holds one "
                                     "kill/restart cycle per flow")
                kills[e.flow] = e.t
            elif e.kind == "restart_flow":
                if e.flow in restarts:
                    raise ValueError(f"flow {e.flow} restarted twice")
                restarts[e.flow] = e.t
        for f, t in restarts.items():
            if f not in kills:
                raise ValueError(f"restart of flow {f} without a kill")
            if t <= kills[f]:
                raise ValueError(f"flow {f} restarts at {t} before its "
                                 f"kill at {kills[f]}")

    # -- fault files ------------------------------------------------------
    def to_dict(self):
        d = asdict(self)
        d["events"] = [e.to_dict() for e in self.events]
        return d

    def to_json(self, path=None):
        s = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_dict(cls, d):
        return cls(**dict(d))

    @classmethod
    def from_json(cls, s_or_path):
        s = s_or_path
        if not s.lstrip().startswith("{"):
            with open(s_or_path) as f:
                s = f.read()
        return cls.from_dict(json.loads(s))

    # -- convenience views ------------------------------------------------
    def outages(self):
        """{flow: (t_kill, t_restart)} with t_restart = inf for unrecovered
        kills: the down-window form the sim compiles to and the live
        ``FaultInjector`` replays."""
        kills = {e.flow: e.t for e in self.events if e.kind == "kill_flow"}
        restarts = {e.flow: e.t for e in self.events
                    if e.kind == "restart_flow"}
        return {f: (t, restarts.get(f, math.inf)) for f, t in kills.items()}


def _events(spec_or_events):
    if spec_or_events is None:
        return []
    if isinstance(spec_or_events, FaultSpec):
        return spec_or_events.events
    return list(spec_or_events)


def _liveness(spec_or_events):
    return [e for e in _events(spec_or_events)
            if e.kind in ("kill_flow", "restart_flow")]


def _capacity(spec_or_events):
    return [e for e in _events(spec_or_events)
            if e.kind in ("stage_hang", "link_blackout")]


def _zero_bins(arr, bin_seconds, t, until):
    """The [lo, hi) time bins of a (..., T, 3) table slice that overlap
    [t, until), on Python floats. Bin b covers [b*bin_s, (b+1)*bin_s); the
    LAST bin also covers everything past the horizon."""
    T = arr.shape[-2]
    lo = max(int(math.floor(t / bin_seconds)), 0)
    hi = T if not math.isfinite(until) \
        else min(int(math.ceil(until / bin_seconds)), T)
    if math.isfinite(until) and until > T * bin_seconds:
        hi = T  # past-horizon recovery: the held last bin is dark too
    return lo, hi


# ---------------------------------------------------------------------------
# The edits, in NumPy on one env's host arrays (in place)
# ---------------------------------------------------------------------------


def _edit_flows(events, ts, te, ds, de):
    """Kill/restart events on one env's (F,) float32 arrays: an
    unrecovered kill truncates ``te``, a kill/restart pair writes a down
    window into ``ds``/``de``."""
    F = ts.shape[-1]
    for f, (t_kill, t_restart) in FaultSpec(events=events).outages().items():
        if not 0 <= f < F:
            raise ValueError(f"kill_flow targets flow {f} of an F={F} fleet")
        if math.isfinite(t_restart):
            if np.isfinite(ds[..., f]).any():
                raise ValueError(f"flow {f} already carries a down window")
            ds[..., f] = t_kill
            de[..., f] = t_restart
        else:
            te[..., f] = np.minimum(te[..., f], np.float32(t_kill))


def _edit_table(events, tpt, bw, bin_s):
    """Hang/blackout events on one (T, 3) table: the covered bins drop to
    zero (a blackout of the single bottleneck darkens every stage)."""
    for e in events:
        lo, hi = _zero_bins(tpt, bin_s, e.t, e.until)
        cols = slice(None) if e.kind == "link_blackout" \
            else slice(e.stage, e.stage + 1)
        tpt[lo:hi, cols] = 0.0
        bw[lo:hi, cols] = 0.0


def _edit_graph(events, tpt, bw, bin_s):
    """Hang/blackout events on one (L, T, 3) graph: a hang zeroes its stage
    on EVERY link (the stage is endpoint-side, shared by all paths), a
    blackout every stage of its link."""
    L = tpt.shape[0]
    for e in events:
        lo, hi = _zero_bins(tpt, bin_s, e.t, e.until)
        if e.kind == "link_blackout":
            if not 0 <= e.link < L:
                raise ValueError(f"link_blackout targets link {e.link} of "
                                 f"an E={L} graph")
            tpt[e.link, lo:hi, :] = 0.0
            bw[e.link, lo:hi, :] = 0.0
        else:
            tpt[:, lo:hi, e.stage] = 0.0
            bw[:, lo:hi, e.stage] = 0.0


def _host(*tensors):
    """The tensors stacked and copied to the host in ONE copy: a writable
    (k, ...) array of their dtype, sharing no memory with them."""
    compile_fault_batch.host_copies += 1
    return torch.stack(tensors).cpu().numpy()


def _back(arr, like):
    """``arr`` (k, ...) on ``like``'s device and dtype in ONE copy, as k
    tensors."""
    compile_fault_batch.host_copies += 1
    return torch.from_numpy(arr).to(device=like.device,
                                    dtype=like.dtype).unbind(0)


# ---------------------------------------------------------------------------
# One structure
# ---------------------------------------------------------------------------


def apply_faults_to_flows(spec_or_events, flows: FlowSchedule) -> FlowSchedule:
    """Compile kill/restart events into one UNBATCHED (F,) FlowSchedule:
    an unrecovered kill truncates ``t_end``; a kill/restart pair becomes a
    down window. No kill events -> the input, untouched."""
    events = _liveness(spec_or_events)
    if not events:
        return flows
    inf = torch.full_like(flows.t_start, math.inf)
    fields = [flows.t_start, flows.t_end,
              inf if flows.down_start is None else flows.down_start,
              inf if flows.down_end is None else flows.down_end]
    arr = _host(*fields)
    _edit_flows(events, *arr)
    return FlowSchedule(*_back(arr, flows.t_start))


def apply_faults_to_table(spec_or_events, table: ScheduleTable) \
        -> ScheduleTable:
    """Compile stage_hang / link_blackout events into one UNBATCHED (T, 3)
    ScheduleTable by zeroing the covered bins. No capacity events -> the
    input, untouched."""
    events = _capacity(spec_or_events)
    if not events:
        return table
    arr = _host(table.tpt, table.bw)
    _edit_table(events, arr[0], arr[1], float(table.bin_seconds))
    tpt, bw = _back(arr, table.tpt)
    return ScheduleTable(tpt=tpt, bw=bw, bin_seconds=table.bin_seconds)


def apply_faults_to_graph(spec_or_events, graph: LinkGraph) -> LinkGraph:
    """Compile stage_hang / link_blackout events into one UNBATCHED
    (L, T, 3) LinkGraph: a hang zeroes its stage on every link, a blackout
    every stage of its link. No capacity events -> the input, untouched."""
    events = _capacity(spec_or_events)
    if not events:
        return graph
    arr = _host(graph.tpt, graph.bw)
    _edit_graph(events, arr[0], arr[1], float(graph.bin_seconds))
    tpt, bw = _back(arr, graph.tpt)
    return LinkGraph(tpt=tpt, bw=bw, bin_seconds=graph.bin_seconds)


# ---------------------------------------------------------------------------
# A batch
# ---------------------------------------------------------------------------


def compile_fault_batch(faults, *, tables=None, flows=None, topology=None):
    """Apply per-env fault schedules to BATCHED sim structures (leading env
    axis): ``faults`` is a list of FaultSpec/None, one per env. Returns
    ``(tables, flows, topology)`` with the edits applied; envs with no
    faults pass through bitwise unchanged, and an all-None list returns
    the inputs untouched (same objects). Each structure an env edits goes
    to the host and back once for the whole batch; shapes never change.

    Down windows appear on ``flows`` when any env kills a flow (the other
    envs get all-inf windows, exact no-ops), as the reference's stack of
    per-env schedules makes them."""
    faults = list(faults or [])
    if not any(f is not None for f in faults):
        return tables, flows, topology

    def _check(n, what):
        if n != len(faults):
            raise ValueError(f"{len(faults)} fault schedules for a batch "
                             f"of {n} {what}")

    if flows is not None:
        shape = flows.t_start.shape
        if len(shape) != 2:
            raise ValueError(f"compile_fault_batch expects batched (N, F) "
                             f"flows, got {tuple(shape)}")
        _check(shape[0], "flow schedules")
        kills = [_liveness(f) for f in faults]
        if any(kills):
            inf = torch.full_like(flows.t_start, math.inf)
            arr = _host(flows.t_start, flows.t_end,
                        inf if flows.down_start is None else flows.down_start,
                        inf if flows.down_end is None else flows.down_end)
            for i, events in enumerate(kills):
                if events:
                    _edit_flows(events, *arr[:, i])
            flows = FlowSchedule(*_back(arr, flows.t_start))
    hangs = [_capacity(f) for f in faults]
    if tables is not None:
        _check(tables.tpt.shape[0], "tables")
        if any(hangs):
            arr = _host(tables.tpt, tables.bw)
            for i, events in enumerate(hangs):
                if events:
                    _edit_table(events, arr[0, i], arr[1, i],
                                float(tables.bin_seconds[i]))
            tpt, bw = _back(arr, tables.tpt)
            tables = ScheduleTable(tpt=tpt, bw=bw,
                                   bin_seconds=tables.bin_seconds)
    if topology is not None:
        graph = topology.graph
        _check(graph.tpt.shape[0], "graphs")
        if any(hangs):
            arr = _host(graph.tpt, graph.bw)
            for i, events in enumerate(hangs):
                if events:
                    _edit_graph(events, arr[0, i], arr[1, i],
                                float(graph.bin_seconds[i]))
            tpt, bw = _back(arr, graph.tpt)
            topology = Topology(
                graph=LinkGraph(tpt=tpt, bw=bw,
                                bin_seconds=graph.bin_seconds),
                paths=topology.paths)
    return tables, flows, topology


compile_fault_batch.host_copies = 0


# ---------------------------------------------------------------------------
# Sampling (NumPy, byte-identical to the reference for the same seed)
# ---------------------------------------------------------------------------


def sample_faults(n_flows, *, seed=0, horizon=60.0, n_links=1,
                  kill_prob=0.4, restart_prob=0.75, hang_prob=0.3,
                  blackout_prob=0.0, kill_window=(0.2, 0.6),
                  outage_frac=(0.05, 0.25), hang_frac=(0.05, 0.2)) \
        -> FaultSpec:
    """One random fault schedule. Each flow is killed with probability
    ``kill_prob`` at a uniform time in ``kill_window`` of the horizon and
    restarts with probability ``restart_prob`` after an outage of
    ``outage_frac`` of the horizon; with probability ``hang_prob`` one
    random stage hangs for ``hang_frac`` of the horizon; with probability
    ``blackout_prob`` (per link, meaningful when ``n_links`` > 1) a link
    blacks out likewise. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    events = []
    for f in range(n_flows):
        if rng.random() >= kill_prob:
            continue
        t_kill = float(rng.uniform(*kill_window) * horizon)
        events.append(FaultEvent(kind="kill_flow", t=t_kill, flow=f))
        if rng.random() < restart_prob:
            t_back = t_kill + float(rng.uniform(*outage_frac) * horizon)
            events.append(FaultEvent(kind="restart_flow", t=t_back, flow=f))
    if rng.random() < hang_prob:
        t = float(rng.uniform(0.1, 0.7) * horizon)
        events.append(FaultEvent(
            kind="stage_hang", t=t,
            until=t + float(rng.uniform(*hang_frac) * horizon),
            stage=int(rng.integers(0, 3))))
    for e in range(n_links):
        if rng.random() >= blackout_prob:
            continue
        t = float(rng.uniform(0.1, 0.7) * horizon)
        events.append(FaultEvent(
            kind="link_blackout", t=t,
            until=t + float(rng.uniform(*hang_frac) * horizon), link=e))
    return FaultSpec(name=f"faults-{seed}", seed=seed, events=events)


def sample_fault_batch(n, n_flows, *, seed=0, horizon=60.0, n_links=1,
                       fault_prob=1.0, **mix):
    """``n`` per-env fault schedules for training, drawn from their OWN
    NumPy stream (``seed + 0xFA17``). Each env carries a schedule with
    probability ``fault_prob`` (None otherwise); the remaining ``mix``
    kwargs go to ``sample_faults``. Deterministic in ``seed``. Returns
    ``list[FaultSpec | None]`` of length ``n``."""
    rng = np.random.default_rng(seed + 0xFA17)
    out = []
    for _ in range(n):
        sub = int(rng.integers(0, 2 ** 31 - 1))
        if rng.random() >= fault_prob:
            out.append(None)
            continue
        out.append(sample_faults(n_flows, seed=sub, horizon=horizon,
                                 n_links=n_links, **mix))
    return out
