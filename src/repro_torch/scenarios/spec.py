"""ScenarioSpec and the domain-randomized samplers (port of
``repro.scenarios.spec``).

A spec is a small, JSON-serializable description (family + knobs + seed)
that compiles to a ScheduleTable; a ``TopologySpec`` compiles to a link
graph and its routes. The samplers draw condition tables, link graphs,
flow-arrival schedules, per-flow objectives and per-env fault schedules
with NumPy, on the same streams as the reference (the tables' ``seed``,
the graphs' ``seed + 0x70B0``, the arrivals' ``seed + 0x5EED``, the
objectives' ``seed + 0x0BB1``, the faults' ``seed + 0xFA17``), so every
array is byte-identical to the reference's for the same seed; the arrays
then go to ``device`` (None: the CUDA device) as torch tensors.

File format (``.scenario.json``)::

    {"name": "evening-burst", "family": "bursty", "seed": 7,
     "horizon": 60.0, "bin_seconds": 1.0,
     "base_tpt": [0.2, 0.15, 0.2], "base_bw": [1.0, 1.0, 1.0],
     "params": {"burst_prob": 0.3, "load": 0.7}}

"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict

import numpy as np

from repro_torch.core.fleet import (make_flow_schedule, stack_flow_schedules,
                                    make_flow_objective, default_objectives,
                                    stack_flow_objectives, PRIORITY_TIERS,
                                    flow_bucket, pad_flow_schedule,
                                    pad_flow_objectives)
from repro_torch.core.topology import (Topology, make_link_graph,
                                       make_path_spec, stack_topologies,
                                       pad_path_spec)
from repro_torch.core.workload import Workload
from repro_torch.scenarios.faults import sample_fault_batch
from repro_torch.scenarios.families import (FAMILIES, ARRIVAL_FAMILIES,
                                            TOPOLOGY_FAMILIES)
from repro_torch.scenarios.schedule import (ScheduleTable, make_table,
                                            stack_tables)

DEFAULT_TPT = (0.2, 0.15, 0.2)   # per-thread Gbit/s (ratios are what matter)
DEFAULT_BW = (1.0, 1.0, 1.0)


@dataclass
class ScenarioSpec:
    family: str
    name: str = ""
    seed: int = 0
    horizon: float = 60.0          # simulated seconds covered by the table
    bin_seconds: float = 1.0
    base_tpt: tuple = DEFAULT_TPT
    base_bw: tuple = DEFAULT_BW
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown scenario family {self.family!r}; "
                             f"have {sorted(FAMILIES)}")
        if not self.name:
            self.name = f"{self.family}-{self.seed}"

    def tables(self):
        """Raw numpy (tpt[T,3], bw[T,3])."""
        fn = FAMILIES[self.family]
        return fn(self.horizon, self.bin_seconds,
                  list(self.base_tpt), list(self.base_bw),
                  seed=self.seed, **self.params)

    def table(self, *, device=None) -> ScheduleTable:
        tpt, bw = self.tables()
        return make_table(tpt, bw, self.bin_seconds, device=device)

    # -- scenario files ---------------------------------------------------
    def to_dict(self):
        d = asdict(self)
        d["base_tpt"] = list(self.base_tpt)
        d["base_bw"] = list(self.base_bw)
        return d

    def to_json(self, path=None):
        s = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["base_tpt"] = tuple(d.get("base_tpt", DEFAULT_TPT))
        d["base_bw"] = tuple(d.get("base_bw", DEFAULT_BW))
        return cls(**d)

    @classmethod
    def from_json(cls, s_or_path):
        s = s_or_path
        if not s.lstrip().startswith("{"):
            with open(s_or_path) as f:
                s = f.read()
        return cls.from_dict(json.loads(s))


def default_specs(*, horizon=60.0, bin_seconds=1.0, seed=0,
                  base_tpt=DEFAULT_TPT, base_bw=DEFAULT_BW):
    """One representative spec per family."""
    return [ScenarioSpec(family=f, seed=seed, horizon=horizon,
                         bin_seconds=bin_seconds, base_tpt=base_tpt,
                         base_bw=base_bw)
            for f in FAMILIES]


def holdout_families(holdout, *, pool=None):
    """Split the condition families into ``(train, held_out)``; ``pool``
    defaults to every registered family, order preserved."""
    pool = list(pool if pool is not None else FAMILIES)
    held = set(holdout)
    unknown = held - set(pool)
    if unknown:
        raise ValueError(f"unknown held-out families {sorted(unknown)}; "
                         f"pool is {pool}")
    train = [f for f in pool if f not in held]
    if not train:
        raise ValueError("holding out every family leaves nothing to "
                         "train on")
    return train, [f for f in pool if f in held]


def arrival_schedule(family, n_flows, *, horizon=60.0, seed=0, device=None,
                     **params):
    """One flow-arrival family compiled to a ``FlowSchedule`` (F,).
    Deterministic in ``seed``."""
    if family not in ARRIVAL_FAMILIES:
        raise ValueError(f"unknown arrival family {family!r}; "
                         f"have {sorted(ARRIVAL_FAMILIES)}")
    t_start, t_end = ARRIVAL_FAMILIES[family](n_flows, horizon, seed=seed,
                                              **params)
    return make_flow_schedule(t_start, t_end, device=device)


def sample_objectives(n_flows, *, seed=0, horizon=60.0, base_bw=DEFAULT_BW,
                      tier_probs=(0.25, 0.25, 0.5), deadline_prob=0.5,
                      deadline_frac=(0.4, 0.9), demand_frac=(0.25, 0.6),
                      floor_deadline_frac=0.0, device=None):
    """One random heterogeneous objective set: tiers drawn gold/silver/
    bronze with ``tier_probs``; each flow carries a deadline with
    probability ``deadline_prob`` (uniform in ``deadline_frac`` of the
    horizon, demand in ``demand_frac`` of what the link could deliver by
    then); ``floor_deadline_frac`` reserves that fraction of the link as a
    rate floor for every deadline flow. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    tiers = list(PRIORITY_TIERS)
    names = [tiers[i] for i in rng.choice(len(tiers), size=n_flows,
                                          p=list(tier_probs))]
    link = float(min(base_bw))
    deadline = np.full(n_flows, np.inf, np.float32)
    demand = np.full(n_flows, np.inf, np.float32)
    floor = np.zeros(n_flows, np.float32)
    for f in range(n_flows):
        if rng.random() >= deadline_prob:
            continue
        d = rng.uniform(*deadline_frac) * horizon
        deadline[f] = d
        demand[f] = rng.uniform(*demand_frac) * link * d
        floor[f] = floor_deadline_frac * link
    return make_flow_objective(tiers=names, deadline=deadline,
                               demand=demand, rate_floor=floor,
                               device=device)


def sample_fleet_batch(n, n_flows, *, arrival_families=None,
                       families=("static",), seed=0, horizon=60.0,
                       bin_seconds=1.0, base_tpt=DEFAULT_TPT,
                       base_bw=DEFAULT_BW, jitter=0.25, objective_mix=None,
                       fault_mix=None, pad_flows=False, device=None):
    """Domain randomization for fleet training: ``n`` (condition table,
    arrival schedule, objective set) triples — conditions drawn like
    ``sample_scenario_batch``, arrivals over ``arrival_families`` with
    randomized seeds, objectives by ``sample_objectives`` when
    ``objective_mix`` is given (a kwargs dict, or ``True`` for its
    defaults; None = the default objective for every flow). Each axis has
    its own NumPy stream, so adding one never perturbs the others.
    ``fault_mix`` draws a per-env fault schedule (a kwargs dict for
    ``sample_fault_batch``, or ``True`` for its defaults), left UNCOMPILED
    in ``Workload.faults`` (``Workload.compiled()`` folds them in).
    ``pad_flows=True`` pads the flow axis to ``flow_bucket(n_flows)`` with
    never-active flows. Returns a ``Workload`` with batched (leading env
    axis) tables, flows and objectives on ``device``."""
    specs, tables = sample_scenario_batch(
        n, families=families, seed=seed, horizon=horizon,
        bin_seconds=bin_seconds, base_tpt=base_tpt, base_bw=base_bw,
        jitter=jitter, device=device)
    arrivals = list(arrival_families or ARRIVAL_FAMILIES)
    rng = np.random.default_rng(seed + 0x5EED)  # distinct from the tables'
    flows = [arrival_schedule(arrivals[int(rng.integers(0, len(arrivals)))],
                              n_flows, horizon=horizon,
                              seed=int(rng.integers(0, 2 ** 31 - 1)),
                              device=device)
             for _ in range(n)]
    if objective_mix is None:
        objectives = [default_objectives(n_flows, device=device)
                      for _ in range(n)]
    else:
        kw = {} if objective_mix is True else dict(objective_mix)
        orng = np.random.default_rng(seed + 0x0BB1)
        objectives = [sample_objectives(
            n_flows, seed=int(orng.integers(0, 2 ** 31 - 1)),
            horizon=horizon, base_bw=base_bw, device=device, **kw)
            for _ in range(n)]
    faults = None
    if fault_mix is not None:
        kw = {} if fault_mix is True else dict(fault_mix)
        faults = sample_fault_batch(n, n_flows, seed=seed, horizon=horizon,
                                    **kw)
    flows = stack_flow_schedules(flows)
    objectives = stack_flow_objectives(objectives)
    if pad_flows:
        flows = pad_flow_schedule(flows, flow_bucket(n_flows))
        objectives = pad_flow_objectives(objectives, flow_bucket(n_flows))
    return Workload(tables=tables, flows=flows, objectives=objectives,
                    faults=faults, specs=specs)


@dataclass
class TopologySpec:
    """The multi-link twin of ScenarioSpec: family + knobs + seed compiles
    to a (LinkGraph, PathSpec) pair — L per-link condition tables plus the
    time-varying routing matrix. Same JSON round trip
    (``.topology.json``)."""

    family: str
    name: str = ""
    seed: int = 0
    n_links: int = 2
    n_flows: int = 4
    horizon: float = 60.0
    bin_seconds: float = 1.0
    base_tpt: tuple = DEFAULT_TPT
    base_bw: tuple = DEFAULT_BW
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.family not in TOPOLOGY_FAMILIES:
            raise ValueError(f"unknown topology family {self.family!r}; "
                             f"have {sorted(TOPOLOGY_FAMILIES)}")
        if self.n_links < 1:
            raise ValueError("a topology needs at least one link")
        if not self.name:
            self.name = f"{self.family}-{self.seed}"

    def arrays(self):
        """Raw numpy (tpt[L,T,3], bw[L,T,3], onpath[2,F,L],
        route_bin_seconds): the live-replay side."""
        fn = TOPOLOGY_FAMILIES[self.family]
        return fn(self.n_links, self.n_flows, self.horizon,
                  self.bin_seconds, list(self.base_tpt), list(self.base_bw),
                  seed=self.seed, **self.params)

    def compile(self, *, device=None):
        """(LinkGraph, PathSpec) on ``device`` (None: the CUDA device)."""
        tpt, bw, onpath, route_bin = self.arrays()
        graph = make_link_graph(tpt, bw, self.bin_seconds, device=device)
        return graph, make_path_spec(onpath, route_bin,
                                     device=graph.tpt.device)

    def topology(self, *, device=None) -> Topology:
        return Topology(*self.compile(device=device))

    # -- topology files ---------------------------------------------------
    def to_dict(self):
        d = asdict(self)
        d["base_tpt"] = list(self.base_tpt)
        d["base_bw"] = list(self.base_bw)
        return d

    def to_json(self, path=None):
        s = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["base_tpt"] = tuple(d.get("base_tpt", DEFAULT_TPT))
        d["base_bw"] = tuple(d.get("base_bw", DEFAULT_BW))
        return cls(**d)

    @classmethod
    def from_json(cls, s_or_path):
        s = s_or_path
        if not s.lstrip().startswith("{"):
            with open(s_or_path) as f:
                s = f.read()
        return cls.from_dict(json.loads(s))


def sample_topology_batch(n, n_flows, *, n_links=2, families=None,
                          arrival_families=None, seed=0, horizon=60.0,
                          bin_seconds=1.0, base_tpt=DEFAULT_TPT,
                          base_bw=DEFAULT_BW, jitter=0.25,
                          objective_mix=None, fault_mix=None,
                          pad_flows=False, device=None):
    """Domain randomization for topology training: ``n`` (link graph +
    routes, arrival schedule, objective set) triples — graphs drawn over
    the topology ``families`` with randomized seeds and per-stage jitter,
    arrivals and objectives drawn as ``sample_fleet_batch`` draws them,
    each axis on its own NumPy stream (0x70B0 / 0x5EED / 0x0BB1 / 0xFA17
    offsets); ``fault_mix`` works as in ``sample_fleet_batch``, with
    ``n_links`` defaulted into the mix so link blackouts can target every
    link.
    ``pad_flows=True`` pads the flow axis (schedules, objectives and route
    rows) to ``flow_bucket(n_flows)``. Returns a ``Workload`` with a
    batched (leading env axis) topology, flows and objectives on
    ``device``."""
    families = list(families or TOPOLOGY_FAMILIES)
    rng = np.random.default_rng(seed + 0x70B0)
    specs = []
    for i in range(n):
        fam = families[int(rng.integers(0, len(families)))]
        scale = 1.0 + jitter * rng.uniform(-1.0, 1.0, size=3)
        specs.append(TopologySpec(
            family=fam, seed=int(rng.integers(0, 2 ** 31 - 1)),
            name=f"{fam}-dr{i}", n_links=n_links, n_flows=n_flows,
            horizon=horizon, bin_seconds=bin_seconds,
            base_tpt=tuple(float(t * s) for t, s in zip(base_tpt, scale)),
            base_bw=tuple(base_bw)))
    topology = stack_topologies([s.topology(device=device) for s in specs])
    arrivals = list(arrival_families or ARRIVAL_FAMILIES)
    arng = np.random.default_rng(seed + 0x5EED)
    flows = [arrival_schedule(arrivals[int(arng.integers(0, len(arrivals)))],
                              n_flows, horizon=horizon,
                              seed=int(arng.integers(0, 2 ** 31 - 1)),
                              device=device)
             for _ in range(n)]
    if objective_mix is None:
        objectives = [default_objectives(n_flows, device=device)
                      for _ in range(n)]
    else:
        kw = {} if objective_mix is True else dict(objective_mix)
        orng = np.random.default_rng(seed + 0x0BB1)
        objectives = [sample_objectives(
            n_flows, seed=int(orng.integers(0, 2 ** 31 - 1)),
            horizon=horizon, base_bw=base_bw, device=device, **kw)
            for _ in range(n)]
    faults = None
    if fault_mix is not None:
        kw = {} if fault_mix is True else dict(fault_mix)
        kw.setdefault("n_links", n_links)
        faults = sample_fault_batch(n, n_flows, seed=seed, horizon=horizon,
                                    **kw)
    flows = stack_flow_schedules(flows)
    objectives = stack_flow_objectives(objectives)
    if pad_flows:
        flows = pad_flow_schedule(flows, flow_bucket(n_flows))
        objectives = pad_flow_objectives(objectives, flow_bucket(n_flows))
        topology = Topology(graph=topology.graph,
                            paths=pad_path_spec(topology.paths,
                                                flow_bucket(n_flows)))
    return Workload(topology=topology, flows=flows, objectives=objectives,
                    faults=faults, specs=specs)


def sample_scenario_batch(n, *, families=None, seed=0, horizon=60.0,
                          bin_seconds=1.0, base_tpt=DEFAULT_TPT,
                          base_bw=DEFAULT_BW, jitter=0.25, device=None):
    """Domain randomization: ``n`` specs drawn over ``families`` with
    randomized seeds and base rates jittered by up to ``jitter``
    (relative). Returns (specs, batched ScheduleTable on ``device``).
    Deterministic in ``seed``."""
    families = list(families or FAMILIES)
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        fam = families[int(rng.integers(0, len(families)))]
        scale = 1.0 + jitter * rng.uniform(-1.0, 1.0, size=3)
        specs.append(ScenarioSpec(
            family=fam, seed=int(rng.integers(0, 2 ** 31 - 1)),
            name=f"{fam}-dr{i}", horizon=horizon, bin_seconds=bin_seconds,
            base_tpt=tuple(float(t * s) for t, s in zip(base_tpt, scale)),
            base_bw=tuple(base_bw)))
    return specs, stack_tables([s.table(device=device) for s in specs])
