"""Workload: the one bundle a training round consumes (port of
``repro.core.workload``).

``train_ppo(workload=..., resample=fn(round) -> Workload)`` takes one per
round, and ``repro_torch.scenarios.sample_fleet_batch`` and
``sample_topology_batch`` return one. ``tables`` is a batched
ScheduleTable (leading env axis) or None for the static env params table;
``flows`` a batched FlowSchedule or None (every flow active all episode);
``objectives`` a batched FlowObjective or None (the objective-free fleet);
``topology`` a batched ``core.topology.Topology`` (link graphs and routes)
or None for the single-bottleneck world; ``faults`` a list of
``repro_torch.scenarios.FaultSpec`` (one per env, None entries allowed) or
None for the fault-free world.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass
class Workload:
    """Everything one training round runs on. ``faults`` stay UNCOMPILED:
    ``compiled()`` applies them and returns a new Workload whose tables,
    flows and topology carry the edits, so the pristine draw stays
    inspectable."""

    tables: Any = None      # batched ScheduleTable (leading env axis)
    flows: Any = None       # batched FlowSchedule
    objectives: Any = None  # batched FlowObjective
    topology: Any = None    # batched Topology (graph + paths)
    faults: Any = None      # list[FaultSpec | None], one per env
    specs: Any = field(default=None, repr=False)  # the scenario draws

    # Deprecated tuple compatibility (the reference keeps it for one
    # cycle): the samplers used to return positional tuples, fleet
    # (specs, tables, flows, objectives) and topology (specs, topology,
    # flows, objectives), so a Workload unpacks and indexes in that order,
    # the topology in the tables' place when present. Faults stay out.
    def __iter__(self):
        yield self.specs
        yield self.topology if self.topology is not None else self.tables
        yield self.flows
        yield self.objectives

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return tuple(self)[i]

    def replace(self, **changes) -> "Workload":
        return replace(self, **changes)

    @property
    def has_faults(self) -> bool:
        return bool(self.faults) and any(f is not None for f in self.faults)

    def compiled(self) -> "Workload":
        """Apply the fault schedules to the sim tensors: kills truncate or
        carve down windows out of ``flows``, stage hangs zero ScheduleTable
        bins, link blackouts zero LinkGraph bins. No faults -> self,
        untouched."""
        if not self.has_faults:
            return self
        from repro_torch.scenarios.faults import compile_fault_batch
        tables, flows, topology = compile_fault_batch(
            self.faults, tables=self.tables, flows=self.flows,
            topology=self.topology)
        return self.replace(tables=tables, flows=flows, topology=topology,
                            faults=None)
