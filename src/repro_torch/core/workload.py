"""Workload: the one bundle a training round consumes (port of
``repro.core.workload``: the ``tables``, ``flows``, ``objectives`` and
``topology`` axes).

``train_ppo(workload=..., resample=fn(round) -> Workload)`` takes one per
round, and ``repro_torch.scenarios.sample_fleet_batch`` and
``sample_topology_batch`` return one. ``tables`` is a batched
ScheduleTable (leading env axis) or None for the static env params table;
``flows`` a batched FlowSchedule or None (every flow active all episode);
``objectives`` a batched FlowObjective or None (the objective-free fleet);
``topology`` a batched ``core.topology.Topology`` (link graphs and routes)
or None for the single-bottleneck world. The fault axis belongs to a later
slice of the port and is refused here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass
class Workload:
    tables: Any = None      # batched ScheduleTable (leading env axis)
    flows: Any = None       # batched FlowSchedule
    objectives: Any = None  # batched FlowObjective
    topology: Any = None    # batched Topology (graph + paths)
    faults: Any = None
    specs: Any = field(default=None, repr=False)  # the scenario draws

    def __post_init__(self):
        if self.faults is not None:
            raise NotImplementedError(
                "Workload.faults lands with the fault slice of the port")

    def replace(self, **changes) -> "Workload":
        return replace(self, **changes)
