"""Workload: the one bundle a training round consumes (port of
``repro.core.workload``: the ``tables``, ``flows`` and ``objectives``
axes).

``train_ppo(workload=..., resample=fn(round) -> Workload)`` takes one per
round, and ``repro_torch.scenarios.sample_fleet_batch`` returns one.
``tables`` is a batched ScheduleTable (leading env axis) or None for the
static env params table; ``flows`` a batched FlowSchedule or None (every
flow active all episode); ``objectives`` a batched FlowObjective or None
(the objective-free fleet). The topology and fault axes belong to later
slices of the port and are refused here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass
class Workload:
    tables: Any = None      # batched ScheduleTable (leading env axis)
    flows: Any = None       # batched FlowSchedule
    objectives: Any = None  # batched FlowObjective
    topology: Any = None
    faults: Any = None
    specs: Any = field(default=None, repr=False)  # the scenario draws

    def __post_init__(self):
        for axis in ("topology", "faults"):
            if getattr(self, axis) is not None:
                raise NotImplementedError(
                    f"Workload.{axis} lands with the topology/fault slice "
                    "of the port")

    def replace(self, **changes) -> "Workload":
        return replace(self, **changes)
