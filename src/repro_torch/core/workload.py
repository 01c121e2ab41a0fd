"""Workload: the one bundle a training round consumes (port of
``repro.core.workload``, the ``tables`` axis).

``train_ppo(workload=..., resample=fn(round) -> Workload)`` takes one per
round. ``tables`` is a batched ScheduleTable (leading env axis) or None for
the static env params table. The flow, objective, topology and fault axes
belong to the multi-flow slices of the port and are refused here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass
class Workload:
    tables: Any = None      # batched ScheduleTable (leading env axis)
    flows: Any = None
    objectives: Any = None
    topology: Any = None
    faults: Any = None
    specs: Any = field(default=None, repr=False)  # the scenario draws

    def __post_init__(self):
        for axis in ("flows", "objectives", "topology", "faults"):
            if getattr(self, axis) is not None:
                raise NotImplementedError(
                    f"Workload.{axis} lands with the fleet/topology/fault "
                    "slice of the port")

    def replace(self, **changes) -> "Workload":
        return replace(self, **changes)
