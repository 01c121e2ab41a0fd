"""Re-export of the schedule core (port of ``repro.scenarios.schedule``):
the ScheduleTable type and its lookups live in ``repro_torch.core.schedule``;
this module keeps the ``scenarios.schedule`` import path."""

from __future__ import annotations

from repro_torch.core.schedule import (ScheduleTable, make_table,
                                       constant_table, schedule_at,
                                       horizon_seconds, stack_tables,
                                       table_to_numpy, peak_bw,
                                       bottleneck_trace)

__all__ = ["ScheduleTable", "make_table", "constant_table", "schedule_at",
           "horizon_seconds", "stack_tables", "table_to_numpy", "peak_bw",
           "bottleneck_trace"]
