"""Piecewise-constant condition schedules — the core data structure of the
schedule-native environment (port of ``repro.core.schedule``).

A schedule is a pair of tables ``tpt[T, 3]`` / ``bw[T, 3]`` giving the
per-thread throughput and aggregate bandwidth cap of each pipeline stage
(read, network, write) over ``T`` fixed-width time bins. A lookup is one
gather, so a batch of tables (leading env axis: ``tpt``/``bw`` (E, T, 3),
``bin_seconds`` (E,)) steps every env of a batch in the same tensor ops.
A static configuration is the 1-bin table ``constant_table``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import as_f32


class ScheduleTable(NamedTuple):
    """Time-binned stage conditions, one table or a batch of them."""

    tpt: torch.Tensor          # (T, 3) or (E, T, 3) per-thread throughput
    bw: torch.Tensor           # (T, 3) or (E, T, 3) aggregate stage bandwidth
    bin_seconds: torch.Tensor  # () or (E,) width of one bin


def make_table(tpt, bw, bin_seconds=1.0, *, device=None) -> ScheduleTable:
    tpt = as_f32(tpt, device)
    bw = as_f32(bw, tpt.device)
    if tpt.shape != bw.shape or tpt.ndim != 2 or tpt.shape[-1] != 3:
        raise ValueError(f"schedule tables must be (T, 3): "
                         f"{tuple(tpt.shape)} vs {tuple(bw.shape)}")
    return ScheduleTable(tpt=tpt, bw=bw,
                         bin_seconds=as_f32(bin_seconds, tpt.device))


def constant_table(tpt, bw, bin_seconds=1.0, *, device=None) -> ScheduleTable:
    """A static configuration as a 1-bin schedule (every lookup clips to
    bin 0)."""
    tpt = as_f32(tpt, device)
    return ScheduleTable(tpt=tpt[None, :], bw=as_f32(bw, tpt.device)[None, :],
                         bin_seconds=as_f32(bin_seconds, tpt.device))


def _bin_index(table: ScheduleTable, t):
    T = table.tpt.shape[-2]
    idx = torch.clamp(torch.floor(t / table.bin_seconds), 0, T - 1)
    return idx.to(torch.int64)


def schedule_at(table: ScheduleTable, t):
    """Conditions at simulated time ``t``: (tpt (3,), bw (3,)) for one
    table and a scalar ``t``, (E, 3) each for a batch and ``t`` (E,). Times
    past the horizon hold the last bin, negative times the first."""
    t = as_f32(t, table.tpt.device)
    idx = _bin_index(table, t)
    if table.tpt.ndim == 2:
        return table.tpt[idx], table.bw[idx]
    rows = torch.arange(table.tpt.shape[0], device=idx.device)
    return table.tpt[rows, idx], table.bw[rows, idx]


def horizon_seconds(table: ScheduleTable) -> float:
    return float(table.tpt.shape[-2] * table.bin_seconds)


def stack_tables(tables) -> ScheduleTable:
    """Stack same-length tables into one batched ScheduleTable (leading env
    axis). All tables must share T."""
    tables = list(tables)
    lengths = {t.tpt.shape[0] for t in tables}
    if len(lengths) != 1:
        raise ValueError(f"cannot stack tables of different lengths {lengths}")
    return ScheduleTable(
        tpt=torch.stack([t.tpt for t in tables]),
        bw=torch.stack([t.bw for t in tables]),
        bin_seconds=torch.stack([t.bin_seconds for t in tables]),
    )


def table_to_numpy(table: ScheduleTable):
    """Host-side copy for engine-facing scenario replay and plotting."""
    return (table.tpt.cpu().numpy(), table.bw.cpu().numpy(),
            float(np.asarray(table.bin_seconds.cpu())))


def peak_bw(table: ScheduleTable):
    """Max aggregate bandwidth anywhere in the schedule — the observation
    normalization reference: a scalar for one table, (E,) for a batch."""
    return torch.clamp_min(table.bw.amax(dim=(-2, -1)), 1e-9)


def bottleneck_trace(table: ScheduleTable, n_max: float):
    """(..., T) best achievable end-to-end rate per bin: the slowest stage's
    aggregate cap, itself capped by what n_max threads can carry."""
    return torch.minimum(n_max * table.tpt, table.bw).amin(dim=-1)
