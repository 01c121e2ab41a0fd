"""Plain PyTorch versions of the sim_step kernels: the CPU path of the
wrappers in ``ops.py`` and the yardstick the CUDA kernel is held against.

``sim_interval_reference`` is ``repro.core.simulator._scan_substeps`` with
the env batch written out: a Python loop over the S substeps doing the same
f32 arithmetic in the same order, the moved bytes summed substep by substep
as the kernel sums them."""

from __future__ import annotations

import torch


def sim_interval_reference(bufs, rates_dt, cap):
    """bufs (E, 2); rates_dt (E, S, 3) per-substep aggregate rates already
    multiplied by dt; cap (E, 2). Returns (bufs' (E, 2), moved (E, 3))."""
    s, r = bufs[:, 0], bufs[:, 1]
    cap_s, cap_r = cap[:, 0], cap[:, 1]
    mr = torch.zeros_like(s)
    mn = torch.zeros_like(s)
    mw = torch.zeros_like(s)
    for i in range(rates_dt.shape[1]):
        rate = rates_dt[:, i]
        read = torch.clamp_min(torch.minimum(rate[:, 0], cap_s - s), 0.0)
        s_mid = s + read
        net = torch.clamp_min(
            torch.minimum(torch.minimum(rate[:, 1], s_mid), cap_r - r), 0.0)
        r_mid = r + net
        wr = torch.clamp_min(torch.minimum(rate[:, 2], r_mid), 0.0)
        s = s_mid - net
        r = r_mid - wr
        mr = mr + read
        mn = mn + net
        mw = mw + wr
    return torch.stack([s, r], dim=-1), torch.stack([mr, mn, mw], dim=-1)


def sim_step_reference(bufs, rate, cap, *, substeps=50, duration=1.0):
    """The constant-rate form: rate (E, 3) held for ``substeps`` substeps of
    ``duration / substeps`` each. Returns (bufs' (E, 2), moved (E, 3))."""
    dt = duration / substeps
    rates_dt = (rate * dt)[:, None, :].expand(-1, substeps, -1)
    return sim_interval_reference(bufs, rates_dt, cap)
