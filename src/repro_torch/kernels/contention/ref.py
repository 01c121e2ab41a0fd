"""Plain PyTorch version of the contention solve: the CPU path of
``ops.contention_rates`` and the yardstick the CUDA kernel is held against.

``contention_rates_reference`` is ``repro.kernels.contention.ref.
contention_rates_reference`` with a leading env axis E on every operand:
the same float32 operations in the same order, reductions over the flow
axis."""

from __future__ import annotations

import torch


def contention_rates_reference(threads, act, onpath, tpt, bw, floor=None,
                               cap=None, *, rounds=0):
    """threads (E, F, 3); act (E, S, F); onpath (E, S, F, L); tpt/bw
    (E, S, L, 3); floor/cap optional (E, F). Returns (E, S, F, 3)."""
    eff = (threads[:, None, :, None, :] * act[..., None, None]
           * onpath[..., None])                          # (E, S, F, L, 3)
    total = torch.clamp_min(eff.sum(dim=2), 1e-9)        # (E, S, L, 3)
    share = eff / total[:, :, None]
    if floor is None and cap is None:
        link_rate = torch.minimum(eff * tpt[:, :, None],
                                  share * bw[:, :, None])
    else:
        if floor is None:
            floor = torch.zeros_like(cap)
        if cap is None:
            cap = torch.full_like(floor, float("inf"))
        cap_b = cap[:, None, :, None, None]
        demand = torch.minimum(eff * tpt[:, :, None], cap_b)
        guaranteed = torch.minimum(floor[:, None, :, None, None], demand)
        g_tot = guaranteed.sum(dim=2)                    # (E, S, L, 3)
        guaranteed = guaranteed * torch.clamp_max(
            bw / torch.clamp_min(g_tot, 1e-9), 1.0)[:, :, None]
        residual = torch.clamp_min(bw - guaranteed.sum(dim=2), 0.0)
        alloc = share * residual[:, :, None]
        headroom = cap_b - guaranteed
        for _ in range(rounds):
            spill = torch.clamp_min(alloc - headroom, 0.0).sum(dim=2)
            alloc = torch.minimum(alloc, headroom)
            w = eff * (alloc < headroom)
            w_tot = torch.clamp_min(w.sum(dim=2), 1e-9)
            alloc = alloc + (w / w_tot[:, :, None]) * spill[:, :, None]
        if rounds:
            alloc = torch.minimum(alloc, headroom)
        link_rate = torch.minimum(demand, guaranteed + alloc)
    constraining = torch.where(onpath[..., None] > 0, link_rate,
                               torch.full_like(link_rate, float("inf")))
    rate = constraining.amin(dim=3)                      # (E, S, F, 3)
    has_path = onpath.sum(dim=3) > 0
    return (torch.where(has_path[..., None], rate, torch.zeros_like(rate))
            * act[..., None])
