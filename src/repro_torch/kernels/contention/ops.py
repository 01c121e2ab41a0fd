"""Wrapper of the batched contention solve (K3).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor
launches the CUDA kernel (``csrc/contention.cu``) or raises. The wrapper
counts its launches in ``contention_rates.launches``, so a run can show
that its main path went through the kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.contention import kernel
from repro_torch.kernels.contention.ref import contention_rates_reference


def contention_rates(threads, act, onpath, tpt, bw, floor=None, cap=None, *,
                     rounds=0):
    """(E, S, F, 3) per-flow contention rates, the whole per-substep solve
    of every env and substep in one launch.

    threads (E, F, 3); act (E, S, F) activity mask per substep; onpath
    (E, S, F, L) routing matrix per substep; tpt/bw (E, S, L, 3) per-link
    schedule window. ``floor``/``cap``: optional (E, F) per-flow rate
    floor and cap (both None = the objective-free solve). ``rounds``: the
    water-fill spill rounds (0 = no redistribution, the fleet's model)."""
    E, S, F = act.shape
    L = onpath.shape[-1]
    if floor is None and cap is not None:
        floor = torch.zeros_like(cap)
    if cap is None and floor is not None:
        cap = torch.full_like(floor, float("inf"))
    given = [t for t in (threads, act, onpath, tpt, bw, floor, cap)
             if t is not None]
    shapes = [(E, F, 3), (E, S, F), (E, S, F, L), (E, S, L, 3),
              (E, S, L, 3)] + ([(E, F), (E, F)] if floor is not None else [])
    for t, shape in zip(given, shapes):
        if t.dtype != torch.float32:
            raise TypeError(f"contention takes float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"contention shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if int(rounds) != rounds or rounds < 0:
        raise ValueError(f"rounds must be a count >= 0, got {rounds!r}")
    devices = {t.device for t in given}
    if len(devices) != 1:
        raise ValueError(f"contention inputs on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return contention_rates_reference(threads, act, onpath, tpt, bw,
                                          floor, cap, rounds=rounds)
    if device.type != "cuda":
        raise ValueError(f"contention runs on CUDA or the CPU, not {device}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("contention takes contiguous tensors")
    if L > kernel.max_links():
        raise ValueError(f"the contention kernel takes at most "
                         f"{kernel.max_links()} links, got {L}")
    out = kernel.launch(threads, act, onpath, tpt, bw, floor, cap,
                        rounds=int(rounds))
    contention_rates.launches += 1
    return out


contention_rates.launches = 0
