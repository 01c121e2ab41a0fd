"""Wrappers of the batched simulator-interval kernel (K1 and K2).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor
launches the CUDA kernel (``csrc/sim_step.cu``) or raises. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``,
so a run can show that its main path went through the kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.sim_step import kernel
from repro_torch.kernels.sim_step.ref import (sim_interval_reference,
                                              sim_step_reference)


def _on_cuda(tensors, shapes):
    """True for CUDA inputs, False for CPU ones; raises on a device mix or
    on inputs the kernel does not take."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"sim_step inputs on several devices: {devices}")
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32:
            raise TypeError(f"sim_step takes float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sim_step shape {tuple(t.shape)}, "
                             f"expected {shape}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"sim_step runs on CUDA or the CPU, not {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sim_step takes contiguous tensors")
    return True


def sim_interval_batch(bufs, rates_dt, cap):
    """bufs (E, 2); rates_dt (E, S, 3) per-substep aggregate rates already
    multiplied by dt; cap (E, 2). Returns (bufs' (E, 2), moved (E, 3)).
    One launch for the whole env batch."""
    E, S = rates_dt.shape[0], rates_dt.shape[1]
    if not _on_cuda((bufs, rates_dt, cap), ((E, 2), (E, S, 3), (E, 2))):
        return sim_interval_reference(bufs, rates_dt, cap)
    out = kernel.launch_interval(bufs, rates_dt, cap)
    sim_interval_batch.launches += 1
    return out


sim_interval_batch.launches = 0


def sim_step_batch(bufs, rate, cap, *, substeps=50, duration=1.0):
    """bufs (E, 2); rate (E, 3) aggregate per-stage rates held for the
    whole interval; cap (E, 2). Returns (bufs' (E, 2), moved (E, 3)).
    The recurrence of ``sim_interval_batch``, with one rate per env."""
    E = bufs.shape[0]
    if not _on_cuda((bufs, rate, cap), ((E, 2), (E, 3), (E, 2))):
        return sim_step_reference(bufs, rate, cap, substeps=substeps,
                                  duration=duration)
    out = kernel.launch_step(bufs, rate, cap, rate_scale=duration / substeps,
                             substeps=substeps)
    sim_step_batch.launches += 1
    return out


sim_step_batch.launches = 0
