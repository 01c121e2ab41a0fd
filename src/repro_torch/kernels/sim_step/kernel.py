"""ctypes binding of ``csrc/sim_step.cu``: one launch of the batched
simulator-interval kernel on PyTorch's current stream, in either of its two
forms.

The caller (``ops.py``) has checked devices, dtypes, shapes and contiguity;
this module allocates the outputs, passes raw device pointers and raises if
the launch was refused."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("sim_step")
        lib.sim_interval_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.sim_step_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.sim_interval_launch.restype = ctypes.c_int
        lib.sim_step_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(entry, bufs, rates, cap, scale, substeps):
    E = bufs.shape[0]
    out_bufs = torch.empty((E, 2), dtype=torch.float32, device=bufs.device)
    moved = torch.empty((E, 3), dtype=torch.float32, device=bufs.device)
    with torch.cuda.device(bufs.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(bufs.device).cuda_stream
        err = entry(bufs.data_ptr(), rates.data_ptr(), *scale,
                    cap.data_ptr(), out_bufs.data_ptr(), moved.data_ptr(), E,
                    substeps, stream)
    if err != 0:
        raise RuntimeError(f"sim_step kernel launch failed: cudaError {err}")
    return out_bufs, moved


def launch_interval(bufs, rates_dt, cap):
    """The per-substep form: bufs (E, 2), rates_dt (E, S, 3) already
    multiplied by dt, cap (E, 2), contiguous f32 CUDA tensors. Returns
    (bufs' (E, 2), moved (E, 3))."""
    return _launch(_library().sim_interval_launch, bufs, rates_dt, cap, (),
                   rates_dt.shape[1])


def launch_step(bufs, rate, cap, *, rate_scale, substeps):
    """The constant form: rate (E, 3), multiplied by ``rate_scale`` (dt) in
    the kernel and held for ``substeps`` substeps; otherwise as
    ``launch_interval``."""
    return _launch(_library().sim_step_launch, bufs, rate, cap,
                   (rate_scale,), substeps)
