"""ctypes binding of ``csrc/sim_step.cu``: one launch of the batched
simulator-interval kernel on PyTorch's current stream.

The caller (``ops.py``) has checked devices, dtypes, shapes and contiguity;
this module allocates the outputs, passes raw device pointers and raises if
the launch was refused."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("sim_step").sim_interval_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(bufs, rates, cap, *, rate_env_stride, rate_sub_stride, rate_scale,
           substeps):
    """bufs (E, 2), cap (E, 2) and ``rates`` contiguous f32 CUDA tensors;
    rates are read at ``e * rate_env_stride + i * rate_sub_stride`` (floats)
    and scaled by ``rate_scale``. Returns (bufs' (E, 2), moved (E, 3))."""
    E = bufs.shape[0]
    out_bufs = torch.empty((E, 2), dtype=torch.float32, device=bufs.device)
    moved = torch.empty((E, 3), dtype=torch.float32, device=bufs.device)
    with torch.cuda.device(bufs.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(bufs.device).cuda_stream
        err = _entry()(bufs.data_ptr(), rates.data_ptr(), rate_env_stride,
                       rate_sub_stride, rate_scale, cap.data_ptr(),
                       out_bufs.data_ptr(), moved.data_ptr(), E, substeps,
                       stream)
    if err != 0:
        raise RuntimeError(f"sim_step kernel launch failed: cudaError {err}")
    return out_bufs, moved
