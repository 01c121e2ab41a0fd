"""ctypes binding of ``csrc/flash_attention.cu``: one launch of flash
attention on PyTorch's current stream, and the head dims it takes
(``check_head_dim``).

The caller (``ops.py``) has checked devices, dtypes, shapes, contiguity
and alignment; this module allocates the output, passes raw device
pointers and raises if the launch was refused."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIM_MAX = 256         # the widest instance's panels
# a head dim's step on each route: the bf16 route's tensor maps need rows
# of a multiple of 16 bytes; the float32 route loads 4 values at a time
HEAD_DIM_STEP = {torch.float32: 4, torch.bfloat16: 8}
# the dtype picks the kernel's route: 0 the scalar float32 kernel (the
# first design), 1 the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def check_head_dim(D, dtype):
    """Raise ValueError unless the kernel takes head dim ``D`` in ``dtype``:
    a multiple of ``HEAD_DIM_STEP[dtype]`` up to ``HEAD_DIM_MAX``. It runs
    the instance of 64 columns up to D = 64, of 128 up to 128 and of 256
    above, the columns past D read as zeros."""
    step = HEAD_DIM_STEP.get(dtype)
    if step is None or not (step <= D <= HEAD_DIM_MAX and D % step == 0):
        raise ValueError(f"the flash_attention kernel takes head dims that "
                         f"are multiples of {step} up to {HEAD_DIM_MAX} in "
                         f"{dtype}, got {D}")


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(q, k, v, *, causal, window, scale):
    """Contiguous CUDA tensors as ``ops.flash_attention`` documents them,
    D on the kernel's step; ``scale`` multiplies the dots (1/sqrt of the
    caller's head dim). Returns o (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    fn = _entry()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, Skv, Hq, Hkv, D, int(causal), window or 0,
                 _DTYPES[q.dtype], scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return o
