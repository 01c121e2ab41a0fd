"""ctypes binding of ``csrc/flash_attention.cu``: one launch of causal
flash attention on PyTorch's current stream.

The caller (``ops.py``) has checked devices, dtypes, shapes, contiguity
and alignment; this module allocates the output, passes raw device
pointers and raises if the launch was refused."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)      # the head dims the kernel is instantiated for
# the dtype picks the kernel's route: 0 the scalar float32 kernel (the
# first design), 1 the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(q, k, v, *, window):
    """Contiguous CUDA tensors as ``ops.flash_attention`` documents them.
    Returns o (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    fn = _entry()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, Skv, Hq, Hkv, D, window or 0, _DTYPES[q.dtype],
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return o
