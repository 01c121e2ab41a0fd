"""ctypes binding of ``csrc/contention.cu``: one launch of the batched
contention solve on PyTorch's current stream.

The caller (``ops.py``) has checked devices, dtypes, shapes and contiguity;
this module allocates the output, passes raw device pointers and raises if
the launch was refused. The kernel takes no workspace."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_fns = None


def _entries():
    global _fns
    if _fns is None:
        lib = build.load("contention")
        fn = lib.contention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.contention_max_links.argtypes = []
        lib.contention_max_links.restype = ctypes.c_int
        _fns = (fn, lib.contention_max_links())
    return _fns


def max_links() -> int:
    """The most links per flow the kernel takes."""
    return _entries()[1]


def launch(threads, act, onpath, tpt, bw, floor, cap, *, rounds):
    """Contiguous f32 CUDA tensors as ``ops.contention_rates`` documents
    them; floor and cap both None or both (E, F). Returns (E, S, F, 3)."""
    E, S, F = act.shape
    L = onpath.shape[-1]
    fn = _entries()[0]
    out = torch.empty((E, S, F, 3), dtype=torch.float32, device=act.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(act.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(act.device).cuda_stream
        err = fn(threads.data_ptr(), act.data_ptr(), onpath.data_ptr(),
                 tpt.data_ptr(), bw.data_ptr(), ptr(floor), ptr(cap),
                 out.data_ptr(), E, S, F, L, rounds, stream)
    if err != 0:
        raise RuntimeError(f"contention kernel launch failed: cudaError "
                           f"{err}")
    return out
