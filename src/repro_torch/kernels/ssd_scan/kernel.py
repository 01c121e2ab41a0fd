"""ctypes binding of ``csrc/ssd_scan.cu``: one launch of the SSD chunked
scan on PyTorch's current stream, and the widths it takes
(``check_widths``).

The caller (``ops.py``) has checked devices, dtypes, shapes, strides and
alignment; this module allocates y and, when asked, the final state,
passes raw device pointers and strides, and raises if the launch was
refused."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK_MAX = 256      # a chunk's rows in the kernel's two row tiles
CHUNK_STEP = 16      # a chunk is whole 16-row tiles of the tensor cores
HEAD_DIM_MAX = 128   # two blocks of the x tile's 64 columns a head
STATE_MAX = 256      # the largest state dim that fits the shared memory
WIDTH_STEP = 8       # p and n: rows of a multiple of 16 bytes in bf16
VEC = 4              # elements of one vector load of x, B or C
# the dtype picks the kernel's route: 0 the scalar float32 kernel (the
# first design), 1 the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def check_widths(p, n, chunk):
    """Raise ValueError unless the kernel takes head dim ``p``, state dim
    ``n`` and ``chunk``: p and n multiples of ``WIDTH_STEP`` up to
    ``HEAD_DIM_MAX`` and ``STATE_MAX``, the chunk a multiple of
    ``CHUNK_STEP`` up to ``CHUNK_MAX``. The tiles' columns past p or n and
    rows past the chunk read as zeros; a chunk above 128 is computed as one
    chunk in two row tiles."""
    if not (CHUNK_STEP <= chunk <= CHUNK_MAX and chunk % CHUNK_STEP == 0):
        raise ValueError(f"the ssd_scan kernel takes chunks that are "
                         f"multiples of {CHUNK_STEP} up to {CHUNK_MAX}, got "
                         f"{chunk}")
    for name, width, top in (("head dim", p, HEAD_DIM_MAX),
                             ("state dim", n, STATE_MAX)):
        if not (WIDTH_STEP <= width <= top and width % WIDTH_STEP == 0):
            raise ValueError(f"the ssd_scan kernel takes a {name} that is "
                             f"a multiple of {WIDTH_STEP} up to {top}, got "
                             f"{width}")


def _entry():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x, dt, A, B, C, *, chunk, return_state):
    """Tensors as ``ops.ssd_scan`` documents them, on one card: x, B and C
    with unit stride in their last two axes, dt and A contiguous float32.
    Returns (y (b, s, h, p) in x's dtype, state (b, h, p, n) float32 or
    None)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    fn = _entry()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    with torch.cuda.device(x.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(),
                 state.data_ptr() if return_state else None,
                 b, s, h, g, n, p, chunk, x.stride(0), x.stride(1),
                 B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y, state
