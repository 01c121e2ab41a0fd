"""Wrapper of the SSD chunked scan (K5).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor
launches the CUDA kernel (``csrc/ssd_scan.cu``) or raises. The wrapper
counts its launches in ``ssd_scan.launches``, so a run can show that its
main path went through the kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_reference


def _check(x, dt, A, B, C, chunk):
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4:
        raise ValueError("ssd_scan takes x (b,s,h,p), dt (b,s,h), A (h,), "
                         "B and C (b,s,g,n)")
    b, s, h, p = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, s) or C.shape != B.shape):
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if s < 1 or h % B.shape[2]:
        raise ValueError(f"ssd_scan needs s >= 1 and groups dividing heads, "
                         f"got s={s}, {B.shape[2]} groups, {h} heads")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            x.dtype == B.dtype == C.dtype):
        raise TypeError(f"ssd_scan takes x, B and C float32 or bf16 alike, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt and A in float32, got "
                        f"{dt.dtype}, {A.dtype}")
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"chunk must be a length >= 1, got {chunk!r}")
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan inputs on several devices: {devices}")
    return devices.pop()


def _check_kernel(x, dt, A, B, C, chunk):
    """What the CUDA kernel takes beyond the wrapper's own checks (x, B
    and C padded by ``pad_widths``)."""
    kernel.check_widths(x.shape[3], B.shape[3], chunk)
    vec = kernel.VEC
    for name, t in (("x", x), ("B", B), ("C", C)):
        st = t.stride()
        if st[3] != 1 or st[2] != t.shape[3] or st[0] % vec or st[1] % vec:
            raise ValueError(f"ssd_scan takes {name} with unit stride in "
                             f"its last two axes and batch and sequence "
                             f"strides that are multiples of {vec}, got "
                             f"strides {st}")
        if t.data_ptr() % (vec * t.element_size()):
            raise ValueError(f"ssd_scan takes {name} on a "
                             f"{vec * t.element_size()}-byte boundary")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan takes dt and A contiguous")


def pad_widths(x, B, C):
    """x with zero columns up to the next multiple of the kernel's width
    step in p, and B and C in n (the same tensors where a width is on
    it). The zeros leave C B^T, y's live columns and the state's live part
    exact; the caller slices y and the state."""
    step = kernel.WIDTH_STEP
    pad_p, pad_n = -x.shape[3] % step, -B.shape[3] % step
    if pad_p:
        x = F.pad(x, (0, pad_p))
    if pad_n:
        B, C = F.pad(B, (0, pad_n)), F.pad(C, (0, pad_n))
    return x, B, C


def ssd_scan(x, dt, A, B, C, *, chunk=128, return_state=False):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n) -> (y:(b,s,h,p) in x's
    dtype, final state (b,h,p,n) float32 when ``return_state``, else
    None). Any s: a ragged last chunk is exact (as ``ssd_chunked``'s dt = 0
    padding). x, B and C float32 or bf16; dt and A float32. On CUDA p and
    n are at most ``kernel.HEAD_DIM_MAX`` and ``kernel.STATE_MAX``; widths
    off the kernel's step run with zero columns (``pad_widths``)."""
    device = _check(x, dt, A, B, C, chunk)
    if device.type == "cpu":
        y, state = ssd_reference(x, dt, A, B, C, chunk=chunk)
        return y, state if return_state else None
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {device}")
    p, n = x.shape[3], B.shape[3]
    for name, width, top in (("head dim", p, kernel.HEAD_DIM_MAX),
                             ("state dim", n, kernel.STATE_MAX)):
        if width > top:
            raise ValueError(f"the ssd_scan kernel takes a {name} up to "
                             f"{top}, got {width}")
    xp, Bp, Cp = pad_widths(x, B, C)
    _check_kernel(xp, dt, A, Bp, Cp, chunk)
    y, state = kernel.launch(xp, dt, A, Bp, Cp, chunk=int(chunk),
                             return_state=return_state)
    ssd_scan.launches += 1
    if xp is not x:
        y = y[..., :p].contiguous()
    if state is not None and (xp is not x or Bp is not B):
        state = state[:, :, :p, :n].contiguous()
    return y, state


ssd_scan.launches = 0
