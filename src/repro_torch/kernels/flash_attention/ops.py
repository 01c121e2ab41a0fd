"""Wrapper of flash attention (K4).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor
launches the CUDA kernel (``csrc/flash_attention.cu``) or raises. The
wrapper counts its launches in ``flash_attention.launches``, so a run can
show that its main path went through the kernel."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_reference


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B,S,Hq,D); k/v: (B,Skv,Hkv,D) -> (B,S,Hq,D) in q's dtype.

    Causal attention over positions counted from 0 (the prefill path; the
    decode path reads the cache instead), limited to the last ``window``
    keys when given; with ``causal=False`` every query attends to all Skv
    keys (no window). GQA when Hkv divides Hq. float32 or bf16. On CUDA
    the head dim is at most ``kernel.HEAD_DIM_MAX``; one off the kernel's
    step runs with zero columns (``pad_head_dim``)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide {Hq} q heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bf16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a count >= 1, got {window!r}")
    if window is not None and not causal:
        # the reference's kernel keeps every later key there and its oracle
        # drops the window (ROADMAP.md, R9): no one function to port
        raise ValueError("flash_attention takes a window only with the "
                         "causal mask (causal=False with a window: R9)")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs on several devices: "
                         f"{devices}")
    device = devices.pop()
    if device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention takes contiguous tensors on "
                             "16-byte boundaries")
    if D > kernel.HEAD_DIM_MAX:
        raise ValueError(f"the flash_attention kernel takes head dims up to "
                         f"{kernel.HEAD_DIM_MAX}, got {D}")
    qp, kp, vp = pad_head_dim(q, k, v)
    kernel.check_head_dim(qp.shape[3], q.dtype)
    out = kernel.launch(qp, kp, vp, causal=bool(causal),
                        window=None if window is None else int(window),
                        scale=1.0 / math.sqrt(D))
    flash_attention.launches += 1
    return out if out.shape[3] == D else out[..., :D].contiguous()


def pad_head_dim(q, k, v):
    """q, k and v with zero columns up to the next multiple of the
    kernel's head-dim step in their dtype (the same tensors where D is on
    it). The zeros leave Q K^T exact and give zero output columns; the
    caller keeps the scale of the true D and slices the output."""
    step = kernel.HEAD_DIM_STEP[q.dtype]
    pad = -q.shape[3] % step
    if not pad:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


flash_attention.launches = 0
