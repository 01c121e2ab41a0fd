"""Plain PyTorch version of the flash-attention kernel (K4): the CPU path
of the wrapper in ``ops.py`` and the yardstick the CUDA kernel is held
against.

It computes what the reference's Pallas kernel ``_fa_kernel`` computes,
materialized: float32 scores scaled by 1/sqrt(D) after the dot, causal and
sliding-window masks with the value -1e30 (no mask at all with
``causal=False``, as the reference's oracle), float32 probabilities for the
product with V (the reference's ``sdpa_full`` casts them to q's dtype
first; the kernel does not), a divide by max(l, 1e-30), and only the
output cast to q's dtype. GQA maps kv_head = q_head // group."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,S,Hq,D); k/v: (B,Skv,Hkv,D) -> (B,S,Hq,D), causal over
    positions counted from 0, and within ``window`` keys when given; with
    ``causal=False`` over all Skv keys (the wrapper refuses a window
    there). ``scale`` multiplies the dots (default 1/sqrt(D))."""
    S, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=2)
    vf = torch.repeat_interleave(v.to(torch.float32), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf)
    s = s * (1.0 / math.sqrt(D) if scale is None else scale)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = (qp >= kp) | (not causal)
    if window is not None:
        ok = ok & (qp - kp < window)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    # rows with no live key: nothing, as in the kernel's init state
    p = torch.where(m <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)                                   # (B, Hq, S)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)
