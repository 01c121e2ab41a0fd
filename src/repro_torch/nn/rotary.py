"""Rotary position embeddings (port of ``repro.nn.rotary``): the standard
(llama) rope and the partial rope (chatglm3 rotates the first half of the
head dim). M-RoPE (qwen2-vl) is still to port (ROADMAP.md)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim, *, theta=10000.0, dtype=torch.float32,
                     device=None):
    """inv_freq over the (even) rotary dim."""
    exps = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    # x: (..., d) with d even; rotate pairs (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _cos_sin(positions, inv_freq, dtype):
    # positions: (B, S) -> cos/sin: (B, S, 1, d/2), cast to the rotated
    # tensor's dtype BEFORE the rotation, as the reference does
    ang = positions[..., None].to(torch.float32) * inv_freq  # (B, S, d/2)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def apply_rope(q, k, positions, *, theta=10000.0):
    """Standard RoPE. q: (B,S,Hq,D), k: (B,S,Hk,D), positions: (B,S)."""
    inv_freq = rope_frequencies(q.shape[-1], theta=theta, device=q.device)
    cos, sin = _cos_sin(positions, inv_freq, q.dtype)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def apply_partial_rope(q, k, positions, *, fraction=0.5, theta=10000.0):
    """ChatGLM3-style: rope on the first ``int(D * fraction)`` dims of each
    head, with the frequencies taken over those dims; the rest pass
    through."""
    rot = int(q.shape[-1] * fraction)
    inv_freq = rope_frequencies(rot, theta=theta, device=q.device)
    cos, sin = _cos_sin(positions, inv_freq, q.dtype)
    return (torch.cat([_rotate(q[..., :rot], cos, sin), q[..., rot:]], -1),
            torch.cat([_rotate(k[..., :rot], cos, sin), k[..., rot:]], -1))
