"""Rotary position embeddings (port of ``repro.nn.rotary``): the standard
(llama) rope, the partial rope (chatglm3 rotates the first half of the
head dim) and M-RoPE (qwen2-vl: the head dim is split into temporal,
height and width sections, each rotated by its own position id)."""

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


def apply_mrope(q, k, positions_thw, *, sections=(16, 24, 24),
                theta=1000000.0):
    """Qwen2-VL M-RoPE. ``positions_thw``: (3, B, S) temporal, height and
    width ids. ``sections`` are half-dim section sizes (t, h, w) summing to
    head_dim // 2; each frequency band takes its position id from the
    section it falls in."""
    d = q.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim // 2 = {d // 2}")
    inv_freq = rope_frequencies(d, theta=theta, device=q.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=q.device)  # (d/2,)
    pos = positions_thw[sec_id].permute(1, 2, 0)              # (B, S, d/2)
    ang = pos.to(torch.float32) * inv_freq
    cos = torch.cos(ang)[:, :, None, :].to(q.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(q.dtype)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def text_mrope_positions(batch, seq, offset=0, *, device=None):
    """For pure-text inputs all three M-RoPE sections share the token
    index: (3, batch, seq) int32."""
    p = torch.arange(offset, offset + seq, dtype=torch.int32, device=device)
    return p[None, None].expand(3, batch, seq)
