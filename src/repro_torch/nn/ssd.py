"""Mamba2 block built on SSD (port of ``repro.nn.ssd``; state-space duality,
arXiv:2405.21060).

``ssd_chunked`` is the plain PyTorch version of the SSD chunked scan: the
CPU path of the K5 wrapper (``repro_torch.kernels.ssd_scan``) and the
yardstick its CUDA kernel is held against. Every public function keeps the
reference's layout: x (b, s, h, p), dt (b, s, h), A (h,), B and C
(b, s, g, n), the state (b, h, p, n); B/C group ``g`` serves the heads
``g * h/G .. (g + 1) * h/G - 1``.

The block's parameters are an ``nn.Module`` (``Mamba2``) with the
reference's names (``in_proj.w``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm.scale``, ``out_proj.w``): ``A_log``, ``D`` and
``dt_bias`` are float32, the rest in the model's parameter dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import Linear, RMSNorm, rmsnorm, truncated_normal


def segsum(x):
    """Stable 'segment sum': out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    i >= j, -inf otherwise. x: (..., L) -> (..., L, L)."""
    L = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    diff = xc[..., :, None] - xc[..., None, :]  # (..., L, L): sum (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, *, chunk=128, bf16=False):
    """SSD forward. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,g,n). Returns
    (y:(b,s,h,p) in x's dtype, final_state:(b,h,p,n) float32). The math is
    float32; with ``bf16`` the intra-chunk tensors are rounded to bf16 where
    the reference's variant keeps them in bf16: the decay mask L, the
    scores C Bᵀ (from bf16 C and B, rounded once), their product with L,
    and x·dt. The products run on float32 copies of those bf16 values with
    float32 sums, as the reference's ``preferred_element_type`` asks; the
    states stay float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:  # dt=0 padding is exact: zero state update, unit decay
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s_pad = s + pad
    nc = s_pad // chunk
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n).to(f32), rep,
                                 dim=3)                      # (b,nc,l,h,n)
    Cc = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n).to(f32), rep,
                                 dim=3)

    dA = dtc * A.to(f32)  # (b,nc,l,h) negative
    dA_cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative

    # 1) intra-chunk (diagonal blocks): attention-like masked quadratic form
    cdt = torch.bfloat16 if bf16 else f32
    L = torch.exp(segsum(dA.movedim(-1, -2))).to(cdt)  # (b,nc,h,l,l)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc.to(cdt).to(f32),
                          Bc.to(cdt).to(f32)).to(cdt)
    gated = (scores * L).to(f32)  # lower-triangular
    xdt = (xc * dtc[..., None]).to(cdt).to(f32)  # (b,nc,l,h,p)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", gated, xdt)

    # 2) per-chunk end states
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc, decay_states * dtc,
                          xc)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (b,nc,h)
    hstate = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(hstate)  # state entering the chunk
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (b,nc,h,p,n)

    # 4) inter-chunk contribution to outputs
    state_decay = torch.exp(dA_cum)  # (b,nc,l,h)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, h_prev, state_decay)

    y = (y_diag + y_off).reshape(b, s_pad, h, p)[:, :s]
    return y.to(x.dtype), hstate


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrence. state:(b,h,p,n), x_t:(b,h,p), dt_t:(b,h),
    B_t/C_t:(b,g,n). Returns (y_t:(b,h,p) in x_t's dtype, new_state)."""
    h, g = x_t.shape[1], B_t.shape[1]
    rep = h // g
    f32 = torch.float32
    Bh = torch.repeat_interleave(B_t, rep, dim=1).to(f32)  # (b,h,n)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).to(f32)
    dtf = dt_t.to(f32)
    dA = torch.exp(dtf * A.to(f32))  # (b,h)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtf, x_t.to(f32), Bh)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """The block's parameters, drawn with the reference's stddevs and
    constants: truncated normals (1/sqrt(d_in) for the projections,
    1/sqrt(d_conv) for the depthwise conv), a zero conv bias,
    A_log = log(linspace(1, 16, H)), D = 1, dt_bias = log(expm1(0.01))."""

    def __init__(self, d_model, *, d_inner=None, headdim=64, d_state=128,
                 n_groups=1, d_conv=4, generator=None, dtype=torch.bfloat16):
        super().__init__()
        d_inner = d_inner or 2 * d_model
        H = d_inner // headdim
        conv_ch = d_inner + 2 * n_groups * d_state
        d_in_proj = 2 * d_inner + 2 * n_groups * d_state + H
        f32 = torch.float32
        self.in_proj = Linear(d_model, d_in_proj, use_bias=False,
                              generator=generator, dtype=dtype)
        self.conv_w = nn.Parameter(truncated_normal(
            (d_conv, conv_ch), 1.0 / math.sqrt(d_conv), generator).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H,
                                                           dtype=f32)))
        self.D = nn.Parameter(torch.ones(H, dtype=f32))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(
            torch.full((H,), 0.01, dtype=f32))))
        self.norm = RMSNorm(d_inner, dtype=dtype)
        self.out_proj = Linear(d_inner, d_model, use_bias=False,
                               generator=generator, dtype=dtype)


def _silu(x):
    """``jax.nn.silu`` as the reference computes it: x * (1 / (1 + exp(-x))),
    each operation rounded to x's dtype (``F.silu`` rounds once, and in
    bf16 differs from the reference in a third of the values)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _split_zxbcdt(z_xbc_dt, d_inner, n_groups, d_state, H):
    z = z_xbc_dt[..., :d_inner]
    xBC = z_xbc_dt[..., d_inner:2 * d_inner + 2 * n_groups * d_state]
    dt = z_xbc_dt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, *, state=None):
    """Depthwise causal conv1d. xBC: (B,S,ch); conv_w: (W,ch).
    If ``state`` (B,W-1,ch) is given, prepend it (decode path). The W taps
    are summed in the working dtype, rounded after each add, in the
    reference's order."""
    W = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = state
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+W-1, ch)
    S = xBC.shape[1]
    out = xp[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * conv_w[i]
    new_state = xp[:, -(W - 1):]
    return _silu(out + conv_b), new_state


def _ssd_inputs(params, zxbcdt, b, s, *, headdim, d_state, n_groups,
                conv_state=None):
    """in_proj's output -> (z, x, dt, A, B, C, conv_state) in the reference's
    layout; x, B and C are views into the conv's output."""
    d_inner = params.out_proj.w.shape[0]
    H = d_inner // headdim
    z, xBC, dt = _split_zxbcdt(zxbcdt, d_inner, n_groups, d_state, H)
    xBC, conv_state = _causal_conv(xBC, params.conv_w, params.conv_b,
                                   state=conv_state)
    x = xBC[..., :d_inner].reshape(b, s, H, headdim)
    B = xBC[..., d_inner:d_inner + n_groups * d_state].reshape(
        b, s, n_groups, d_state)
    C = xBC[..., d_inner + n_groups * d_state:].reshape(
        b, s, n_groups, d_state)
    dt = F.softplus(dt.to(torch.float32) + params.dt_bias)
    A = -torch.exp(params.A_log)
    return z, x, dt, A, B, C, conv_state


def _gated_out(params, y, x, z):
    """y + D x, gated by silu(z), RMS-normed (eps 1e-6), projected out."""
    b, s = y.shape[:2]
    y = y + params.D.to(y.dtype)[None, None, :, None] * x
    y = y.reshape(b, s, -1)
    y = rmsnorm(params.norm.scale, y * _silu(z))
    return params.out_proj(y)


def mamba2_apply(params, u, *, headdim=64, d_state=128, n_groups=1, chunk=128,
                 ssd_fn=None):
    """Full-sequence forward. u: (B,S,d_model) -> (B,S,d_model). ``ssd_fn``
    (default ``ssd_chunked``) takes (x, dt, A, B, C, chunk=) and returns
    (y, state)."""
    b, s = u.shape[:2]
    z, x, dt, A, B, C, _ = _ssd_inputs(params, params.in_proj(u), b, s,
                                       headdim=headdim, d_state=d_state,
                                       n_groups=n_groups)
    y, _ = (ssd_fn or ssd_chunked)(x, dt, A, B, C, chunk=chunk)
    return _gated_out(params, y, x, z)


def init_ssm_cache(batch, d_model, *, d_inner=None, headdim=64, d_state=128,
                   n_groups=1, d_conv=4, dtype=torch.bfloat16, device=None):
    d_inner = d_inner or 2 * d_model
    H = d_inner // headdim
    conv_ch = d_inner + 2 * n_groups * d_state
    return {
        "conv": torch.zeros((batch, d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, headdim, d_state), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(params, u_t, cache, *, headdim=64, d_state=128,
                  n_groups=1):
    """One-token step. u_t: (B,1,d_model). Returns (y_t, new cache); the
    cache given is not written."""
    b = u_t.shape[0]
    z, x, dt, A, B, C, conv_state = _ssd_inputs(
        params, params.in_proj(u_t), b, 1, headdim=headdim, d_state=d_state,
        n_groups=n_groups, conv_state=cache["conv"])
    y, ssm_state = ssd_decode_step(cache["ssm"], x[:, 0], dt[:, 0], A,
                                   B[:, 0], C[:, 0])
    return (_gated_out(params, y[:, None], x, z),
            {"conv": conv_state, "ssm": ssm_state})
