"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V2,
arXiv:2405.04434).

Queries and keys/values are projected through low-rank bottlenecks
(q_lora / kv_lora). The KV cache stores only the compressed latent c_kv
plus the shared rotary key k_rope. Decode uses the *absorbed* formulation
(q_nope taken into the latent space through W_uk, the output out through
W_uv), so the full K/V are never materialized at decode time.

The full-sequence attention runs the config's 'full' or 'chunked'
backend. q and k have head dim nope + rope and v has v_head_dim, and the
reference's flash-attention kernel (K4) takes one head dim for all three,
so MLA under 'pallas' raises in both packages (ROADMAP.md, R6).

The cache is a dict of tensors {"ckv" (B, slots, kv_lora), "krope" (B,
slots, rope_d), "len" (B,)}; prefill and decode write it IN PLACE and
return the same dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.nn import attention as attn
from repro_torch.nn.layers import Linear, RMSNorm, truncated_normal
from repro_torch.nn.rotary import apply_rope


def check_backend(cfg, backend):
    """MLA runs 'full' and 'chunked'; 'pallas' raises (see the module
    docstring)."""
    if backend == "pallas":
        raise NotImplementedError(
            "MLA under attn_backend='pallas': q and k have head dim "
            f"{cfg.nope_head_dim + cfg.rope_head_dim} and v "
            f"{cfg.v_head_dim}, and the reference's flash-attention kernel "
            "takes one head dim for q, k and v; serve MLA with 'chunked' "
            "or 'full' (see ROADMAP.md)")


class MLA(nn.Module):
    """The reference's ``mla_init`` tree: ``wdq``, ``q_norm``, ``wuq``,
    ``wdkv``, ``kv_norm``, ``wo`` and the up-projections ``wuk``
    (kv_lora, H, nope) and ``wuv`` (kv_lora, H, v_head_dim), stored so the
    absorbed decode's products are direct."""

    def __init__(self, cfg, *, generator=None, dtype=torch.bfloat16):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        nope, rope_d, v_d = (cfg.nope_head_dim, cfg.rope_head_dim,
                             cfg.v_head_dim)
        kw = dict(use_bias=False, generator=generator, dtype=dtype)
        self.wdq = Linear(d, cfg.q_lora, **kw)
        self.q_norm = RMSNorm(cfg.q_lora, dtype=dtype)
        self.wuq = Linear(cfg.q_lora, H * (nope + rope_d), **kw)
        self.wdkv = Linear(d, cfg.kv_lora + rope_d, **kw)
        self.kv_norm = RMSNorm(cfg.kv_lora, dtype=dtype)
        std = 1.0 / math.sqrt(cfg.kv_lora)
        self.wuk = nn.Parameter(truncated_normal(
            (cfg.kv_lora, H, nope), std, generator).to(dtype))
        self.wuv = nn.Parameter(truncated_normal(
            (cfg.kv_lora, H, v_d), std, generator).to(dtype))
        self.wo = Linear(H * v_d, d, **kw)


def _project_q(cfg, params, x):
    B, S = x.shape[:2]
    nope = cfg.nope_head_dim
    cq = params.q_norm(params.wdq(x))
    q = params.wuq(cq).reshape(B, S, cfg.n_heads, nope + cfg.rope_head_dim)
    return q[..., :nope], q[..., nope:]


def _project_kv_latent(cfg, params, x):
    ckv_full = params.wdkv(x)
    ckv = params.kv_norm(ckv_full[..., :cfg.kv_lora])
    krope = ckv_full[..., cfg.kv_lora:]   # (B, S, rope_d), shared over heads
    return ckv, krope


def _attend(cfg, params, x, positions, *, backend, chunk):
    """Full-sequence causal MLA -> (output, c_kv, the rotated k_rope
    (B, S, rope_d)) for the cache."""
    check_backend(cfg, backend)
    B, S = x.shape[:2]
    H, rope_d, v_d = cfg.n_heads, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, params, x)
    ckv, krope = _project_kv_latent(cfg, params, x)
    k_nope = torch.einsum("bsl,lhd->bshd", ckv, params.wuk)
    v = torch.einsum("bsl,lhd->bshd", ckv, params.wuv)
    q_rope, krope_r = apply_rope(q_rope, krope[:, :, None, :], positions,
                                 theta=cfg.rope_theta)
    k_rope = krope_r.expand(B, S, H, rope_d)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    pos = positions[0] if positions.ndim > 1 else positions
    out = attn._sdpa(q, k, v, pos, pos, backend=backend, mode="causal",
                     window=None, chunk=chunk)
    return params.wo(out.reshape(B, S, H * v_d)), ckv, krope_r[:, :, 0, :]


def mla_apply(cfg, params, x, positions, *, backend="chunked", chunk=1024):
    """Full-sequence causal MLA (training / prefill compute)."""
    return _attend(cfg, params, x, positions, backend=backend,
                   chunk=chunk)[0]


def init_mla_cache(cfg, batch, max_len, dtype=torch.bfloat16, *,
                   device=None):
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                             dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_prefill(cfg, params, x, positions, cache, *, backend="chunked",
                chunk=1024):
    """``mla_apply``, and the latent and the rotated k_rope of every
    position into the cache, so decode never rotates history again (the
    reference projects and rotates them a second time; the values are the
    same)."""
    out, ckv, krope_r = _attend(cfg, params, x, positions, backend=backend,
                                chunk=chunk)
    S = x.shape[1]
    cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :S] = krope_r.to(cache["krope"].dtype)
    cache["len"] += S
    return out, cache


def mla_decode(cfg, params, x_t, cache):
    """Absorbed one-token decode. x_t: (B, 1, d_model)."""
    B = x_t.shape[0]
    H, v_d = cfg.n_heads, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, params, x_t)   # (B, 1, H, ·)
    ckv_t, krope_t = _project_kv_latent(cfg, params, x_t)
    pos = cache["len"].clone()   # (B,)
    q_rope, krope_r = apply_rope(q_rope, krope_t[:, :, None, :],
                                 pos[:, None], theta=cfg.rope_theta)
    slots = cache["ckv"].shape[1]
    attn.write_slot(cache["ckv"], pos.long(), ckv_t[:, 0])
    attn.write_slot(cache["krope"], pos.long(), krope_r[:, 0, 0])
    cache["len"].copy_(pos + 1)

    f32 = torch.float32
    # absorbed scores: q_nope into the latent space once, then dot with the
    # cached c_kv
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], params.wuk)
    ckv = cache["ckv"].to(f32)
    s_nope = torch.einsum("bhl,bsl->bhs", q_abs.to(f32), ckv)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32),
                          cache["krope"].to(f32))
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    s = (s_nope + s_rope) * scale
    valid = torch.arange(slots, device=x_t.device)[None, :] <= pos[:, None]
    s = s + torch.where(valid, 0.0, attn.NEG_INF)[:, None, :]
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", p, ckv)                 # (B, H, kv_lora)
    out = torch.einsum("bhl,lhd->bhd", ctx, params.wuv.to(f32))  # (B, H, v_d)
    out = out.reshape(B, 1, H * v_d).to(x_t.dtype)
    return params.wo(out), cache
